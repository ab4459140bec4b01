"""Per-frame scene mutability: object translations and lights as diffs.

The torch counterpart of distributed_raytracer_tpu/ops/render_dynamic.py.
The reference ships a mutable-state diff in every work order — object
positions, lights, camera (shared/state/environment.go:65-69) — and every
worker re-links it and rebuilds its object R-tree per frame
(worker/distributed/main.go:56-64, environment.go:73-98). Here the diff is
folded into the packed device arrays each frame, with no re-bake:

  - Translation-only placement (object.go:17-22) means a shift d touches
    exactly: p0' = p0 + d, plane_d' = plane_d + geo_n.d, c_u' = c_u - d.k_u,
    c_v' = c_v - d.k_v; edges, normals and the barycentric projectors are
    translation-invariant. A few elementwise ops over the packed triangle
    rows per frame — no re-bake, no BVH rebuild.
  - The BVH survives because bake_bvh_grouped Morton-orders each object
    separately: a leaf block belongs to exactly one object, so its AABB
    shifts exactly by that object's delta.
  - Lights are refolded per frame from the diffed rows (the per-light
    shadow scalars, bsr_trace.fold_origin_scal under use_mxu, else the
    pack_tris_origin rows). The tensor-core form's direction matrix is
    translation-invariant and never refolds.

The diffed arrays form one per-frame `DeviceScene` bundle that the parent's
frozen pipeline reads in place of its own; the renderer is never mutated
per frame. On CUDA the fold and the pipeline are captured together in one
CUDA graph (ops/frozen_graph.py), so a frame is one replay.

Tracing (utils/tracing.py). Each render_dynamic call counts one frame in
`COUNTS["scene_diffs"]`, on or off. While the tracer is on, the diff's
pack and its copy into pinned memory are the span `dynamic.diff`, and the
fold (`_apply_diff`, light refolds included) lies between two device
stamps of their own kind, "fold", marked before the culled frame's five
"stages" stamps and captured into the same graph; with the tracer off the
graph holds no stamp.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.scene import Scene, SceneDiff
from distributed_raytracer_tpu_torch.ops import raygen
from distributed_raytracer_tpu_torch.ops.render_bvh import (CulledRenderer,
                                                            DeviceScene)
from distributed_raytracer_tpu_torch.utils import tracing


def _rowdot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise (T, 3) . (T, 3) -> (T, 1), summed in order x, y, z."""
    return a[:, 0:1] * b[:, 0:1] + a[:, 1:2] * b[:, 1:2] + a[:, 2:3] * b[:, 2:3]


class DynamicCulledRenderer(CulledRenderer):
    """CulledRenderer whose frozen render step takes a SceneDiff each
    frame. Builds from a Scene (its own grouped bake), never `prebaked`."""

    def __init__(self, scene: Scene, width: int, height: int, **kwargs):
        if kwargs.get("prebaked") is not None or scene is None:
            raise ValueError("DynamicCulledRenderer bakes its scene itself "
                             "(bake_bvh_grouped): pass a Scene, no prebaked")
        super().__init__(scene, width, height, **kwargs)

    def _bake_scene(self, scene: Scene, block_size: int):
        """The grouped bake, keeping the ownership maps on the device."""
        arrays, tree, obj_id, block_obj, obj_pos0 = scene.bake_bvh_grouped(
            block_size=block_size)
        self._obj_id = torch.from_numpy(obj_id.astype(np.int64)).to(
            self.device)
        self._block_obj = torch.from_numpy(block_obj.astype(np.int64)).to(
            self.device)
        self.obj_pos0 = torch.from_numpy(obj_pos0).to(self.device)
        self.block_layout = "object"
        return arrays, tree

    @staticmethod
    def _diff_packed(diff: SceneDiff) -> torch.Tensor:
        """The diff's fields as one (n, 3) float32 host tensor, the one
        host-to-device copy of a frame's diff."""
        return torch.from_numpy(np.concatenate(
            [np.asarray(a, np.float32).reshape(-1, 3) for a in diff]))

    def _diff_views(self, packed: torch.Tensor) -> SceneDiff:
        """SceneDiff viewing a (n, 3) _diff_packed tensor on the device."""
        n_obj = self.obj_pos0.shape[0]
        n_light = (packed.shape[0] - n_obj) // 2
        return SceneDiff(packed[:n_obj], packed[n_obj:n_obj + n_light],
                         packed[n_obj + n_light:])

    def _apply_diff(self, diff: SceneDiff) -> DeviceScene:
        """This frame's scene arrays: the renderer's own with the diff's
        object shifts and lights folded in (on the device, no host sync)."""
        base = self.dev_scene
        delta = diff.obj_pos - self.obj_pos0                 # (O, 3)
        dt = delta[self._obj_id]                             # (T, 3)
        t16 = base.tris_packed
        plane = t16[:, 3:4] + _rowdot3(t16[:, 0:3], dt)
        cu = t16[:, 7:8] - _rowdot3(t16[:, 4:7], dt)
        cv = t16[:, 11:12] - _rowdot3(t16[:, 8:11], dt)
        tris16 = torch.cat([t16[:, 0:3], plane, t16[:, 4:7], cu,
                            t16[:, 8:11], cv, t16[:, 12:]], dim=1)
        # p0 rows of the (32, T) shading table.
        table = torch.cat([base.shade_tbl[0:3] + dt.T, base.shade_tbl[3:]])
        shift = delta[self._block_obj]                       # exact shift
        # The pipeline reads only lights (and array shapes) from the slim
        # SceneArrays; the per-triangle data it consumes is the rows above.
        arrays = base.arrays._replace(light_pos=diff.light_pos,
                                      light_col=diff.light_col)
        return DeviceScene(
            arrays=arrays, tris_packed=tris16, tris_dirs=base.tris_dirs,
            lights_scal=self._fold_lights(tris16, diff.light_pos),
            shade_tbl=table, block_lo=base.block_lo + shift,
            block_hi=base.block_hi + shift)

    def render_dynamic(self, camera, diff: SceneDiff,
                       verify: bool = False) -> torch.Tensor:
        """Diff fold + cull + traversal + shadows + shading with the frozen
        buckets and no host sync; returns the (H, W, 3) tensor. On CUDA
        the diff fold and the stages replay one graph, the diff written
        into its static input in one pinned, non-blocking copy.

        Buckets come from the parent's freeze state (size with a
        representative camera first, or let the first call run the static
        sizing render); verify=True re-sizes on overflow, grow-only, as
        render_fast does."""
        if self.buckets() is None:
            self.freeze(camera)
        tracing.COUNTS["scene_diffs"] += 1
        with tracing.span("dynamic.diff"):
            packed = self._diff_packed(diff)
            if self.device.type == "cuda":
                packed = packed.pin_memory()
        frame = self._frozen_frame(
            "dynamic", {"camera": raygen.camera_packed(camera),
                        "diff": packed}, self._dynamic_body)
        return self._render_frozen(frame, camera, verify, "render_dynamic")

    def _dynamic_body(self, bufs: dict, pads: tuple):
        mark = self._marks("fold", 2)
        mark(0)
        sc = self._apply_diff(self._diff_views(bufs["diff"]))
        mark(1)
        return self._full(sc, pads, raygen.camera_views(bufs["camera"]))
