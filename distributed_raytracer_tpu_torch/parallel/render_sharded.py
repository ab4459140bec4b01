"""Ray-sharded dense rendering over a mesh of ranks.

The torch counterpart of distributed_raytracer_tpu/parallel/render_sharded.py,
the replacement for the reference's master/worker tile dispatch
(master/main.go:94-187): the ray grid is statically row-partitioned across
the ranks (`tile.row_partition`), the scene is replicated to every rank's
device (registrar.go:41-47 ships the full scene to every worker), each rank
generates and traces only its own contiguous block of flat pixel indices on
its own device and stream, and the frame is gathered at the end. Rays are
independent, so no other collective is needed.

A mesh is a tuple of devices (parallel/mesh.py); n ranks may share one
card, their streams then run side by side.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from distributed_raytracer_tpu_torch.models.scene import SceneArrays
from distributed_raytracer_tpu_torch.ops import intersect, raygen, shade
from distributed_raytracer_tpu_torch.ops.render import scene_on, trace_rays
from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
from distributed_raytracer_tpu_torch.parallel.mesh import default_mesh
from distributed_raytracer_tpu_torch.parallel.tile import row_partition
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

__all__ = ["default_mesh", "make_sharded_renderer", "render_frame_sharded"]


def make_sharded_renderer(width: int, height: int, mesh=None,
                          cfg: RenderConfig = DEFAULT_CONFIG):
    """A (scene, cam) -> (H, W, 3) renderer sharded over `mesh` (default:
    one rank per card). `scene` is a SceneArrays of numpy arrays or
    tensors; it is replicated to each rank's device per call (no copy where
    it already lies there). The frame lands on rank 0's device.
    `render.device_fn(scene, cam)` returns the padded flat
    (n * per_shard, 3) rows; `render.mesh` is the mesh."""
    mesh = mesh_mod.check_mesh(default_mesh() if mesh is None else mesh)
    ranks = mesh_mod.Ranks(mesh)
    for d in set(mesh):
        intersect.fp32_matmuls(d)
    n_shards = len(mesh)
    n_rays = width * height
    chunk = min(cfg.ray_chunk, -(-n_rays // n_shards))
    per_shard = row_partition(n_rays, n_shards, chunk)

    def render_padded(scene: SceneArrays, cam) -> torch.Tensor:
        reps = {d: scene_on(scene, d) for d in set(mesh)}
        ranks.begin()
        inputs, parts = [], [[] for _ in range(n_shards)]
        for r in range(n_shards):
            with ranks.on(r):
                sc = reps[mesh[r]]
                if ranks.cuda:
                    for a in sc:
                        a.record_stream(ranks.compute[r])
                c = raygen.camera_arrays(cam, mesh[r])
                idx = r * per_shard + torch.arange(
                    per_shard, dtype=torch.int32, device=mesh[r])
                inputs.append((sc, c, raygen.ray_directions_flat(
                    c, width, height, idx), shade.pack_table(sc)))
        # Chunk by chunk across the ranks, so that no rank's launch queue
        # fills (and blocks the host) before the others have work.
        for s in range(0, per_shard, chunk):
            for r in range(n_shards):
                sc, c, dirs, table = inputs[r]
                with ranks.on(r):
                    parts[r].append(trace_rays(sc, c.pos, c.pos,
                                               dirs[s:s + chunk], cfg, table))
        out = []
        for r in range(n_shards):
            with ranks.on(r):
                out.append(torch.cat(parts[r]))
        return mesh_mod.gather(ranks, out)

    def render(scene: SceneArrays, cam) -> torch.Tensor:
        """The full frame on rank 0's device (the framebuffer gather: the
        master reassembling worker tiles, main.go:163-177)."""
        return render_padded(scene, cam)[:n_rays].reshape(height, width, 3)

    render.device_fn = render_padded
    render.mesh = mesh
    return render


@functools.lru_cache(maxsize=8)
def _cached_renderer(width: int, height: int, n_devices: Optional[int],
                     device: str, cfg: RenderConfig):
    return make_sharded_renderer(width, height,
                                 default_mesh(n_devices, device), cfg)


def render_frame_sharded(scene: SceneArrays, cam, width: int, height: int,
                         n_devices: Optional[int] = None,
                         cfg: RenderConfig = DEFAULT_CONFIG,
                         device: str = "cuda") -> torch.Tensor:
    """Convenience wrapper with renderer caching keyed on (W, H, devices)."""
    return _cached_renderer(width, height, n_devices, device, cfg)(scene,
                                                                   cam)
