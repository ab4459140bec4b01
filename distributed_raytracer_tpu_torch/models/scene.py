"""Scene model: environments, objects, lights — and baking to flat arrays.

A copy of distributed_raytracer_tpu/models/scene.py with its logic unchanged
(the per-object grouped bake `bake_bvh_grouped` and the per-frame
`SceneDiff` included), plus `arrays_from_reference` and `from_reference`,
which take the JAX package's bake as it is.

The reference splits an Environment into immutables (mesh library) and
mutables (object R-tree + lights + camera) with gob serialization and
per-frame re-linking (shared/state/environment.go:25-98,162-234). This
design replaces the object graph with flat SoA arrays: at load time all mesh
instances are *baked* into one world-space triangle soup (translation-only
placement, object.go:17-22), with per-triangle precomputed intersection data
(Baldwin–Weber style plane + barycentric projectors) so the hot kernel needs
no cross products per ray-triangle pair.

JSON schema matches the reference scene format (environment.go:155-234):
  {"objs": [{"model": path, "pos": {xyz}}], "lights": [{"pos", "col"(u8)}],
   "cam": {"pos", "dir", "fov"}}
Model paths resolve relative to the scene file first, then as given
(environment.go:195-199).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, NamedTuple

import numpy as np

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.objparse import MeshData, parse_obj

TRI_PAD = 128  # pad triangle count to a multiple of 128 (the JAX bake's)


class SceneArrays(NamedTuple):
    """Flat scene arrays (all float32 / int32; numpy on the host, tensors
    inside the renderer).

    Triangle soup, padded to a multiple of TRI_PAD. Padding triangles have
    geo_n == 0, which makes the intersection denominator 0 -> never hit
    (mirrors how degenerate faces can never pass triangle.go:46's
    incidence != 0 test).
    """

    # Raw geometry (world space).
    p0: np.ndarray        # (T, 3) first vertex
    e1: np.ndarray        # (T, 3) p1 -> p2 edge
    e2: np.ndarray        # (T, 3) p1 -> p3 edge
    # Precomputed intersection data (float64-accurate, stored float32).
    geo_n: np.ndarray     # (T, 3) unnormalized geometric normal e1 x e2
    plane_d: np.ndarray   # (T,)  geo_n . p0
    k_u: np.ndarray       # (T, 3) barycentric-u projector: u = x . k_u + c_u
    k_v: np.ndarray       # (T, 3) barycentric-v projector
    c_u: np.ndarray       # (T,)  -p0 . k_u
    c_v: np.ndarray       # (T,)  -p0 . k_v
    # Shading data.
    n0: np.ndarray        # (T, 3) vertex normals (face normal if mesh had none,
    n1: np.ndarray        #        reproducing triangle.go:24-31's flat/smooth split)
    n2: np.ndarray
    mat_id: np.ndarray    # (T,) int32
    # Materials.
    mat_ka: np.ndarray    # (M, 3)
    mat_kd: np.ndarray    # (M, 3)
    mat_ks: np.ndarray    # (M, 3)
    mat_ns: np.ndarray    # (M,)
    # Lights.
    light_pos: np.ndarray  # (L, 3)
    light_col: np.ndarray  # (L, 3)

    @property
    def num_tris(self) -> int:
        return self.p0.shape[0]


@dataclasses.dataclass
class SceneObject:
    """A mesh instance with translation-only placement (object.go:17-22)."""

    obj_id: int
    model: str
    pos: np.ndarray  # (3,) float64


@dataclasses.dataclass
class Scene:
    """Host-side environment (the Environment/EnvMutables analog)."""

    meshes: Dict[str, MeshData]
    objects: List[SceneObject]
    light_pos: np.ndarray   # (L, 3) float64
    light_col: np.ndarray   # (L, 3) float64, channels in [0, 1]
    camera: Camera

    def set_object_pos(self, obj_id: int, pos) -> None:
        """Move an object (the EnvMutables diff analog). Requires re-bake."""
        for o in self.objects:
            if o.obj_id == obj_id:
                o.pos = np.asarray(pos, dtype=np.float64)
                return
        raise KeyError(f"no object with id {obj_id}")

    # ---- world-space triangle soup ------------------------------------

    def bake(self, dtype=np.float32, tri_pad: int = TRI_PAD) -> SceneArrays:
        """Flatten all instances into padded SoA arrays for the device.

        The analog of the reference's scene/mesh R-tree construction
        (environment.go:183, mesh.go:139) — except the acceleration structure
        here is array layout + (later) a block BVH, not a pointer tree.
        """
        p0s, e1s, e2s, n0s, n1s, n2s, mats = [], [], [], [], [], [], []
        mat_key_to_idx: Dict[tuple, int] = {}
        mat_rows: List[tuple] = []

        for obj in self.objects:
            mesh = self.meshes[obj.model]
            v = mesh.vertices + obj.pos[None, :]  # translation-only placement
            tri = v[mesh.faces_v]                 # (F, 3, 3)
            p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
            e1, e2 = p1 - p0, p2 - p0
            if mesh.has_normals:
                n = mesh.normals[mesh.faces_n]    # (F, 3, 3)
                n0, n1, n2 = n[:, 0], n[:, 1], n[:, 2]
            else:
                # Flat shading: bake the face normal into all three vertex
                # slots; barycentric interpolation then returns it exactly
                # (triangle.go:24-26 vs :29-31).
                fn = np.cross(e1, e2)
                with np.errstate(invalid="ignore", divide="ignore"):
                    fn = fn / np.linalg.norm(fn, axis=1, keepdims=True)
                fn = np.nan_to_num(fn)
                n0 = n1 = n2 = fn
            # Deduplicate materials across meshes.
            local_to_global = []
            for m in mesh.materials:
                key = (m.ka, m.kd, m.ks, m.ns)
                idx = mat_key_to_idx.get(key)
                if idx is None:
                    idx = len(mat_rows)
                    mat_rows.append(key)
                    mat_key_to_idx[key] = idx
                local_to_global.append(idx)
            remap = np.asarray(local_to_global, dtype=np.int32)

            p0s.append(p0); e1s.append(e1); e2s.append(e2)
            n0s.append(n0); n1s.append(n1); n2s.append(n2)
            mats.append(remap[mesh.face_mat])

        if p0s:
            p0 = np.concatenate(p0s); e1 = np.concatenate(e1s); e2 = np.concatenate(e2s)
            n0 = np.concatenate(n0s); n1 = np.concatenate(n1s); n2 = np.concatenate(n2s)
            mat_id = np.concatenate(mats)
        else:
            p0 = e1 = e2 = n0 = n1 = n2 = np.zeros((0, 3))
            mat_id = np.zeros((0,), dtype=np.int32)
        if not mat_rows:
            mat_rows.append(((0.0,) * 3, (1.0,) * 3, (0.0,) * 3, 0.0))

        # Pad to a lane multiple with degenerate (never-hit) triangles.
        t = p0.shape[0]
        t_pad = max(tri_pad, -(-max(t, 1) // tri_pad) * tri_pad)
        pad = t_pad - t

        def padded(a, fill=0.0):
            width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, width, constant_values=fill)

        p0, e1, e2 = padded(p0), padded(e1), padded(e2)
        n0, n1, n2 = padded(n0), padded(n1), padded(n2)
        mat_id = padded(mat_id)

        # Precompute intersection data in float64, then cast.
        geo_n = np.cross(e1, e2)
        plane_d = np.einsum("ij,ij->i", geo_n, p0)
        nn = np.einsum("ij,ij->i", geo_n, geo_n)
        with np.errstate(invalid="ignore", divide="ignore"):
            k_u = np.cross(e2, geo_n) / nn[:, None]
            k_v = np.cross(geo_n, e1) / nn[:, None]
        k_u = np.nan_to_num(k_u, posinf=0.0, neginf=0.0)
        k_v = np.nan_to_num(k_v, posinf=0.0, neginf=0.0)
        c_u = -np.einsum("ij,ij->i", p0, k_u)
        c_v = -np.einsum("ij,ij->i", p0, k_v)

        mat_ka = np.asarray([m[0] for m in mat_rows])
        mat_kd = np.asarray([m[1] for m in mat_rows])
        mat_ks = np.asarray([m[2] for m in mat_rows])
        mat_ns = np.asarray([m[3] for m in mat_rows])

        f = lambda a: np.asarray(a, dtype=dtype)
        return SceneArrays(
            p0=f(p0), e1=f(e1), e2=f(e2),
            geo_n=f(geo_n), plane_d=f(plane_d), k_u=f(k_u), k_v=f(k_v),
            c_u=f(c_u), c_v=f(c_v),
            n0=f(n0), n1=f(n1), n2=f(n2),
            mat_id=np.asarray(mat_id, dtype=np.int32),
            mat_ka=f(mat_ka), mat_kd=f(mat_kd), mat_ks=f(mat_ks), mat_ns=f(mat_ns),
            light_pos=f(self.light_pos), light_col=f(self.light_col),
        )


    @property
    def num_tris(self) -> int:
        """Real (unpadded) triangle count across all instances."""
        return sum(len(self.meshes[o.model].faces_v) for o in self.objects)

    def _slot_map(self, block_size: int, grouped: bool):
        """The native bake's leaf-block slot map, (slot_src, obj_id):
        slot_src (T',) int64 is the source triangle (the objects' triangles
        in order) at each slot, -1 at padding. Grouped: per-object Morton
        order and gap alignment, so no leaf block spans two objects
        (_grouped_order's layout, same codes and order), and obj_id (T',)
        int32 owns each slot. Else one global Morton order, obj_id None.
        Without the native library, NumPy's codes and centroids stand in."""
        from distributed_raytracer_tpu_torch.models import bvh as bvh_mod, native

        lib = native.available()
        codes_of = native.morton_codes if lib else bvh_mod.morton_codes

        def centroids(obj):
            mesh = self.meshes[obj.model]
            if lib:
                return native.centroids(mesh.vertices, mesh.faces_v, obj.pos)
            return mesh.vertices[mesh.faces_v].sum(axis=1) / 3.0 + obj.pos

        counts = [len(self.meshes[o.model].faces_v) for o in self.objects]
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        if grouped:
            slot_chunks, id_chunks = [], []
            for oi, obj in enumerate(self.objects):
                codes = codes_of(centroids(obj))
                order = np.argsort(codes, kind="stable")
                slots = bvh_mod.gap_aligned_slots(codes[order], block_size)
                full = np.where(slots >= 0,
                                starts[oi] + order[np.maximum(slots, 0)], -1)
                slot_chunks.append(full)
                id_chunks.append(np.full(full.shape, oi, np.int32))
            return np.concatenate(slot_chunks), np.concatenate(id_chunks)
        cents = np.concatenate([centroids(obj) for obj in self.objects])
        order = (native.morton_argsort(cents) if lib
                 else np.argsort(codes_of(cents), kind="stable"))
        codes = codes_of(cents)[order]
        slots = bvh_mod.gap_aligned_slots(codes, block_size)
        return np.where(slots >= 0, order[np.maximum(slots, 0)], -1), None

    def _bake_bvh_native(self, block_size: int, grouped: bool):
        """One-pass C++ bake (native/drt_native.cpp drt_bake_object): the
        whole per-triangle loop — world-space placement, Baldwin-Weber
        precompute, normals, per-slot AABBs with the bound-epsilon floor —
        runs in OpenMP, writing rows directly at their final Morton/
        gap-aligned slots. Behaviorally identical to the NumPy chain
        (bake + reorder_scene + build_block_bvh). Returns None to fall
        back."""
        from distributed_raytracer_tpu_torch.models import bvh as bvh_mod, native

        if not self.objects or not native.available():
            return None
        counts = [len(self.meshes[o.model].faces_v) for o in self.objects]
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        n_real = int(starts[-1])
        if n_real == 0:
            return None

        # Material dedup across meshes — bake()'s exact loop, geometry-free.
        mat_key_to_idx: Dict[tuple, int] = {}
        mat_rows: List[tuple] = []
        remaps = []
        for obj in self.objects:
            mesh = self.meshes[obj.model]
            local = []
            for m in mesh.materials:
                key = (m.ka, m.kd, m.ks, m.ns)
                idx = mat_key_to_idx.get(key)
                if idx is None:
                    idx = len(mat_rows)
                    mat_rows.append(key)
                    mat_key_to_idx[key] = idx
                local.append(idx)
            remaps.append(np.asarray(local, np.int32))
        if not mat_rows:
            mat_rows.append(((0.0,) * 3, (1.0,) * 3, (0.0,) * 3, 0.0))

        slot_src, obj_id = self._slot_map(block_size, grouped)

        out = native.BakeOut(slot_src.shape[0])
        slot_src = np.ascontiguousarray(slot_src, np.int64)
        for oi, obj in enumerate(self.objects):
            mesh = self.meshes[obj.model]
            native.bake_object(out, mesh.vertices, mesh.faces_v,
                               mesh.faces_n, mesh.normals, mesh.has_normals,
                               remaps[oi][mesh.face_mat], obj.pos, slot_src,
                               int(starts[oi]), int(starts[oi + 1]))
        lo, hi = native.block_bounds(out, block_size)
        f = lambda a: np.asarray(a, np.float32)
        arrays = SceneArrays(
            p0=out.p0, e1=out.e1, e2=out.e2, geo_n=out.geo_n,
            plane_d=out.plane_d, k_u=out.k_u, k_v=out.k_v,
            c_u=out.c_u, c_v=out.c_v, n0=out.n0, n1=out.n1, n2=out.n2,
            mat_id=out.mat_id,
            mat_ka=f([m[0] for m in mat_rows]),
            mat_kd=f([m[1] for m in mat_rows]),
            mat_ks=f([m[2] for m in mat_rows]),
            mat_ns=f([m[3] for m in mat_rows]),
            light_pos=f(self.light_pos), light_col=f(self.light_col))
        tree = bvh_mod.BlockBVH(block_lo=lo, block_hi=hi,
                                block_size=block_size)
        if grouped:
            block_obj = obj_id.reshape(-1, block_size)[:, 0]
            obj_pos0 = np.stack([o.pos for o in self.objects])
            return arrays, tree, obj_id, block_obj, obj_pos0.astype(np.float32)
        return arrays, tree

    def bake_bvh(self, block_size: int = 128, dtype=np.float32):
        """bake() + Morton reorder + gap-aligned leaf blocks + block AABBs.

        Returns (SceneArrays in Morton order, BlockBVH). The array analog of
        building the reference's R-trees at load time (mesh.go:139,
        environment.go:183). Block boundaries align to Morton-code gaps
        (bvh.gap_aligned_slots) so a leaf never spans spatially distant
        clusters — padding triangles are degenerate zero rows.

        Dispatches to the one-pass C++ bake (_bake_bvh_native) when the
        native library is available; the NumPy chain below is the
        behavioral reference and fallback.
        """
        from distributed_raytracer_tpu_torch.models import bvh as bvh_mod

        if dtype == np.float32:
            got = self._bake_bvh_native(block_size, grouped=False)
            if got is not None:
                return got
        arrays = self.bake(dtype=dtype, tri_pad=block_size)
        n_real = self.num_tris
        p0 = np.asarray(arrays.p0, np.float64)
        e1 = np.asarray(arrays.e1, np.float64)
        e2 = np.asarray(arrays.e2, np.float64)
        order = bvh_mod.morton_order(p0, e1, e2, n_real)[:n_real]
        centroids = p0[:n_real] + (e1[:n_real] + e2[:n_real]) / 3.0
        codes = bvh_mod.morton_codes(centroids)[order]
        slots = bvh_mod.gap_aligned_slots(codes, block_size)
        full = np.where(slots >= 0, order[np.maximum(slots, 0)], -1)
        arrays = bvh_mod.reorder_scene(arrays, full)
        tree = bvh_mod.build_block_bvh(arrays, slots >= 0, block_size)
        return arrays, tree

    def bake_bvh_grouped(self, block_size: int = 128, dtype=np.float32):
        """bake_bvh with per-OBJECT Morton ordering: no leaf block ever
        spans two objects, so a per-frame object translation (SceneDiff)
        shifts each block's AABB exactly — the structural requirement of
        the dynamic renderer (ops/render_dynamic.py).

        Returns (arrays, tree, obj_id (T,) int32 owner per slot,
        block_obj (NB,) int32 owner per block, obj_pos0 (O, 3) float32
        baked object positions)."""
        from distributed_raytracer_tpu_torch.models import bvh as bvh_mod

        if dtype == np.float32:
            got = self._bake_bvh_native(block_size, grouped=True)
            if got is not None:
                return got
        arrays = self.bake(dtype=dtype, tri_pad=block_size)
        slots, obj_id = _grouped_order(self, arrays, block_size)
        arrays = bvh_mod.reorder_scene(arrays, slots)
        tree = bvh_mod.build_block_bvh(arrays, slots >= 0, block_size)
        block_obj = obj_id.reshape(-1, block_size)[:, 0]
        obj_pos0 = (np.stack([o.pos for o in self.objects])
                    if self.objects else np.zeros((0, 3)))
        return (arrays, tree, obj_id, block_obj,
                obj_pos0.astype(np.float32))

    def bake_blocks(self, block_size: int = 128):
        """The static renderers' bake: bake_bvh's one global leaf-block
        layout or bake_bvh_grouped's per-object one, whichever has the
        smaller sum of block AABB surface areas (the global one on a tie).

        A leaf block costs the traversal `block_size` pairs for every ray
        tile whose hull meets its box, however full it is, so the summed
        surface area is the cull's expected cost (the SAH leaf cost). The
        global Morton codes normalise each axis to its own extent: on a
        flat grid of objects they are z-major, and their runs are thin
        slabs across neighbouring objects, which the per-object order never
        makes. A scene of one object has one order, and skips the
        comparison.

        Returns (arrays, tree, layout), layout "global" or "object";
        tracing.COUNTS["bake_by_object"] counts the bakes that chose
        "object"."""
        from distributed_raytracer_tpu_torch.utils import tracing

        if len(self.objects) > 1:
            v = np.concatenate([self.meshes[o.model].vertices[
                self.meshes[o.model].faces_v] + o.pos for o in self.objects])
            lo, hi = v.min(axis=1), v.max(axis=1)   # triangle boxes
            area = {g: _summed_block_area(self._slot_map(block_size, g)[0],
                                          lo, hi, block_size)
                    for g in (False, True)}
            if area[True] < area[False]:
                tracing.COUNTS["bake_by_object"] += 1
                arrays, tree = self.bake_bvh_grouped(block_size)[:2]
                return arrays, tree, "object"
        return (*self.bake_bvh(block_size), "global")

    def make_diff(self) -> "SceneDiff":
        """Snapshot the current mutable state as a per-frame diff (the
        master gob-encoding EnvMutables each frame, master/main.go:260-262)."""
        obj_pos = (np.stack([o.pos for o in self.objects])
                   if self.objects else np.zeros((0, 3)))
        return SceneDiff(obj_pos=obj_pos.astype(np.float32),
                         light_pos=np.asarray(self.light_pos, np.float32),
                         light_col=np.asarray(self.light_col, np.float32))


class SceneDiff(NamedTuple):
    """Per-frame mutable scene state — the EnvMutables analog
    (shared/state/environment.go:65-69: object positions + lights + camera;
    the camera already rides every render call).

    Where the reference gob-encodes the diff and every worker re-links and
    rebuilds its R-tree per order (worker/distributed/main.go:56-64,
    environment.go:73-98), here the diff is a tiny host tuple folded into
    the baked arrays on the device each frame (ops/render_dynamic.py) —
    translation only touches plane_d/c_u/c_v/p0 and shifts whole-object
    block AABBs, so no host re-bake or BVH rebuild happens at frame rate.
    """

    obj_pos: np.ndarray    # (O, 3) float32 ABSOLUTE object positions
    light_pos: np.ndarray  # (L, 3) float32
    light_col: np.ndarray  # (L, 3) float32


def _summed_block_area(slot_src: np.ndarray, tri_lo: np.ndarray,
                       tri_hi: np.ndarray, block_size: int) -> float:
    """Sum over the leaf blocks of a slot map (-1 = padding) of the surface
    area of the block's box around its real triangles' boxes."""
    pad = (slot_src < 0)[:, None]
    src = np.maximum(slot_src, 0)
    lo = np.where(pad, np.inf, tri_lo[src]).reshape(-1, block_size, 3)
    hi = np.where(pad, -np.inf, tri_hi[src]).reshape(-1, block_size, 3)
    d = hi.max(axis=1) - lo.min(axis=1)
    d = d[np.isfinite(d).all(axis=1)]          # all-padding blocks: none
    return float(2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                        + d[:, 2] * d[:, 0]).sum())


def _grouped_order(scene: "Scene", arrays: SceneArrays, block_size: int):
    """Per-object Morton ordering + gap alignment (objects never share a
    leaf block, so a per-object translation shifts each block AABB exactly).

    Returns (slots, obj_id) where slots is the reorder_scene map (-1 =
    padding) and obj_id tags every output slot with its owner object index.
    """
    from distributed_raytracer_tpu_torch.models import bvh as bvh_mod

    p0 = np.asarray(arrays.p0, np.float64)
    e1 = np.asarray(arrays.e1, np.float64)
    e2 = np.asarray(arrays.e2, np.float64)
    counts = [len(scene.meshes[o.model].faces_v) for o in scene.objects]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    slot_chunks, id_chunks = [], []
    for oi in range(len(scene.objects)):
        a, b = int(starts[oi]), int(starts[oi + 1])
        cent = p0[a:b] + (e1[a:b] + e2[a:b]) / 3.0
        codes = bvh_mod.morton_codes(cent)
        order = np.argsort(codes, kind="stable")
        slots = bvh_mod.gap_aligned_slots(codes[order], block_size)
        full = np.where(slots >= 0, a + order[np.maximum(slots, 0)], -1)
        slot_chunks.append(full)
        id_chunks.append(np.full(full.shape, oi, np.int32))
    if not slot_chunks:
        return (np.full(block_size, -1, np.int64),
                np.zeros(block_size, np.int32))
    return np.concatenate(slot_chunks), np.concatenate(id_chunks)


def load_scene(path: str) -> Scene:
    """Load a JSON scene (the EnvironmentFromFile analog, environment.go:162-234)."""
    with open(path, "r") as fh:
        data = json.load(fh)

    meshes: Dict[str, MeshData] = {}
    objects: List[SceneObject] = []
    for i, stored in enumerate(data.get("objs", [])):
        model = stored["model"]
        if model not in meshes:
            rel = os.path.join(os.path.dirname(path), model)
            mesh_path = rel if os.path.exists(rel) else model
            meshes[model] = parse_obj(mesh_path)
        pos = stored["pos"]
        objects.append(SceneObject(
            obj_id=i + 1,  # ids are 1..N (environment.go:209)
            model=model,
            pos=np.asarray([pos["x"], pos["y"], pos["z"]], dtype=np.float64),
        ))

    lights = data.get("lights", [])
    light_pos = np.asarray(
        [[l["pos"]["x"], l["pos"]["y"], l["pos"]["z"]] for l in lights], dtype=np.float64
    ).reshape(-1, 3)
    light_col = np.asarray(
        [[l["col"]["r"] / 255.0, l["col"]["g"] / 255.0, l["col"]["b"] / 255.0] for l in lights],
        dtype=np.float64,
    ).reshape(-1, 3)  # colour.go:28-30 NewRGB semantics

    cam = data["cam"]
    camera = Camera.create(
        pos=[cam["pos"]["x"], cam["pos"]["y"], cam["pos"]["z"]],
        direction=[cam["dir"]["x"], cam["dir"]["y"], cam["dir"]["z"]],
        fov=cam["fov"],
    )
    return Scene(meshes=meshes, objects=objects,
                 light_pos=light_pos, light_col=light_col, camera=camera)


def _check_array(name: str, a, shape, dtype) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != dtype or a.shape != shape:
        raise ValueError(f"{name}: expected {np.dtype(dtype)} {shape}, "
                         f"got {a.dtype} {a.shape}")
    return a


def arrays_from_reference(arrays) -> SceneArrays:
    """The JAX package's flat bake (`Scene.bake()` of
    distributed_raytracer_tpu, a NamedTuple of numpy arrays) as this
    package's SceneArrays. Field names, shapes and dtypes are checked, not
    converted, so the dense, sharded and ring renderers see exactly the
    reference's arrays."""
    if tuple(arrays._fields) != SceneArrays._fields:
        raise ValueError(f"SceneArrays fields differ: {arrays._fields}")
    t = np.asarray(arrays.p0).shape[0]
    m = np.asarray(arrays.mat_ka).shape[0]
    n_lights = np.asarray(arrays.light_pos).shape[0]
    shapes = {"plane_d": (t,), "c_u": (t,), "c_v": (t,), "mat_id": (t,),
              "mat_ka": (m, 3), "mat_kd": (m, 3), "mat_ks": (m, 3),
              "mat_ns": (m,), "light_pos": (n_lights, 3),
              "light_col": (n_lights, 3)}
    fields = {}
    for name in SceneArrays._fields:
        dtype = np.int32 if name == "mat_id" else np.float32
        fields[name] = _check_array(name, getattr(arrays, name),
                                    shapes.get(name, (t, 3)), dtype)
    return SceneArrays(**fields)


def from_reference(arrays, tree):
    """The JAX package's bake, `(SceneArrays, BlockBVH)` from
    distributed_raytracer_tpu's `Scene.bake_bvh`, as this package's pair.

    Both are NamedTuples of numpy arrays; field names, shapes and dtypes are
    checked (`arrays_from_reference`), so `CulledRenderer(None, W, H,
    prebaked=from_reference(...))` renders from exactly the reference's
    triangle order and leaf blocks."""
    from distributed_raytracer_tpu_torch.models.bvh import BlockBVH

    if tuple(tree._fields) != BlockBVH._fields:
        raise ValueError(f"BlockBVH fields differ: {tree._fields}")
    arrays = arrays_from_reference(arrays)
    t = arrays.p0.shape[0]
    bs = int(tree.block_size)
    if bs <= 0 or t % bs:
        raise ValueError(f"block_size {bs} does not divide {t} triangles")
    nb = t // bs
    lo = _check_array("block_lo", tree.block_lo, (nb, 3), np.float32)
    hi = _check_array("block_hi", tree.block_hi, (nb, 3), np.float32)
    return arrays, BlockBVH(block_lo=lo, block_hi=hi, block_size=bs)
