"""Geometry-sharded rendering with ray halo exchange (dense).

The torch counterpart of distributed_raytracer_tpu/parallel/halo.py, the
second sharded-geometry schedule. Where parallel/ring.py rotates triangle
shards past resident rays (n steps of the full geometry shard), this one
keeps the geometry pinned and routes the rays to the shards: the
reference's "every worker holds the whole scene" (registrar.go:41-47)
relaxed into contiguous geometry shards plus an exchange of rays.

Exchange per frame: one `all_gather` of the ray directions (queries out),
one `all_to_all` of the per-shard candidates (results home), and per light
one `all_gather` of the shadow segments and one `all_to_all` of the
occlusion bits: O(rays), whatever the triangle count.

Exactness: every triangle lies inside its shard's AABB, so a ray's nearest
hit is the minimum over shards of the per-shard nearest hits; candidates
fold in (t, then global id) order (`_fold_payloads`), the replicated
renderer's tie rule. The routing mask (`_segment_mask`, a conservative
segment-vs-shard-AABB slab test) zeroes the candidates of rays that miss a
shard's box: it removes no work in this dense form, and its mean is the
`halo_density` diagnostic.

Per rank (r_loc resident rays, T / n resident triangles), in plain torch
(no kernel runs on this path, as in the JAX package):
  1. raygen of the resident band of flat pixel indices;
  2. all_gather of the directions -> nearest hits against the local shard
     (parallel/ring._local_nearest, cfg.ray_chunk rays at a time) -> the
     routing mask -> all_to_all of the candidates -> the fold;
  3. per light, the shadow segments of the resident hits: all_gather ->
     local any-hit with per-ray t_max and self-exclusion -> the routing
     mask -> all_to_all of the bits -> OR;
  4. Phong from the folded payload (the ring's shading).
A mesh is a tuple of devices (parallel/mesh.py); ranks may share a card.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.scene import SceneArrays
from distributed_raytracer_tpu_torch.ops import intersect, raygen
from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
from distributed_raytracer_tpu_torch.parallel.ring import (
    _PER_TRI, HitPayload, RingShard, _hit_frames, _local_any, _local_nearest,
    _phong, _Replicated, _shadow_inputs, pad_for_ring)
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

__all__ = ["make_halo_renderer", "pad_for_ring", "shard_bounds"]

INF = float("inf")


def shard_bounds(arrays: SceneArrays, n_shards: int) -> tuple:
    """(n, 3) lo / hi AABBs of each contiguous triangle shard, on the host
    in float64, returned as float32.

    Call after Morton-ordering (models/bvh.morton_order) so contiguous
    shards are spatially compact: that is what routing by AABB needs."""
    p0 = np.asarray(arrays.p0, np.float64)
    p1 = p0 + np.asarray(arrays.e1, np.float64)
    p2 = p0 + np.asarray(arrays.e2, np.float64)
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    # Degenerate all-zero padding triangles would drag every shard AABB to
    # the origin; give them inverted bounds instead.
    degenerate = (np.asarray(arrays.geo_n) == 0).all(axis=1)
    lo[degenerate] = np.inf
    hi[degenerate] = -np.inf
    t = lo.shape[0]
    if t % n_shards:
        raise ValueError(f"{t} triangles do not split over {n_shards} "
                         "shards: call pad_for_ring first")
    lo = lo.reshape(n_shards, t // n_shards, 3).min(axis=1)
    hi = hi.reshape(n_shards, t // n_shards, 3).max(axis=1)
    return (np.nan_to_num(lo, posinf=1.0).astype(np.float32),
            np.nan_to_num(hi, neginf=-1.0).astype(np.float32))


def _segment_mask(origins, dirs, t_max, lo, hi) -> torch.Tensor:
    """(R,) bool slab test: does the segment o + s d, s in [0, t_max],
    cross the AABB [lo, hi]? origins (R, 3) or (3,), dirs (R, 3). Exact
    for rays (the routing test, shared/geom/box.go:29's role)."""
    o = origins[None, :] if origins.dim() == 1 else origins
    flat = dirs == 0.0
    inv = 1.0 / torch.where(flat, INF, dirs)
    a = (lo[None, :] - o) * inv
    b = (hi[None, :] - o) * inv
    # Zero-direction axes: inside the slab iff lo <= o <= hi.
    inside = (o >= lo[None, :]) & (o <= hi[None, :])
    t1 = torch.where(flat, torch.where(inside, -INF, INF),
                     torch.minimum(a, b))
    t2 = torch.where(flat, torch.where(inside, INF, -INF),
                     torch.maximum(a, b))
    t1 = t1.amax(dim=1)
    enter = torch.maximum(t1, torch.zeros_like(t1))
    exit_ = torch.minimum(t2.amin(dim=1), t_max)
    return enter <= exit_


def _fold_payloads(parts: HitPayload, n: int) -> HitPayload:
    """Fold (n, R_loc) per-shard candidates, source rank first, into the
    home payload with the global argmin tie rule (least t, then least
    global triangle id)."""
    best = HitPayload(*(a[0] for a in parts))
    for s in range(1, n):
        cand = HitPayload(*(a[s] for a in parts))
        better = (cand.t < best.t) | ((cand.t == best.t)
                                      & (cand.tri < best.tri))
        best = HitPayload(*(torch.where(better[:, None] if y.dim() > 1
                                        else better, x, y)
                            for x, y in zip(cand, best)))
    return best


def make_halo_renderer(arrays: SceneArrays, width: int, height: int,
                       mesh=None, cfg: RenderConfig = DEFAULT_CONFIG):
    """A cam -> (H, W, 3) renderer over `mesh` (default: one rank per
    card), the triangles sharded across the ranks and the rays exchanged.

    `arrays` (numpy SceneArrays) must be padded with pad_for_ring(arrays,
    n); Morton-order the triangles first (Scene.bake_bvh does; for a raw
    bake(), models/bvh.morton_order + reorder_scene), or every shard AABB
    spans the scene and the routing masks stay dense. The frame lands on
    rank 0's device. `render.device_fn(cam)` returns the padded flat
    (r_pad, 3) rows, `render.halo_density(cam)` the mean fraction of shards
    each ray is routed to (1/n: perfect spatial separation, 1.0: no
    benefit), and `render.mesh` is the mesh."""
    mesh = mesh_mod.check_mesh(mesh_mod.default_mesh() if mesh is None
                               else mesh)
    ranks = mesh_mod.Ranks(mesh)
    for d in set(mesh):
        intersect.fp32_matmuls(d)
    n = len(mesh)
    n_rays = width * height
    r_pad = -(-n_rays // n) * n
    r_loc = r_pad // n
    t_total = arrays.p0.shape[0]
    if t_total % n:
        raise ValueError(f"{t_total} triangles do not split over {n} ranks: "
                         "call pad_for_ring first")
    t_shard = t_total // n
    lo_np, hi_np = shard_bounds(arrays, n)
    n_lights = int(arrays.light_pos.shape[0])

    def put(a, r, rows=True):
        a = np.asarray(a)
        if rows:
            a = a[r * t_shard:(r + 1) * t_shard]
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh[r])

    shards = [RingShard(**{f: put(getattr(arrays, f), r) for f in _PER_TRI},
                        base=r * t_shard) for r in range(n)]
    reps = [_Replicated(*(put(getattr(arrays, f), r, rows=False)
                          for f in _Replicated._fields)) for r in range(n)]
    boxes = [(put(lo_np[r], r, rows=False), put(hi_np[r], r, rows=False))
             for r in range(n)]
    step = min(cfg.ray_chunk, r_pad)
    chunks = [slice(s, min(s + step, r_pad)) for s in range(0, r_pad, step)]

    def gathered_rays(cam):
        """Per rank, its camera and every rank's primary directions."""
        cams, dirs = [], []
        for r in range(n):
            with ranks.on(r):
                c = raygen.camera_arrays(cam, mesh[r])
                idx = r * r_loc + torch.arange(r_loc, dtype=torch.int32,
                                               device=mesh[r])
                cams.append(c)
                dirs.append(raygen.ray_directions_flat(c, width, height,
                                                       idx))
        return cams, dirs, mesh_mod.all_gather(ranks, dirs)

    def render_padded(cam) -> torch.Tensor:
        ranks.begin()
        cams, dirs, all_dirs = gathered_rays(cam)

        # Primary halo: queries out, candidates home.
        cands = []
        for r in range(n):
            with ranks.on(r):
                d = all_dirs[r]
                z = d.new_zeros((r_pad,))
                z3 = d.new_zeros((r_pad, 3))
                i32 = lambda v: torch.full((r_pad,), v, dtype=torch.int32,
                                           device=mesh[r])
                init = HitPayload(t=d.new_full((r_pad,), INF),
                                  tri=i32(2 ** 30), u=z, v=z, n0=z3, n1=z3,
                                  n2=z3, geo_n=z3, mat=i32(0))
                parts = [_local_nearest(shards[r], cams[r].pos, d[c],
                                        HitPayload(*(a[c] for a in init)))
                         for c in chunks]
                cand = HitPayload(*(torch.cat(a) for a in zip(*parts)))
                # Rays that provably miss the shard's AABB carry no
                # candidate (the fold's identity). Conservative, so it only
                # reaffirms what _local_nearest found.
                route = _segment_mask(cams[r].pos, d,
                                      d.new_full((r_pad,), INF), *boxes[r])
                cands.append(cand._replace(
                    t=torch.where(route, cand.t, INF)))
        homed = [mesh_mod.all_to_all(ranks, [c[k] for c in cands])
                 for k in range(len(HitPayload._fields))]
        frames = []
        for r in range(n):
            with ranks.on(r):
                payload = _fold_payloads(HitPayload(*(
                    h[r].reshape((n, r_loc) + h[r].shape[1:])
                    for h in homed)), n)
                valid, x, normal, geo = _hit_frames(payload, cams[r].pos,
                                                    dirs[r])
                frames.append((valid, x, normal, payload, _shadow_inputs(
                    reps[r].light_pos, cfg, x, geo, valid)))

        # Secondary halo: shadow segments out, occlusion bits home.
        shadowed = [[] for _ in range(n)]
        for li in range(n_lights):
            g_o, g_d, g_t, g_x = (mesh_mod.all_gather(ranks, xs) for xs in (
                [f[4][0][li] for f in frames], [f[4][1][li] for f in frames],
                [f[4][2][li] for f in frames], [f[3].tri for f in frames]))
            bits = []
            for r in range(n):
                with ranks.on(r):
                    hit = torch.cat([_local_any(shards[r], g_o[r][c],
                                                g_d[r][c], g_t[r][c],
                                                g_x[r][c]) for c in chunks])
                    hit &= _segment_mask(g_o[r], g_d[r], g_t[r], *boxes[r])
                    bits.append(hit.to(torch.int32))
            homed_bits = mesh_mod.all_to_all(ranks, bits)
            for r in range(n):
                with ranks.on(r):
                    shadowed[r].append(
                        homed_bits[r].reshape(n, r_loc).amax(dim=0) > 0)

        colours = []
        for r in range(n):
            valid, x, normal, payload, (_, sh_dir, _) = frames[r]
            with ranks.on(r):
                colours.append(_phong(reps[r], reps[r].light_col,
                                      cams[r].pos, x, normal, payload,
                                      sh_dir, shadowed[r], valid))
        return mesh_mod.gather(ranks, colours)

    def halo_density(cam) -> float:
        ranks.begin()
        cams, _, all_dirs = gathered_rays(cam)
        means = []
        for r in range(n):
            with ranks.on(r):
                d = all_dirs[r]
                route = _segment_mask(cams[r].pos, d,
                                      d.new_full((r_pad,), INF), *boxes[r])
                means.append(route.to(torch.float32).mean()[None])
        return float(mesh_mod.gather(ranks, means).sum() / n)

    def render(cam) -> torch.Tensor:
        return render_padded(cam)[:n_rays].reshape(height, width, 3)

    render.device_fn = render_padded
    render.halo_density = halo_density
    render.mesh = mesh
    return render
