"""Geometry-sharded ring rendering (the ring-attention schedule for rays).

The torch counterpart of distributed_raytracer_tpu/parallel/ring.py. For
scenes too large to replicate per device, the triangles are split into one
contiguous shard per rank and *rotated* past resident rays: rays are
queries, triangle shards are keys, and the online reduction is the
nearest-hit minimum (associative, so blockwise streaming is exact).

Schedule per rank (R/n resident rays, T/n resident triangles):
  phase 1 — n ring steps: intersect the rays with the resident shard, fold
    the per-ray nearest hit into a carry, rotate the shard to the right;
  phase 2 — shadow queries from the hit points; n more ring steps of
    any-hit OR-accumulation;
  shade — local Phong math from the hit payload and the replicated
    materials and lights.

Two transports, each copied exactly from the JAX package (a port that
mixes their rules is off on edge pixels):
  - use_rdma=False, the `ppermute` scan in plain torch: `_local_nearest`
    takes the first index within a shard and keeps the carried hit unless a
    new one is strictly nearer, so rank r's result depends on its visiting
    order (shards r, r-1, ...); the payload (u, v from the intersection,
    normals, material) is carried with the hit;
  - use_rdma=True, the kernel transport (ops/ring_trace.py: K6, K7 on CUDA
    ranks): K6 breaks ties on the lowest global id; u and v are recomputed
    as x . k_u + c_u from the winner's rows, fetched from the rank that
    owns it (`mesh.fetch_rows`); the shadow exclusion is
    where(valid, gid, -1); every light's shadow rays go round in ONE
    rotation (L * R_loc stacked rays; the JAX package rotates once per
    light, with the same flags). Triangles pad to a multiple of n * 128,
    rays to r_pad = ceil(W*H / (n*128)) * n * 128; padding rays (idx >= W*H,
    clamped to the last pixel) are traced and dropped.

A mesh is a tuple of devices (parallel/mesh.py); n ranks may share one
card. Each rank's work runs on its own compute stream; the frame is
gathered on rank 0's device. The plain transport holds a chunk of
cfg.ray_chunk rays x T/n triangles at a time, so its (C, T/n) arrays stay
bounded on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.scene import SceneArrays
from distributed_raytracer_tpu_torch.ops import bsr_trace, intersect, raygen
from distributed_raytracer_tpu_torch.ops import ring_trace
from distributed_raytracer_tpu_torch.ops.intersect import _dot3
from distributed_raytracer_tpu_torch.ops.shade import _normalize
from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

_PER_TRI = ("p0", "e1", "e2", "geo_n", "plane_d", "k_u", "k_v", "c_u", "c_v",
            "n0", "n1", "n2", "mat_id")


class RingShard(NamedTuple):
    """The rotating geometry payload: one shard of per-triangle data."""

    p0: torch.Tensor; e1: torch.Tensor; e2: torch.Tensor
    geo_n: torch.Tensor; plane_d: torch.Tensor
    k_u: torch.Tensor; k_v: torch.Tensor; c_u: torch.Tensor; c_v: torch.Tensor
    n0: torch.Tensor; n1: torch.Tensor; n2: torch.Tensor
    mat_id: torch.Tensor
    base: int   # global index of this shard's first triangle


class HitPayload(NamedTuple):
    """Per-ray best-hit state (no gathers needed afterwards)."""

    t: torch.Tensor        # (R,)
    tri: torch.Tensor      # (R,) int32 global triangle id
    u: torch.Tensor        # (R,)
    v: torch.Tensor
    n0: torch.Tensor       # (R, 3) winning triangle's vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    geo_n: torch.Tensor    # (R, 3)
    mat: torch.Tensor      # (R,) int32


class _Replicated(NamedTuple):
    """What every rank holds whole: the lights and the material tables."""

    light_pos: torch.Tensor
    light_col: torch.Tensor
    mat_ka: torch.Tensor
    mat_kd: torch.Tensor
    mat_ks: torch.Tensor
    mat_ns: torch.Tensor


def pad_for_ring(arrays: SceneArrays, n_shards: int) -> SceneArrays:
    """Pad the triangle axis (with zero triangles, which never hit) so it
    divides evenly across shards."""
    t = arrays.p0.shape[0]
    t_new = -(-t // n_shards) * n_shards
    if t_new == t:
        return arrays
    pad = t_new - t
    rep = {}
    for name in _PER_TRI:
        a = np.asarray(getattr(arrays, name))
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        rep[name] = np.pad(a, width)
    return arrays._replace(**rep)


def _local_nearest(shard: RingShard, origins, dirs,
                   payload: HitPayload) -> HitPayload:
    """Fold the local shard's nearest hits into the carried payload. The
    pair math is intersect's dense sweep: a RingShard has the fields it
    reads."""
    t, u, v, valid = intersect._pair_quantities(shard, origins, dirs)
    cand = torch.where(valid, t, float("inf"))
    loc = torch.argmin(cand, dim=1)                 # first index wins a tie
    tmin = torch.gather(cand, 1, loc[:, None])[:, 0]

    better = tmin < payload.t
    sel = lambda new, old: torch.where(
        better[:, None] if old.dim() > 1 else better, new, old)
    return HitPayload(
        t=sel(tmin, payload.t),
        tri=sel((shard.base + loc).to(torch.int32), payload.tri),
        u=sel(torch.gather(u, 1, loc[:, None])[:, 0], payload.u),
        v=sel(torch.gather(v, 1, loc[:, None])[:, 0], payload.v),
        n0=sel(shard.n0[loc], payload.n0),
        n1=sel(shard.n1[loc], payload.n1),
        n2=sel(shard.n2[loc], payload.n2),
        geo_n=sel(shard.geo_n[loc], payload.geo_n),
        mat=sel(shard.mat_id[loc], payload.mat),
    )


def _local_any(shard: RingShard, origins, dirs, t_max,
               exclude) -> torch.Tensor:
    """(C,) bool: some triangle of the local shard is hit with t <= t_max
    and a global id other than the ray's `exclude`."""
    t, _, _, valid = intersect._pair_quantities(shard, origins, dirs)
    gids = shard.base + torch.arange(shard.p0.shape[0], dtype=torch.int32,
                                     device=dirs.device)
    valid = valid & (gids[None, :] != exclude[:, None])
    return torch.any(valid & (t <= t_max[:, None]), dim=1)


def _rotate(ranks: mesh_mod.Ranks, shards):
    """Every shard to the right neighbour (`ppermute` with (i, i+1 mod n))."""
    n = ranks.n
    moved = {f: mesh_mod.rotate_right(ranks, [getattr(s, f) for s in shards])
             for f in _PER_TRI}
    return [RingShard(**{f: moved[f][i] for f in _PER_TRI},
                      base=shards[(i - 1) % n].base) for i in range(n)]


def _hit_frames(payload: HitPayload, origins, dirs):
    """(valid, x, normal, geo) from a folded payload — shared by both
    transports."""
    valid = torch.isfinite(payload.t)
    t_safe = torch.where(valid, payload.t, 0.0)
    x = origins[None, :] + t_safe[:, None] * dirs
    r1 = 1.0 - payload.u - payload.v
    nrm = (r1[:, None] * payload.n0 + payload.u[:, None] * payload.n1
           + payload.v[:, None] * payload.n2)
    return valid, x, _normalize(nrm), _normalize(payload.geo_n)


def _shadow_inputs(lights_pos, cfg, x, geo, valid):
    """Per-light shadow segments (origin, dir, t_max) — tracer.go:64
    semantics with the f32 normal lift."""
    sh_origin, sh_dir, sh_tmax = [], [], []
    for li in range(lights_pos.shape[0]):
        to_l = lights_pos[li][None, :] - x
        ldist = torch.sqrt(_dot3(to_l, to_l))
        ldir = to_l / ldist[:, None]
        side = torch.where(_dot3(geo, ldir) >= 0.0, 1.0, -1.0)
        sh_origin.append(x + cfg.shadow_offset * ldir
                         + (cfg.shadow_normal_offset * side)[:, None] * geo)
        sh_dir.append(ldir)
        sh_tmax.append(torch.where(valid, ldist - cfg.shadow_offset, 0.0))
    return sh_origin, sh_dir, sh_tmax


def _phong(mats: _Replicated, lights_col, origins, x, normal, payload,
           sh_dir, shadowed, valid):
    """Phong accumulation from the payload; `mats` holds the material
    tables on the rank's device."""
    mat = payload.mat.long()
    ka, kd, ks = mats.mat_ka[mat], mats.mat_kd[mat], mats.mat_ks[mat]
    ns = mats.mat_ns[mat]
    cam_dir = _normalize(origins[None, :] - x)

    colour = ka
    for li in range(len(sh_dir)):
        ldir = sh_dir[li]
        l_dot_n = _dot3(ldir, normal)
        diff = torch.clamp_min(l_dot_n, 0.0)
        refl = 2.0 * l_dot_n[:, None] * normal - ldir
        spec = torch.pow(torch.clamp_min(_dot3(refl, cam_dir), 0.0), ns)
        contrib = ((kd * diff[:, None] + ks * spec[:, None])
                   * lights_col[li][None, :])
        colour = colour + torch.where(~shadowed[li][:, None], contrib, 0.0)
    colour = torch.clamp_max(colour, 1.0)
    return torch.where(valid[:, None], colour, 0.0)


def make_ring_renderer(arrays: SceneArrays, width: int, height: int,
                       mesh=None, cfg: RenderConfig = DEFAULT_CONFIG,
                       use_rdma: bool = False):
    """A cam -> (H, W, 3) renderer over `mesh` (default: one rank per card)
    with the scene's triangles sharded across the ranks.

    `arrays` (a SceneArrays of numpy arrays) must already be padded with
    pad_for_ring(arrays, n). use_rdma=True takes the kernel transport (see
    the module docstring). The frame lands on rank 0's device;
    `render.device_fn(cam)` returns the padded flat (r_pad, 3) rows and
    `render.mesh` is the mesh."""
    mesh = mesh_mod.check_mesh(mesh_mod.default_mesh() if mesh is None
                               else mesh)
    ranks = mesh_mod.Ranks(mesh)
    for d in set(mesh):
        intersect.fp32_matmuls(d)
    n = len(mesh)
    n_rays = width * height
    if use_rdma:
        # Kernel tiling: ray tiles and triangle blocks of 128-multiples.
        arrays = pad_for_ring(arrays, n * 128)
        r_pad = -(-n_rays // (n * 128)) * (n * 128)
    else:
        r_pad = -(-n_rays // n) * n
    t_total = arrays.p0.shape[0]
    if t_total % n:
        raise ValueError(f"{t_total} triangles do not split over {n} ranks: "
                         "call pad_for_ring first")
    t_shard = t_total // n
    r_loc = r_pad // n
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

    def rays_of(cam, r):
        """Rank r's camera and primary directions, on its stream."""
        c = raygen.camera_arrays(cam, mesh[r])
        idx = r * r_loc + torch.arange(r_loc, dtype=torch.int32,
                                       device=mesh[r])
        return c, raygen.ray_directions_flat(c, width, height, idx)

    def chunks():
        step = min(cfg.ray_chunk, r_loc)
        return [slice(s, min(s + step, r_loc)) for s in range(0, r_loc, step)]

    def render_scan(cam) -> torch.Tensor:
        ranks.begin()
        cams, dirs, payload = [], [], []
        for r in range(n):
            with ranks.on(r):
                c, d = rays_of(cam, r)
                cams.append(c)
                dirs.append(d)
                z3 = d.new_zeros((r_loc, 3))
                payload.append(HitPayload(
                    t=d.new_full((r_loc,), float("inf")),
                    tri=torch.full((r_loc,), -1, dtype=torch.int32,
                                   device=mesh[r]),
                    u=d.new_zeros((r_loc,)), v=d.new_zeros((r_loc,)),
                    n0=z3, n1=z3, n2=z3, geo_n=z3,
                    mat=torch.zeros((r_loc,), dtype=torch.int32,
                                    device=mesh[r])))

        # Phase 1: rotate the shards n times, folding nearest hits.
        sh = shards
        for _ in range(n):
            for r in range(n):
                with ranks.on(r):
                    parts = [_local_nearest(sh[r], cams[r].pos, dirs[r][c],
                                            HitPayload(*(a[c] for a in
                                                         payload[r])))
                             for c in chunks()]
                    payload[r] = HitPayload(*(torch.cat(a) for a in
                                              zip(*parts)))
            sh = _rotate(ranks, sh)

        # Phase 2: the shadow ring, every light in one rotation.
        frames, shadowed = [], []
        for r in range(n):
            with ranks.on(r):
                valid, x, normal, geo = _hit_frames(payload[r], cams[r].pos,
                                                    dirs[r])
                frames.append((valid, x, normal, _shadow_inputs(
                    reps[r].light_pos, cfg, x, geo, valid)))
                shadowed.append(torch.zeros((n_lights, r_loc),
                                            dtype=torch.bool, device=mesh[r]))
        for _ in range(n):
            for r in range(n):
                sh_origin, sh_dir, sh_tmax = frames[r][3]
                with ranks.on(r):
                    for li in range(n_lights):
                        hit = torch.cat([_local_any(
                            sh[r], sh_origin[li][c], sh_dir[li][c],
                            sh_tmax[li][c], payload[r].tri[c])
                            for c in chunks()])
                        shadowed[r][li] |= hit
            sh = _rotate(ranks, sh)

        colours = []
        for r in range(n):
            valid, x, normal, (_, sh_dir, _) = frames[r]
            with ranks.on(r):
                colours.append(_phong(reps[r], reps[r].light_col,
                                      cams[r].pos, x, normal, payload[r],
                                      sh_dir, shadowed[r], valid))
        return mesh_mod.gather(ranks, colours)

    if use_rdma:
        tris16 = bsr_trace.pack_tris(arrays)
        tris = [put(tris16, r) for r in range(n)]
        # The winners' shading rows, fetched from their owners: n0, n1, n2,
        # geo_n, k_u, k_v (3 columns each), c_u, c_v; and the material id.
        rows = np.concatenate(
            [np.asarray(getattr(arrays, f), np.float32) for f in
             ("n0", "n1", "n2", "geo_n", "k_u", "k_v")]
            + [np.asarray(arrays.c_u, np.float32)[:, None],
               np.asarray(arrays.c_v, np.float32)[:, None]], axis=1)
        row_tables = [put(rows, r) for r in range(n)]
        mat_tables = [put(arrays.mat_id, r) for r in range(n)]
        rt = 512 if r_loc % 512 == 0 else (256 if r_loc % 256 == 0 else 128)

    def render_rdma(cam) -> torch.Tensor:
        ranks.begin()
        cams, dirs, rays = [], [], []
        for r in range(n):
            with ranks.on(r):
                c, d = rays_of(cam, r)
                cams.append(c)
                dirs.append(d)
                rays.append(bsr_trace.pack_rays(c.pos, d))
        best_t, gid = ring_trace.ring_nearest(ranks, rays, tris, rt=rt)
        got = mesh_mod.fetch_rows(ranks, gid, row_tables, t_shard)
        mats = mesh_mod.fetch_rows(ranks, gid, mat_tables, t_shard)

        frames, queries, excl = [], [], []
        for r in range(n):
            g = got[r]
            with ranks.on(r):
                valid = torch.isfinite(best_t[r])
                t_safe = torch.where(valid, best_t[r], 0.0)
                x = cams[r].pos[None, :] + t_safe[:, None] * dirs[r]
                u = _dot3(x, g[:, 12:15]) + g[:, 18]
                v = _dot3(x, g[:, 15:18]) + g[:, 19]
                payload = HitPayload(t=best_t[r], tri=gid[r], u=u, v=v,
                                     n0=g[:, 0:3], n1=g[:, 3:6],
                                     n2=g[:, 6:9], geo_n=g[:, 9:12],
                                     mat=mats[r])
                valid, x, normal, geo = _hit_frames(payload, cams[r].pos,
                                                    dirs[r])
                sh_origin, sh_dir, sh_tmax = _shadow_inputs(
                    reps[r].light_pos, cfg, x, geo, valid)
                frames.append((valid, x, normal, payload, sh_dir))
                if n_lights:
                    queries.append(torch.cat([bsr_trace.pack_rays(
                        sh_origin[li], sh_dir[li], t_max=sh_tmax[li])
                        for li in range(n_lights)], dim=1))
                    excl.append(torch.where(valid, gid[r], -1).repeat(
                        n_lights))
        hit = (ring_trace.ring_any(ranks, queries, tris, excl, rt=rt)
               if n_lights else None)

        colours = []
        for r in range(n):
            valid, x, normal, payload, sh_dir = frames[r]
            with ranks.on(r):
                shadowed = ([] if hit is None else
                            (hit[r] > 0).reshape(n_lights, r_loc))
                colours.append(_phong(reps[r], reps[r].light_col,
                                      cams[r].pos, x, normal, payload,
                                      sh_dir, shadowed, valid))
        return mesh_mod.gather(ranks, colours)

    render_padded = render_rdma if use_rdma else render_scan

    def render(cam) -> torch.Tensor:
        return render_padded(cam)[:n_rays].reshape(height, width, 3)

    render.device_fn = render_padded
    render.mesh = mesh
    return render
