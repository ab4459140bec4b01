"""Block-BVH-culled ring rendering: geometry rotation with per-step
hierarchical culling.

The torch counterpart of distributed_raytracer_tpu/parallel/ring_bvh.py.
parallel/ring.py rotates triangle shards past resident rays densely, every
resident ray against every rotating triangle. This schedule keeps the ring
(geometry streams past pinned queries; the nearest hit folds as an
associative minimum) but culls each step with the multilevel interval walk
(ops/cull.py multilevel_mask / multilevel_worklist) against the shard the
rank holds now, and runs only the surviving (tile, block) pairs through the
traversal kernels (ops/bsr_trace.py), pruning on every query at every level
as the reference's R-trees do (shared/state/mesh.go:139, object.go:76).

Per rank (r_loc resident rays, one shard of T / n triangles), one iteration
per bounce:
  phase 1 - n ring steps: cull the resident ray tiles against the shard
    held now, run bsr_nearest seeded with the carried (t, gid) and the
    shard's global id base (the kernels' lowest-gid tie rule makes the
    fold order-independent), gather the 32-wide shading row from the
    shard's table where the candidate improved; then rotate the shard to
    the right neighbour. After n steps the geometry is home again.
  phase 2 - shadows: the reversed per-light queries (light -> surface
    point) of the resident rays; n more steps of culled bsr_any per light,
    carrying the occlusion flags. The tile hulls are computed once per
    phase; only the masks against the rotating block AABBs change.
  shade - Phong from the carried rows; colour += throughput * phong_b, as
    CulledRenderer.render_bounced accumulates it.
  next bounce - the reflection rays stay resident (reflect_rows), so a
    bounce costs no exchange of rays: the next rotation streams geometry
    past them, per-ray origins. Dead rays are masked out of the hulls.

JAX's `shard_map` body is a host loop here: each step is one pass over the
ranks under `ranks.on(r)`, then one `mesh.rotate_right` of the shard's five
tensors (parallel/mesh.py). The frame runs eagerly (no CUDA graph). Over a
multi-process mesh each process runs its own ranks (`ranks.local`), the
rotations cross processes, the rows come home to process 0 and the counts
reach every process; the sizing counts are maxed over the processes, as
parallel/halo_bvh.py does.

Work-list buckets are sized at build time on one device over the full
geometry: each rank meets every shard during the rotation, so the per-level
counts of every (ray shard, geometry shard) pair, maxed over the pairs,
bound every step (the parent-box test is conservative, so a member that
passes has a passing parent, and the per-pair member masks count each
level's expansion exactly). render(cam, verify=True) refreezes grow-only
until every reported count fits, up to 8 rounds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import Scene, SceneDiff
from distributed_raytracer_tpu_torch.ops import bsr_trace, cull, raygen, shade
from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
from distributed_raytracer_tpu_torch.parallel.halo_bvh import (
    ShardedCulledRenderer, ShardedGeometry, _put, apply_diff_sharded,
    reflect_rows)
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

AXIS = "ring"
_bucket = bsr_trace.bucket_w_pad


class RingCulledRenderer(ShardedCulledRenderer):
    """Geometry-rotation renderer with per-step hierarchical BVH culling
    over a mesh of ranks (default: one per card).

    Static work lists sized from `sizing_camera` x `margin`; render(cam,
    verify=True) grows them (up to 8 rounds) until every reported count
    fits, instead of dropping candidate blocks. `bake` holds the unpadded
    (SceneArrays, BlockBVH) the shards were cut from."""

    kind = "ring"

    def __init__(self, scene: Scene, width: int, height: int, mesh=None,
                 sizing_camera: Optional[Camera] = None,
                 margin: float = 2.0, cfg: RenderConfig = DEFAULT_CONFIG,
                 block_size: int = 128, ray_tile: int = 512,
                 dynamic: bool = False, bounces: int = 0,
                 local_levels: Optional[int] = None, local_group: int = 16,
                 tile_w: Optional[int] = None):
        # dynamic=True: the SceneDiff folds into the resident shard before
        # the first rotation, so every step of every bounce streams the
        # moved geometry. `tile_w` overrides the ray tiles' aspect:
        # squarer tiles have tighter hulls per ray, which cuts the
        # scheduled pairs on surface-heavy scenes, at the cost of more
        # tiles.
        perm, host = self._build(scene, width, height, mesh, margin, cfg,
                                 block_size, ray_tile, dynamic, bounces,
                                 local_levels, local_group,
                                 tile_w=32 if tile_w is None else tile_w)
        r_loc = self.r_loc
        self.nt_loc = r_loc // ray_tile
        self._perm = self.ranks.per_rank(lambda r: _put(
            perm[r * r_loc:(r + 1) * r_loc].astype(np.int64), self.mesh[r]))
        camera = sizing_camera if sizing_camera is not None else scene.camera
        self.sizing_counts = self.ranks.max_over_processes(
            self._sizing_counts(camera, perm, *host))
        self._freeze(self.sizing_counts)
        # Per-rank counts of the last frame, (n, B+1, 2 * n_levels + 2);
        # None until a frame has run.
        self.last_counts = None

    # -- sizing (build time, rank 0's device, full geometry) -------------
    #
    # Each rank meets every geometry shard during the rotation, so the
    # work of (ray shard d, step k) at any level is the full-scene level
    # mask restricted to d's tile rows and shard (d - k)'s block columns
    # (local groups never straddle shards, so global level boxes restricted
    # to a shard's columns are that shard's local boxes). The max over all
    # (d, s) pairs bounds every step of every rank.

    def _per_pair(self, mask: torch.Tensor, nbl: int) -> torch.Tensor:
        """(nt_ext, n * nbl) mask -> (n, n) kept cells per (ray, geometry)
        shard pair."""
        nt = mask.shape[0]
        return mask.reshape(self.n, nt // self.n, self.n, nbl).sum(
            dim=(1, 3))

    def _pair_levels(self, ti, blo, bhi) -> torch.Tensor:
        """(n_levels, n, n) kept cells per pair at every local level,
        coarsest first."""
        rows = []
        for lo, hi in reversed(cull.level_bounds(blo, bhi, self.loc_groups)):
            m, _ = cull.block_mask_with_entry(ti, lo, hi)
            rows.append(self._per_pair(m, lo.shape[0] // self.n))
        return torch.stack(rows)

    def _size_step(self, shared: bool, tris16, table32, blo, bhi, rays,
                   live, excl, view, lights_pos, lights_col):
        """One bounce of the sizing walk on the full geometry: per-level
        per-pair primary and shadow counts, and the next bounce's rays."""
        rt = self.rt
        ti = cull.tile_intervals_packed(rays, rt, live=live)
        p_levels = self._pair_levels(ti, blo, bhi)
        mask, entry = cull.block_mask_with_entry(ti, blo, bhi)
        wl = cull.compact_worklist(mask, _bucket(int(mask.sum())),
                                   entry=entry)
        tris = (bsr_trace.pack_tris_origin(tris16, rays[0:3, 0]) if shared
                else tris16)
        bt, bi = bsr_trace.bsr_nearest(
            rays, excl, tris, wl.tile_ids, wl.block_ids, wl.entry, wl.count,
            rt=rt, tb=self.tb, shared_origin=shared)
        visited = mask.any(dim=1).repeat_interleave(rt)
        bt = torch.where(visited, bt, float("inf"))
        bi = torch.where(visited, bi, bsr_trace.BIG_IDX)
        valid = torch.isfinite(bt) & live
        g = table32[torch.clamp(bi, 0, table32.shape[0] - 1).long()].T
        prep = shade.prepare_packed_rows(
            lights_pos, rays, torch.where(valid, bt, 0.0), g, self.cfg)
        live_l = shade.light_gates_rows(lights_col, view, prep, valid)
        s_levels = [self._pair_levels(
            cull.tile_intervals_packed(prep.q_rev[li], rt, live=live_l[li],
                                       use_tmax=True), blo, bhi)
            for li in range(self.n_lights)]
        s_max = (torch.stack(s_levels).amax(dim=(0, 2, 3)) if s_levels
                 else torch.zeros(self.n_levels, dtype=torch.int64))
        r_rays, live2 = reflect_rows(self.cfg, prep, rays, valid)
        excl2 = torch.where(valid, bi, -1)
        counts = torch.cat([p_levels.amax(dim=(1, 2)).cpu(), s_max.cpu()])
        return counts, r_rays, live2, excl2, prep.x

    def _sizing_counts(self, camera, perm, tris16, table32, lo,
                       hi) -> np.ndarray:
        """(B+1, 2 * n_levels): per bounce, the per-level max over pairs
        of the primary cells, then of the shadow cells (max over lights),
        coarsest first: the bucket-sizing inputs."""
        dev, lpos, lcol = self._sizing_device()
        tris16, table32, blo, bhi = (_put(a, dev) for a in (tris16, table32,
                                                             lo, hi))
        cam = raygen.camera_arrays(camera, dev)
        rays = bsr_trace.pack_rays_rows(cam.pos, raygen.ray_rows_flat(
            cam, self.width, self.height, _put(perm.astype(np.int64), dev)))
        live = torch.ones(self.n_pad_ext, dtype=torch.bool, device=dev)
        excl = torch.full((self.n_pad_ext,), -1, dtype=torch.int32,
                          device=dev)
        view = cam.pos
        out = []
        for b in range(self.bounces + 1):
            counts, rays, live, excl, view = self._size_step(
                b == 0, tris16, table32, blo, bhi, rays, live, excl, view,
                lpos, lcol)
            out.append(counts.numpy())
        return np.stack(out)

    # -- the frame -------------------------------------------------------

    def device_fn(self, camera, diff=None):
        """One frame over the ranks, with `diff` (a SceneDiff, dynamic=True)
        folded in: (colour rows (3, n_pad_ext), per-rank counts (n, B+1,
        2 * n_levels + 2)) on rank 0's device, without a host sync. Over
        several processes the rows land on process 0 (None elsewhere) and
        the counts on every process."""
        ranks, n, rt, nl = self.ranks, self.n, self.rt, self.n_levels
        local = ranks.local
        packed = raygen.camera_packed(camera)
        ranks.begin()
        geom = list(self.geom)
        lpos, lcol = list(self.lights_pos), list(self.lights_col)
        cam, rays, live, excl, colour, thru, view = ([None] * n
                                                    for _ in range(7))
        for r in local:
            d = self.mesh[r]
            with ranks.on(r):
                c = raygen.camera_views(raygen.to_device(packed, d))
                if diff is not None:
                    # Fold the frame's diff into the resident shard before
                    # the rotation starts (environment.go:73-98).
                    dd = SceneDiff(*(raygen.to_device(a, d) for a in diff))
                    geom[r] = apply_diff_sharded(geom[r], self._dyn[r], dd)
                    lpos[r], lcol[r] = dd.light_pos, dd.light_col
                cam[r] = c
                rays[r] = bsr_trace.pack_rays_rows(c.pos, raygen.ray_rows_flat(
                    c, self.width, self.height, self._perm[r]))
                live[r] = torch.ones(self.r_loc, dtype=torch.bool, device=d)
                excl[r] = torch.full((self.r_loc,), -1, dtype=torch.int32,
                                     device=d)
                colour[r] = torch.zeros((3, self.r_loc), device=d)
                thru[r] = torch.ones((3, self.r_loc), device=d)
                view[r] = c.pos
        counts = {r: [] for r in local}
        for b in range(self.bounces + 1):
            pads, pads_sh = self.w_pads[b], self.w_pads_sh[b]
            ti, state = [None] * n, [None] * n
            for r in local:
                d = self.mesh[r]
                with ranks.on(r):
                    ti[r] = cull.tile_intervals_packed(rays[r], rt,
                                                       live=live[r])
                    state[r] = [
                        torch.full((self.r_loc,), float("inf"), device=d),
                        torch.full((self.r_loc,), bsr_trace.BIG_IDX,
                                   dtype=torch.int32, device=d),
                        torch.zeros((self.r_loc, 32), device=d),
                        torch.zeros(nl, dtype=torch.int32, device=d),
                        torch.zeros((), dtype=torch.int32, device=d)]
            # Phase 1: n steps of culled nearest against the shard held
            # now, each followed by one rotation.
            for _ in range(n):
                for r in local:
                    with ranks.on(r):
                        self._nearest_step(state[r], geom[r], ti[r], rays[r],
                                           excl[r], cam[r], pads, b == 0)
                geom = self._rotate(geom)
            prep, valid, s_state = [None] * n, [None] * n, [None] * n
            for r in local:
                d = self.mesh[r]
                with ranks.on(r):
                    best_t, best_i, best_g = state[r][:3]
                    v = torch.isfinite(best_t) & live[r]
                    p = shade.prepare_packed_rows(
                        lpos[r], rays[r], torch.where(v, best_t, 0.0),
                        best_g.T, self.cfg)
                    live_l = shade.light_gates_rows(lcol[r], view[r], p, v)
                    tis = [cull.tile_intervals_packed(
                        p.q_rev[li], rt, live=live_l[li], use_tmax=True)
                        for li in range(self.n_lights)]
                    prep[r] = p
                    valid[r] = v
                    s_state[r] = [
                        torch.zeros((self.n_lights, self.r_loc),
                                    dtype=torch.int32, device=d),
                        torch.zeros(nl, dtype=torch.int32, device=d),
                        torch.zeros((), dtype=torch.int32, device=d),
                        tis, torch.where(v, best_i, -1)]
            # Phase 2: n steps of culled any-hit per light.
            for _ in range(n):
                for r in local:
                    with ranks.on(r):
                        self._shadow_step(s_state[r], geom[r], prep[r],
                                          lpos[r], pads_sh)
                geom = self._rotate(geom)
            for r in local:
                with ranks.on(r):
                    p, v = prep[r], valid[r]
                    hit, cvec_s, csum_s = s_state[r][:3]
                    _, best_i, _, cvec_p, csum_p = state[r]
                    local_c = shade.shade_core_rows(lcol[r], view[r], p, v,
                                                    hit == 0)
                    colour[r] = colour[r] + thru[r] * local_c
                    counts[r].append(torch.cat([cvec_p, cvec_s, csum_p[None],
                                                csum_s[None]]))
                    if b < self.bounces:
                        thru[r] = torch.where(v[None, :], thru[r] * p.ks, 0.0)
                        rays[r], live[r] = reflect_rows(self.cfg, p, rays[r],
                                                        v)
                        excl[r] = torch.where(v, best_i, -1)
                        view[r] = p.x
        rows, cts = [None] * n, [None] * n
        for r in local:
            with ranks.on(r):
                rows[r] = torch.clamp(colour[r], 0.0, 1.0).T
                cts[r] = torch.stack(counts[r])[None]
        out = mesh_mod.gather(ranks, rows)
        return (None if out is None else out.T,
                mesh_mod.gather(ranks, cts, everywhere=True))

    def _rotate(self, geom: list) -> list:
        """Every rank's shard to its right neighbour (`ppermute`)."""
        fields = [mesh_mod.rotate_right(
            self.ranks, [None if g is None else g[k] for g in geom])
            for k in range(len(ShardedGeometry._fields))]
        return self.ranks.per_rank(
            lambda r: ShardedGeometry(*(f[r] for f in fields)))

    def _nearest_step(self, st: list, sh: ShardedGeometry, ti, rays, excl,
                      cam, pads: tuple, shared: bool) -> None:
        """One rank's ring step of phase 1: cull against shard `sh`, fold
        its nearest hits into the carried (t, gid, shading row) and the
        level counts `st` (in place)."""
        bt, bi, g, cvec, csum = st
        mask, entry, c_top = cull.multilevel_mask(ti, sh.block_lo,
                                                  sh.block_hi,
                                                  self.loc_groups)
        wl, exp = cull.multilevel_worklist(ti, mask, entry, c_top,
                                           sh.block_lo, sh.block_hi,
                                           self.loc_groups, pads)
        lv = torch.stack([c_top, *exp]).to(torch.int32)
        # Bounce 0's rays share the camera origin, folded into the rows;
        # reflection rays bring their own.
        tris = (bsr_trace.pack_tris_origin(sh.tris16, cam.pos) if shared
                else sh.tris16)
        nt, ni = bsr_trace.bsr_nearest(
            rays, excl, tris, wl.tile_ids, wl.block_ids, wl.entry, wl.count,
            init_t=bt, init_i=bi, gid_base=sh.base, rt=self.rt, tb=self.tb,
            shared_origin=shared)
        visited = cull.visited_tiles(wl, self.nt_loc).repeat_interleave(
            self.rt)
        nt = torch.where(visited, nt, bt)
        ni = torch.where(visited, ni, bi)
        improved = (nt < bt) | ((nt == bt) & (ni < bi))
        loc = torch.clamp(ni - sh.base, 0, sh.tris16.shape[0] - 1).long()
        st[:] = [nt, ni, torch.where(improved[:, None], sh.table32[loc], g),
                 torch.maximum(cvec, lv), csum + lv[-1]]

    def _shadow_step(self, st: list, sh: ShardedGeometry, prep, lights_pos,
                     pads: tuple) -> None:
        """One rank's ring step of phase 2: per light, cull the reversed
        shadow queries against shard `sh` and OR its any-hits into the
        carried flags (in place)."""
        hit, cvec, csum, tis, excl = st
        new = []
        for li in range(self.n_lights):
            mask, entry, c_top = cull.multilevel_mask(
                tis[li], sh.block_lo, sh.block_hi, self.loc_groups)
            wl, exp = cull.multilevel_worklist(
                tis[li], mask, entry, c_top, sh.block_lo, sh.block_hi,
                self.loc_groups, pads)
            lv = torch.stack([c_top, *exp]).to(torch.int32)
            cvec = torch.maximum(cvec, lv)
            csum = csum + lv[-1]
            h = bsr_trace.bsr_any(
                prep.q_rev[li], excl,
                bsr_trace.pack_tris_origin(sh.tris16, lights_pos[li]),
                wl.tile_ids, wl.block_ids, wl.entry, wl.count, init=hit[li],
                gid_base=sh.base, rt=self.rt, tb=self.tb, shared_origin=True)
            visited = cull.visited_tiles(wl, self.nt_loc).repeat_interleave(
                self.rt)
            new.append(torch.where(visited, h, hit[li]))
        st[:3] = [torch.stack(new) if new else hit, cvec, csum]

    # -- public ----------------------------------------------------------

    def scheduled_pairs(self) -> Optional[int]:
        """(ray, triangle) pairs the last frame's nearest queries scheduled
        over all ranks, steps and bounces (finest-level cells x rt x tb;
        shadow queries excluded); None before the first frame."""
        if self.last_counts is None:
            return None
        c = self.last_counts
        return int(c[:, :, 2 * self.n_levels].sum()) * self.rt * self.tb
