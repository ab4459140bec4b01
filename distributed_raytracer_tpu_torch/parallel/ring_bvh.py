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
tensors (parallel/mesh.py). The frame runs eagerly (no CUDA graph).

Work-list buckets are sized at build time on one device over the full
geometry: each rank meets every shard during the rotation, so the per-level
counts of every (ray shard, geometry shard) pair, maxed over the pairs,
bound every step (the parent-box test is conservative, so a member that
passes has a passing parent, and the per-pair member masks count each
level's expansion exactly). render(cam, verify=True) refreezes grow-only
until every reported count fits, up to 8 rounds.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import Scene, SceneDiff
from distributed_raytracer_tpu_torch.ops import bsr_trace, cull, raygen, shade
from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
from distributed_raytracer_tpu_torch.parallel.halo_bvh import (
    DynGeometry, ShardedGeometry, _pad_to_shardable, apply_diff_sharded,
    reflect_rows)
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

_log = logging.getLogger(__name__)

AXIS = "ring"
_bucket = bsr_trace.bucket_w_pad


class RingCulledRenderer:
    """Geometry-rotation renderer with per-step hierarchical BVH culling
    over a mesh of ranks (default: one per card).

    Static work lists sized from `sizing_camera` x `margin`; render(cam,
    verify=True) grows them (up to 8 rounds) until every reported count
    fits, instead of dropping candidate blocks. `bake` holds the unpadded
    (SceneArrays, BlockBVH) the shards were cut from."""

    def __init__(self, scene: Scene, width: int, height: int, mesh=None,
                 sizing_camera: Optional[Camera] = None,
                 margin: float = 2.0, cfg: RenderConfig = DEFAULT_CONFIG,
                 block_size: int = 128, ray_tile: int = 512,
                 dynamic: bool = False, bounces: int = 0,
                 local_levels: Optional[int] = None, local_group: int = 16,
                 tile_w: Optional[int] = None):
        self.mesh = mesh_mod.check_mesh(
            mesh_mod.default_mesh() if mesh is None else mesh)
        self.ranks = mesh_mod.Ranks(self.mesh)
        self.n = n = len(self.mesh)
        self.bounces = int(bounces)
        self.width, self.height, self.cfg = width, height, cfg
        self.rt, self.tb = ray_tile, block_size
        self.margin = margin

        # dynamic=True: the per-object grouped bake, whose leaf blocks
        # shift exactly under a SceneDiff (render_dynamic). The diff folds
        # into the resident shard before the first rotation, so every step
        # of every bounce streams the moved geometry.
        if dynamic:
            (arrays, tree, obj_id, block_obj,
             obj_pos0) = scene.bake_bvh_grouped(block_size=block_size)
        else:
            arrays, tree = scene.bake_bvh(block_size=block_size)
        self.bake = (arrays, tree)
        # Per-step hierarchy over the rotating shard's blocks: from 1,024
        # blocks per shard the flat (tiles x blocks) mask and its sort
        # dominate a step, so local superblock levels are added (the
        # padding keeps groups inside one shard).
        if local_levels is None:
            local_levels = 2 if -(-tree.num_blocks // n) >= 1024 else 1
        self.loc_groups = (local_group,) * (local_levels - 1)
        self.n_levels = local_levels
        arrays, lo, hi = _pad_to_shardable(
            arrays, tree, n, align=local_group if self.loc_groups else 1)
        self.nb_ext = lo.shape[0]
        self.nb_loc = self.nb_ext // n
        self.t_loc = self.nb_loc * block_size
        tris16 = bsr_trace.pack_tris(arrays)
        table32 = shade.pack_table(arrays, xp=np)

        def put(a, d):
            return torch.from_numpy(np.ascontiguousarray(a)).to(d)

        t_loc, nb_loc = self.t_loc, self.nb_loc
        self.geom = [ShardedGeometry(
            tris16=put(tris16[r * t_loc:(r + 1) * t_loc], d),
            table32=put(table32[r * t_loc:(r + 1) * t_loc], d),
            block_lo=put(lo[r * nb_loc:(r + 1) * nb_loc], d),
            block_hi=put(hi[r * nb_loc:(r + 1) * nb_loc], d),
            base=torch.full((1,), r * t_loc, dtype=torch.int32, device=d))
            for r, d in enumerate(self.mesh)]
        self.lights_pos = [put(arrays.light_pos, d) for d in self.mesh]
        self.lights_col = [put(arrays.light_col, d) for d in self.mesh]
        self.n_lights = int(arrays.light_pos.shape[0])
        if dynamic:
            pad_b = self.nb_ext - tree.num_blocks
            obj_id = np.pad(np.asarray(obj_id, np.int64),
                            (0, pad_b * block_size))
            block_obj = np.pad(np.asarray(block_obj, np.int64), (0, pad_b))
            self._dyn = [DynGeometry(
                obj_id=put(obj_id[r * t_loc:(r + 1) * t_loc], d),
                block_obj=put(block_obj[r * nb_loc:(r + 1) * nb_loc], d),
                obj_pos0=put(np.asarray(obj_pos0, np.float32), d))
                for r, d in enumerate(self.mesh)]
        else:
            self._dyn = None

        # 2D screen-tile ray layout, padded to a whole number of tiles per
        # rank with copies of the last pixel. `tile_w` overrides the
        # aspect: squarer tiles have tighter hulls per ray, which cuts the
        # scheduled pairs on surface-heavy scenes, at the cost of more
        # tiles.
        self.tile_w = 32 if tile_w is None else tile_w
        self.tile_h = ray_tile // self.tile_w
        perm, _, self.n_pad = cull.tiled_ray_order(width, height,
                                                   self.tile_w, self.tile_h)
        nt_ext = -(-(self.n_pad // ray_tile) // n) * n
        self.n_pad_ext = nt_ext * ray_tile
        perm = np.concatenate([perm, np.full(
            (self.n_pad_ext - self.n_pad,), width * height - 1, np.int32)])
        self.r_loc = self.n_pad_ext // n
        self.nt_loc = self.r_loc // ray_tile
        self._perm = [put(perm[r * self.r_loc:(r + 1) * self.r_loc]
                          .astype(np.int64), d)
                      for r, d in enumerate(self.mesh)]

        camera = sizing_camera if sizing_camera is not None else scene.camera
        self.sizing_counts = self._sizing_counts(
            camera, perm, tris16, table32, lo, hi)
        self.w_pads = self.w_pads_sh = None
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
        dev = self.mesh[0]
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        tris16, table32, blo, bhi = put(tris16), put(table32), put(lo), put(hi)
        cam = raygen.camera_arrays(camera, dev)
        rays = bsr_trace.pack_rays_rows(cam.pos, raygen.ray_rows_flat(
            cam, self.width, self.height, put(perm.astype(np.int64))))
        live = torch.ones(self.n_pad_ext, dtype=torch.bool, device=dev)
        excl = torch.full((self.n_pad_ext,), -1, dtype=torch.int32,
                          device=dev)
        view = cam.pos
        out = []
        for b in range(self.bounces + 1):
            counts, rays, live, excl, view = self._size_step(
                b == 0, tris16, table32, blo, bhi, rays, live, excl, view,
                self.lights_pos[0], self.lights_col[0])
            out.append(counts.numpy())
        return np.stack(out)

    # -- the frame -------------------------------------------------------

    def device_fn(self, camera, diff=None):
        """One frame over the ranks, with `diff` (a SceneDiff, dynamic=True)
        folded in: (colour rows (3, n_pad_ext), per-rank counts (n, B+1,
        2 * n_levels + 2)) on rank 0's device, without a host sync."""
        ranks, n, rt, nl = self.ranks, self.n, self.rt, self.n_levels
        packed = raygen.camera_packed(camera)
        ranks.begin()
        geom = list(self.geom)
        lpos, lcol = list(self.lights_pos), list(self.lights_col)
        cam, rays, live, excl, colour, thru, view = ([] for _ in range(7))
        for r, d in enumerate(self.mesh):
            with ranks.on(r):
                c = raygen.camera_views(raygen.to_device(packed, d))
                if diff is not None:
                    # Fold the frame's diff into the resident shard before
                    # the rotation starts (environment.go:73-98).
                    dd = SceneDiff(*(raygen.to_device(a, d) for a in diff))
                    geom[r] = apply_diff_sharded(geom[r], self._dyn[r], dd)
                    lpos[r], lcol[r] = dd.light_pos, dd.light_col
                cam.append(c)
                rays.append(bsr_trace.pack_rays_rows(c.pos, raygen.ray_rows_flat(
                    c, self.width, self.height, self._perm[r])))
                live.append(torch.ones(self.r_loc, dtype=torch.bool, device=d))
                excl.append(torch.full((self.r_loc,), -1, dtype=torch.int32,
                                       device=d))
                colour.append(torch.zeros((3, self.r_loc), device=d))
                thru.append(torch.ones((3, self.r_loc), device=d))
                view.append(c.pos)
        counts = [[] for _ in range(n)]
        for b in range(self.bounces + 1):
            pads, pads_sh = self.w_pads[b], self.w_pads_sh[b]
            ti, state = [], []
            for r, d in enumerate(self.mesh):
                with ranks.on(r):
                    ti.append(cull.tile_intervals_packed(rays[r], rt,
                                                         live=live[r]))
                    state.append([
                        torch.full((self.r_loc,), float("inf"), device=d),
                        torch.full((self.r_loc,), bsr_trace.BIG_IDX,
                                   dtype=torch.int32, device=d),
                        torch.zeros((self.r_loc, 32), device=d),
                        torch.zeros(nl, dtype=torch.int32, device=d),
                        torch.zeros((), dtype=torch.int32, device=d)])
            # Phase 1: n steps of culled nearest against the shard held
            # now, each followed by one rotation.
            for _ in range(n):
                for r in range(n):
                    with ranks.on(r):
                        self._nearest_step(state[r], geom[r], ti[r], rays[r],
                                           excl[r], cam[r], pads, b == 0)
                geom = self._rotate(geom)
            prep, valid, lit, s_state = [], [], [], []
            for r, d in enumerate(self.mesh):
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
                    prep.append(p)
                    valid.append(v)
                    s_state.append([
                        torch.zeros((self.n_lights, self.r_loc),
                                    dtype=torch.int32, device=d),
                        torch.zeros(nl, dtype=torch.int32, device=d),
                        torch.zeros((), dtype=torch.int32, device=d),
                        tis, torch.where(v, best_i, -1)])
            # Phase 2: n steps of culled any-hit per light.
            for _ in range(n):
                for r in range(n):
                    with ranks.on(r):
                        self._shadow_step(s_state[r], geom[r], prep[r],
                                          lpos[r], pads_sh)
                geom = self._rotate(geom)
            for r in range(n):
                with ranks.on(r):
                    p, v = prep[r], valid[r]
                    hit, cvec_s, csum_s = s_state[r][:3]
                    _, best_i, _, cvec_p, csum_p = state[r]
                    local = shade.shade_core_rows(lcol[r], view[r], p, v,
                                                  hit == 0)
                    colour[r] = colour[r] + thru[r] * local
                    counts[r].append(torch.cat([cvec_p, cvec_s, csum_p[None],
                                                csum_s[None]]))
                    if b < self.bounces:
                        thru[r] = torch.where(v[None, :], thru[r] * p.ks, 0.0)
                        rays[r], live[r] = reflect_rows(self.cfg, p, rays[r],
                                                        v)
                        excl[r] = torch.where(v, best_i, -1)
                        view[r] = p.x
        rows, cts = [], []
        for r in range(n):
            with ranks.on(r):
                rows.append(torch.clamp(colour[r], 0.0, 1.0).T)
                cts.append(torch.stack(counts[r])[None])
        return (mesh_mod.gather(ranks, rows).T,
                mesh_mod.gather(ranks, cts))

    def _rotate(self, geom: list) -> list:
        """Every rank's shard to its right neighbour (`ppermute`)."""
        fields = [mesh_mod.rotate_right(self.ranks, [g[k] for g in geom])
                  for k in range(len(ShardedGeometry._fields))]
        return [ShardedGeometry(*(f[r] for f in fields))
                for r in range(self.n)]

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

    def _freeze(self, counts: np.ndarray) -> None:
        """Per-bounce per-level buckets from (B+1, 2 * n_levels) counts x
        margin, grow-only (a verify loop that could shrink a bucket would
        lose its convergence argument)."""
        counts = np.asarray(counts)
        nl = self.n_levels
        w_pads = tuple(tuple(_bucket(int(c), self.margin) for c in row[:nl])
                       for row in counts)
        w_pads_sh = tuple(tuple(_bucket(int(c), self.margin)
                                for c in row[nl:2 * nl]) for row in counts)
        if self.w_pads is not None:
            grow = lambda new, old: tuple(tuple(map(max, a, b))
                                          for a, b in zip(new, old))
            w_pads = grow(w_pads, self.w_pads)
            w_pads_sh = grow(w_pads_sh, self.w_pads_sh)
        self.w_pads, self.w_pads_sh = w_pads, w_pads_sh

    # -- public ----------------------------------------------------------

    def _assemble(self, rows: torch.Tensor) -> torch.Tensor:
        """(3, n_pad_ext) tile-major rows -> the (H, W, 3) frame."""
        tw, th = self.tile_w, self.tile_h
        tx, ty = -(-self.width // tw), -(-self.height // th)
        img = rows[:, :self.n_pad].reshape(3, ty, tx, th, tw)
        img = img.permute(1, 3, 2, 4, 0).reshape(ty * th, tx * tw, 3)
        return img[:self.height, :self.width]

    def _counts_fit(self, counts: torch.Tensor) -> bool:
        worst = counts.amax(dim=0).tolist()            # (B+1, 2nl + 2)
        nl = self.n_levels
        return all(int(c) <= p for b, row in enumerate(worst)
                   for c, p in zip(row[:2 * nl],
                                   self.w_pads[b] + self.w_pads_sh[b]))

    def _verify_loop(self, dispatch, rows, counts):
        """Refreezes from the reported counts until they all fit (up to 8
        rounds): a truncated level makes the finer counts undercounts, and
        later bounces' rays come from earlier, possibly truncated, hits, so
        one refreeze is not enough."""
        fits = False
        for _ in range(8):
            if self._counts_fit(counts):
                fits = True
                break
            self._freeze(counts.amax(dim=0)[:, :2 * self.n_levels].cpu()
                         .numpy())
            rows, counts = dispatch()
        if not fits:
            _log.warning("ring verify did not converge in 8 rounds (counts "
                         "%s); image may drop blocks", counts.tolist())
        return rows, counts

    def render(self, camera, verify: bool = False) -> torch.Tensor:
        """The (H, W, 3) frame on rank 0's device."""
        rows, counts = self.device_fn(camera)
        if verify:
            rows, counts = self._verify_loop(lambda: self.device_fn(camera),
                                             rows, counts)
        self.last_counts = counts
        return self._assemble(rows)

    def render_dynamic(self, camera, diff: SceneDiff,
                       verify: bool = False) -> torch.Tensor:
        """One frame with the frame's SceneDiff folded into every shard
        before the rotation (needs dynamic=True); composes with bounces."""
        if self._dyn is None:
            raise ValueError("build with dynamic=True for render_dynamic")
        diff = SceneDiff(*(torch.as_tensor(np.asarray(a, np.float32))
                           for a in diff))
        rows, counts = self.device_fn(camera, diff)
        if verify:
            rows, counts = self._verify_loop(
                lambda: self.device_fn(camera, diff), rows, counts)
        self.last_counts = counts
        return self._assemble(rows)

    def scheduled_pairs(self) -> Optional[int]:
        """(ray, triangle) pairs the last frame's nearest queries scheduled
        over all ranks, steps and bounces (finest-level cells x rt x tb;
        shadow queries excluded); None before the first frame."""
        if self.last_counts is None:
            return None
        c = self.last_counts
        return int(c[:, :, 2 * self.n_levels].sum()) * self.rt * self.tb
