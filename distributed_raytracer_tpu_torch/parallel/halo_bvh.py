"""Block-BVH-culled geometry-sharded rendering with ray halo exchange.

The torch counterpart of distributed_raytracer_tpu/parallel/halo_bvh.py,
the production schedule for geometry split across ranks (the config-5
class). parallel/halo.py routes rays to geometry shards but tests every
received ray against every resident triangle. Here each rank culls the
gathered ray tiles against its OWN blocks (ops/cull.py's multilevel
interval walk) and runs only the surviving (tile, block) pairs through the
traversal kernels (ops/bsr_trace.py): the pruning of the replicated path,
which the reference applies to every query (tracer.go:32 scene R-tree,
object.go:76 face R-tree), now per shard.

Scene.bake_bvh Morton-orders triangles and gap-aligns leaf blocks, so a
contiguous run of blocks is spatially compact: sharding the block axis
contiguously gives each rank a tight region, which is what makes per-shard
culling effective (most ray tiles miss most shards and cull to no work).

Per rank (the frame's rays in tile-major order, r_loc of them resident),
one iteration per bounce:
  1. raygen of the FULL frame (rays are a function of the camera, cheaper
     to make than to gather); later bounces all_gather the resident
     reflection rays, their liveness and their exclusion ids instead;
  2. the multilevel cull of every ray tile against the local blocks, then
     bsr_nearest (K1 for the camera rays, K3n with per-ray origins for
     reflections) with the shard's global id base; unvisited tiles are
     (inf, BIG_IDX);
  3. the candidate's 32-wide shading row from the LOCAL table (only the
     owner holds the winner's data), then all_to_all of (t, gid, row) home
     and a fold over the source ranks: least t, then least global id, the
     kernels' own tie rule, so the fold order does not matter;
  4. per light, the reversed shadow queries of the resident hits
     (shade.PackedPrep.q_rev) with their liveness and global exclusion ids
     are all_gathered, culled against the local blocks with t_max, traced
     by bsr_any (K2, the light's origin folded into the rows), and the
     bits go home by all_to_all and are ORed;
  5. Phong from the carried rows (shade.shade_core_rows); with bounces,
     colour += throughput * phong_b, throughput *= Ks, one final clamp
     (CulledRenderer.render_bounced's accumulation).
Exchange per frame and bounce: one all_to_all of 34 words per ray, per
light one all_gather of the queries and one all_to_all of the bits (one
all_gather of the reflection rays per further bounce): O(rays), whatever
the triangle count. Geometry never moves.

JAX's `shard_map` body is a host loop here, as in parallel/ring_bvh.py:
each stage is one pass over the ranks under `ranks.on(r)`, and data
crosses ranks only through parallel/mesh.py's collectives. The frame runs
eagerly (no CUDA graph).

Work-list buckets are sized at build time on one device over the full
geometry: each rank culls the whole frame against its shard, so the
per-shard column sums of the full-scene level masks are the ranks' counts
exactly. render(cam, verify=True) refreezes grow-only until every
reported count fits, up to 8 rounds.

Over a multi-process mesh (parallel/multihost.py) each process holds and
runs its own ranks' shards; every per-rank loop runs over `ranks.local`,
the collectives cross processes, the frame's rows come home to process 0
(None elsewhere, assembled there) and the per-rank counts reach every
process, so the verify loop refreezes alike everywhere. Every process
sizes the buckets on its own device over the full geometry, and the
sizing counts are maxed over the processes, so all freeze the same
buckets.

The module also holds the pieces parallel/ring_bvh.py shares: the
reflection rays of one bounce (`reflect_rows`, ops/render_bvh.py's), the
per-rank geometry shard (`ShardedGeometry`) and its ownership maps for
per-frame object diffs (`DynGeometry`, `apply_diff_sharded`), and the block
padding that makes the block count divide the rank count
(`_pad_to_shardable`).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import Scene, SceneDiff
from distributed_raytracer_tpu_torch.ops import bsr_trace, cull, raygen, shade
from distributed_raytracer_tpu_torch.ops.render_bvh import reflect_rows
from distributed_raytracer_tpu_torch.ops.render_dynamic import _rowdot3
from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

__all__ = ["DynGeometry", "HaloCulledRenderer", "ShardedCulledRenderer",
           "ShardedGeometry", "apply_diff_sharded", "reflect_rows"]

_log = logging.getLogger(__name__)

AXIS = "geom"
_bucket = bsr_trace.bucket_w_pad


class ShardedGeometry(NamedTuple):
    """One rank's contiguous shard of the per-triangle and per-block
    arrays."""

    tris16: torch.Tensor    # (T_loc, 16) bsr_trace.pack_tris rows
    table32: torch.Tensor   # (T_loc, 32) shade.pack_table rows
    block_lo: torch.Tensor  # (NB_loc, 3)
    block_hi: torch.Tensor  # (NB_loc, 3)
    base: torch.Tensor      # (1,) int32: the shard's first global id


class DynGeometry(NamedTuple):
    """Ownership maps for per-frame object diffs on one rank's shard
    (Scene.bake_bvh_grouped's outputs, sharded like ShardedGeometry)."""

    obj_id: torch.Tensor     # (T_loc,) int64 owning object per triangle
    block_obj: torch.Tensor  # (NB_loc,) int64 owning object per block
    obj_pos0: torch.Tensor   # (O, 3) f32 baked object positions (all)


def apply_diff_sharded(geom: ShardedGeometry, dyn: DynGeometry,
                       diff) -> ShardedGeometry:
    """One shard's geometry with a SceneDiff's object shifts folded in, on
    the device: ops/render_dynamic.py's translation fold applied to the
    local rows (every worker applies every diff, environment.go:73-98). A
    shift d touches plane_d, c_u, c_v, the table's p0 and the whole-object
    block AABBs (one owner per block); inverted padding AABBs stay
    inverted (+-inf + finite = +-inf)."""
    delta = diff.obj_pos - dyn.obj_pos0                          # (O, 3)
    dt = delta[dyn.obj_id]                                       # (T, 3)
    t16 = geom.tris16
    plane = t16[:, 3:4] + _rowdot3(t16[:, 0:3], dt)
    cu = t16[:, 7:8] - _rowdot3(t16[:, 4:7], dt)
    cv = t16[:, 11:12] - _rowdot3(t16[:, 8:11], dt)
    tris16 = torch.cat([t16[:, 0:3], plane, t16[:, 4:7], cu, t16[:, 8:11],
                        cv, t16[:, 12:]], dim=1)
    db = delta[dyn.block_obj]
    return geom._replace(
        tris16=tris16,
        table32=torch.cat([geom.table32[:, 0:3] + dt, geom.table32[:, 3:]],
                          dim=1),
        block_lo=geom.block_lo + db, block_hi=geom.block_hi + db)


def _pad_to_shardable(arrays, tree, n: int, align: int = 1):
    """Appends degenerate blocks so the block count divides the rank count
    (and, with align > 1, each shard's block count divides the local cull
    grouping, so superblocks never straddle shards). Returns (arrays,
    block_lo, block_hi) as numpy.

    Padding triangles are all-zero (den == num == 0: never hit) and padding
    blocks carry inverted AABBs (+inf, -inf), which the cull rejects."""
    nb = tree.num_blocks
    nb_ext = -(-nb // (n * align)) * (n * align)
    if nb_ext == nb:
        return arrays, tree.block_lo, tree.block_hi
    pad_t = (nb_ext - nb) * tree.block_size
    per_tri = {"p0", "e1", "e2", "geo_n", "plane_d", "k_u", "k_v",
               "c_u", "c_v", "n0", "n1", "n2", "mat_id"}
    rep = {}
    for name in per_tri:
        a = np.asarray(getattr(arrays, name))
        rep[name] = np.pad(a, [(0, pad_t)] + [(0, 0)] * (a.ndim - 1))
    arrays = arrays._replace(**rep)
    lo = np.concatenate([tree.block_lo,
                         np.full((nb_ext - nb, 3), np.inf, np.float32)])
    hi = np.concatenate([tree.block_hi,
                         np.full((nb_ext - nb, 3), -np.inf, np.float32)])
    return arrays, lo, hi


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class ShardedCulledRenderer:
    """What the culled geometry-sharded renderers share (this module's
    halo, parallel/ring_bvh.py's ring): per-bounce per-level buckets, the
    verify loop and the frame's assembly. A subclass sets `kind` (its name
    in the verify loop's warning) and provides device_fn(camera, diff=None)
    -> (colour rows (3, n_pad_ext), per-rank counts (n, [B+1,] >= 2 *
    n_levels)); the counts' first 2 * n_levels columns are the per-level
    primary, then shadow, cells the buckets are checked against."""

    kind = ""

    def _build(self, scene: Scene, width: int, height: int, mesh,
               margin: float, cfg: RenderConfig, block_size: int,
               ray_tile: int, dynamic: bool, bounces: int,
               local_levels: Optional[int], local_group: int, tile_w: int):
        """The shards and the ray layout both schedules share: bakes the
        scene (per-object grouped when `dynamic`, so a SceneDiff shifts
        whole leaf blocks exactly), pads the blocks to whole shards, puts
        one ShardedGeometry (and DynGeometry) per rank on its device and
        lays the frame's rays out in tile-major order, padded with copies
        of the last pixel to a whole number of tiles per rank. Returns
        (perm (n_pad_ext,), (tris16, table32, block_lo, block_hi)): the
        host arrays of the full geometry the sizing pass reads."""
        self.mesh = mesh_mod.check_mesh(
            mesh_mod.default_mesh() if mesh is None else mesh)
        self.ranks = ranks = mesh_mod.Ranks(self.mesh)
        self.n = n = len(self.mesh)
        self.bounces = int(bounces)
        self.width, self.height, self.cfg = width, height, cfg
        self.rt, self.tb = ray_tile, block_size
        self.margin = margin
        if dynamic:
            (arrays, tree, obj_id, block_obj,
             obj_pos0) = scene.bake_bvh_grouped(block_size=block_size)
        else:
            arrays, tree = scene.bake_bvh(block_size=block_size)
        self.bake = (arrays, tree)
        # Per-shard cull hierarchy: from 1,024 blocks per shard the flat
        # (tiles x blocks) mask and its sort dominate, so a local
        # superblock level is added (the padding keeps groups inside one
        # shard).
        if local_levels is None:
            local_levels = 2 if -(-tree.num_blocks // n) >= 1024 else 1
        self.loc_groups = (local_group,) * (local_levels - 1)
        self.n_levels = local_levels
        arrays, lo, hi = _pad_to_shardable(
            arrays, tree, n, align=local_group if self.loc_groups else 1)
        self.nb_ext = lo.shape[0]
        self.nb_loc = nb_loc = self.nb_ext // n
        self.t_loc = t_loc = nb_loc * block_size
        tris16 = bsr_trace.pack_tris(arrays)
        table32 = shade.pack_table(arrays, xp=np)
        mesh = self.mesh
        self.geom = ranks.per_rank(lambda r: ShardedGeometry(
            tris16=_put(tris16[r * t_loc:(r + 1) * t_loc], mesh[r]),
            table32=_put(table32[r * t_loc:(r + 1) * t_loc], mesh[r]),
            block_lo=_put(lo[r * nb_loc:(r + 1) * nb_loc], mesh[r]),
            block_hi=_put(hi[r * nb_loc:(r + 1) * nb_loc], mesh[r]),
            base=torch.full((1,), r * t_loc, dtype=torch.int32,
                            device=mesh[r])))
        self.lights_pos = ranks.per_rank(
            lambda r: _put(arrays.light_pos, mesh[r]))
        self.lights_col = ranks.per_rank(
            lambda r: _put(arrays.light_col, mesh[r]))
        self.n_lights = int(arrays.light_pos.shape[0])
        self._dyn = None
        if dynamic:
            # Padding slots and blocks chart to object 0: degenerate
            # triangles never hit and inverted boxes never pass.
            pad_b = self.nb_ext - tree.num_blocks
            obj_id = np.pad(np.asarray(obj_id, np.int64),
                            (0, pad_b * block_size))
            block_obj = np.pad(np.asarray(block_obj, np.int64), (0, pad_b))
            self._dyn = ranks.per_rank(lambda r: DynGeometry(
                obj_id=_put(obj_id[r * t_loc:(r + 1) * t_loc], mesh[r]),
                block_obj=_put(block_obj[r * nb_loc:(r + 1) * nb_loc],
                               mesh[r]),
                obj_pos0=_put(np.asarray(obj_pos0, np.float32), mesh[r])))
        self.tile_w = tile_w
        self.tile_h = ray_tile // tile_w
        perm, _, self.n_pad = cull.tiled_ray_order(width, height,
                                                   self.tile_w, self.tile_h)
        nt_ext = -(-(self.n_pad // ray_tile) // n) * n
        self.n_pad_ext = nt_ext * ray_tile
        perm = np.concatenate([perm, np.full(
            (self.n_pad_ext - self.n_pad,), width * height - 1, np.int32)])
        self.r_loc = self.n_pad_ext // n
        self.w_pads = self.w_pads_sh = None
        return perm, (tris16, table32, lo, hi)

    def _freeze(self, worst) -> None:
        """Per-bounce per-level buckets from (B+1, 2 * n_levels) counts (the
        max over ranks) x margin, grow-only (a verify loop that could
        shrink a bucket would lose its convergence argument)."""
        worst = np.asarray(worst).reshape(self.bounces + 1, -1)
        nl = self.n_levels
        w_pads = tuple(tuple(_bucket(int(c), self.margin) for c in row[:nl])
                       for row in worst)
        w_pads_sh = tuple(tuple(_bucket(int(c), self.margin)
                                for c in row[nl:2 * nl]) for row in worst)
        if self.w_pads is not None:
            grow = lambda new, old: tuple(tuple(map(max, a, b))
                                          for a, b in zip(new, old))
            w_pads = grow(w_pads, self.w_pads)
            w_pads_sh = grow(w_pads_sh, self.w_pads_sh)
        self.w_pads, self.w_pads_sh = w_pads, w_pads_sh

    def _sizing_device(self):
        """(device, light positions, light colours) of the build-time
        sizing pass: this process's first rank's."""
        r = self.ranks.local[0]
        return self.mesh[r], self.lights_pos[r], self.lights_col[r]

    def _assemble(self, rows: torch.Tensor) -> torch.Tensor:
        """(3, n_pad_ext) tile-major rows -> the (H, W, 3) frame."""
        tw, th = self.tile_w, self.tile_h
        tx, ty = -(-self.width // tw), -(-self.height // th)
        img = rows[:, :self.n_pad].reshape(3, ty, tx, th, tw)
        img = img.permute(1, 3, 2, 4, 0).reshape(ty * th, tx * tw, 3)
        return img[:self.height, :self.width]

    def _worst(self, counts: torch.Tensor) -> np.ndarray:
        """(B+1, 2 * n_levels): per bounce, the max over ranks of a
        frame's level counts."""
        worst = counts.amax(dim=0).cpu().numpy()
        return worst.reshape(self.bounces + 1, -1)[:, :2 * self.n_levels]

    def _counts_fit(self, counts: torch.Tensor) -> bool:
        return all(int(c) <= p for b, row in enumerate(self._worst(counts))
                   for c, p in zip(row, self.w_pads[b] + self.w_pads_sh[b]))

    def _verify_loop(self, dispatch, rows, counts):
        """Refreezes from the reported counts until they all fit (up to 8
        rounds): a truncated level makes the finer counts undercounts, and
        later bounces' rays come from earlier, possibly truncated, hits, so
        one refreeze is not enough. Warns only if the last frame's counts
        still overflow."""
        for _ in range(8):
            if self._counts_fit(counts):
                return rows, counts
            self._freeze(self._worst(counts))
            rows, counts = dispatch()
        if not self._counts_fit(counts):
            _log.warning("%s verify did not converge in 8 rounds (counts "
                         "%s); image may drop blocks", self.kind,
                         counts.tolist())
        return rows, counts

    # -- public ----------------------------------------------------------

    def render(self, camera, verify: bool = False) -> torch.Tensor:
        """The (H, W, 3) frame on rank 0's device (None in the other
        processes of a multi-process mesh); verify=True refreezes until
        the counts fit."""
        rows, counts = self.device_fn(camera)
        if verify:
            rows, counts = self._verify_loop(lambda: self.device_fn(camera),
                                             rows, counts)
        self.last_counts = counts
        return None if rows is None else self._assemble(rows)

    def render_dynamic(self, camera, diff: SceneDiff,
                       verify: bool = False) -> torch.Tensor:
        """One frame with the frame's SceneDiff folded into every shard
        before any cull (needs dynamic=True); composes with bounces."""
        if self._dyn is None:
            raise ValueError("build with dynamic=True for render_dynamic")
        diff = SceneDiff(*(torch.as_tensor(np.asarray(a, np.float32))
                           for a in diff))
        rows, counts = self.device_fn(camera, diff)
        if verify:
            rows, counts = self._verify_loop(
                lambda: self.device_fn(camera, diff), rows, counts)
        self.last_counts = counts
        return None if rows is None else self._assemble(rows)


class HaloCulledRenderer(ShardedCulledRenderer):
    """Geometry-sharded renderer with per-shard block-BVH culling and ray
    halo exchange over a mesh of ranks (default: one per card).

    Static work lists sized from `sizing_camera` x `margin` (a one-device
    pass over the full scene, maxed over ranks and lights); render(cam,
    verify=True) grows them (up to 8 rounds) until every reported count
    fits, instead of dropping candidate blocks (the reference never shows a
    wrong tile, master/main.go:153-161). `bake` holds the unpadded
    (SceneArrays, BlockBVH) the shards were cut from.

    Counts, per rank and per local cull level (coarsest first), primary
    cells then shadow cells (max over lights): `last_counts` is (n, 2 *
    n_levels) without bounces and (n, B+1, 2 * n_levels) with them. It
    holds the sizing counts until a frame has run."""

    kind = "halo"

    def __init__(self, scene: Scene, width: int, height: int, mesh=None,
                 sizing_camera: Optional[Camera] = None,
                 margin: float = 2.0, cfg: RenderConfig = DEFAULT_CONFIG,
                 block_size: int = 128, ray_tile: int = 512,
                 dynamic: bool = False, bounces: int = 0,
                 local_levels: Optional[int] = None, local_group: int = 16):
        perm, host = self._build(scene, width, height, mesh, margin, cfg,
                                 block_size, ray_tile, dynamic, bounces,
                                 local_levels, local_group, tile_w=32)
        # Every rank makes the whole frame's rays; rank r's resident rays
        # are its r_loc slice of them.
        self.n_tiles = self.n_pad_ext // ray_tile
        self._perm = self.ranks.per_rank(
            lambda r: _put(perm.astype(np.int64), self.mesh[r]))
        camera = sizing_camera if sizing_camera is not None else scene.camera
        counts = self.ranks.max_over_processes(
            self._sizing_counts(camera, perm, *host))
        self._freeze(counts.max(axis=1))
        # As in the JAX package, the sizing counts stand in for the last
        # frame's until one has run (in the frame's layout).
        counts = torch.from_numpy(counts.transpose(1, 0, 2).copy())
        self.last_counts = (counts if self.bounces else counts[:, 0]).to(
            self.ranks.device)

    # -- sizing (build time, rank 0's device, full geometry) -------------
    #
    # Rank s culls every ray tile against its own blocks, so its count at
    # any level is the full-scene level mask restricted to s's block
    # columns (local groups never straddle shards, so the global level
    # boxes restricted to s's columns are s's local boxes).

    def _per_shard_levels(self, ti, blo, bhi) -> torch.Tensor:
        """(n_levels, n) kept cells per shard at every local level,
        coarsest first."""
        rows = []
        for lo, hi in reversed(cull.level_bounds(blo, bhi, self.loc_groups)):
            m, _ = cull.block_mask_with_entry(ti, lo, hi)
            rows.append(m.reshape(m.shape[0], self.n, -1).sum(dim=(0, 2)))
        return torch.stack(rows)

    def _size_step(self, shared: bool, tris16, table32, blo, bhi, rays,
                   live, excl, view):
        """One bounce of the sizing walk on the full geometry: (n, 2 *
        n_levels) per-shard counts (primary, then the max over lights of
        the shadow cells) and the next bounce's rays."""
        rt = self.rt
        _, lpos, lcol = self._sizing_device()
        ti = cull.tile_intervals_packed(rays, rt, live=live)
        p_levels = self._per_shard_levels(ti, blo, bhi)
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
            lpos, rays, torch.where(valid, bt, 0.0), g, self.cfg)
        live_l = shade.light_gates_rows(lcol, view, prep, valid)
        s_levels = [self._per_shard_levels(
            cull.tile_intervals_packed(prep.q_rev[li], rt, live=live_l[li],
                                       use_tmax=True), blo, bhi)
            for li in range(self.n_lights)]
        s_max = (torch.stack(s_levels).amax(dim=0) if s_levels
                 else torch.zeros_like(p_levels))
        r_rays, live2 = reflect_rows(self.cfg, prep, rays, valid)
        counts = torch.cat([p_levels, s_max]).T.cpu()
        return counts, r_rays, live2, torch.where(valid, bi, -1), prep.x

    def _sizing_counts(self, camera, perm, tris16, table32, lo,
                       hi) -> np.ndarray:
        """(B+1, n, 2 * n_levels) per bounce, per shard, per local level:
        the primary cells, then the max over lights of the shadow cells;
        the bucket-sizing inputs."""
        dev = self._sizing_device()[0]
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
                b == 0, tris16, table32, blo, bhi, rays, live, excl, view)
            out.append(counts.numpy())
        return np.stack(out)

    # -- the frame -------------------------------------------------------

    def device_fn(self, camera, diff=None):
        """One frame over the ranks, with `diff` (a SceneDiff, dynamic=True)
        folded into every shard: (colour rows (3, n_pad_ext), per-rank
        counts in last_counts' layout) on rank 0's device, without a host
        sync. Over several processes the rows land on process 0 (None
        elsewhere) and the counts on every process."""
        ranks, n, rt, r_loc = self.ranks, self.n, self.rt, self.r_loc
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
                    # Every shard folds the frame's diff into its resident
                    # rows before any culling (environment.go:73-98).
                    dd = SceneDiff(*(raygen.to_device(a, d) for a in diff))
                    geom[r] = apply_diff_sharded(geom[r], self._dyn[r], dd)
                    lpos[r], lcol[r] = dd.light_pos, dd.light_col
                cam[r] = c
                rays[r] = bsr_trace.pack_rays_rows(
                    c.pos, raygen.ray_rows_flat(c, self.width, self.height,
                                                self._perm[r]))
                live[r] = torch.ones(self.n_pad_ext, dtype=torch.bool,
                                     device=d)
                excl[r] = torch.full((self.n_pad_ext,), -1,
                                     dtype=torch.int32, device=d)
                colour[r] = torch.zeros((3, r_loc), device=d)
                thru[r] = torch.ones((3, r_loc), device=d)
                view[r] = c.pos
        counts = {r: [] for r in local}
        for b in range(self.bounces + 1):
            pads, pads_sh = self.w_pads[b], self.w_pads_sh[b]
            cand = ranks.per_rank(lambda r: self._nearest(
                geom[r], rays[r], live[r], excl[r], cam[r], pads, b == 0, r))
            homed = [mesh_mod.all_to_all(
                ranks, [None if c is None else c[k] for c in cand])
                for k in range(3)]
            mine, prep, valid, live_l, excl_sh = ([None] * n
                                                  for _ in range(5))
            for r in local:
                with ranks.on(r):
                    best_t, best_i, best_g = self._fold(
                        *(h[r] for h in homed))
                    res = slice(r * r_loc, (r + 1) * r_loc)
                    v = torch.isfinite(best_t) & live[r][res]
                    mine[r] = rays[r][:, res]
                    p = shade.prepare_packed_rows(
                        lpos[r], mine[r], torch.where(v, best_t, 0.0),
                        best_g.T, self.cfg)
                    prep[r] = p
                    valid[r] = v
                    live_l[r] = shade.light_gates_rows(lcol[r], view[r], p,
                                                       v)
                    excl_sh[r] = torch.where(v, best_i, -1)
            excl_g = mesh_mod.all_gather(ranks, excl_sh)
            lit, s_counts = self._shadows(geom, prep, live_l, excl_g, lpos,
                                          pads_sh)
            for r in local:
                with ranks.on(r):
                    p, v = prep[r], valid[r]
                    local_c = shade.shade_core_rows(lcol[r], view[r], p, v,
                                                    lit[r])
                    colour[r] = colour[r] + thru[r] * local_c
                    counts[r].append(torch.cat([cand[r][3], s_counts[r]]))
                    if b < self.bounces:
                        thru[r] = torch.where(v[None, :], thru[r] * p.ks, 0.0)
                        rays[r], live[r] = reflect_rows(self.cfg, p, mine[r],
                                                        v)
                        view[r] = p.x
            if b < self.bounces:
                # Next bounce: the resident reflection rays, gathered.
                rays = mesh_mod.all_gather(ranks, rays, dim=1)
                live = mesh_mod.all_gather(ranks, live)
                excl = excl_g
        rows, cts = [None] * n, [None] * n
        for r in local:
            with ranks.on(r):
                rows[r] = torch.clamp(colour[r], 0.0, 1.0).T
                c = torch.stack(counts[r])
                cts[r] = (c if self.bounces else c[0])[None]
        out = mesh_mod.gather(ranks, rows)
        return (None if out is None else out.T,
                mesh_mod.gather(ranks, cts, everywhere=True))

    def _nearest(self, sh: ShardedGeometry, rays, live, excl, cam,
                 pads: tuple, shared: bool, r: int):
        """Rank r's nearest query of the gathered rays against its shard:
        (t, gid, shading row) per ray and the level counts."""
        with self.ranks.on(r):
            ti = cull.tile_intervals_packed(rays, self.rt, live=live)
            mask, entry, c_top = cull.multilevel_mask(
                ti, sh.block_lo, sh.block_hi, self.loc_groups)
            wl, exp = cull.multilevel_worklist(
                ti, mask, entry, c_top, sh.block_lo, sh.block_hi,
                self.loc_groups, pads)
            # Camera rays share the camera origin, folded into the rows;
            # reflection rays bring their own.
            tris = (bsr_trace.pack_tris_origin(sh.tris16, cam.pos) if shared
                    else sh.tris16)
            bt, bi = bsr_trace.bsr_nearest(
                rays, excl, tris, wl.tile_ids, wl.block_ids, wl.entry,
                wl.count, gid_base=sh.base, rt=self.rt, tb=self.tb,
                shared_origin=shared)
            visited = cull.visited_tiles(wl, self.n_tiles).repeat_interleave(
                self.rt)
            bt = torch.where(visited, bt, float("inf"))
            bi = torch.where(visited, bi, bsr_trace.BIG_IDX)
            loc = torch.clamp(bi - sh.base, 0, sh.tris16.shape[0] - 1).long()
            return (bt, bi, sh.table32[loc],
                    torch.stack([c_top, *exp]).to(torch.int32))

    def _fold(self, bt, bi, g):
        """The homed candidates of every source rank folded: least t, then
        least global id (the JAX package's `better` test, source order)."""
        bt = bt.reshape(self.n, self.r_loc)
        bi = bi.reshape(self.n, self.r_loc)
        g = g.reshape(self.n, self.r_loc, 32)
        best_t, best_i, best_g = bt[0], bi[0], g[0]
        for s in range(1, self.n):
            better = (bt[s] < best_t) | ((bt[s] == best_t) & (bi[s] < best_i))
            best_t = torch.where(better, bt[s], best_t)
            best_i = torch.where(better, bi[s], best_i)
            best_g = torch.where(better[:, None], g[s], best_g)
        return best_t, best_i, best_g

    def _shadows(self, geom: list, prep: list, live_l: list, excl_g: list,
                 lpos: list, pads: tuple):
        """Per light, the resident reversed shadow queries gathered, culled
        against every rank's blocks with t_max, traced by bsr_any (the
        light folded into the rows) and the bits homed and ORed: per rank
        (lit (L, r_loc) bool, the shadow level counts, max over lights)."""
        ranks, n, rt = self.ranks, self.n, self.rt
        nl = self.n_levels
        lit = ranks.per_rank(lambda r: [])
        s_counts = ranks.per_rank(lambda r: torch.zeros(
            nl, dtype=torch.int32, device=self.mesh[r]))
        for li in range(self.n_lights):
            q_g = mesh_mod.all_gather(
                ranks, [None if p is None else p.q_rev[li] for p in prep],
                dim=1)
            live_g = mesh_mod.all_gather(
                ranks, [None if lv is None else lv[li] for lv in live_l])
            bits = [None] * n
            for r in ranks.local:
                sh = geom[r]
                with ranks.on(r):
                    ti = cull.tile_intervals_packed(q_g[r], rt,
                                                    live=live_g[r],
                                                    use_tmax=True)
                    mask, entry, c_top = cull.multilevel_mask(
                        ti, sh.block_lo, sh.block_hi, self.loc_groups)
                    wl, exp = cull.multilevel_worklist(
                        ti, mask, entry, c_top, sh.block_lo, sh.block_hi,
                        self.loc_groups, pads)
                    s_counts[r] = torch.maximum(s_counts[r], torch.stack(
                        [c_top, *exp]).to(torch.int32))
                    hit = bsr_trace.bsr_any(
                        q_g[r], excl_g[r],
                        bsr_trace.pack_tris_origin(sh.tris16, lpos[r][li]),
                        wl.tile_ids, wl.block_ids, wl.entry, wl.count,
                        gid_base=sh.base, rt=rt, tb=self.tb,
                        shared_origin=True)
                    visited = cull.visited_tiles(wl, self.n_tiles)
                    bits[r] = torch.where(visited.repeat_interleave(rt), hit,
                                          0)
            homed = mesh_mod.all_to_all(ranks, bits)
            for r in ranks.local:
                with ranks.on(r):
                    lit[r].append(
                        homed[r].reshape(n, self.r_loc).amax(dim=0) == 0)
        lit = ranks.per_rank(lambda r: torch.stack(lit[r]) if lit[r]
                             else torch.zeros((0, self.r_loc),
                                              dtype=torch.bool,
                                              device=self.mesh[r]))
        return lit, s_counts

    def scheduled_pairs(self) -> int:
        """(ray, triangle) pairs the last frame's nearest queries scheduled
        over all ranks and bounces (finest-level cells x rt x tb; shadow
        queries excluded): the work-reduction diagnostic the dense sharded
        paths cannot offer. Before a frame, the sizing pass's."""
        cells = self.last_counts[..., self.n_levels - 1].sum()
        return int(cells) * self.rt * self.tb
