"""Block-sparse (BVH-culled) frame rendering.

The torch counterpart of distributed_raytracer_tpu/ops/render_bvh.py's
`CulledRenderer`, single device, with Whitted reflection bounces. The
pipeline first culls (ray-tile, tri-block) pairs with the conservative
interval test (ops/cull.py) over the Morton block BVH (models/bvh.py), then
runs only the surviving pairs through the traversal kernels
(ops/bsr_trace.py). Images are exact (culling is conservative); only the
work changes.

Rays are laid out in 2D screen tiles (cull.tiled_ray_order): compact tiles
have tight interval hulls, which is what makes the cull effective. Data is
row-native end to end: rays are (8, R) packed rows, per-ray vectors (3, R)
rows, shadow queries kernel-ready (L, 8, R).

A frame is seven stages:
  1. ray generation (raygen.ray_rows_flat, bsr_trace.pack_rays_rows);
  2. the multi-level interval cull (cull.multilevel_mask / _worklist);
  3. the nearest-hit kernel (bsr_trace.bsr_nearest, shared camera origin);
  4. hit-tile compaction, shading prep, light gates and the shadow tile
     hulls (ops/shade_prep.py: one CUDA kernel, or its plain version);
  5. the per-light shadow cull;
  6. one any-hit kernel launch covering all lights (bsr_trace.bsr_any);
  7. Phong shading (shade.shade_core_packed) and tile-major assembly.
`render()` sizes the work lists exactly, with host syncs between stages;
`freeze()` fixes the buckets from the last counts and `render_fast()` runs
all stages with them and no host sync, checking the true counts against
the buckets only when asked (verify=True): before the call returns, or,
inside the frame loop (runtime/loop.run_loop), when the loop drains the
frame (ops/frozen_graph.verify). `render_many(cameras)` renders a batch of
poses with the frozen buckets.

On CUDA every frozen frame (render_fast, render_many, freeze_bounced's
render, the dynamic renderer's render_dynamic) replays a CUDA graph of its
stages (ops/frozen_graph.py), the counterpart of the JAX package's jitted
dispatch; on the CPU the stages run eagerly. While the tracer is on
(utils/tracing.py), a frozen frame of the culled stages (`_full`) marks
five device stamps, before stage A and after A, B1, B2 and C, captured into
its graph (a graph key of its own), and the verify check is the span
`frozen.verify`; with the tracer off the graph holds the stages alone.

`render_bounced(camera, depth)` adds `depth` reflection bounces: stages 2-6
again per bounce over the previous bounce's reflection rays, whose nearest
query runs the per-ray-origin kernel. `freeze_bounced(camera, depth)`
returns the same pipeline with per-bounce buckets and no host sync. Its
frames count in `tracing.COUNTS["bounced_frames"]`, on or off. While the
tracer is on, a bounced frozen frame (`_full_bounced`) marks 4 * depth + 5
device stamps of kind "bounced" (tracing.bounce_stages): before stage A,
after A, and for each bounce b after B1.b (the nearest query), B2.b (stage
B2 and the shadow top cull) and C.b (the shadow query, Phong, the colour
accumulated; the last bounce's also the final clamp and assembly) and,
but for the last bounce, after R.b (the reflection rays, their tile hulls
and coarse mask); its `frozen.verify` span carries, beside `rounds`, each
bounce's work-list counts of the frame it returns: `top_cells` (the
(ray tile, top block) cells of its live ray tiles after the top cull,
which set K3n's work) and `hit_tiles` (the ray tiles with a hit, which
set stage B2's and K2's).

A renderer may draw one band of a larger frame (parallel/render_sharded_bvh.py):
`raygen_height` is the full frame's height, which rays project with, and
`set_rays(perm, live)` writes the band's pixel of every ray slot and which
slots are live into the renderer's buffers in place, so frozen graphs that
read them see the new values on their next replay.

`use_mxu=True` runs the shared-origin launches (stage 3 and every shadow
query, bounced ones included) in the tensor-core form of the JAX package's
MXU kernels: a static direction matrix (`bsr_trace.pack_dirs`) and
per-origin scalar rows (`fold_origin_scal`). Every stage reads the scene's
device arrays from one `DeviceScene` bundle passed to it: the renderer's
own, or per-frame diffed copies (ops/render_dynamic.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.camera import CameraArrays
from distributed_raytracer_tpu_torch.models.scene import Scene, SceneArrays
from distributed_raytracer_tpu_torch.ops import (bsr_trace, cull,
                                                frozen_graph, intersect,
                                                raygen, shade, shade_prep)
from distributed_raytracer_tpu_torch.ops.frozen_graph import (bucket_w_pad,
                                                              tile_bucket)
from distributed_raytracer_tpu_torch.ops.intersect import Hits
from distributed_raytracer_tpu_torch.ops.shade import PackedPrep
from distributed_raytracer_tpu_torch.utils import tracing
from distributed_raytracer_tpu_torch.utils.config import (
    DEFAULT_CONFIG, RenderConfig, default_block_size)

# freeze()'s default margin, and the margin render_fast's and
# render_dynamic's checks refreeze at (frozen_graph.Buckets).
FREEZE_MARGIN = 1.4


def _no_mark(point: int) -> None:
    pass


def reflect_rows(cfg: RenderConfig, prep: PackedPrep, rays: torch.Tensor,
                 valid: torch.Tensor):
    """Reflection rays (8, C) and their liveness (C,) from one bounce's
    shading prep: the shading normal mirrors the direction and lifts the
    origin off the surface; dead rays (misses, zero Ks) are live False.
    Shared with the geometry-sharded schedules (parallel/halo_bvh.py)."""
    n = prep.normal
    d = rays[3:6]
    d_dot_n = shade._sum3(d * n)
    refl = shade._normalize_rows(d - 2.0 * d_dot_n[None, :] * n)
    side = torch.where(shade._sum3(n * refl) >= 0.0, 1.0, -1.0)
    o = (prep.x + cfg.shadow_offset * refl
         + (cfg.shadow_normal_offset * side)[None, :] * n)
    return (bsr_trace.pack_rays_rows(o, refl),
            valid & (prep.ks > 0.0).any(dim=0))


class DeviceScene(NamedTuple):
    """The scene arrays on the device that one frame reads. The renderer
    keeps its own (`CulledRenderer.dev_scene`); the dynamic renderer passes
    per-frame diffed copies, never mutating the renderer."""

    arrays: SceneArrays        # slim: lights and material tables
    tris_packed: torch.Tensor  # (T, 16) static pack_tris rows
    tris_dirs: torch.Tensor    # (3T, 8) pack_dirs A (use_mxu), else (0, 8)
    lights_scal: torch.Tensor  # per-light origin folds stacked: (L*T, 8)
    #   fold_origin_scal rows (use_mxu) or (L*T, 16) pack_tris_origin rows
    shade_tbl: torch.Tensor    # (32, T) shading table
    block_lo: torch.Tensor     # (NB, 3) leaf-block AABBs
    block_hi: torch.Tensor


class _Shading(NamedTuple):
    """One ray set's hit-tile compaction, shading prep and shadow masks
    (stage B2's output); compacted shapes are ht_pad * rt."""

    tpos: torch.Tensor         # (nt,) compact position of each hit tile
    hit_tile: torch.Tensor     # (nt,) bool: the tile has a hit
    ht_count: torch.Tensor     # () int32 hit tiles
    rays_h: Optional[torch.Tensor]  # (8, C) compacted rays (keep_rays)
    hits_h: Hits               # compacted hits
    view_h: torch.Tensor       # (3,) camera or (3, C) compacted viewers
    prep: PackedPrep           # q_rev a (L, 8, C) view of (8, L, C)
    live_l: torch.Tensor       # (L, C) bool light gates
    sti: cull.TileIntervals    # stacked (L * C / rt) shadow tile hulls
    smasks: torch.Tensor       # (L, C / rt, n_top) coarse shadow masks
    sentries: torch.Tensor
    sc1: torch.Tensor          # () int32 coarse shadow count


def _slim_arrays(arrays: SceneArrays) -> SceneArrays:
    """Strip the per-triangle fields the culled pipeline never reads (it
    reads the packed rows and the shading table). (T, 0) placeholders keep
    `p0.shape[0]` meaningful; lights and material tables stay real. The
    full host copy lives on as `renderer.arrays_host`."""
    t = arrays.p0.shape[0]
    e2 = np.zeros((t, 0), np.float32)
    e1 = np.zeros((0,), np.float32)
    return arrays._replace(
        p0=e2, e1=e2, e2=e2, geo_n=e2, n0=e2, n1=e2, n2=e2,
        k_u=e2, k_v=e2, plane_d=e1, c_u=e1, c_v=e1,
        mat_id=np.zeros((0,), np.int32))


class CulledRenderer:
    """Per-(scene, resolution) renderer on one explicit device."""

    # Auto early-exit policy: average fine cells per ray tile above which
    # the kernels refresh their front-to-back skip bound every _EXIT_STEP
    # items. The JAX package's thresholds, measured on a TPU; not yet
    # re-measured on the H100.
    _EXIT_DENSITY = 48
    _EXIT_STEP = 32

    def __init__(self, scene: Optional[Scene], width: int, height: int,
                 cfg: RenderConfig = DEFAULT_CONFIG, block_size=128,
                 ray_tile: int = 512, prebaked=None,
                 exit_every: Optional[int] = None, cull_group: int = 16,
                 cull_levels: Optional[int] = None, use_mxu: bool = False,
                 tile_w: Optional[int] = None, *, device):
        # 2D screen tiles of tile_w x rt/tile_w pixels (tile_w 32 unless
        # given): squarer tiles have tighter interval hulls, so they can
        # schedule fewer pairs, at the cost of more tiles.
        self.tile_w = 32 if tile_w is None else tile_w
        if self.tile_w <= 0 or ray_tile % self.tile_w:
            raise ValueError(f"tile_w={self.tile_w} does not divide "
                             f"ray_tile={ray_tile}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {self.device} requested but "
                                   "CUDA is not available")
            # Full float32 on the hit path. (No product on the path uses
            # TF32 today; the call makes the intent explicit for any later
            # one.)
            intersect.fp32_matmuls(self.device)
        if block_size == "auto":
            block_size = default_block_size(
                scene.num_tris if scene is not None else 1 << 30)
        self.width, self.height, self.cfg = width, height, cfg
        # The frame height rays project with: the band renderers of
        # parallel/render_sharded_bvh.py set the full frame's.
        self.raygen_height = height
        self.rt, self.tb = ray_tile, block_size
        # Amortized front-to-back early exit of the traversal kernels:
        # refresh the per-tile bound every `exit_every` work items; 0 = off;
        # None = decided from the first sizing render's work density.
        self._exit_auto = exit_every is None
        self.exit_every = 0 if exit_every is None else exit_every
        # Kernel form of the shared-origin launches: False = the (T, 16)
        # pack_tris_origin rows on the CUDA cores (K1, K2); True = the
        # direction dots on the tensor cores (K4, K5).
        self.use_mxu = use_mxu

        # `prebaked` = (SceneArrays, BlockBVH), e.g. models.scene
        # .from_reference of the JAX package's bake; its leaf size wins.
        # block_layout: the leaf-block layout of the renderer's own bake,
        # "global" or "object" (Scene.bake_blocks); None when prebaked.
        self.block_layout = None
        if prebaked is not None:
            arrays, tree = prebaked
            self.tb = block_size = int(tree.block_size)
        else:
            arrays, tree = self._bake_scene(scene, block_size)
        self.arrays_host: SceneArrays = arrays
        self.tree = tree
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        tris16_np = bsr_trace.pack_tris(arrays)
        self.n_tris = int(arrays.p0.shape[0])
        slim = SceneArrays(*(put(a) for a in _slim_arrays(arrays)))
        tris_packed = put(tris16_np)
        # Shading table (32, T), assembled on the device from the packed
        # rows, p0, the vertex normals (smooth bakes only) and mat_id.
        flat_bake = (np.array_equal(arrays.n0, arrays.geo_n)
                     and np.array_equal(arrays.n1, arrays.geo_n)
                     and np.array_equal(arrays.n2, arrays.geo_n))
        p0_t = put(np.asarray(arrays.p0, np.float32).T)
        n_t = None if flat_bake else put(np.concatenate(
            [np.asarray(arrays.n0, np.float32).T,
             np.asarray(arrays.n1, np.float32).T,
             np.asarray(arrays.n2, np.float32).T]))
        shade_tbl = shade.table_rows_device(
            tris_packed, p0_t, n_t, put(arrays.mat_id), slim.mat_ka,
            slim.mat_kd, slim.mat_ks, slim.mat_ns)
        # The tensor-core form's direction matrix is static: it holds only
        # translation-invariant direction coefficients.
        tris_dirs = (put(bsr_trace.pack_dirs(tris16_np, self.tb))
                     if use_mxu else tris_packed.new_zeros((0, 8)))
        self.dev_scene = DeviceScene(
            arrays=slim, tris_packed=tris_packed, tris_dirs=tris_dirs,
            lights_scal=self._fold_lights(tris_packed, slim.light_pos),
            shade_tbl=shade_tbl, block_lo=put(tree.block_lo),
            block_hi=put(tree.block_hi))
        # Hierarchy depth: one grouping level normally; two when the
        # superblock count itself is large. `cull_levels` (2 or 3)
        # overrides the automatic choice.
        nsb = -(-tree.num_blocks // cull_group)
        if cull_levels is None:
            cull_levels = 3 if nsb > 768 else 2
        self.groups = (cull_group,) * (cull_levels - 1)
        # Count-vector layout: per-level primary counts (top mask count +
        # one per expansion), the hit-tile count, then the shadow counts in
        # the same level layout.
        self.n_levels = len(self.groups) + 1

        self.tile_h = ray_tile // self.tile_w
        perm, _, n_slots = cull.tiled_ray_order(width, height, self.tile_w,
                                                self.tile_h)
        # Flat pixel index of every ray slot, and (None = all live) the
        # slots whose rays count: buffers written in place (set_rays).
        self._perm = put(perm.astype(np.int64))
        self._live = None
        self.n_pad = n_slots
        self.n_tiles = self.n_pad // ray_tile
        self._no_excl = torch.full((self.n_pad,), -1, dtype=torch.int32,
                                   device=dev)
        # The frozen buckets (the hit-TILE count after the primary levels).
        self._buckets = frozen_graph.Buckets(
            FREEZE_MARGIN, hit=self.n_levels, n_tiles=self.n_tiles,
            on_grow=self._regrown)
        # Raw counts of the last sync render, in the count-vector layout.
        self._last_counts = None
        # CUDA graphs of the frozen frames, one per kind ("fast",
        # "bounced", "dynamic"; ops/frozen_graph.py).
        self._graphs = {}
        # The frames' stamps by (kind, points), each made when the tracer
        # first marks it, and the band's rank they are named by
        # (parallel/render_sharded_bvh.py).
        self._stamps = {}
        self.rank = None

    def _bake_scene(self, scene: Scene, block_size: int):
        """Bake hook: the layout Scene.bake_blocks picks by its summed
        block areas; the dynamic renderer (ops/render_dynamic.py)
        overrides it to group leaf blocks per object always."""
        arrays, tree, self.block_layout = scene.bake_blocks(block_size)
        return arrays, tree

    def _fold_lights(self, tris_packed: torch.Tensor,
                     light_pos: torch.Tensor) -> torch.Tensor:
        """Shadow rays are reversed to start at their light, so each
        light's rays share one origin: per-light origin folds of the static
        rows (fold_origin_scal under use_mxu, else pack_tris_origin),
        stacked to (L*T, 8 or 16); block ids with a light*nb offset index
        straight into light l's rows."""
        fold = (bsr_trace.fold_origin_scal if self.use_mxu
                else bsr_trace.pack_tris_origin)
        if light_pos.shape[0] == 0:
            return tris_packed.new_zeros((0, 8 if self.use_mxu else 16))
        return torch.cat([fold(tris_packed, light_pos[li])
                          for li in range(light_pos.shape[0])])

    def set_rays(self, perm, live=None) -> None:
        """Writes the flat pixel index of every ray slot ((n_pad,) ints, of
        a raygen_height-high frame) and the live slots ((n_pad,) bool, or
        None for all) into the renderer's buffers in place, on the current
        stream. Dead slots drop out of the cull's tile hulls, so a tile
        of dead rays costs no work."""
        self._perm.copy_(torch.as_tensor(perm).reshape(self.n_pad))
        if live is None:
            self._live = None
        elif self._live is None:
            self._live = torch.as_tensor(live).to(self.device).reshape(
                self.n_pad).clone()
        else:
            self._live.copy_(torch.as_tensor(live).reshape(self.n_pad))

    # -- helpers ---------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _visited_rays(self, wl: cull.WorkList, n_tiles: int) -> torch.Tensor:
        v = cull.visited_tiles(wl, n_tiles)
        return v[:, None].expand(n_tiles, self.rt).reshape(-1)

    def _assemble(self, rows: torch.Tensor) -> torch.Tensor:
        """(3, n_pad) tile-major colour rows -> (H, W, 3) row-major frame
        (slot s = ((tj*tx + ti)*th + wj)*tw + wi, the cull.tiled_ray_order
        layout): a reshape and a permute, not a gather."""
        tw, th = self.tile_w, self.tile_h
        tx, ty = -(-self.width // tw), -(-self.height // th)
        img = rows.reshape(3, ty, tx, th, tw).permute(1, 3, 2, 4, 0)
        img = img.reshape(ty * th, tx * tw, 3)
        return img[:self.height, :self.width]

    # -- stage A: primary rays + cull ------------------------------------

    def _stage_a(self, sc: DeviceScene, cam: CameraArrays):
        d_rows = raygen.ray_rows_flat(cam, self.width, self.raygen_height,
                                      self._perm)
        rays = bsr_trace.pack_rays_rows(cam.pos, d_rows)
        ti = cull.tile_intervals_packed(rays, self.rt, live=self._live)
        mask1, entry1, c1 = cull.multilevel_mask(ti, sc.block_lo,
                                                 sc.block_hi, self.groups)
        return rays, ti, mask1, entry1, c1

    def _size_pads(self, sc: DeviceScene, ti, mask, entry, c_top):
        """Walk the hierarchy with one host sync per level: returns
        (pads tuple len n_levels, counts tuple len n_levels). `mask` and
        `entry` may carry a leading light axis."""
        if mask.numel() == 0:   # no lights: no shadow work at any level
            return ((bucket_w_pad(0),) * self.n_levels,
                    (0,) * self.n_levels)
        m = mask.reshape(-1, mask.shape[-1])
        e = entry.reshape(-1, entry.shape[-1])
        counts = [int(c_top)]
        pads = [bucket_w_pad(counts[0])]
        for _ in range(len(self.groups)):
            _, c = cull.multilevel_worklist(ti, m, e, c_top, sc.block_lo,
                                            sc.block_hi, self.groups,
                                            tuple(pads))
            counts.append(int(c[-1]))
            pads.append(bucket_w_pad(counts[-1]))
        return tuple(pads), tuple(counts)

    def per_tile_cells(self, camera) -> torch.Tensor:
        """(n_tiles,) int32 on the device: the fine-level cull cells of
        every ray tile for `camera`, the per-tile work that the balanced
        band split sums per tile row (parallel/render_sharded_bvh.py). One
        host sync per level, as render() sizes."""
        sc, cam = self.dev_scene, raygen.camera_arrays(camera, self.device)
        _, ti, mask1, entry1, c1 = self._stage_a(sc, cam)
        pads, _ = self._size_pads(sc, ti, mask1, entry1, c1)
        wl, _ = cull.multilevel_worklist(ti, mask1, entry1, c1, sc.block_lo,
                                         sc.block_hi, self.groups, pads)
        real = (torch.arange(pads[-1], device=self.device)
                < wl.count).to(torch.int32)
        return torch.zeros(self.n_tiles, dtype=torch.int32,
                           device=self.device).index_add_(
                               0, wl.tile_ids.long(), real)

    # -- stage B: nearest hit + shadow masks -----------------------------

    def _nearest(self, sc: DeviceScene, pads: tuple, tris, rays, exclude,
                 ti, mask1, entry1, c1, shared_origin: bool = False):
        """Multi-level compaction + BSR nearest. Returns (hits, hit-tile
        count, per-level counts).

        Results are masked by the EXACT visited tile set: unvisited means
        the cull proved no block can be hit. With shared_origin, `tris` is
        the pack_tris_origin fold for rays[0:3, 0] (or the (A, scal) tuple
        of the tensor-core form); otherwise the static rows, and every ray
        brings its own origin."""
        wl, counts = cull.multilevel_worklist(ti, mask1, entry1, c1,
                                              sc.block_lo, sc.block_hi,
                                              self.groups, pads)
        best_t, best_i = bsr_trace.bsr_nearest(
            rays, exclude, tris, wl.tile_ids, wl.block_ids, wl.entry,
            wl.count, rt=self.rt, tb=self.tb, shared_origin=shared_origin,
            exit_every=self.exit_every)
        best_t = torch.where(self._visited_rays(wl, self.n_tiles), best_t,
                             float("inf"))
        hits = Hits(t=best_t, tri=torch.clamp(best_i, max=self.n_tris - 1),
                    valid=torch.isfinite(best_t))
        ht = hits.valid.reshape(self.n_tiles, self.rt).any(dim=1)
        return hits, ht.sum(dtype=torch.int32), counts

    def _stage_b1(self, sc: DeviceScene, pads: tuple, rays, ti, mask1,
                  entry1, c1):
        """Primary nearest hit. Primary rays share the camera origin, folded
        into the triangle rows (or, under use_mxu, the scalar rows beside
        the static direction matrix) each frame for the shared-origin
        kernel."""
        if self.use_mxu:
            tris_cam = (sc.tris_dirs,
                        bsr_trace.fold_origin_scal(sc.tris_packed,
                                                   rays[0:3, 0]))
        else:
            tris_cam = bsr_trace.pack_tris_origin(sc.tris_packed,
                                                  rays[0:3, 0])
        return self._nearest(sc, pads, tris_cam, rays, self._no_excl, ti,
                             mask1, entry1, c1, shared_origin=True)

    def _stage_b2(self, sc: DeviceScene, ht_pad: int, rays, hits,
                  view, keep_rays: bool = False) -> _Shading:
        """Hit-TILE compaction + shading prep + per-light shadow masks.

        Everything downstream of the nearest kernel is proportional to the
        hit count, not the ray count, so it runs on the compacted set of
        ray tiles that hit anything (ht_pad of them; ht_pad is capped at
        n_tiles, so overflow is impossible when every tile hits). `view` is
        the viewer of the light gates and the shading: the (3,) camera for
        primary rays, the (3, n_pad) previous hit points for a bounce's
        reflection rays (compacted alongside). The compacted rays are kept
        only with `keep_rays` (a bounce's reflection rays read them).

        The tile order is sorted here; the per-ray work is
        shade_prep.prep_tiles: on CUDA one kernel (its launches counted in
        tracing.COUNTS["shade_prep"]), on the CPU its plain version."""
        hit_tile, tidx, ht_count, tpos = self._tile_order(ht_pad, hits)
        n_lights = sc.arrays.light_pos.shape[0]
        tp = shade_prep.prep_tiles(rays, hits, tidx, ht_count, sc.arrays,
                                   sc.shade_tbl, view, self.cfg, rt=self.rt,
                                   keep_rays=keep_rays)
        smasks, sentries, sc1 = self._light_masks(sc, tp.sti, n_lights,
                                                  ht_pad)
        return _Shading(tpos, hit_tile, ht_count, tp.rays_h, tp.hits_h,
                        tp.view_h, tp.prep, tp.live_l, tp.sti, smasks,
                        sentries, sc1)

    def _tile_order(self, ht_pad: int, hits):
        """The order-preserving hit-TILE compaction's order: (hit_tile
        (nt,) bool, tidx (ht_pad,) the source tile of each compacted tile,
        hit tiles first, ht_count () int32, tpos (nt,) the compact position
        of each hit tile)."""
        hit_tile = hits.valid.reshape(self.n_tiles, self.rt).any(dim=1)
        tidx = torch.argsort((~hit_tile).to(torch.uint8),
                             stable=True)[:ht_pad]
        return (hit_tile, tidx, hit_tile.sum(dtype=torch.int32),
                torch.cumsum(hit_tile, 0) - 1)

    def _gather_tiles(self, rows_h, tpos, hit_tile, fill=0.0):
        """Tile-granular write-back: compacted (..., ht_pad * rt) rows ->
        full-grid (..., n_pad); output tile j reads compact tile tpos[j] if
        it had any hit, else `fill`."""
        rt = self.rt
        ht_pad = rows_h.shape[-1] // rt
        src = torch.clamp(tpos, 0, ht_pad - 1)
        if rows_h.dim() == 1:
            out = rows_h.reshape(ht_pad, rt)[src]
            return torch.where(hit_tile[:, None], out,
                               fill).reshape(self.n_pad)
        out = rows_h.reshape(rows_h.shape[0], ht_pad, rt)[:, src, :]
        return torch.where(hit_tile[None, :, None], out,
                           fill).reshape(rows_h.shape[0], self.n_pad)

    def _light_masks(self, sc: DeviceScene, sti: cull.TileIntervals,
                     n_lights: int, nt: int):
        """Per-light coarse cull masks (L, nt, n_top), entries and their
        count for the shadow queries, from the stacked (L*nt) tile hulls
        (light-major), which the finer levels test against. Dead rays
        (misses, and rays this light provably cannot colour) are out of the
        hulls, so they never widen the work lists. One cull over all
        lights' tiles: its rows are independent."""
        if not n_lights:
            ntop = sc.block_lo.shape[0]
            for g in self.groups:
                ntop = -(-ntop // g)
            return (torch.zeros((0, nt, ntop), dtype=torch.bool,
                                device=self.device),
                    sc.block_lo.new_zeros((0, nt, ntop)),
                    torch.zeros((), dtype=torch.int32, device=self.device))
        m, e, count = cull.multilevel_mask(sti, sc.block_lo, sc.block_hi,
                                           self.groups)
        return (m.reshape(n_lights, nt, -1), e.reshape(n_lights, nt, -1),
                count)

    # -- stage C: shadow queries + shading -------------------------------

    def _lit(self, sc: DeviceScene, s_pads: tuple, sh: _Shading):
        """All lights' shadow queries in ONE bsr_any launch: the (light,
        tile) pairs are the tile axis of a single multi-level work list.
        Dead rays pre-seed the accumulator as 'hit' so fully-occluded tiles
        exit on live rays alone. Returns (lit (L, R) bool, shadow
        expansion counts)."""
        prep = sh.prep
        n_lights = prep.q.shape[0]
        if n_lights == 0:
            return (torch.zeros((0, prep.x.shape[1]), dtype=torch.bool,
                                device=self.device),
                    (torch.zeros((), dtype=torch.int32,
                                 device=self.device),) * len(self.groups))
        r = prep.q_rev.shape[2]
        n_tiles = r // self.rt
        nb = sc.block_lo.shape[0]
        mask = sh.smasks.reshape(n_lights * n_tiles, -1)
        entry = sh.sentries.reshape(n_lights * n_tiles, -1)
        wl, s_counts = cull.multilevel_worklist(sh.sti, mask, entry, sh.sc1,
                                                sc.block_lo, sc.block_hi,
                                                self.groups, s_pads)
        # q_rev's storage is (8, L, r): a view, not a copy.
        q = prep.q_rev.permute(1, 0, 2).reshape(8, n_lights * r)
        # Light l's origin-folded rows sit at block offset l * nb; the
        # tensor-core form's direction matrix is shared by all lights
        # (ablock_ids index it without the offset).
        light_of = torch.div(wl.tile_ids, n_tiles, rounding_mode="floor")
        block_ids = light_of * nb + wl.block_ids
        excl = (sh.hits_h.tri[None, :]
                + (torch.arange(n_lights, dtype=torch.int32,
                                device=self.device) * self.n_tris)[:, None]
                ).reshape(-1)
        dead = (~sh.live_l).reshape(-1).to(torch.int32)
        if self.use_mxu:
            tris, a_ids = (sc.tris_dirs, sc.lights_scal), wl.block_ids
        else:
            tris, a_ids = sc.lights_scal, None
        hit = bsr_trace.bsr_any(
            q, excl, tris, wl.tile_ids, block_ids, wl.entry, wl.count, dead,
            ablock_ids=a_ids, rt=self.rt, tb=self.tb, shared_origin=True,
            exit_every=self.exit_every)
        visited = self._visited_rays(wl, n_lights * n_tiles)
        lit = torch.where(visited, hit == 0, True).reshape(n_lights, r)
        return lit, s_counts

    def _stage_shade(self, sc: DeviceScene, s_pads: tuple, sh: _Shading):
        """Shadow queries + Phong on the COMPACTED tile set -> ((3, C)
        local radiance rows, shadow counts)."""
        lit, s_counts = self._lit(sc, s_pads, sh)
        return (shade.shade_core_packed(sc.arrays, sh.view_h, sh.prep,
                                        sh.hits_h, lit), s_counts)

    def _stage_c(self, sc: DeviceScene, s_pads: tuple, sh: _Shading):
        """Stage C of the primary frame: the shaded compact tiles written
        back tile by tile and assembled. Returns (image, shadow counts)."""
        colours_h, s_counts = self._stage_shade(sc, s_pads, sh)
        return (self._assemble(self._gather_tiles(colours_h, sh.tpos,
                                                  sh.hit_tile)), s_counts)

    # -- public ----------------------------------------------------------

    def _resolve_exit(self, c2: int) -> None:
        """Pick exit_every from the measured primary work density (only in
        auto mode)."""
        if self._exit_auto:
            dense = c2 / max(self.n_tiles, 1) >= self._EXIT_DENSITY
            self.exit_every = self._EXIT_STEP if dense else 0

    def render(self, camera, block: bool = False) -> torch.Tensor:
        """Render a frame with exactly sized work lists (a few host syncs);
        returns an (H, W, 3) float32 tensor on the renderer's device."""
        sc, cam = self.dev_scene, raygen.camera_arrays(camera, self.device)
        rays, ti, mask1, entry1, c1 = self._stage_a(sc, cam)
        p_pads, p_counts = self._size_pads(sc, ti, mask1, entry1, c1)
        self._resolve_exit(p_counts[-1])
        hits, hcount, _ = self._stage_b1(sc, p_pads, rays, ti, mask1, entry1,
                                         c1)
        ht_pad = tile_bucket(int(hcount), self.n_tiles)
        sh = self._stage_b2(sc, ht_pad, rays, hits, cam.pos)
        s_pads, s_counts = self._size_pads(sc, sh.sti, sh.smasks,
                                           sh.sentries, sh.sc1)
        img, _ = self._stage_c(sc, s_pads, sh)
        self._last_counts = p_counts + (int(sh.ht_count),) + s_counts
        if block:
            self._sync()
        return img

    # -- frozen fast path ------------------------------------------------
    #
    # The sync render pays host round trips to size the work lists
    # exactly. freeze() fixes the buckets (last observed counts x a safety
    # margin) and render_fast() runs every stage with them and no host
    # sync. Work-list overflow would drop candidate blocks, so
    # render_fast(verify=True) checks the true counts and refreezes on
    # overflow: at once, or at the frame's drain inside the frame loop.

    def _marks(self, kind: str = "stages", points: int = 5):
        """mark(point) of a frame's stamps of `kind` ("stages", "bounced",
        "fold"): the renderer's tracing.Stamps of that kind and row length
        while the tracer is on, else nothing."""
        if not tracing.enabled():
            return _no_mark
        key = (kind, points)
        if key not in self._stamps:
            self._stamps[key] = tracing.Stamps(self.device, points=points,
                                               kind=kind, rank=self.rank)
        return self._stamps[key].mark

    def _full(self, sc: DeviceScene, pads: tuple, cam: CameraArrays):
        """All stages with fixed buckets; pads layout == the counts layout.
        Returns (image, int32 counts on the device)."""
        nl = self.n_levels
        p_pads, h_pad, s_pads = pads[:nl], pads[nl], pads[nl + 1:]
        mark = self._marks()
        mark(0)
        rays, ti, mask1, entry1, c1 = self._stage_a(sc, cam)
        mark(1)
        hits, _, p_counts = self._stage_b1(sc, p_pads, rays, ti, mask1,
                                           entry1, c1)
        mark(2)
        sh = self._stage_b2(sc, h_pad, rays, hits, cam.pos)
        mark(3)
        img, s_counts = self._stage_c(sc, s_pads, sh)
        mark(4)
        counts = torch.stack([c1, *p_counts, sh.ht_count, sh.sc1,
                              *s_counts])
        return img, counts

    def freeze(self, camera=None, margin: float = FREEZE_MARGIN) -> None:
        """Fix work-list buckets from the last sync render (running one if
        needed). Buckets only grow."""
        if self._last_counts is None:
            if camera is None:
                raise ValueError("freeze() needs a camera for the sizing "
                                 "render")
            self.render(camera, block=True)
        self._buckets.grow(self._last_counts, margin)

    def _regrown(self, counts) -> None:
        """A check's refreeze counts become the counts the next freeze()
        sizes from, as in the JAX package."""
        self._last_counts = tuple(counts)

    def buckets(self) -> Optional[tuple]:
        """The frozen work-list buckets (the counts layout), None before
        the first freeze."""
        return self._buckets.pads

    def render_fast(self, camera, verify: bool = False) -> torch.Tensor:
        """All stages with the frozen buckets and no host sync; returns the
        (H, W, 3) tensor. With verify=True, checks the true counts and, if
        a bucket overflowed, refreezes and renders again — in a loop, since
        an overflowed level truncates the next level's reported count.
        The check runs before the call returns, except inside the frame
        loop (runtime/loop.run_loop), which runs it when it drains the
        frame, before the frame is displayed, and issues the frame and
        those behind it again if the buckets grew (ops/frozen_graph.py)."""
        if self.buckets() is None:
            self.freeze(camera)
        frame = self._frozen_frame(
            "fast", {"camera": raygen.camera_packed(camera)}, self._fast_body)
        return self._render_frozen(frame, camera, verify, "render_fast")

    def _fast_body(self, bufs: dict, pads: tuple):
        return self._full(self.dev_scene, pads,
                          raygen.camera_views(bufs["camera"]))

    def render_many(self, cameras):
        """Renders a batch of poses with the frozen buckets (freezing on
        cameras[0] if nothing is frozen): each image equals render_fast's
        for its pose bit for bit. `cameras` are Cameras or host
        CameraArrays, stacked on the host and sent in one copy. Returns
        (imgs (K, H, W, 3), counts (K, n_counts)) on the device; callers
        check the counts against the buckets as render_fast(verify=True)
        does.

        On CUDA the batch is K replays of render_fast's graph, each fed its
        pose by a device-to-device copy from the stack: one graph launch
        per frame (the JAX package unrolls the batch into one dispatch to
        the same end). On the CPU, K eager frames."""
        if self.buckets() is None:
            self.freeze(cameras[0])
        stack = raygen.to_device(torch.stack(
            [raygen.camera_packed(c) for c in cameras]), self.device)
        frames = [self._frozen_frame("fast", {"camera": cam},
                                     self._fast_body)(self.buckets())
                  for cam in stack]
        return (torch.stack([f[0] for f in frames]),
                torch.stack([f[1] for f in frames]))

    def release_graphs(self) -> None:
        """Frees every captured frozen frame and its memory pool."""
        for graph in self._graphs.values():
            graph.release()
        self._graphs = {}

    def _graph_key(self, kind: str, pads) -> tuple:
        """Everything that shapes a frozen frame's graph."""
        return (kind, pads, self.exit_every, self.use_mxu,
                self._live is not None, tracing.enabled())

    def _frame_graph(self, kind: str, inputs: dict) -> frozen_graph.FrameGraph:
        """The graph of one frozen frame kind, its static inputs shaped
        like `inputs` (name -> tensor)."""
        graph = self._graphs.get(kind)
        if graph is None:
            graph = self._graphs[kind] = frozen_graph.FrameGraph(
                self.device, {k: (tuple(v.shape), v.dtype)
                              for k, v in inputs.items()}, kind=kind)
        return graph

    def _frozen_frame(self, kind: str, inputs: dict, body):
        """frame(pads) -> (image, counts) of one frozen frame: body(bufs,
        pads) runs the stages on the input tensors `bufs` (name -> device
        tensor, from `inputs`: host or device tensors). On CUDA each call
        writes the inputs into the graph's static buffers (pinned,
        non-blocking), replays the graph of (kind, pads) and returns fresh
        copies of its outputs, so a call made after other frames have
        replayed the graph still renders this frame's inputs (a deferred
        verify check renders again that way); on the CPU each call runs
        body eagerly."""
        if self.device.type != "cuda":
            bufs = {k: raygen.to_device(v, self.device)
                    for k, v in inputs.items()}
            return lambda pads: body(bufs, pads)
        graph = self._frame_graph(kind, inputs)

        def frame(pads):
            for k, v in inputs.items():
                frozen_graph.write(graph.inputs[k], v)
            return frozen_graph.fresh(graph.run(
                self._graph_key(kind, pads),
                lambda: body(graph.inputs, pads)))
        return frame

    def _render_frozen(self, frame, camera, verify: bool,
                       name: str) -> torch.Tensor:
        """One frozen frame, frame(pads) -> (image, counts), with the
        bucket check of a verify frame (frozen_graph.verify: at once, or
        at the frame's drain inside the frame loop; `name` labels its span
        and its warning)."""
        img, counts = frame(self.buckets())
        if not verify:
            return img
        return self._buckets.check(img, counts,
                                   lambda: frame(self.buckets()), name,
                                   self.device.index).out

    # -- multi-bounce path -----------------------------------------------
    #
    # Whitted reflections on the block-sparse path (the JAX package's
    # render_bvh.py:566-829; semantics identical to its dense
    # render_frame_bounced and the float64 oracle's _radiance). Bounce b is
    # one more nearest query over bounce b-1's reflection rays, each with
    # its own origin (the per-ray-origin kernel, for bounce 0's primary
    # rays too, as in the JAX package), plus the all-lights shadow query
    # (reversed to the light: shared origin). The radiance accumulates as
    # colour += throughput * phong_b with one clamp at the end.

    def _reflect_from(self, sh: _Shading):
        """Full-grid reflection rays (8, n_pad) and liveness (n_pad,) from
        one bounce's compacted shading prep: the shading normal mirrors the
        direction and lifts the origin off the surface; dead rays (misses,
        zero Ks, non-hit tiles) are zeros with live=False, which cull
        away."""
        r_rays_h, r_live_h = reflect_rows(self.cfg, sh.prep, sh.rays_h,
                                          sh.hits_h.valid)
        return (self._gather_tiles(r_rays_h, sh.tpos, sh.hit_tile),
                self._gather_tiles(r_live_h, sh.tpos, sh.hit_tile,
                                   fill=False))

    def _bounce(self, sc: DeviceScene, sh: _Shading, hits, throughput):
        """The next bounce's query from this one's shading: (rays, tile
        hulls, coarse mask, entry, count, exclude ids, viewer,
        throughput)."""
        rays, live = self._reflect_from(sh)
        ti = cull.tile_intervals_packed(rays, self.rt, live=live)
        mask1, entry1, c1 = cull.multilevel_mask(ti, sc.block_lo,
                                                 sc.block_hi, self.groups)
        ks = self._gather_tiles(sh.prep.ks, sh.tpos, sh.hit_tile)
        throughput = torch.where(hits.valid[None, :], throughput * ks, 0.0)
        view = self._gather_tiles(sh.prep.x, sh.tpos, sh.hit_tile)
        return rays, ti, mask1, entry1, c1, hits.tri, view, throughput

    def render_bounced(self, camera, depth: int,
                       block: bool = False) -> torch.Tensor:
        """Whitted multi-bounce render (primary rays + `depth` reflection
        bounces) with exactly sized work lists (host syncs per level and
        bounce); returns the (H, W, 3) tensor. Records the buckets and raw
        counts of every bounce in `_last_bounce_pads` / `_last_bounce_counts`
        (per bounce, the counts layout of render())."""
        if depth < 0:
            raise ValueError(f"depth={depth}: must be >= 0")
        sc, cam = self.dev_scene, raygen.camera_arrays(camera, self.device)
        rays, ti, mask1, entry1, c1 = self._stage_a(sc, cam)
        colour = rays.new_zeros((3, self.n_pad))
        throughput = rays.new_ones((3, self.n_pad))
        view, exclude = cam.pos, self._no_excl
        pads_used, counts_used = [], []
        for b in range(depth + 1):
            p_pads, p_counts = self._size_pads(sc, ti, mask1, entry1, c1)
            if b == 0:
                # Decided once, from primary density; every bounce uses it.
                self._resolve_exit(p_counts[-1])
            hits, hcount, _ = self._nearest(sc, p_pads, sc.tris_packed, rays,
                                            exclude, ti, mask1, entry1, c1)
            ht_pad = tile_bucket(int(hcount), self.n_tiles)
            sh = self._stage_b2(sc, ht_pad, rays, hits, view,
                                keep_rays=b < depth)
            s_pads, s_counts = self._size_pads(sc, sh.sti, sh.smasks,
                                               sh.sentries, sh.sc1)
            pads_used.append(p_pads + (ht_pad,) + s_pads)
            # Raw (unbucketed) counts: freeze_bounced applies its margin to
            # these, never to already-rounded pads.
            counts_used.append(p_counts + (int(sh.ht_count),) + s_counts)
            local_h, _ = self._stage_shade(sc, s_pads, sh)
            colour = colour + throughput * self._gather_tiles(
                local_h, sh.tpos, sh.hit_tile)
            if b < depth:
                (rays, ti, mask1, entry1, c1, exclude, view,
                 throughput) = self._bounce(sc, sh, hits, throughput)
        img = self._assemble(torch.clamp(colour, 0.0, 1.0))
        self._last_bounce_pads = tuple(pads_used)
        self._last_bounce_counts = tuple(counts_used)
        if block:
            self._sync()
        return img

    def _full_bounced(self, pads: tuple, cam: CameraArrays):
        """The multi-bounce pipeline with fixed buckets (no host sync).
        `pads` holds one bucket vector per bounce (the counts layout).
        Returns (image, (B, 2*n_levels + 1) int32 true counts on the
        device), so callers can check the buckets and refreeze on overflow
        instead of silently dropping candidate blocks. Bounce b's stamps
        are points 2 + 4b (after B1.b) to 5 + 4b (after R.b)."""
        nl, sc = self.n_levels, self.dev_scene
        mark = self._marks("bounced", 4 * len(pads) + 1)
        mark(0)
        rays, ti, mask1, entry1, c1 = self._stage_a(sc, cam)
        mark(1)
        colour = rays.new_zeros((3, self.n_pad))
        throughput = rays.new_ones((3, self.n_pad))
        view, exclude = cam.pos, self._no_excl
        counts = []
        for b, b_pads in enumerate(pads):
            p_pads, ht_pad, s_pads = b_pads[:nl], b_pads[nl], b_pads[nl + 1:]
            hits, _, p_counts = self._nearest(sc, p_pads, sc.tris_packed,
                                              rays, exclude, ti, mask1,
                                              entry1, c1)
            mark(2 + 4 * b)
            sh = self._stage_b2(sc, ht_pad, rays, hits, view,
                                keep_rays=b + 1 < len(pads))
            mark(3 + 4 * b)
            local_h, s_counts = self._stage_shade(sc, s_pads, sh)
            colour = colour + throughput * self._gather_tiles(
                local_h, sh.tpos, sh.hit_tile)
            counts.append(torch.stack([c1, *p_counts, sh.ht_count, sh.sc1,
                                       *s_counts]))
            if b + 1 < len(pads):
                mark(4 + 4 * b)
                (rays, ti, mask1, entry1, c1, exclude, view,
                 throughput) = self._bounce(sc, sh, hits, throughput)
                mark(5 + 4 * b)
        img = self._assemble(torch.clamp(colour, 0.0, 1.0))
        mark(4 * len(pads))
        return img, torch.stack(counts)

    def _bounce_counts(self, counts) -> dict:
        """The per-bounce work-list counts a bounced frame's verify span
        carries, from its (B, 2*n_levels + 1) host counts."""
        return {"top_cells": [int(row[0]) for row in counts],
                "hit_tiles": [int(row[self.n_levels]) for row in counts]}

    def freeze_bounced(self, camera, depth: int, margin: float = 1.4):
        """Fix per-bounce buckets from one sync render_bounced's RAW counts
        x margin. Returns render(cam, verify=False) -> (H, W, 3) tensor,
        which runs the bounced pipeline with no host sync (on CUDA a replay
        of its graph, keyed by the per-bounce buckets); verify=True checks
        the true per-bounce counts, refreezing (grow-only) and rendering
        again until they fit, at most 8 rounds, as render_fast's check
        does (at once, or at the frame's drain inside the frame loop).
        `render.pads()` gives the current buckets."""
        self.render_bounced(camera, depth, block=True)
        buckets = frozen_graph.Buckets(margin, hit=self.n_levels,
                                       n_tiles=self.n_tiles)
        buckets.grow(self._last_bounce_counts)

        def render(cam, verify: bool = False) -> torch.Tensor:
            tracing.COUNTS["bounced_frames"] += 1
            frame = self._frozen_frame(
                "bounced", {"camera": raygen.camera_packed(cam)},
                lambda bufs, pads: self._full_bounced(
                    pads, raygen.camera_views(bufs["camera"])))
            img, counts = frame(buckets.pads)
            if not verify:
                return img
            # Every bounce's counts must fit, and the check loops: an
            # overflowed level truncates the next level's list, so its
            # reported count is an undercount and one refreeze is not
            # enough.
            return buckets.check(img, counts, lambda: frame(buckets.pads),
                                 "bounced", self.device.index,
                                 attrs=self._bounce_counts).out

        render.pads = lambda: buckets.pads
        return render
