"""Band-sharded block-sparse rendering: the culled frame split by rows.

The torch counterpart of distributed_raytracer_tpu/parallel/render_sharded_bvh.py.
Each rank owns a horizontal band of the frame and runs the whole culled
pipeline of ops/render_bvh.py (cull, nearest, shadows, shading) on its own
rays against the whole scene, replicated on every rank (registrar.go:41-47
ships the full scene to every worker). No collective runs inside a frame;
the bands are gathered at the end, as the reference's master reassembles
its workers' tiles.

Every rank has a CulledRenderer of its own on its own device, all built
from ONE bake, each holding its band's ray permutation (and, for balanced
bands, its live slots) in buffers written in place (CulledRenderer
.set_rays). Bands project with the full frame's field of view
(`raygen_height`). All ranks run with common work-list buckets, sized by a
sync render of every band at build time, maxed over the bands and padded
by `margin`; every frame also returns its true per-band counts, and
render(cam, verify=True) refreezes (grow-only, up to 8 rounds) until they
fit, so a camera outside the sizing margin never drops candidate blocks
(master/main.go:153-161): before the call returns, or, inside the frame
loop in one process, when the loop drains the frame
(ops/frozen_graph.verify). On CUDA a rank's frame is one replay of its
renderer's frozen graph (ops/frozen_graph.py) on the rank's stream.

Three constructors, as in the JAX package: equal bands
(make_sharded_culled_renderer), cost-balanced band heights
(balance=True, make_balanced_culled_renderer) and bounced bands
(make_sharded_bounced_renderer).

Over a multi-process mesh (parallel/multihost.py) each process builds and
runs the bands of its own ranks, and the frame comes home to process 0
(None elsewhere). Every process must freeze the same buckets, or the
collectives' shapes differ: the build-time sizing maxes its counts over
the processes, every frame's per-band counts reach every process, so the
verify loop's refreeze is one decision taken alike everywhere, and the
balanced split is struck on process 0 (rank 0's band probes the costs)
and broadcast. The collectives stay outside the CUDA graphs: each rank
replays its graph, then the bands are gathered.

While the tracer is on (utils/tracing.py), each rank's replay is the span
`bands.replay` (attribute `rank`), the gather `bands.gather` and the
verify check `frozen.verify`; each band's frame marks its stage stamps
(named by its rank), and the assembled frame one more stamp on rank 0's
card (kind "gather") once the gather has run.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import Scene
from distributed_raytracer_tpu_torch.ops import cull, frozen_graph, raygen
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
from distributed_raytracer_tpu_torch.parallel import tile as tile_mod
from distributed_raytracer_tpu_torch.utils import tracing
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

AXIS = "bands"


class BandRenderer:
    """render(cam, verify=False) -> the (H, W, 3) frame on rank 0's device,
    from one band per rank (None in the other processes of a
    multi-process mesh). `device_fn(cam)` gives the stacked band images
    and the (n, ...) per-band counts without a host sync; `buckets()` the
    common buckets; `last_counts` the last frame's counts (None before the
    first); `band` this process's first band renderer (rank 0's in
    process 0), `bands` every rank's (None at other processes' ranks)."""

    def __init__(self, ranks: mesh_mod.Ranks, bands: list, height: int,
                 kind: str, worst, margin: float):
        """`worst`: the sizing counts, maxed over the bands; `margin` the
        buckets' margin, at build and at each refreeze."""
        self.ranks, self.mesh = ranks, ranks.mesh
        self.bands, self.band = bands, bands[ranks.local[0]]
        self.height = height
        self._kind = kind            # "fast" or "bounced"
        # Checked against the worst band's counts.
        self._buckets = frozen_graph.Buckets(
            margin, hit=self.band.n_levels, n_tiles=self.band.n_tiles,
            worst=lambda c: c.amax(dim=0).tolist())
        self._buckets.grow(worst)
        self.last_counts = None
        self._gathered = None        # tracing.Stamps after the gather

    def buckets(self):
        return self._buckets.pads

    def _body(self, band: CulledRenderer):
        if self._kind == "fast":
            return band._fast_body
        return lambda bufs, pads: band._full_bounced(
            pads, raygen.camera_views(bufs["camera"]))

    def device_fn(self, cam):
        """(band images stacked on dim 0, per-band counts (n, ...)) on rank
        0's device; on CUDA each rank replays its graph on its stream. Over
        several processes the images land on process 0 (None elsewhere)
        and the counts on every process."""
        packed = raygen.camera_packed(cam)
        self.ranks.begin()
        imgs, counts = [None] * len(self.bands), [None] * len(self.bands)
        for r in self.ranks.local:
            band = self.bands[r]
            with self.ranks.on(r), tracing.span("bands.replay", rank=r):
                frame = band._frozen_frame(self._kind, {"camera": packed},
                                           self._body(band))
                img, c = frame(self.buckets())
                imgs[r] = img
                counts[r] = c[None]
        with tracing.span("bands.gather"):
            return (mesh_mod.gather(self.ranks, imgs),
                    mesh_mod.gather(self.ranks, counts, everywhere=True))

    def __call__(self, cam, verify: bool = False) -> torch.Tensor:
        out, counts = self.device_fn(cam)
        if verify:
            # The check loops until every band's counts fit: a level-1
            # overflow makes the reported level-2 counts undercounts, so
            # one refreeze from the reported values can still truncate.
            # Over several processes it runs at once, so every process
            # refreezes at the same point of its stream.
            check = self._buckets.check(
                out, counts, lambda: self.device_fn(cam), "bands",
                self.ranks.device.index, now=self.ranks.n_procs > 1)
            out, counts = check.out, check.counts
        self.last_counts = counts
        if out is None:
            return None
        img = self._assemble(out)
        if tracing.enabled():
            if self._gathered is None:
                self._gathered = tracing.Stamps(self.ranks.device, points=1,
                                                kind="gather")
            self._gathered.mark(0)
        return img

    def _assemble(self, out: torch.Tensor) -> torch.Tensor:
        """The gathered band images as the (H, W, 3) frame."""
        return out[:self.height]


class BalancedBandRenderer(BandRenderer):
    """BandRenderer over cost-balanced bands: each rank renders a band of
    one static height whose first rows[r] tile rows are live. Adds
    `layout()` and `rebalance(cam)`."""

    def __init__(self, *args, rows, tile_h: int, set_layout: Callable,
                 layout_for: Callable, starts):
        super().__init__(*args)
        self._starts, self._rows = starts, rows
        self._tile_h = tile_h
        self._set_layout, self._layout_for = set_layout, layout_for

    def layout(self):
        """(starts, rows) in tile rows, one entry per rank."""
        return np.asarray(self._starts), np.asarray(self._rows)

    def rebalance(self, cam) -> None:
        """Re-probes the costs for `cam` and moves rows between ranks in
        place, with no rebuild: the bands' permutations and live slots are
        buffers their graphs read. Overflow after a move is caught by the
        verify loop."""
        self._starts, self._rows = self._layout_for(cam)
        self._set_layout(self._starts, self._rows)

    def _assemble(self, out: torch.Tensor) -> torch.Tensor:
        n = len(self.bands)
        img = out.reshape(n, -1, *out.shape[1:])
        parts = [img[b, :int(self._rows[b]) * self._tile_h]
                 for b in range(n)]
        return torch.cat(parts)[:self.height]


def _mesh(mesh) -> tuple:
    return mesh_mod.check_mesh(mesh_mod.default_mesh() if mesh is None
                               else mesh)


def _make_bands(scene: Optional[Scene], width: int, band_h: int,
                height: int, mesh: tuple, cfg: RenderConfig, prebaked):
    """(Ranks, one band renderer per rank of this process on its device,
    None at other processes' ranks), all from one bake (Scene.bake_blocks,
    blocks of 128, unless prebaked), projecting with the full frame's
    height."""
    layout = None
    if prebaked is None:
        arrays, tree, layout = scene.bake_blocks(block_size=128)
        prebaked = (arrays, tree)
    ranks = mesh_mod.Ranks(mesh)

    def band(r):
        b = CulledRenderer(None, width, band_h, cfg=cfg, prebaked=prebaked,
                           device=mesh[r])
        b.raygen_height = height
        b.rank = r
        b.block_layout = layout
        return b

    return ranks, ranks.per_rank(band)


def _base_perm(band: CulledRenderer) -> np.ndarray:
    """The band frame's own pixel of every ray slot (its tiled order)."""
    return cull.tiled_ray_order(band.width, band.height, band.tile_w,
                                band.tile_h)[0].astype(np.int64)


def _shifted(base: np.ndarray, offset: int, width: int,
             height: int) -> np.ndarray:
    """A band's permutation: the band-frame pixels shifted by `offset`
    pixels, the overhang clamped to the frame's last pixel."""
    return np.minimum(base + offset, width * height - 1)


def _equal_bands(scene, width: int, height: int, mesh, cfg, prebaked):
    """_make_bands with bands of ceil(H / n) rows, rank r's starting at
    row r * ceil(H / n)."""
    mesh = _mesh(mesh)
    h_band = -(-height // len(mesh))
    ranks, bands = _make_bands(scene, width, h_band, height, mesh, cfg,
                               prebaked)
    base = _base_perm(bands[ranks.local[0]])
    for r in ranks.local:
        with ranks.on(r):
            bands[r].set_rays(_shifted(base, r * h_band * width, width,
                                       height))
    return ranks, bands


def _sized(ranks, bands, measure: Callable) -> list:
    """The sizing counts: measure(band) (a sync render's raw counts) on
    every local rank's stream, maxed over the bands (and the processes).
    Every band then takes the early-exit cadence the last band's sizing
    render chose, as the JAX package's one band renderer does (broadcast
    from the process that runs it)."""
    counts = []
    for r in ranks.local:
        with ranks.on(r):
            counts.append(measure(bands[r]))
    worst = ranks.max_over_processes(np.asarray(counts).max(axis=0))
    last = ranks.n - 1
    exit_every = int(ranks.broadcast(
        [bands[last].exit_every if ranks.is_local(last) else 0], last)[0])
    for r in ranks.local:
        bands[r].exit_every = exit_every
    return worst.tolist()


def _sync_counts(band: CulledRenderer, camera) -> tuple:
    band.render(camera, block=True)
    return band._last_counts


def make_sharded_culled_renderer(scene: Optional[Scene], width: int,
                                 height: int, mesh=None,
                                 sizing_camera: Optional[Camera] = None,
                                 margin: float = 2.0,
                                 cfg: RenderConfig = DEFAULT_CONFIG,
                                 balance: bool = False,
                                 prebaked=None) -> BandRenderer:
    """Equal bands of ceil(H / n) rows over `mesh` (default: one rank per
    card); balance=True gives cost-balanced heights
    (make_balanced_culled_renderer). `prebaked` = (SceneArrays, BlockBVH)
    replaces the bake of `scene` (blocks of 128; the bake's own leaf size
    wins)."""
    if balance:
        return make_balanced_culled_renderer(
            scene, width, height, mesh=mesh, sizing_camera=sizing_camera,
            margin=margin, cfg=cfg, prebaked=prebaked)
    ranks, bands = _equal_bands(scene, width, height, mesh, cfg, prebaked)
    camera = sizing_camera if sizing_camera is not None else scene.camera
    worst = _sized(ranks, bands, lambda b: _sync_counts(b, camera))
    return BandRenderer(ranks, bands, height, "fast", worst, margin)


def make_balanced_culled_renderer(scene: Optional[Scene], width: int,
                                  height: int, mesh=None,
                                  sizing_camera: Optional[Camera] = None,
                                  margin: float = 2.0,
                                  cfg: RenderConfig = DEFAULT_CONFIG,
                                  cap_factor: int = 2, prebaked=None
                                  ) -> BalancedBandRenderer:
    """Cost-balanced band heights, the least-loaded-scheduler analog
    (master/pool/pool.go:148-197): the work per band is not equal (the band
    covering the model schedules far more pairs than sky bands), so

      1. the full frame's fine cull cells per ray tile
         (CulledRenderer.per_tile_cells) are summed per tile row;
      2. the rows are split into n contiguous bands minimizing the largest
         band's cost (parallel/tile.balanced_rows), each at most
         cap_factor x the equal share;
      3. every rank renders one static band height; the slots past its
         band's rows are dead and cull to zero work.

    The split is struck from the sizing camera; `rebalance(cam)` re-probes
    and moves rows without a rebuild. Images equal the equal split's bit
    for bit (only the row-to-rank assignment changes)."""
    mesh = _mesh(mesh)
    n = len(mesh)
    camera = sizing_camera if sizing_camera is not None else scene.camera
    tile_h = 512 // 32                         # CulledRenderer's defaults
    ty_full = -(-height // tile_h)
    rows_eq = -(-ty_full // n)
    cap = min(ty_full, cap_factor * rows_eq)
    ranks, bands = _make_bands(scene, width, cap * tile_h, height, mesh,
                               cfg, prebaked)
    geom = bands[ranks.local[0]]            # every band's shape
    tx = -(-width // geom.tile_w)
    slot_row = (np.arange(geom.n_pad) // geom.rt) // tx
    base = _base_perm(geom)
    band_perm = lambda start: _shifted(base, start * tile_h * width, width,
                                       height)

    def probe_costs(cam) -> np.ndarray:
        """(ty_full,) fine cull cells per tile row, probed on rank 0's
        band in windows of `cap` tile rows."""
        probe = bands[0]
        out = []
        with ranks.on(0):
            for j in range(-(-ty_full // cap)):
                rows_here = min(cap, ty_full - j * cap)
                probe.set_rays(band_perm(j * cap), slot_row < rows_here)
                per_tile = probe.per_tile_cells(cam).cpu().numpy()
                out.append(per_tile.reshape(cap, tx).sum(axis=1)[:rows_here])
        return np.concatenate(out)

    def layout_for(cam):
        """(starts, rows) of the split for `cam`: struck by the process
        that runs rank 0 and broadcast, so every process takes the same."""
        split = np.zeros(2 * n, np.int64)
        if ranks.is_local(0):
            split = np.concatenate(tile_mod.balanced_rows(probe_costs(cam),
                                                          n, cap))
        split = ranks.broadcast(split, 0)
        return (split[:n].astype(np.int32), split[n:].astype(np.int32))

    def set_layout(starts, rows) -> None:
        for r in ranks.local:
            with ranks.on(r):
                bands[r].set_rays(band_perm(int(starts[r])),
                                  slot_row < int(rows[r]))

    starts, rows = layout_for(camera)
    set_layout(starts, rows)
    worst = _sized(ranks, bands, lambda b: _sync_counts(b, camera))
    return BalancedBandRenderer(
        ranks, bands, height, "fast", worst, margin, rows=rows,
        tile_h=tile_h, set_layout=set_layout, layout_for=layout_for,
        starts=starts)


def make_sharded_bounced_renderer(scene: Optional[Scene], width: int,
                                  height: int, depth: int, mesh=None,
                                  sizing_camera: Optional[Camera] = None,
                                  margin: float = 2.0,
                                  cfg: RenderConfig = DEFAULT_CONFIG,
                                  prebaked=None) -> BandRenderer:
    """Whitted bounces on equal bands (the sharded sibling of
    CulledRenderer.freeze_bounced): per-bounce buckets sized from every
    band's raw sync render_bounced counts, verified per frame as the
    culled bands are. Reflection rays stay in their band's pipeline: the
    scene is replicated, so no exchange between bands is needed."""
    ranks, bands = _equal_bands(scene, width, height, mesh, cfg, prebaked)
    camera = sizing_camera if sizing_camera is not None else scene.camera

    def measure(band):
        band.render_bounced(camera, depth, block=True)
        return band._last_bounce_counts

    return BandRenderer(ranks, bands, height, "bounced",
                        _sized(ranks, bands, measure), margin)
