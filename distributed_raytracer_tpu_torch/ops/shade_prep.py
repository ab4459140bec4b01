"""Stage B2 of the culled frame in one pass: hit-tile gather, shading prep,
light gates and the per-light shadow tile hulls.

Given the frame's rays and nearest hits and the order of its ray tiles
(`tidx`: the ht_pad tiles to keep, the tiles with a hit first, as
ops/render_bvh.py's `_stage_b2` sorts them), `prep_tiles` returns, for the
C = ht_pad * rt rays of the compacted tiles:
  - the compacted hits (t and tri zeroed where invalid; the tiles past
    `ht_count` are padding, every ray invalid) and, when asked, rays;
  - the viewer: the (3,) one as given, or the compacted (3, C) rows of a
    per-ray one (a bounce's previous hit points);
  - shade.PackedPrep as shade.prepare_packed computes it, with `q_rev` a
    (L, 8, C) view of (8, L, C) storage, so all lights' reversed rays are
    one (8, L * C) view (`q_rev.permute(1, 0, 2).reshape(8, -1)`);
  - the (L, C) light gates (shade.light_gates);
  - every light's tile hulls of its reversed rays over the rays it gates
    live (cull.tile_intervals_packed(q_rev[l], rt, live=gates[l],
    use_tmax=True)), stacked light-major to (L * ht_pad, 3).

Two implementations, chosen by the device of the tensors alone:
  - a CUDA kernel (csrc/shade_prep.cu, `shade_prep_tiles`: one block per
    compacted tile, every output written once), launched for CUDA tensors;
  - the plain PyTorch version, `prep_tiles_ref` (the functions above called
    op by op), used for CPU tensors and as the reference the kernel is held
    to on the card: bit for bit, NaN and inf patterns included.
A scene without lights takes the same kernel: its per-light outputs and
hulls are empty.
The JAX package has no kernel here: XLA fuses the same jnp code.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from distributed_raytracer_tpu_torch.ops import _build, cull, shade
from distributed_raytracer_tpu_torch.ops.bsr_trace import _check, _ptr
from distributed_raytracer_tpu_torch.ops.intersect import Hits
from distributed_raytracer_tpu_torch.ops.shade import PackedPrep
from distributed_raytracer_tpu_torch.utils import tracing
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

# The kernel's name in a profile (utils/profiling.py and rtbench class it
# with the glue, not with K1-K7).
KERNEL = "shade_prep_tiles"
# Ray tiles the kernel takes: one thread per ray.
RAY_TILES = (128, 256, 512, 1024)
# Rows of the kernel's shading buffer: x, normal, geo_n, ka, kd, ks (3
# each), ns.
_ROWS = 19


class TilePrep(NamedTuple):
    """Stage B2's per-ray outputs over C = ht_pad * rt compacted rays."""

    rays_h: Optional[torch.Tensor]  # (8, C) compacted rays, or None
    hits_h: Hits                    # compacted hits
    view_h: torch.Tensor            # (3,) viewer, or (3, C) compacted rows
    prep: PackedPrep                # q_rev: (L, 8, C) view of (8, L, C)
    live_l: torch.Tensor            # (L, C) bool light gates
    sti: cull.TileIntervals         # (L * ht_pad, 3) hulls, light-major


def bytes_moved(n_lights: int, ht_pad: int, rt: int, view_rows: bool,
                keep_rays: bool) -> int:
    """Device-memory bytes one prep_tiles call moves when it reads each
    input and writes each output once: per compacted ray the ray's origin
    and direction, t, tri and valid (and a per-ray viewer) in; the hits,
    the 19 shading rows and per light q, q_rev and the gate (and the
    compacted rays and viewer) out; 13 floats per (light, tile) of hulls.
    The shading table's rows are read through L2 and not counted."""
    c = ht_pad * rt
    read = c * (6 * 4 + 4 + 4 + 1)
    write = c * (4 + 4 + 1 + _ROWS * 4 + n_lights * (2 * 8 * 4 + 1))
    if view_rows:
        read, write = read + 12 * c, write + 12 * c
    if keep_rays:
        read, write = read + 8 * c, write + 32 * c
    return read + write + n_lights * ht_pad * 13 * 4


def _empty_hulls(like: torch.Tensor) -> cull.TileIntervals:
    z3 = like.new_zeros((0, 3))
    return cull.TileIntervals(z3, z3, z3, z3, t_hi=like.new_zeros((0,)))


def prep_tiles_ref(rays, hits: Hits, tidx, ht_count, arrays, table, view,
                   cfg: RenderConfig = DEFAULT_CONFIG, *, rt: int,
                   keep_rays: bool = False) -> TilePrep:
    """The plain version of prep_tiles: the order-preserving hit-tile
    gather, shade.prepare_packed, shade.light_gates and a
    cull.tile_intervals_packed per light, op by op."""
    nt = rays.shape[1] // rt
    ht_pad = tidx.shape[0]
    h = ht_pad * rt
    tile_ok = torch.arange(ht_pad, device=rays.device) < ht_count
    valid_h = (hits.valid.reshape(nt, rt)[tidx] & tile_ok[:, None]).reshape(h)
    t_h = torch.where(valid_h, hits.t.reshape(nt, rt)[tidx].reshape(h), 0.0)
    tri_h = torch.where(valid_h, hits.tri.reshape(nt, rt)[tidx].reshape(h),
                        0)
    hits_h = Hits(t=t_h, tri=tri_h, valid=valid_h)
    rays_h = rays.reshape(8, nt, rt)[:, tidx, :].reshape(8, h)
    if view.dim() == 1:
        view_h = view
    else:
        view_h = view.reshape(3, nt, rt)[:, tidx, :].reshape(3, h)
    prep = shade.prepare_packed(arrays, rays_h, hits_h, cfg, table=table)
    # The kernel's layout: (8, L, C) storage behind the (L, 8, C) view.
    prep = prep._replace(q_rev=prep.q_rev.permute(1, 0, 2).clone(
        memory_format=torch.contiguous_format).permute(1, 0, 2))
    live_l = shade.light_gates(arrays, view_h, prep, valid_h)
    tis = [cull.tile_intervals_packed(prep.q_rev[li], rt, live=live_l[li],
                                      use_tmax=True)
           for li in range(prep.q.shape[0])]
    sti = (cull.TileIntervals(*(torch.cat([getattr(t, f) for t in tis])
                                for f in cull.TileIntervals._fields))
           if tis else _empty_hulls(rays))
    return TilePrep(rays_h if keep_rays else None, hits_h, view_h, prep,
                    live_l, sti)


def _outputs(n_lights: int, ht_pad: int, rt: int, view: torch.Tensor,
             keep_rays: bool, device) -> TilePrep:
    """prep_tiles' outputs, allocated for the kernel in prep_tiles_ref's
    shapes and strides. The kernel writes through the first view of each
    buffer: the shading rows behind prep.x .. prep.ns, q_rev's (8, L, C)
    storage, the four hull fields behind sti.o_lo."""
    c = ht_pad * rt
    f32 = dict(dtype=torch.float32, device=device)
    rows = torch.empty((_ROWS, c), **f32)
    prep = PackedPrep(
        x=rows[0:3], normal=rows[3:6], geo_n=rows[6:9], ka=rows[9:12],
        kd=rows[12:15], ks=rows[15:18], ns=rows[18],
        q=torch.empty((n_lights, 8, c), **f32),
        q_rev=torch.empty((8, n_lights, c), **f32).permute(1, 0, 2))
    hits_h = Hits(t=torch.empty(c, **f32),
                  tri=torch.empty(c, dtype=torch.int32, device=device),
                  valid=torch.empty(c, dtype=torch.bool, device=device))
    hulls = torch.empty((4, n_lights * ht_pad, 3), **f32)
    return TilePrep(
        rays_h=torch.empty((8, c), **f32) if keep_rays else None,
        hits_h=hits_h,
        view_h=view if view.dim() == 1 else torch.empty((3, c), **f32),
        prep=prep,
        live_l=torch.empty((n_lights, c), dtype=torch.bool, device=device),
        sti=cull.TileIntervals(*hulls,
                               t_hi=torch.empty(n_lights * ht_pad, **f32)))


def prep_tiles(rays, hits: Hits, tidx, ht_count, arrays, table, view,
               cfg: RenderConfig = DEFAULT_CONFIG, *, rt: int,
               keep_rays: bool = False) -> TilePrep:
    """Stage B2's per-ray work over the compacted tiles (module docstring).

    rays (8, R) packed rows, R = n_tiles * rt; hits of those rays; tidx
    (ht_pad,) int64 source tile of each compacted tile; ht_count () int32
    tiles with a hit; arrays: the scene arrays (light_pos, light_col
    (L, 3) are read); table the (32, T) shade.table_rows_device table;
    view (3,) or (3, R). rays_h is returned only with keep_rays. CUDA
    tensors launch the kernel (or raise), CPU tensors run prep_tiles_ref.
    """
    dev = rays.device
    if dev.type == "cpu":
        return prep_tiles_ref(rays, hits, tidx, ht_count, arrays, table,
                              view, cfg, rt=rt, keep_rays=keep_rays)
    if dev.type != "cuda":
        raise ValueError(f"prep_tiles: no kernel for device {dev}")
    if rt not in RAY_TILES:
        raise ValueError(f"rt={rt}: must be one of {RAY_TILES}")
    r = rays.shape[1]
    if rays.dim() != 2 or r % rt:
        raise ValueError(f"rays: expected (8, R), R a multiple of rt={rt}, "
                         f"got {tuple(rays.shape)}")
    _check("rays", rays, torch.float32, (8, r), dev)
    _check("hits.t", hits.t, torch.float32, (r,), dev)
    _check("hits.tri", hits.tri, torch.int32, (r,), dev)
    _check("hits.valid", hits.valid, torch.bool, (r,), dev)
    ht_pad = tidx.shape[0]
    if not 0 < ht_pad <= r // rt:
        raise ValueError(f"tidx: {ht_pad} tiles, not in 1..{r // rt}")
    _check("tidx", tidx, torch.int64, (ht_pad,), dev)
    _check("ht_count", ht_count.reshape(1), torch.int32, (1,), dev)
    n_tris = table.shape[1]
    _check("table", table, torch.float32, (shade.TABLE_WIDTH, n_tris), dev)
    n_lights = arrays.light_pos.shape[0]
    light_pos = _check("light_pos", arrays.light_pos.contiguous(),
                       torch.float32, (n_lights, 3), dev)
    light_col = _check("light_col", arrays.light_col.contiguous(),
                       torch.float32, (n_lights, 3), dev)
    view_rows = view.dim() == 2
    if not view_rows:
        view = view.contiguous()
    _check("view", view, torch.float32, (3, r) if view_rows else (3,), dev)

    out = _outputs(n_lights, ht_pad, rt, view, keep_rays, dev)
    lib = _build.load_library("shade_prep")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch(
            "shade_prep", lib.drt_shade_prep, _ptr(rays), r, _ptr(hits.t),
            _ptr(hits.tri), _ptr(hits.valid, 1), _ptr(view), int(view_rows),
            _ptr(tidx, 8), _ptr(ht_count), ht_pad, _ptr(table), n_tris,
            _ptr(light_pos), _ptr(light_col), n_lights, cfg.shadow_offset,
            cfg.shadow_normal_offset, rt,
            _ptr(out.rays_h) if keep_rays else 0,
            _ptr(out.view_h) if view_rows else 0, _ptr(out.hits_h.t),
            _ptr(out.hits_h.tri), _ptr(out.hits_h.valid, 1),
            _ptr(out.prep.x), _ptr(out.prep.q), _ptr(out.prep.q_rev),
            _ptr(out.live_l, 1), _ptr(out.sti.o_lo), _ptr(out.sti.t_hi),
            stream)
    tracing.COUNTS["shade_prep"] += 1
    return out
