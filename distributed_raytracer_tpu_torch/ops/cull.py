"""Conservative ray-tile vs triangle-block culling.

The torch counterpart of distributed_raytracer_tpu/ops/cull.py, operation
for operation. Rays are grouped into tiles, each tile is summarized by
componentwise origin/direction intervals, and one interval-arithmetic slab
test per (tile, block) conservatively decides whether any ray in the tile
can hit the block's AABB (the array replacement for the reference's R-tree
predicates, shared/geom/box.go:29-69). False positives cost only wasted
work; false negatives are impossible, so images are exact.

The surviving (tile, block) pairs are compacted into a flat, tile-major work
list — the schedule the traversal kernels in ops/bsr_trace.py consume.

Three defaults differ from jax.numpy and are spelled out here:
  - sorts pass `stable=True` (jnp.argsort is stable, torch.argsort is not
    unless asked), or work lists would order ties differently;
  - indices are int64 inside (torch indexing), int32 at the public outputs
    (WorkList), so the tests compare like with like;
  - the interval math relies on NaN propagating through min and max — the
    inverted (+inf, -inf) padding boxes and dead-tile hulls depend on it —
    so it uses torch.minimum / maximum / amin / amax, never fmin / fmax.
No function here syncs with the host: counts stay device tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

INF = float("inf")


class TileIntervals(NamedTuple):
    o_lo: torch.Tensor   # (nT, 3)
    o_hi: torch.Tensor   # (nT, 3)
    d_lo: torch.Tensor   # (nT, 3)
    d_hi: torch.Tensor   # (nT, 3)
    t_hi: torch.Tensor   # (nT,) max t of interest per tile (inf if unbounded)


def tile_intervals_packed(rays: torch.Tensor, tile: int,
                          live: Optional[torch.Tensor] = None,
                          use_tmax: bool = False) -> TileIntervals:
    """Componentwise bounds of each tile's rays, for packed (8, R) ray rows
    (ox,oy,oz,dx,dy,dz,tmax,·); R must be a multiple of `tile`.

    `live` (R,) bool masks rays out of the hull: a tile with no live ray
    gets an inverted (+inf, -inf) hull whose slab quotients are NaN, so it
    culls to zero work. Row 6 (t_max) participates only when `use_tmax`
    (nearest queries are unbounded)."""
    r = rays.shape[1]
    nt = r // tile

    def lohi(rows):  # (3, R) -> (nt, 3), (nt, 3)
        v = rows.reshape(3, nt, tile)
        if live is not None:
            lv = live.reshape(1, nt, tile)
            lo = torch.where(lv, v, INF).amin(dim=2)
            hi = torch.where(lv, v, -INF).amax(dim=2)
        else:
            lo, hi = v.amin(dim=2), v.amax(dim=2)
        return lo.T, hi.T

    o_lo, o_hi = lohi(rays[0:3])
    d_lo, d_hi = lohi(rays[3:6])
    if use_tmax:
        tm = rays[6]
        if live is not None:
            tm = torch.where(live, tm, 0.0)
        t_hi = tm.reshape(nt, tile).amax(dim=1)
    else:
        t_hi = torch.full((nt,), INF, dtype=rays.dtype, device=rays.device)
        if live is not None:
            # all-dead tiles must still cull to nothing
            t_hi = torch.where(live.reshape(nt, tile).any(dim=1), t_hi, 0.0)
    return TileIntervals(o_lo=o_lo, o_hi=o_hi, d_lo=d_lo, d_hi=d_hi, t_hi=t_hi)


def _slab(a, b, d_lo, d_hi, t_hi):
    """Interval slab test shared by block_mask_with_entry and _mask_rows:
    per axis, the crossing times of every (origin, direction) in the hull
    lie within the interval quotient [a, b] / [d_lo, d_hi]; a direction
    interval straddling 0 makes the quotient (-inf, inf). Returns
    (enter <= exit, enter) over the last (xyz) axis."""
    straddle = (d_lo <= 0.0) & (d_hi >= 0.0)
    dl = torch.where(d_lo == 0.0, 1.0, d_lo)
    dh = torch.where(d_hi == 0.0, 1.0, d_hi)
    q1, q2, q3, q4 = a / dl, a / dh, b / dl, b / dh
    t_lo_axis = torch.minimum(torch.minimum(q1, q2), torch.minimum(q3, q4))
    t_hi_axis = torch.maximum(torch.maximum(q1, q2), torch.maximum(q3, q4))
    t_lo_axis = torch.where(straddle, -INF, t_lo_axis)
    t_hi_axis = torch.where(straddle, INF, t_hi_axis)
    enter = torch.clamp_min(t_lo_axis.amax(dim=-1), 0.0)
    exit_ = torch.minimum(t_hi_axis.amin(dim=-1), t_hi)
    return enter <= exit_, enter


def block_mask_with_entry(ti: TileIntervals, block_lo: torch.Tensor,
                          block_hi: torch.Tensor):
    """Conservative (nTiles, NB) cull with entry distances.

    A block is kept iff the intersection of the three axis intervals meets
    [0, t_hi]. Also returns each cell's conservative entry distance (a lower
    bound on any tile ray's entry into the block AABB) — the front-to-back
    sort key and early-exit bound for the traversal kernels.
    """
    a = block_lo[None, :, :] - ti.o_hi[:, None, :]   # (nT, NB, 3)
    b = block_hi[None, :, :] - ti.o_lo[:, None, :]
    keep, enter = _slab(a, b, ti.d_lo[:, None, :], ti.d_hi[:, None, :],
                        ti.t_hi[:, None])
    # Inverted (+inf, -inf) padding boxes do NOT fail the quotient math
    # (a=+inf, b=-inf spans every axis interval to (-inf, +inf)), so they
    # are rejected explicitly: a passing phantom superblock member would
    # expand to an out-of-range block id and an out-of-bounds read in the
    # kernels.
    valid = (block_lo <= block_hi).all(dim=1)[None, :]
    return keep & valid, enter


def _mask_rows(o_lo, o_hi, d_lo, d_hi, t_hi, blo, bhi):
    """block_mask_with_entry's slab math for PAIRED rows: tile hulls
    (W, 3) against per-row block groups (W, G, 3) -> (W, G) mask + entry."""
    a = blo - o_hi[:, None, :]                        # (W, G, 3)
    b = bhi - o_lo[:, None, :]
    keep, enter = _slab(a, b, d_lo[:, None, :], d_hi[:, None, :],
                        t_hi[:, None])
    # Same inverted-padding rejection as block_mask_with_entry: the last
    # superblock's nonexistent members carry (+inf, -inf) boxes.
    valid = (blo <= bhi).all(dim=2)
    return keep & valid, enter


def tiled_ray_order(width: int, height: int, tile_w: int, tile_h: int):
    """Static pixel permutation grouping rays into 2D screen tiles (numpy,
    on the host).

    Row-major flat indexing makes a 512-ray tile a 512x1 pixel strip —
    terrible spatial locality for interval culling. This permutation makes
    each tile a tile_w x tile_h rectangle (the reference's WorkOrder
    rectangles, master/main.go:54-91, reborn as a memory layout).

    Returns (perm, inv_real, n_slots):
      perm[s]      -> flat row-major pixel index for ray slot s (clamped
                      duplicates for out-of-frame padding slots)
      inv_real[p]  -> ray slot of real pixel p (for framebuffer assembly)
      n_slots      = padded slot count (multiple of tile_w*tile_h)
    """
    tx = -(-width // tile_w)
    ty = -(-height // tile_h)
    n_slots = tx * ty * tile_w * tile_h

    s = np.arange(n_slots)
    tile = s // (tile_w * tile_h)
    within = s % (tile_w * tile_h)
    tj, ti = tile // tx, tile % tx
    wj, wi = within // tile_w, within % tile_w
    j = np.minimum(tj * tile_h + wj, height - 1)
    i = np.minimum(ti * tile_w + wi, width - 1)
    perm = (j * width + i).astype(np.int32)

    p = np.arange(width * height)
    pj, pi = p // width, p % width
    ptile = (pj // tile_h) * tx + (pi // tile_w)
    pwithin = (pj % tile_h) * tile_w + (pi % tile_w)
    inv_real = (ptile * (tile_w * tile_h) + pwithin).astype(np.int32)
    return perm, inv_real, n_slots


def _pad_boxes(lo: torch.Tensor, hi: torch.Tensor, n: int):
    """Append n inverted (+inf, -inf) boxes, which never pass the slab
    test."""
    if not n:
        return lo, hi
    return (torch.cat([lo, lo.new_full((n, 3), INF)]),
            torch.cat([hi, hi.new_full((n, 3), -INF)]))


def superblock_bounds(block_lo: torch.Tensor, block_hi: torch.Tensor,
                      group: int):
    """Union AABBs of `group` consecutive blocks (Morton order makes
    consecutive blocks spatially coherent, so the unions are tight)."""
    nb = block_lo.shape[0]
    nsb = -(-nb // group)
    block_lo, block_hi = _pad_boxes(block_lo, block_hi, nsb * group - nb)
    sb_lo = block_lo.reshape(nsb, group, 3).amin(dim=1)
    sb_hi = block_hi.reshape(nsb, group, 3).amax(dim=1)
    return sb_lo, sb_hi


class WorkList(NamedTuple):
    tile_ids: torch.Tensor    # (W,) int32, sorted ascending
    block_ids: torch.Tensor   # (W,) int32
    entry: torch.Tensor       # (W,) float32 conservative block entry distance
    count: torch.Tensor       # () int32 number of real entries (rest repeat the last)


def _take_slots(order: torch.Tensor, count: torch.Tensor, w_pad: int):
    """The first w_pad cells of `order`, with slots at and past `count`
    replaying the last real cell (the kernels' folds are idempotent, so
    replays are harmless). `count` stays on the device: indexing with a
    1-element tensor, not a Python int, avoids a host sync. A count past
    w_pad (a frozen bucket that overflowed) replays slot w_pad - 1, as
    JAX's clamped gather does; the caller's verify pass sees the count."""
    if w_pad <= order.numel():
        order = order[:w_pad]
    else:  # tiny scenes: fewer cells than the minimum bucket
        order = torch.cat([order, order.new_zeros(w_pad - order.numel())])
    last = order[torch.clamp(count - 1, 0, w_pad - 1).reshape(1).long()]
    slot = torch.arange(w_pad, device=order.device)
    return torch.where(slot < count, order, last)


def expand_worklist(ti: TileIntervals, wl1: WorkList,
                    member_lo: torch.Tensor, member_hi: torch.Tensor,
                    group: int, w_pad: Optional[int]):
    """Expand a compacted (tile, parent-id) work list one level down:
    test each item's `group` member boxes (taken from member_lo/hi, the
    CHILD level's AABBs) and compact the survivors into member ids.

    Returns (WorkList, count). With w_pad=None only the count is needed
    (the sizing pass): the compaction is skipped and WorkList is None.
    The result preserves the parent order (tile-major, approximately
    front-to-back; each item still carries its exact member entry for the
    kernels' early-exit bound)."""
    nm = member_lo.shape[0]
    nparent = -(-nm // group)
    member_lo, member_hi = _pad_boxes(member_lo, member_hi,
                                      nparent * group - nm)
    parent = wl1.block_ids.long()
    blo_g = member_lo.reshape(nparent, group, 3)[parent]   # (W1, G, 3)
    bhi_g = member_hi.reshape(nparent, group, 3)[parent]
    t = wl1.tile_ids.long()
    w1_pad = wl1.tile_ids.shape[0]
    mask2, entry2 = _mask_rows(ti.o_lo[t], ti.o_hi[t], ti.d_lo[t],
                               ti.d_hi[t], ti.t_hi[t], blo_g, bhi_g)
    # Parent padding slots replay the last real item; gate their member
    # cells off so the expanded list carries no duplicates.
    slot = torch.arange(w1_pad, device=mask2.device)
    mask2 = mask2 & (slot < wl1.count)[:, None]
    flat = mask2.reshape(-1)
    count2 = flat.sum(dtype=torch.int32)
    if w_pad is None:
        return None, count2
    # Compact preserving the parent order: position is the sort key, so
    # tile-major + front-to-back survive the expansion.
    pos = torch.arange(w1_pad * group, dtype=torch.int32, device=flat.device)
    key = torch.where(flat, pos, 2 ** 31 - 1)
    order = torch.argsort(key, stable=True)
    cell = _take_slots(order, count2, w_pad)
    item = torch.div(cell, group, rounding_mode="floor")
    j = cell % group
    # Defensive clamp: an out-of-range member id would be an out-of-bounds
    # read in the kernels. The mask above keeps phantom members out of
    # `count2`; the clamp makes even a future masking bug degrade to
    # redundant work on a real member (idempotent for both folds).
    block = torch.clamp(parent[item] * group + j, max=nm - 1)
    wl = WorkList(tile_ids=wl1.tile_ids[item],
                  block_ids=block.to(torch.int32),
                  entry=entry2.reshape(-1)[cell],
                  count=count2)
    return wl, count2


def level_bounds(block_lo: torch.Tensor, block_hi: torch.Tensor,
                 groups: tuple):
    """AABBs of every hierarchy level, finest first: groups[k] unions
    level-k boxes into level-(k+1) boxes."""
    out = [(block_lo, block_hi)]
    lo, hi = block_lo, block_hi
    for g in groups:
        lo, hi = superblock_bounds(lo, hi, g)
        out.append((lo, hi))
    return out


def multilevel_mask(ti: TileIntervals, block_lo: torch.Tensor,
                    block_hi: torch.Tensor, groups: tuple):
    """Top-level cull: (nTiles, n_coarsest) mask + entry + int32 count vs
    the COARSEST level of `groups`."""
    lo, hi = level_bounds(block_lo, block_hi, groups)[-1]
    m, e = block_mask_with_entry(ti, lo, hi)
    return m, e, m.sum(dtype=torch.int32)


def multilevel_worklist(ti: TileIntervals, mask: torch.Tensor,
                        entry: torch.Tensor, count, block_lo: torch.Tensor,
                        block_hi: torch.Tensor, groups: tuple, pads: tuple):
    """Compact the coarsest mask and expand level by level down to leaf
    blocks (the R-tree descent as array programs).

    pads[0] sizes the top compaction; pads[k] sizes the k-th expansion.
    A missing/None pad stops the walk (the sizing passes measure one level
    per host sync). Returns (leaf WorkList or None, counts) where counts
    holds every expansion's survivor count, coarsest-to-finest."""
    bounds = level_bounds(block_lo, block_hi, groups)
    wl = compact_worklist(mask, pads[0], entry=entry, count=count)
    counts = []
    for i, k in enumerate(range(len(groups) - 1, -1, -1)):
        pad = pads[i + 1] if i + 1 < len(pads) else None
        lo, hi = bounds[k]
        wl, c = expand_worklist(ti, wl, lo, hi, groups[k], pad)
        counts.append(c)
        if wl is None:
            break
    return wl, tuple(counts)


def visited_tiles(wl: WorkList, n_tiles: int) -> torch.Tensor:
    """(n_tiles,) bool: the ray tiles the work list names (INCLUDING
    padding replays). The kernels leave other tiles at their initial value;
    callers mask by this, as in the JAX package, where unvisited output
    blocks are undefined memory. (The coarse mask is NOT a safe proxy: a
    tile can pass level 1 and lose every member at level 2.)"""
    v = torch.zeros(n_tiles, dtype=torch.bool, device=wl.tile_ids.device)
    return v.index_fill_(0, wl.tile_ids.long(), True)


def compact_worklist(mask: torch.Tensor, w_pad: int,
                     entry: Optional[torch.Tensor] = None,
                     count=None) -> WorkList:
    """Flatten the (nTiles, NB) mask into a tile-major work list of length
    w_pad. Within each tile, blocks are ordered front-to-back by `entry`
    (when given) so the kernels' early-exit bounds bite as soon as possible.
    Entries past `count` repeat the last real entry. `count` may pass a
    precomputed mask.sum() to skip the reduction."""
    nt, nb = mask.shape
    flat = mask.reshape(-1)
    if count is None:
        count = flat.sum(dtype=torch.int32)
    else:
        count = count.to(torch.int32)
    if entry is None:
        # Stable argsort of (!mask) puts kept cells first in tile-major order.
        order = torch.argsort((~flat).to(torch.uint8), stable=True)
        entry_flat = torch.zeros(flat.shape, dtype=torch.float32,
                                 device=flat.device)
    else:
        entry_flat = entry.reshape(-1)
        # Single int32 composite key: [dropped? MAX : tile*4096 + entry
        # quantized to 12 bits]. Quantizing only affects the early-exit
        # heuristic, never correctness (the exact f32 entry still rides
        # the work list for the kernels' skip bound).
        finite = torch.where(torch.isfinite(entry_flat) & flat, entry_flat,
                             0.0)
        scale = 4095.0 / torch.clamp_min(finite.amax(), 1e-6)
        q = torch.clamp(entry_flat * scale, 0.0, 4095.0).to(torch.int32)
        tile_key = torch.div(
            torch.arange(nt * nb, dtype=torch.int32, device=flat.device),
            nb, rounding_mode="floor")
        key = torch.where(flat, tile_key * 4096 + q, 2 ** 31 - 1)
        order = torch.argsort(key, stable=True)
    cell = _take_slots(order, count, w_pad)
    return WorkList(
        tile_ids=torch.div(cell, nb, rounding_mode="floor").to(torch.int32),
        block_ids=(cell % nb).to(torch.int32),
        entry=entry_flat[cell], count=count)
