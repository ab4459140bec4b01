"""Pieces of the block-BVH-culled geometry-sharded schedules.

The torch counterpart of the helpers that distributed_raytracer_tpu/
parallel/ring_bvh.py imports from distributed_raytracer_tpu/parallel/
halo_bvh.py: the reflection rays of one bounce (`reflect_rows`, the
culled renderer's own, ops/render_bvh.py), the
per-rank geometry shard (`ShardedGeometry`) and its ownership maps for
per-frame object diffs (`DynGeometry`, `apply_diff_sharded`), and the block
padding that makes the block count divide the rank count
(`_pad_to_shardable`). The halo schedule itself (`HaloCulledRenderer`,
`--mode halo`) is not ported yet; it joins this module with its exchange.

Scene.bake_bvh Morton-orders triangles and gap-aligns leaf blocks, so a
contiguous run of blocks is spatially compact: sharding the block axis
contiguously gives each rank a tight region, which is what makes per-shard
culling effective.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_raytracer_tpu_torch.ops.render_bvh import reflect_rows
from distributed_raytracer_tpu_torch.ops.render_dynamic import _rowdot3

__all__ = ["DynGeometry", "ShardedGeometry", "apply_diff_sharded",
           "reflect_rows"]


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
