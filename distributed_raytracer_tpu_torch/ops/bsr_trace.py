"""Block-sparse ray-triangle traversal: the hot loop of the renderer.

Given a flat, tile-major work list of (ray tile, triangle block) items from
ops/cull.py, every (ray, triangle) pair of every item is tested with the
Baldwin–Weber intersection and folded into a per-ray nearest hit
(`bsr_nearest`) or any hit (`bsr_any`). The counterparts of
distributed_raytracer_tpu/ops/pallas/bsr_trace.py's packers and kernels.

Each kernel has two implementations here:
  - a CUDA kernel written for Hopper (csrc/bsr_trace.cu, built on first use
    by ops/_build.py), launched for CUDA tensors;
  - a plain PyTorch version (`bsr_nearest_ref`, `bsr_any_ref`) computing the
    same function, used for CPU tensors and as the reference the kernels are
    held against on the card.
The wrappers choose by the device of the tensors they are given and by
nothing else: a CUDA tensor launches the kernel or raises.

Three triangle forms are ported. shared_origin=True with a (T, 16)
tensor: every ray of a launch has one origin, folded into the triangle rows
by `pack_tris_origin` (primary rays; shadow rays reversed to start at their
light). shared_origin=False: each ray has its own origin (ray rows 0..2)
against the static `pack_tris` rows (the reflection rays of bounces). And
the JAX package's "MXU" form, a tuple `(A (3T, 8), scal (S, 8))` from
`pack_dirs` and `fold_origin_scal`, which implies a shared origin: the
three direction dots n.d, k_u.d, k_v.d are one product A @ rays, run on the
tensor cores in FP32-accurate 3xTF32 (csrc/bsr_trace.cu, K4 and K5); A is
static and translation-invariant, only the (T, 8) origin scalars are
refolded per origin. `ablock_ids` indexes A where `block_ids` carries a
per-light offset into the stacked scalars (the all-lights shadow launch).

Layouts (the JAX package's): rays [8, R] f32 rows (ox,oy,oz,dx,dy,dz,tmax,0);
triangles [T, 16] f32 rows. R is a multiple of the ray tile rt, T of the
triangle block tb.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_raytracer_tpu_torch.ops import _build
from distributed_raytracer_tpu_torch.ops.intersect import BARY_EPS
from distributed_raytracer_tpu_torch.utils import tracing

BIG_IDX = 2 ** 30
# "Unbounded" packed t_max: finite, as in the JAX package (its MXU kernels
# multiply whole ray blocks, and 0 * inf = NaN). All t <= t_max comparisons
# behave identically.
BIG_TMAX = 3.4e38
# Threads per block of the CUDA-core kernels (K1-K3); rt / THREADS rays
# per thread.
THREADS = 128
# Work items per block of the traversal kernels (K1, K2 with a shared
# origin; K3n, K3a with per-ray origins; K4, K5 in the tensor-core form),
# whose grid runs over chunks of the work list (csrc/bsr_trace.cu); chosen
# on the H100 for every form (PERF.md).
CHUNK = 2
# Pairs per chunk of the plain versions: bounds their peak memory (an
# unchunked (W, tb, rt) pair tensor is gigabytes at frame sizes).
_REF_CHUNK_PAIRS = 1 << 22


def launch_key(name: str, shared_origin: bool, mxu: bool = False) -> str:
    """The tracing.COUNTS key of wrapper `name`'s kernel launches in one
    triangle form ("_rays": per-ray origins; "_mxu": the (A, scal) tuple
    on the tensor cores). One count per call, only where the CUDA kernel
    is launched: a nearest call of any form (K1, K3n, K4) is three device
    launches (seed the keys, the chunks, unpack), an any-hit call (K2,
    K3a, K5) a copy of init and the chunks."""
    if mxu:
        return name + "_mxu"
    return name if shared_origin else name + "_rays"


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack_tris(scene_arrays) -> np.ndarray:
    """[T, 16] float32 triangle rows on the host (static per scene):
    (nx,ny,nz,plane_d, ku.xyz,c_u, kv.xyz,c_v, 0,0,0,0)."""
    a = scene_arrays
    cols = [
        a.geo_n[:, 0], a.geo_n[:, 1], a.geo_n[:, 2], a.plane_d,
        a.k_u[:, 0], a.k_u[:, 1], a.k_u[:, 2], a.c_u,
        a.k_v[:, 0], a.k_v[:, 1], a.k_v[:, 2], a.c_v,
    ]
    t = a.p0.shape[0]
    packed = np.zeros((t, 16), dtype=np.float32)
    for i, c in enumerate(cols):
        packed[:, i] = np.asarray(c, np.float32)
    return packed


def pack_rays(origins: torch.Tensor, dirs: torch.Tensor,
              t_max: torch.Tensor | None = None) -> torch.Tensor:
    """[8, R] float32 ray rows from (R, 3) directions; origins (R, 3) or
    (3,) shared; t_max (R,) or None for inf (as in the JAX package's
    pack_rays)."""
    r = dirs.shape[0]
    o = origins[None, :].expand(r, 3) if origins.dim() == 1 else origins
    tmax = (dirs.new_full((r,), float("inf")) if t_max is None else t_max)
    return torch.stack([o[:, 0], o[:, 1], o[:, 2], dirs[:, 0], dirs[:, 1],
                        dirs[:, 2], tmax, dirs.new_zeros((r,))])


def pack_rays_rows(origins: torch.Tensor, d_rows: torch.Tensor,
                   t_max: torch.Tensor | None = None) -> torch.Tensor:
    """[8, R] rays from (3, R) direction rows. origins (3, R) rows or (3,)
    shared."""
    r = d_rows.shape[1]
    o = origins[:, None].expand(3, r) if origins.dim() == 1 else origins
    tmax = (d_rows.new_full((1, r), BIG_TMAX) if t_max is None
            else t_max.reshape(1, r))
    return torch.cat([o, d_rows, tmax, d_rows.new_zeros((1, r))], dim=0)


def _dot3(k: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """(T, 3) . (3,) summed in order x, y, z, as jnp.sum reduces three
    terms."""
    return k[:, 0:1] * o[0] + k[:, 1:2] * o[1] + k[:, 2:3] * o[2]


def _origin_scalars(tris_packed: torch.Tensor, origin: torch.Tensor):
    """(num, a_u, a_v), each (T, 1): the origin-dependent parts of
    Baldwin-Weber for one shared origin o:
        num  = plane_d - n.o        (t = num / n.d)
        a_u  = k_u.o + c_u          (u = a_u + t * k_u.d)
        a_v  = k_v.o + c_v"""
    o = origin.reshape(3)
    num = tris_packed[:, 3:4] - _dot3(tris_packed[:, 0:3], o)
    au = _dot3(tris_packed[:, 4:7], o) + tris_packed[:, 7:8]
    av = _dot3(tris_packed[:, 8:11], o) + tris_packed[:, 11:12]
    return num, au, av


def pack_tris_origin(tris_packed: torch.Tensor,
                     origin: torch.Tensor) -> torch.Tensor:
    """Per-launch triangle rows for the shared-origin kernels.

    When every ray of a launch has the SAME origin o (primary rays from the
    camera; shadow rays reversed to start at their point light), the
    origin-dependent dot products of Baldwin-Weber are per-triangle scalars
    (`_origin_scalars`). Output rows: [nx, ny, nz, num, kux, kuy, kuz, a_u,
    kvx, kvy, kvz, a_v, 0...]."""
    num, au, av = _origin_scalars(tris_packed, origin)
    pad = tris_packed.new_zeros((tris_packed.shape[0], 4))
    return torch.cat([tris_packed[:, 0:3], num, tris_packed[:, 4:7], au,
                      tris_packed[:, 8:11], av, pad], dim=1)


def pack_dirs(tris_packed: np.ndarray, tb: int) -> np.ndarray:
    """Static direction matrix A of the tensor-core kernels: (3T, 8) on the
    host from the (T, 16) pack_tris rows. Per block b, rows [3b*tb,
    3b*tb+tb) hold n, the next tb rows k_u, the next tb rows k_v, each with
    xyz in COLUMNS 3:6 (the d rows of the packed rays) and zeros elsewhere.
    A is translation-invariant, so the dynamic renderer never refolds it."""
    t = tris_packed.shape[0]
    if t % tb:
        raise ValueError(f"triangle count {t} not a multiple of tb={tb}")
    nb = t // tb
    blk = tris_packed.reshape(nb, tb, 16)
    a = np.zeros((nb, 3, tb, 8), np.float32)
    a[:, 0, :, 3:6] = blk[:, :, 0:3]
    a[:, 1, :, 3:6] = blk[:, :, 4:7]
    a[:, 2, :, 3:6] = blk[:, :, 8:11]
    return a.reshape(3 * t, 8)


def fold_origin_scal(tris_packed: torch.Tensor,
                     origin: torch.Tensor) -> torch.Tensor:
    """Per-origin scalar rows of the tensor-core kernels: (T, 8), columns
    [num, a_u, a_v, 0...] (`_origin_scalars`, summed in the same order as
    pack_tris_origin's, so both forms see bit-equal scalars)."""
    num, au, av = _origin_scalars(tris_packed, origin)
    pad = tris_packed.new_zeros((tris_packed.shape[0], 5))
    return torch.cat([num, au, av, pad], dim=1)


# ---------------------------------------------------------------------------
# Argument checks (shared by the kernels and the plain versions)
# ---------------------------------------------------------------------------

def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, the rays are on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return x


def _scalar_i32(name, x, default: int, device):
    """A device int32 (1,) tensor from None, a Python int or a tensor. Made
    by a fill on the device, never copied from the host."""
    if x is None:
        x = default
    if isinstance(x, int):
        return torch.full((1,), x, dtype=torch.int32, device=device)
    return _check(name, x.reshape(1), torch.int32, (1,), device)


def _check_tris(tris_packed, block_ids, ablock_ids, w, tb, shared_origin,
                dev):
    """Checks the triangle argument in either form; returns (mxu,
    ablock_ids), ablock_ids defaulting to block_ids in the tuple form."""
    if not isinstance(tris_packed, tuple):
        if ablock_ids is not None:
            raise ValueError("ablock_ids: only with the (A, scal) form")
        t = tris_packed.shape[0]
        if t % tb:
            raise ValueError(f"triangle count {t} not a multiple of tb={tb}")
        _check("tris_packed", tris_packed, torch.float32, (t, 16), dev)
        return False, block_ids
    if len(tris_packed) != 2:
        raise ValueError("tris_packed: the tuple form is (A, scal)")
    if not shared_origin:
        raise ValueError("the (A, scal) form implies a shared origin: pass "
                         "shared_origin=True")
    if tb % 16:
        raise ValueError(f"tb={tb}: the (A, scal) form needs a multiple of "
                         "16 (the tensor-core tile)")
    dirs, scal = tris_packed
    a = dirs.shape[0]
    if a % (3 * tb):
        raise ValueError(f"A has {a} rows, not a multiple of 3*tb={3 * tb}")
    _check("A", dirs, torch.float32, (a, 8), dev)
    s = scal.shape[0]
    if s % tb:
        raise ValueError(f"scal has {s} rows, not a multiple of tb={tb}")
    _check("scal", scal, torch.float32, (s, 8), dev)
    if ablock_ids is None:
        return True, block_ids
    return True, _check("ablock_ids", ablock_ids, torch.int32, (w,), dev)


def _prepare(rays_packed, exclude, tris_packed, tile_ids, block_ids, entry,
             count, gid_base, ablock_ids, rt, tb, shared_origin, exit_every):
    if rt % THREADS or rt // THREADS not in (1, 2, 4, 8):
        raise ValueError(f"rt={rt}: must be 128, 256, 512 or 1024")
    if not 0 < tb <= 512:
        raise ValueError(f"tb={tb}: must be in 1..512")
    if exit_every < 0:
        raise ValueError(f"exit_every={exit_every} < 0")
    dev = rays_packed.device
    if rays_packed.dim() != 2:
        raise ValueError(f"rays_packed: expected (8, R), got "
                         f"{tuple(rays_packed.shape)}")
    r = rays_packed.shape[1]
    if r % rt:
        raise ValueError(f"ray count {r} is not a multiple of rt={rt}")
    _check("rays_packed", rays_packed, torch.float32, (8, r), dev)
    _check("exclude", exclude, torch.int32, (r,), dev)
    w = tile_ids.shape[0]
    _check("tile_ids", tile_ids, torch.int32, (w,), dev)
    _check("block_ids", block_ids, torch.int32, (w,), dev)
    _check("entry", entry, torch.float32, (w,), dev)
    mxu, ablock_ids = _check_tris(tris_packed, block_ids, ablock_ids, w, tb,
                                  shared_origin, dev)
    count = _scalar_i32("count", count, w, dev)
    gid_base = _scalar_i32("gid_base", gid_base, 0, dev)
    return dev, r, w, count, gid_base, mxu, ablock_ids


def _init(name, x, fill, dtype, r, dev):
    if x is None:
        return torch.full((r,), fill, dtype=dtype, device=dev)
    return _check(name, x, dtype, (r,), dev)


def _ptr(x: torch.Tensor, align: int = 4) -> int:
    p = x.data_ptr()
    if p % align:
        raise ValueError(f"tensor at {p:#x} is not {align}-byte aligned")
    return p


def _work_ptrs(tris_packed, tile_ids, block_ids, ablock_ids, mxu):
    """The C entries' triangle and work-list arguments: (tris, tile_ids,
    block_ids) for a (T, 16) tensor; (A, scal, tile_ids, block_ids,
    ablock_ids) for the tuple form."""
    if not mxu:
        return (_ptr(tris_packed, 16), _ptr(tile_ids), _ptr(block_ids))
    dirs, scal = tris_packed
    return (_ptr(dirs, 16), _ptr(scal, 16), _ptr(tile_ids), _ptr(block_ids),
            _ptr(ablock_ids))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def bsr_nearest(rays_packed, exclude, tris_packed, tile_ids, block_ids, entry,
                count=None, init_t=None, init_i=None, gid_base=None,
                ablock_ids=None, *, rt: int, tb: int,
                shared_origin: bool = False, exit_every: int = 0):
    """Nearest hit over the work list: (best_t (R,) f32, best_i (R,) i32).

    Ray tile tile_ids[w] is tested against triangle block block_ids[w] for
    every slot w < min(count, W); later slots are padding. A pair is a hit
    when it passes the inclusive BARY_EPS bounds with den != 0 and t >= 0
    and its global id (gid_base + block * tb + row) is not the ray's
    `exclude` id. Per ray the result is the lexicographic minimum of
    (t, id) over every pair of the ray's tile, seeded with (init_t, init_i)
    (default (inf, BIG_IDX)); a pair that misses counts as (inf, id), as in
    the JAX kernel. Rays of tiles the work list does not name keep init.
    `exit_every` > 0 lets the kernel skip items front to back once every
    ray of the tile has a nearer hit than the item's `entry` (exact).
    With shared_origin=True, tris_packed is the pack_tris_origin layout
    for the common ray origin; with False, the static pack_tris layout, and
    each ray's origin is its rays_packed rows 0..2. Or tris_packed is the
    tuple (A, scal) of pack_dirs and fold_origin_scal (shared_origin=True):
    A block ablock_ids[w] (default block_ids[w]) with scalar block
    block_ids[w]; the direction dots run on the tensor cores in 3xTF32,
    within a few FP32 ulps of the other forms, not bit-equal.
    """
    dev, r, w, count, gid_base, mxu, ablock_ids = _prepare(
        rays_packed, exclude, tris_packed, tile_ids, block_ids, entry, count,
        gid_base, ablock_ids, rt, tb, shared_origin, exit_every)
    init_t = _init("init_t", init_t, float("inf"), torch.float32, r, dev)
    init_i = _init("init_i", init_i, BIG_IDX, torch.int32, r, dev)
    if dev.type == "cpu":
        return _nearest_ref(rays_packed, exclude, tris_packed, tile_ids,
                            block_ids, ablock_ids, count, init_t, init_i,
                            gid_base, rt, tb, shared_origin)
    if dev.type != "cuda":
        raise ValueError(f"bsr_nearest: no kernel for device {dev}")
    out_t, out_i = torch.empty_like(init_t), torch.empty_like(init_i)
    if r:
        lib = _build.load_library()
        work = _work_ptrs(tris_packed, tile_ids, block_ids, ablock_ids, mxu)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            head = (_ptr(rays_packed), r, _ptr(exclude), *work, _ptr(entry),
                    _ptr(count), w, _ptr(init_t), _ptr(init_i),
                    _ptr(gid_base))
            tail = (_ptr(out_t), _ptr(out_i), rt, tb, exit_every)
            # The chunks merge through an int64 key per ray (three
            # launches: seed, chunks, unpack).
            keys = torch.empty(r, dtype=torch.int64, device=dev)
            if mxu:
                _build.launch("bsr_trace", lib.drt_bsr_nearest_mxu, *head,
                              _ptr(keys, 8), *tail, CHUNK, stream)
            else:
                _build.launch("bsr_trace", lib.drt_bsr_nearest, *head,
                              _ptr(keys, 8), *tail, CHUNK, int(shared_origin),
                              stream)
        tracing.COUNTS[launch_key("bsr_nearest", shared_origin, mxu)] += 1
    return out_t, out_i


def bsr_any(rays_packed, exclude, tris_packed, tile_ids, block_ids, entry,
            count=None, init=None, gid_base=None, ablock_ids=None, *,
            rt: int, tb: int, shared_origin: bool = False,
            exit_every: int = 0):
    """Any-hit (shadow) query with per-ray t_max (ray row 6): int32 (R,),
    1 where some pair of the ray's tile hits with t <= t_max (and the id is
    not excluded), else `init` (0/1, default 0). Dead rays pre-seeded as 1
    let a tile stop as soon as every live ray is occluded (`exit_every` > 0;
    exact). Work-list, padding and triangle-form semantics as in
    bsr_nearest; the all-lights launch carries a light * n_blocks offset in
    block_ids into stacked per-light pack_tris_origin (or fold_origin_scal)
    rows, and in the tuple form `ablock_ids` indexes the one shared A.
    """
    dev, r, w, count, gid_base, mxu, ablock_ids = _prepare(
        rays_packed, exclude, tris_packed, tile_ids, block_ids, entry, count,
        gid_base, ablock_ids, rt, tb, shared_origin, exit_every)
    init = _init("init", init, 0, torch.int32, r, dev)
    if dev.type == "cpu":
        return _any_ref(rays_packed, exclude, tris_packed, tile_ids,
                        block_ids, ablock_ids, count, init, gid_base, rt, tb,
                        shared_origin)
    if dev.type != "cuda":
        raise ValueError(f"bsr_any: no kernel for device {dev}")
    out = torch.empty_like(init)
    if r:
        lib = _build.load_library()
        work = _work_ptrs(tris_packed, tile_ids, block_ids, ablock_ids, mxu)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            head = (_ptr(rays_packed), r, _ptr(exclude), *work, _ptr(count),
                    w, _ptr(init), _ptr(gid_base), _ptr(out), rt, tb)
            # Every ray's flag is tested as the chunks go; exit_every has
            # nothing left to do.
            if mxu:
                _build.launch("bsr_trace", lib.drt_bsr_any_mxu, *head, CHUNK,
                              stream)
            else:
                _build.launch("bsr_trace", lib.drt_bsr_any, *head, CHUNK,
                              int(shared_origin), stream)
        tracing.COUNTS[launch_key("bsr_any", shared_origin, mxu)] += 1
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def bsr_nearest_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                    entry, count=None, init_t=None, init_i=None,
                    gid_base=None, ablock_ids=None, *, rt: int, tb: int,
                    shared_origin: bool = False, exit_every: int = 0):
    """bsr_nearest in plain PyTorch on any device, vectorised over work
    items. `exit_every` is accepted and ignored: the kernel's skip never
    changes the result."""
    dev, r, w, count, gid_base, _, ablock_ids = _prepare(
        rays_packed, exclude, tris_packed, tile_ids, block_ids, entry, count,
        gid_base, ablock_ids, rt, tb, shared_origin, exit_every)
    init_t = _init("init_t", init_t, float("inf"), torch.float32, r, dev)
    init_i = _init("init_i", init_i, BIG_IDX, torch.int32, r, dev)
    return _nearest_ref(rays_packed, exclude, tris_packed, tile_ids,
                        block_ids, ablock_ids, count, init_t, init_i,
                        gid_base, rt, tb, shared_origin)


def bsr_any_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                entry, count=None, init=None, gid_base=None, ablock_ids=None,
                *, rt: int, tb: int, shared_origin: bool = False,
                exit_every: int = 0):
    """bsr_any in plain PyTorch on any device, vectorised over work items
    (`exit_every` is accepted and ignored, as in bsr_nearest_ref)."""
    dev, r, w, count, gid_base, _, ablock_ids = _prepare(
        rays_packed, exclude, tris_packed, tile_ids, block_ids, entry, count,
        gid_base, ablock_ids, rt, tb, shared_origin, exit_every)
    init = _init("init", init, 0, torch.int32, r, dev)
    return _any_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                    ablock_ids, count, init, gid_base, rt, tb, shared_origin)


def _chunks(count, w: int, rt: int, tb: int):
    """Item ranges [s, e) covering the live slots [0, min(count, W)). Reads
    `count` on the host: the plain versions are references, not the frame's
    hot path on the card."""
    n = min(max(int(count.item()), 0), w)
    step = max(1, _REF_CHUNK_PAIRS // (rt * tb))
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _pairs(rays_packed, exclude, tris_packed, t_ids, b_ids, a_ids, gid_base,
           rt, tb, shared_origin):
    """The (C, tb, rt) pair math of C items, in the kernels' operation
    order (_pair_math, bsr_trace.py:236-248; _pair_math_mxu :264-277 for
    the tuple form, whose three dots are elementwise here, x, y, z in
    order, so it equals the pack_tris_origin form bit for bit). Returns
    (t, valid incl. exclusion, gid (C, tb, 1), ray rows (8, C, 1, rt))."""
    r = rays_packed.shape[1]
    nt = r // rt
    ray = rays_packed.reshape(8, nt, rt)[:, t_ids, None, :]     # (8, C, 1, rt)
    dx, dy, dz = ray[3], ray[4], ray[5]

    def dot_d(k):                                 # (C, tb, 3) . d -> (C, tb, rt)
        return k[:, :, 0:1] * dx + k[:, :, 1:2] * dy + k[:, :, 2:3] * dz

    if isinstance(tris_packed, tuple):
        dirs, scal = tris_packed
        a = dirs.reshape(-1, 3, tb, 8)[a_ids]                   # (C, 3, tb, 8)
        s = scal.reshape(-1, tb, 8)[b_ids]                      # (C, tb, 8)
        den = dot_d(a[:, 0, :, 3:6])
        t = s[:, :, 0:1] / den
        u = s[:, :, 1:2] + t * dot_d(a[:, 1, :, 3:6])
        v = s[:, :, 2:3] + t * dot_d(a[:, 2, :, 3:6])
    else:
        tri = tris_packed.reshape(-1, tb, 16)[b_ids]            # (C, tb, 16)

        def col(k):
            return tri[:, :, k:k + 1]                           # (C, tb, 1)

        den = dot_d(tri[:, :, 0:3])
        if shared_origin:
            t = col(3) / den
            au, av = col(7), col(11)
        else:
            ox, oy, oz = ray[0], ray[1], ray[2]
            o_n = col(0) * ox + col(1) * oy + col(2) * oz
            t = (col(3) - o_n) / den
            au = (col(4) * ox + col(5) * oy + col(6) * oz) + col(7)
            av = (col(8) * ox + col(9) * oy + col(10) * oz) + col(11)
        u = au + t * dot_d(tri[:, :, 4:7])
        v = av + t * dot_d(tri[:, :, 8:11])
    eps = BARY_EPS
    valid = ((den != 0.0) & (t >= 0.0)
             & (u >= -eps) & (u <= 1.0 + eps)
             & (u + v >= -eps) & (u + v <= 1.0 + eps)
             & (v >= -eps))
    gid = (gid_base + b_ids[:, None] * tb
           + torch.arange(tb, device=t.device)[None, :])[:, :, None]
    excl = exclude.reshape(nt, rt)[t_ids][:, None, :]           # (C, 1, rt)
    return t, valid & (gid != excl), gid, ray


def _keys(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (t, i) lexicographically, for t >= 0 or inf and
    0 <= i < 2**31. Adding 0.0 turns -0.0 into +0.0, which compare equal."""
    bits = (t + 0.0).view(torch.int32).to(torch.int64)
    return (bits << 32) | i.to(torch.int64)


def _item_pairs(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                ablock_ids, count, gid_base, rt, tb, shared_origin):
    """Yields (tile ids (C,), _pairs of the C items) chunk by chunk."""
    for s, e in _chunks(count, tile_ids.shape[0], rt, tb):
        t_ids = tile_ids[s:e].long()
        yield t_ids, _pairs(rays_packed, exclude, tris_packed, t_ids,
                            block_ids[s:e].long(), ablock_ids[s:e].long(),
                            gid_base.long(), rt, tb, shared_origin)


def _nearest_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                 ablock_ids, count, init_t, init_i, gid_base, rt, tb,
                 shared_origin):
    r = rays_packed.shape[1]
    best = _keys(init_t, init_i).reshape(r // rt, rt)
    for t_ids, (t, valid, gid, _) in _item_pairs(
            rays_packed, exclude, tris_packed, tile_ids, block_ids,
            ablock_ids, count, gid_base, rt, tb, shared_origin):
        cand = torch.where(valid, t, float("inf"))
        item = _keys(cand, gid.expand_as(cand)).amin(dim=1)     # (C, rt)
        best.scatter_reduce_(0, t_ids[:, None].expand_as(item), item, "amin")
    best = best.reshape(r)
    best_t = (best >> 32).to(torch.int32).view(torch.float32)
    best_i = (best & 0xFFFFFFFF).to(torch.int32)
    return best_t, best_i


def _any_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids,
             ablock_ids, count, init, gid_base, rt, tb, shared_origin):
    r = rays_packed.shape[1]
    out = init.clone().reshape(r // rt, rt)
    for t_ids, (t, valid, _, ray) in _item_pairs(
            rays_packed, exclude, tris_packed, tile_ids, block_ids,
            ablock_ids, count, gid_base, rt, tb, shared_origin):
        hit = (valid & (t <= ray[6])).any(dim=1).to(torch.int32)  # (C, rt)
        out.scatter_reduce_(0, t_ids[:, None].expand_as(hit), hit, "amax")
    return out.reshape(r)
