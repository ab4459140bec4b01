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

Both origin forms are ported. shared_origin=True: every ray of a launch
has one origin, folded into the triangle rows by `pack_tris_origin`
(primary rays; shadow rays reversed to start at their light).
shared_origin=False: each ray has its own origin (ray rows 0..2) against
the static `pack_tris` rows (the reflection rays of bounces). The MXU
variants of the JAX package are not ported yet.

Layouts (the JAX package's): rays [8, R] f32 rows (ox,oy,oz,dx,dy,dz,tmax,0);
triangles [T, 16] f32 rows. R is a multiple of the ray tile rt, T of the
triangle block tb.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_raytracer_tpu_torch.ops import _build
from distributed_raytracer_tpu_torch.ops.intersect import BARY_EPS

BIG_IDX = 2 ** 30
# "Unbounded" packed t_max: finite, as in the JAX package (its MXU kernels
# multiply whole ray blocks, and 0 * inf = NaN). All t <= t_max comparisons
# behave identically.
BIG_TMAX = 3.4e38
# The JAX package's work-list bucket granule (its SMEM segment length); kept
# so both packages size identical buckets from identical counts.
_BUCKET_SEGMENT = 16384
# Threads per block of the CUDA kernels; rt / THREADS rays per thread.
THREADS = 128
# Pairs per chunk of the plain versions: bounds their peak memory (an
# unchunked (W, tb, rt) pair tensor is gigabytes at frame sizes).
_REF_CHUNK_PAIRS = 1 << 22

# Kernel launches per wrapper and origin form ("_rays": per-ray origins).
# Incremented only where the CUDA kernel is launched, never by the plain
# versions; a caller resets them to 0 to count the launches of one run.
LAUNCHES = {"bsr_nearest": 0, "bsr_any": 0, "bsr_nearest_rays": 0,
            "bsr_any_rays": 0}


def launch_key(name: str, shared_origin: bool) -> str:
    """The LAUNCHES key of wrapper `name` in one origin form."""
    return name if shared_origin else name + "_rays"


def bucket_w_pad(n: int, margin: float = 1.0) -> int:
    """Static work-list capacity for a measured count: small counts round to
    a power of two, larger ones to a 2048-multiple per 16384-item segment
    (the JAX package's policy, unchanged)."""
    n = max(256, int(n * margin))
    if n <= 2048:
        return 1 << (n - 1).bit_length()
    n_seg = -(-n // _BUCKET_SEGMENT)
    g = 2048 * n_seg
    return -(-n // g) * g


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


def pack_tris_origin(tris_packed: torch.Tensor,
                     origin: torch.Tensor) -> torch.Tensor:
    """Per-launch triangle rows for the shared-origin kernels.

    When every ray of a launch has the SAME origin o (primary rays from the
    camera; shadow rays reversed to start at their point light), the
    origin-dependent dot products of Baldwin-Weber are per-triangle scalars:
        num  = plane_d - n.o        (t = num / n.d)
        a_u  = k_u.o + c_u          (u = a_u + t * k_u.d)
        a_v  = k_v.o + c_v
    Output rows: [nx, ny, nz, num, kux, kuy, kuz, a_u, kvx, kvy, kvz, a_v,
    0...]."""
    o = origin.reshape(3)
    n, pd = tris_packed[:, 0:3], tris_packed[:, 3:4]
    ku, cu = tris_packed[:, 4:7], tris_packed[:, 7:8]
    kv, cv = tris_packed[:, 8:11], tris_packed[:, 11:12]
    num = pd - _dot3(n, o)
    au = _dot3(ku, o) + cu
    av = _dot3(kv, o) + cv
    pad = tris_packed.new_zeros((tris_packed.shape[0], 4))
    return torch.cat([n, num, ku, au, kv, av, pad], dim=1)


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


def _prepare(rays_packed, exclude, tris_packed, tile_ids, block_ids, entry,
             count, gid_base, rt, tb, exit_every):
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
    t = tris_packed.shape[0]
    if t % tb:
        raise ValueError(f"triangle count {t} not a multiple of tb={tb}")
    _check("tris_packed", tris_packed, torch.float32, (t, 16), dev)
    w = tile_ids.shape[0]
    _check("tile_ids", tile_ids, torch.int32, (w,), dev)
    _check("block_ids", block_ids, torch.int32, (w,), dev)
    _check("entry", entry, torch.float32, (w,), dev)
    count = _scalar_i32("count", count, w, dev)
    gid_base = _scalar_i32("gid_base", gid_base, 0, dev)
    return dev, r, w, count, gid_base


def _init(name, x, fill, dtype, r, dev):
    if x is None:
        return torch.full((r,), fill, dtype=dtype, device=dev)
    return _check(name, x, dtype, (r,), dev)


def _launch(fn, *args):
    err = fn(*args)
    if err:
        lib = _build.load_library()
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} "
                           f"({lib.drt_cuda_error_string(err).decode()})")


def _ptr(x: torch.Tensor, align: int = 4) -> int:
    p = x.data_ptr()
    if p % align:
        raise ValueError(f"tensor at {p:#x} is not {align}-byte aligned")
    return p


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def bsr_nearest(rays_packed, exclude, tris_packed, tile_ids, block_ids, entry,
                count=None, init_t=None, init_i=None, gid_base=None, *,
                rt: int, tb: int, shared_origin: bool = False,
                exit_every: int = 0):
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
    each ray's origin is its rays_packed rows 0..2.
    """
    dev, r, w, count, gid_base = _prepare(
        rays_packed, exclude, tris_packed, tile_ids, block_ids, entry, count,
        gid_base, rt, tb, exit_every)
    init_t = _init("init_t", init_t, float("inf"), torch.float32, r, dev)
    init_i = _init("init_i", init_i, BIG_IDX, torch.int32, r, dev)
    if dev.type == "cpu":
        return _nearest_ref(rays_packed, exclude, tris_packed, tile_ids,
                            block_ids, count, init_t, init_i, gid_base, rt, tb,
                            shared_origin)
    if dev.type != "cuda":
        raise ValueError(f"bsr_nearest: no kernel for device {dev}")
    out_t, out_i = torch.empty_like(init_t), torch.empty_like(init_i)
    if r:
        lib = _build.load_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launch(lib.drt_bsr_nearest, _ptr(rays_packed), r, _ptr(exclude),
                    _ptr(tris_packed, 16), _ptr(tile_ids), _ptr(block_ids),
                    _ptr(entry), _ptr(count), w, _ptr(init_t), _ptr(init_i),
                    _ptr(gid_base), _ptr(out_t), _ptr(out_i), rt, tb,
                    exit_every, int(shared_origin), stream)
        LAUNCHES[launch_key("bsr_nearest", shared_origin)] += 1
    return out_t, out_i


def bsr_any(rays_packed, exclude, tris_packed, tile_ids, block_ids, entry,
            count=None, init=None, gid_base=None, *, rt: int, tb: int,
            shared_origin: bool = False, exit_every: int = 0):
    """Any-hit (shadow) query with per-ray t_max (ray row 6): int32 (R,),
    1 where some pair of the ray's tile hits with t <= t_max (and the id is
    not excluded), else `init` (0/1, default 0). Dead rays pre-seeded as 1
    let a tile stop as soon as every live ray is occluded (`exit_every` > 0;
    exact). Work-list, padding and origin-form (`shared_origin`) semantics
    as in bsr_nearest; the all-lights launch carries a light * n_blocks
    offset in block_ids into stacked per-light pack_tris_origin rows.
    """
    dev, r, w, count, gid_base = _prepare(
        rays_packed, exclude, tris_packed, tile_ids, block_ids, entry, count,
        gid_base, rt, tb, exit_every)
    init = _init("init", init, 0, torch.int32, r, dev)
    if dev.type == "cpu":
        return _any_ref(rays_packed, exclude, tris_packed, tile_ids,
                        block_ids, count, init, gid_base, rt, tb,
                        shared_origin)
    if dev.type != "cuda":
        raise ValueError(f"bsr_any: no kernel for device {dev}")
    out = torch.empty_like(init)
    if r:
        lib = _build.load_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launch(lib.drt_bsr_any, _ptr(rays_packed), r, _ptr(exclude),
                    _ptr(tris_packed, 16), _ptr(tile_ids), _ptr(block_ids),
                    _ptr(count), w, _ptr(init), _ptr(gid_base), _ptr(out), rt,
                    tb, exit_every, int(shared_origin), stream)
        LAUNCHES[launch_key("bsr_any", shared_origin)] += 1
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def bsr_nearest_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                    entry, count=None, init_t=None, init_i=None,
                    gid_base=None, *, rt: int, tb: int,
                    shared_origin: bool = False, exit_every: int = 0):
    """bsr_nearest in plain PyTorch on any device, vectorised over work
    items. `exit_every` is accepted and ignored: the kernel's skip never
    changes the result."""
    dev, r, w, count, gid_base = _prepare(
        rays_packed, exclude, tris_packed, tile_ids, block_ids, entry, count,
        gid_base, rt, tb, exit_every)
    init_t = _init("init_t", init_t, float("inf"), torch.float32, r, dev)
    init_i = _init("init_i", init_i, BIG_IDX, torch.int32, r, dev)
    return _nearest_ref(rays_packed, exclude, tris_packed, tile_ids,
                        block_ids, count, init_t, init_i, gid_base, rt, tb,
                        shared_origin)


def bsr_any_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                entry, count=None, init=None, gid_base=None, *, rt: int,
                tb: int, shared_origin: bool = False, exit_every: int = 0):
    """bsr_any in plain PyTorch on any device, vectorised over work items
    (`exit_every` is accepted and ignored, as in bsr_nearest_ref)."""
    dev, r, w, count, gid_base = _prepare(
        rays_packed, exclude, tris_packed, tile_ids, block_ids, entry, count,
        gid_base, rt, tb, exit_every)
    init = _init("init", init, 0, torch.int32, r, dev)
    return _any_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                    count, init, gid_base, rt, tb, shared_origin)


def _chunks(count, w: int, rt: int, tb: int):
    """Item ranges [s, e) covering the live slots [0, min(count, W)). Reads
    `count` on the host: the plain versions are references, not the frame's
    hot path on the card."""
    n = min(max(int(count.item()), 0), w)
    step = max(1, _REF_CHUNK_PAIRS // (rt * tb))
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _pairs(rays_packed, exclude, tris_packed, t_ids, b_ids, gid_base, rt, tb,
           shared_origin):
    """The (C, tb, rt) pair math of C items, in the kernels' operation
    order (_pair_math, bsr_trace.py:236-248). Returns (t, valid incl.
    exclusion, gid (C, tb, 1), ray rows (8, C, 1, rt))."""
    r = rays_packed.shape[1]
    nt, nb = r // rt, tris_packed.shape[0] // tb
    tri = tris_packed.reshape(nb, tb, 16)[b_ids]                # (C, tb, 16)
    ray = rays_packed.reshape(8, nt, rt)[:, t_ids, None, :]     # (8, C, 1, rt)

    def col(k):
        return tri[:, :, k:k + 1]                               # (C, tb, 1)

    dx, dy, dz = ray[3], ray[4], ray[5]
    den = col(0) * dx + col(1) * dy + col(2) * dz               # (C, tb, rt)
    if shared_origin:
        t = col(3) / den
        au, av = col(7), col(11)
    else:
        ox, oy, oz = ray[0], ray[1], ray[2]
        o_n = col(0) * ox + col(1) * oy + col(2) * oz
        t = (col(3) - o_n) / den
        au = (col(4) * ox + col(5) * oy + col(6) * oz) + col(7)
        av = (col(8) * ox + col(9) * oy + col(10) * oz) + col(11)
    u = au + t * (col(4) * dx + col(5) * dy + col(6) * dz)
    v = av + t * (col(8) * dx + col(9) * dy + col(10) * dz)
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


def _nearest_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                 count, init_t, init_i, gid_base, rt, tb, shared_origin):
    r = rays_packed.shape[1]
    nt = r // rt
    best = _keys(init_t, init_i).reshape(nt, rt)
    for s, e in _chunks(count, tile_ids.shape[0], rt, tb):
        t_ids, b_ids = tile_ids[s:e].long(), block_ids[s:e].long()
        t, valid, gid, _ = _pairs(rays_packed, exclude, tris_packed, t_ids,
                                  b_ids, gid_base.long(), rt, tb,
                                  shared_origin)
        cand = torch.where(valid, t, float("inf"))
        item = _keys(cand, gid.expand_as(cand)).amin(dim=1)     # (C, rt)
        best.scatter_reduce_(0, t_ids[:, None].expand_as(item), item, "amin")
    best = best.reshape(r)
    best_t = (best >> 32).to(torch.int32).view(torch.float32)
    best_i = (best & 0xFFFFFFFF).to(torch.int32)
    return best_t, best_i


def _any_ref(rays_packed, exclude, tris_packed, tile_ids, block_ids, count,
             init, gid_base, rt, tb, shared_origin):
    r = rays_packed.shape[1]
    nt = r // rt
    out = init.clone().reshape(nt, rt)
    for s, e in _chunks(count, tile_ids.shape[0], rt, tb):
        t_ids, b_ids = tile_ids[s:e].long(), block_ids[s:e].long()
        t, valid, _, ray = _pairs(rays_packed, exclude, tris_packed, t_ids,
                                  b_ids, gid_base.long(), rt, tb,
                                  shared_origin)
        hit = (valid & (t <= ray[6])).any(dim=1).to(torch.int32)  # (C, rt)
        out.scatter_reduce_(0, t_ids[:, None].expand_as(hit), hit, "amax")
    return out.reshape(r)
