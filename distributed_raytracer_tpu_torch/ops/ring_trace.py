"""Geometry-ring traversal: the resident rays of every rank against every
triangle shard, as the shards rotate right around the ranks.

The counterparts of distributed_raytracer_tpu/ops/pallas/ring_trace.py's
`ring_nearest` and `ring_any` (K6 and K7). Each has two implementations of
its step, over ONE rotation:
  - a CUDA kernel written for Hopper (csrc/ring_trace.cu, built on first use
    by ops/_build.py), launched once per rank and ring step for CUDA ranks
    on a grid over chunks of CHUNK (ray tile, 128-row block) items; K6
    merges the steps through a per-rank int64 key scratch, seeded once
    before the rank's first step and unpacked once after its last, K7
    through the rank's flags;
  - a plain PyTorch version of the step (`ring_nearest_ref`, `ring_any_ref`;
    the dense sweep of ops/bsr_trace.py's plain versions), used for CPU
    ranks and as the reference the kernels are held against on the card.
The wrappers choose by the mesh and by nothing else: CUDA ranks launch the
kernel or raise.

The rotation is host-ordered (the Pallas kernel's remote DMAs and
semaphores become streams and events, parallel/mesh.py). Every rank r
has two slots; slot 0 starts as a copy of its own shard (the shard itself
is never written). At step s, with cur = s % 2:
  - compute, on r's compute stream: wait for the shard arriving in slot cur
    (s >= 1), launch the step on slot cur (global ids from origin rank
    (r - s) mod n), record "r done with step s";
  - send (s < n - 1), on r's copy stream: once slot cur's contents are
    there and the right neighbour has finished with its slot 1 - cur (its
    step s - 1 compute AND its step s - 1 send, which read that slot; at
    s = 0, its slots being set up), copy slot cur into the right
    neighbour's slot 1 - cur, and record "arrived at r + 1 for step s + 1".
The copy overlaps the step's kernel. At the end each compute stream waits
for its copy stream, so the slots are free when the call returns.

Layouts: rays (8, R_loc) f32 rows (ox,oy,oz,dx,dy,dz,tmax,0), R_loc a
multiple of the ray tile rt; triangles (T_loc, 16) static `pack_tris` rows
of each rank's resident shard, T_loc a multiple of 128, rank o owning the
global ids [o*T_loc, (o+1)*T_loc); exclusion ids (R_loc,) int32 (-1: none).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from distributed_raytracer_tpu_torch.ops import _build, bsr_trace
from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
from distributed_raytracer_tpu_torch.utils import tracing

BIG_IDX = bsr_trace.BIG_IDX
# Triangle rows per block of the plain step's dense work list (the JAX
# kernel's tb); shards hold a multiple of it.
TB = 128
# (ray tile, TB-row block) items per block of the step kernels' grid
# (csrc/ring_trace.cu); chosen on the H100 (PERF.md).
CHUNK = 2


def _prepare(ranks: mesh_mod.Ranks, rays, tris, exclude, rt: int):
    """Checks the per-rank arguments; returns (exclude list, T_loc)."""
    if rt not in (128, 256, 512):
        raise ValueError(f"rt={rt}: must be 128, 256 or 512")
    n = ranks.n
    if len(rays) != n or len(tris) != n:
        raise ValueError(f"{len(rays)} ray and {len(tris)} triangle tensors "
                         f"for {n} ranks")
    if exclude is not None and len(exclude) != n:
        raise ValueError(f"{len(exclude)} exclusion tensors for {n} ranks")
    t_loc = tris[0].shape[0]
    if t_loc % TB:
        raise ValueError(f"shard of {t_loc} triangles is not a multiple of "
                         f"{TB}")
    r_loc = rays[0].shape[1] if rays[0].dim() == 2 else -1
    if r_loc < 0 or r_loc % rt:
        raise ValueError(f"rays {tuple(rays[0].shape)}: expected (8, R) with "
                         f"R a multiple of rt={rt}")
    excl = []
    for r in range(n):
        dev = ranks.mesh[r]
        bsr_trace._check(f"rays[{r}]", rays[r], torch.float32, (8, r_loc),
                         dev)
        bsr_trace._check(f"tris[{r}]", tris[r], torch.float32, (t_loc, 16),
                         dev)
        if exclude is None:
            with ranks.on(r):
                excl.append(torch.full((r_loc,), -1, dtype=torch.int32,
                                       device=dev))
        else:
            excl.append(bsr_trace._check(f"exclude[{r}]", exclude[r],
                                         torch.int32, (r_loc,), dev))
    return excl, t_loc


def _rotate(ranks: mesh_mod.Ranks, tris: Sequence[torch.Tensor], step):
    """The host-ordered rotation: step(r, slot, gid_base) for every rank r
    and ring step s, on r's compute stream (see the module docstring)."""
    n, mesh = ranks.n, ranks.mesh
    t_loc = tris[0].shape[0]
    slots, ready = [], []
    for r in range(n):
        with ranks.on(r):
            buf = torch.empty((2, t_loc, 16), dtype=torch.float32,
                              device=mesh[r])
            buf[0].copy_(tris[r])
        slots.append(buf)
        ready.append(ranks.record(r))
    done = sent = [None] * n
    for s in range(n):
        cur = s % 2
        arrived = [sent[(r - 1) % n] for r in range(n)]
        now_done = []
        for r in range(n):
            with ranks.on(r):
                ranks.wait(r, arrived[r])
                step(r, slots[r][cur], ((r - s) % n) * t_loc)
            now_done.append(ranks.record(r))
        if s < n - 1:
            now_sent = []
            for r in range(n):
                right = (r + 1) % n
                there = ready[r] if s == 0 else arrived[r]
                capacity = ((ready[right],) if s == 0
                            else (done[right], sent[right]))
                now_sent.append(mesh_mod.copy_async(
                    ranks, r, slots[r][cur], slots[right][1 - cur],
                    after=(there,) + capacity))
            sent = now_sent
        done = now_done
    if n > 1:
        for r in range(n):
            ranks.wait(r, sent[r])   # the last send read our slot


def _nearest(ranks, rays, tris, exclude, rt, kernel: bool):
    excl, t_loc = _prepare(ranks, rays, tris, exclude, rt)
    lib = _build.load_library("ring_trace") if kernel else None
    acc, keys = [], []
    for r in range(ranks.n):
        with ranks.on(r):
            r_loc, dev = rays[r].shape[1], ranks.mesh[r]
            if kernel:
                # The kernel's int64 key per ray, seeded with (inf, BIG_IDX)
                # on the rank's compute stream; acc is unpacked at the end.
                keys.append(torch.empty((r_loc,), dtype=torch.int64,
                                        device=dev))
                _build.launch("ring_trace", lib.drt_ring_seed_keys,
                              _ptr(keys[r], 8), r_loc, *_stream(rays[r]))
                acc.append((torch.empty((r_loc,), device=dev),
                            torch.empty((r_loc,), dtype=torch.int32,
                                        device=dev)))
            else:
                acc.append((torch.full((r_loc,), float("inf"), device=dev),
                            torch.full((r_loc,), BIG_IDX, dtype=torch.int32,
                                       device=dev)))

    def step(r, slot, gid_base):
        acc_t, acc_i = acc[r]
        if kernel:
            _build.launch("ring_trace", lib.drt_ring_nearest_step,
                          *_step_args(rays[r], excl[r], slot, gid_base),
                          _ptr(keys[r], 8), rt, CHUNK, *_stream(rays[r]))
            tracing.COUNTS["ring_nearest"] += 1
            return
        t_ids, b_ids, count, base = _dense_worklist(rays[r], slot, gid_base,
                                                    rt)
        best_t, best_i = bsr_trace._nearest_ref(
            rays[r], excl[r], slot, t_ids, b_ids, b_ids, count, acc_t, acc_i,
            base, rt, TB, False)
        acc_t.copy_(best_t)
        acc_i.copy_(best_i)

    _rotate(ranks, tris, step)
    if kernel:
        for r in range(ranks.n):
            with ranks.on(r):
                _build.launch("ring_trace", lib.drt_ring_unpack_keys,
                              _ptr(keys[r], 8), _ptr(acc[r][0]),
                              _ptr(acc[r][1]), rays[r].shape[1],
                              *_stream(rays[r]))
    return [a[0] for a in acc], [a[1] for a in acc]


def _any(ranks, rays, tris, exclude, rt, kernel: bool):
    excl, t_loc = _prepare(ranks, rays, tris, exclude, rt)
    lib = _build.load_library("ring_trace") if kernel else None
    acc = []
    for r in range(ranks.n):
        with ranks.on(r):
            acc.append(torch.zeros((rays[r].shape[1],), dtype=torch.int32,
                                   device=ranks.mesh[r]))

    def step(r, slot, gid_base):
        if kernel:
            _build.launch("ring_trace", lib.drt_ring_any_step,
                          *_step_args(rays[r], excl[r], slot, gid_base),
                          _ptr(acc[r]), rt, CHUNK, *_stream(rays[r]))
            tracing.COUNTS["ring_any"] += 1
            return
        t_ids, b_ids, count, base = _dense_worklist(rays[r], slot, gid_base,
                                                    rt)
        acc[r].copy_(bsr_trace._any_ref(rays[r], excl[r], slot, t_ids, b_ids,
                                        b_ids, count, acc[r], base, rt, TB,
                                        False))

    _rotate(ranks, tris, step)
    return acc


def _dense_worklist(rays, slot, gid_base: int, rt: int):
    """Every (ray tile, triangle block) pair of one step as a work list for
    ops/bsr_trace.py's plain versions: (tile_ids, block_ids, count,
    gid_base), on the rays' device."""
    dev = rays.device
    nt, nb = rays.shape[1] // rt, slot.shape[0] // TB
    t_ids = torch.arange(nt, dtype=torch.int32,
                         device=dev).repeat_interleave(nb)
    b_ids = torch.arange(nb, dtype=torch.int32, device=dev).repeat(nt)
    full = lambda v: torch.full((1,), v, dtype=torch.int32, device=dev)
    return t_ids, b_ids, full(nt * nb), full(gid_base)


_ptr = bsr_trace._ptr


def _step_args(rays, excl, slot, gid_base: int) -> tuple:
    """The step entries' leading arguments: rays, R, exclusion ids, the
    slot's rows (16-byte aligned), T_loc, gid_base."""
    return (_ptr(rays), rays.shape[1], _ptr(excl), _ptr(slot, 16),
            slot.shape[0], gid_base)


def _stream(x: torch.Tensor) -> tuple:
    """(card, current stream) of x's device: the rank's compute stream."""
    return x.device.index, torch.cuda.current_stream(x.device).cuda_stream


def _check_device(ranks: mesh_mod.Ranks, name: str) -> bool:
    """True for CUDA ranks (the kernel), False for CPU ranks (the plain
    version); raises for anything else."""
    kind = ranks.mesh[0].type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {ranks.mesh[0]}")
    return kind == "cuda"


def ring_nearest(ranks: mesh_mod.Ranks, rays: Sequence[torch.Tensor],
                 tris: Sequence[torch.Tensor],
                 exclude: Optional[Sequence[torch.Tensor]] = None, *,
                 rt: int = 512) -> tuple:
    """Nearest hit of every rank's resident rays against ALL shards.

    Per rank r: rays[r] (8, R_loc), tris[r] (T_loc, 16) its resident
    shard, exclude[r] (R_loc,) ids masked per ray (default none). Returns
    ([best_t (R_loc,) f32], [best_gid (R_loc,) i32]) per rank, made on the
    ranks' compute streams: per ray the lexicographic minimum of (t, gid)
    over every pair, a pair that misses counting as (inf, gid), so a ray
    that hits nothing gets (inf, 0), as in the JAX kernel. K6 (CUDA) on
    CUDA ranks, the plain version on CPU ranks."""
    return _nearest(ranks, rays, tris, exclude, rt,
                    _check_device(ranks, "ring_nearest"))


def ring_any(ranks: mesh_mod.Ranks, rays: Sequence[torch.Tensor],
             tris: Sequence[torch.Tensor],
             exclude: Optional[Sequence[torch.Tensor]] = None, *,
             rt: int = 512) -> List[torch.Tensor]:
    """Any-hit (shadow) query of every rank's rays against ALL shards: rays
    row 6 is the per-ray t_max; `exclude` masks the ray's own surface.
    Returns per rank (R_loc,) int32 0/1. K7 (CUDA) on CUDA ranks, the plain
    version on CPU ranks."""
    return _any(ranks, rays, tris, exclude, rt,
                _check_device(ranks, "ring_any"))


def ring_nearest_ref(ranks, rays, tris, exclude=None, *, rt: int = 512):
    """ring_nearest with the step in plain PyTorch, on any device, over the
    same rotation."""
    return _nearest(ranks, rays, tris, exclude, rt, False)


def ring_any_ref(ranks, rays, tris, exclude=None, *, rt: int = 512):
    """ring_any with the step in plain PyTorch, on any device, over the
    same rotation."""
    return _any(ranks, rays, tris, exclude, rt, False)
