"""Ranks as an explicit list of devices: the counterpart of `jax.make_mesh`
plus `shard_map`.

The JAX package is single-controller: one process runs `shard_map` over a
Mesh of devices. Here one process drives a tuple of `torch.device`s, rank i
at index i. Devices may repeat, so n ranks can share one card, as the JAX
package's virtual CPU devices share one CPU. All ranks are CPU or all are
CUDA; a mixed mesh raises.

`Ranks` holds the per-rank execution state of one renderer: each CUDA rank
gets a compute stream and a copy stream of its own. Per-rank work is
enqueued under `ranks.on(r)`; data crosses ranks only through the
collectives below (`send`, `rotate_right`, `all_gather`, `all_to_all`,
`fetch_rows`, `copy_async`, `gather`), which are explicit copies between
per-rank tensors, ordered by CUDA events. The host enqueues every wait
after the event it waits on was recorded, and no kernel ever waits on a
flag that another kernel writes: ranks sharing one card then cannot deadlock (a
kernel spinning on its neighbour's flag could fill every SM while the
neighbour's kernel waits to launch). Nothing here waits on the host.

Memory: a tensor allocated on one stream and read on another is marked
with `record_stream`, or the reading stream's work is joined back into the
allocating stream before the tensor is freed, so the caching allocator
never hands its memory out while a rank still reads it.

CPU ranks run in order on the host; the collectives are plain copies.
There is no `torch.distributed` here: several processes come with
`--multihost`.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch


def check_mesh(mesh: Sequence) -> tuple:
    """The mesh as a tuple of torch.devices; raises if it is empty or mixes
    CPU and CUDA ranks."""
    mesh = tuple(torch.device(d) for d in mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one rank")
    kinds = {d.type for d in mesh}
    if kinds - {"cpu", "cuda"} or len(kinds) > 1:
        raise ValueError(f"a mesh is all cpu or all cuda ranks, got "
                         f"{[str(d) for d in mesh]}")
    if "cuda" in kinds and any(d.index is None for d in mesh):
        raise ValueError("cuda ranks need a device index (cuda:N)")
    return mesh


def make_mesh(n: int, device="cuda") -> tuple:
    """n ranks on `device`: "cpu" puts every rank on the CPU; "cuda" places
    rank i on cuda:(i % device_count), "cuda:k" every rank on card k."""
    if n < 1:
        raise ValueError(f"n={n}: a mesh needs at least one rank")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            count = torch.cuda.device_count()
            return check_mesh(f"cuda:{i % count}" for i in range(n))
    return check_mesh([dev] * n)


def default_mesh(n_devices: Optional[int] = None, device="cuda") -> tuple:
    """make_mesh over every card (one rank each) when n_devices is None;
    one CPU rank for device="cpu"."""
    if n_devices is None:
        n_devices = (torch.cuda.device_count()
                     if torch.device(device).type == "cuda" else 1)
    return make_mesh(n_devices, device)


class Ranks:
    """Per-rank execution state over a mesh: compute and copy streams of
    the CUDA ranks (none for CPU ranks)."""

    def __init__(self, mesh: Sequence):
        self.mesh = check_mesh(mesh)
        self.n = len(self.mesh)
        self.cuda = self.mesh[0].type == "cuda"
        streams = lambda: [torch.cuda.Stream(d) if self.cuda else None
                           for d in self.mesh]
        self.compute = streams()
        self.copy = streams()

    @contextlib.contextmanager
    def on(self, r: int):
        """Enqueue the block's work as rank r's: on its device, on its
        compute stream."""
        if not self.cuda:
            yield
            return
        with torch.cuda.device(self.mesh[r]), \
                torch.cuda.stream(self.compute[r]):
            yield

    def record(self, r: int, stream=None):
        """An event recorded on rank r's compute stream (or `stream`) now;
        None for CPU ranks."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.compute[r] if stream is None else stream)
        return ev

    def wait(self, r: int, *events, stream=None) -> None:
        """Rank r's compute stream (or `stream`) waits for the events."""
        for ev in events:
            if ev is not None:
                (self.compute[r] if stream is None else stream).wait_event(ev)

    def begin(self) -> None:
        """Every compute stream waits for the work already enqueued on its
        device's current stream: inputs the caller made are ready."""
        if self.cuda:
            for r, d in enumerate(self.mesh):
                self.compute[r].wait_stream(torch.cuda.current_stream(d))


def send(ranks: Ranks, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """x, made on rank src's compute stream, as a tensor rank dst's compute
    stream may read: dst waits for src's work so far, and x is copied when
    the two ranks are on different devices (ranks on one device share it
    as it is)."""
    if not ranks.cuda:
        return x.to(ranks.mesh[dst])
    if src == dst:
        return x
    ranks.wait(dst, ranks.record(src))
    if x.device == ranks.mesh[dst]:
        x.record_stream(ranks.compute[dst])
        return x
    # A peer copy on src's stream; PyTorch orders it against dst's current
    # stream (here dst's compute stream) both ways.
    with torch.cuda.stream(ranks.compute[src]), \
            torch.cuda.stream(ranks.compute[dst]):
        return x.to(ranks.mesh[dst], non_blocking=True)


def rotate_right(ranks: Ranks, xs: Sequence[torch.Tensor]) -> List:
    """`ppermute` with (i, i+1 mod n): out[(i+1) % n] = xs[i]."""
    n = ranks.n
    return [send(ranks, xs[(i - 1) % n], (i - 1) % n, i) for i in range(n)]


def all_gather(ranks: Ranks, xs: Sequence[torch.Tensor],
               dim: int = 0) -> List:
    """Every rank gets the concatenation of all ranks' xs along `dim`, made
    on its own compute stream."""
    out = []
    for dst in range(ranks.n):
        parts = [send(ranks, xs[src], src, dst) for src in range(ranks.n)]
        with ranks.on(dst):
            out.append(torch.cat(parts, dim=dim))
    return out


def all_to_all(ranks: Ranks, parts: Sequence[torch.Tensor]) -> List:
    """`jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`:
    dim 0 of every parts[src] splits into n equal chunks, and out[dst] is
    the concatenation of chunk dst of parts[src] over src = 0..n-1, made on
    dst's compute stream. Chunks cross cards by `send`'s copies; ranks on
    one card pass views."""
    n = ranks.n
    out = []
    for dst in range(n):
        pieces = []
        for src in range(n):
            c = parts[src].shape[0] // n
            if c * n != parts[src].shape[0]:
                raise ValueError(f"all_to_all: dim 0 of rank {src}'s part "
                                 f"({parts[src].shape[0]}) does not split "
                                 f"into {n} chunks")
            pieces.append(send(ranks, parts[src][dst * c:(dst + 1) * c],
                               src, dst))
        with ranks.on(dst):
            out.append(torch.cat(pieces))
    return out


def fetch_rows(ranks: Ranks, ids: Sequence[torch.Tensor],
               tables: Sequence[torch.Tensor], t_loc: int) -> List:
    """The owner-row fetch of the ring's kernel transport (`all_gather`
    plus `psum_scatter` in the JAX package): rank o's `tables[o]` holds the
    rows of global ids [o*t_loc, (o+1)*t_loc); each rank gets, per id of
    its `ids` (R,), the row of the rank that owns the id, and zeros where no
    rank owns it. Every owner contributes its rows (zeros elsewhere) and the
    home rank sums the contributions: only one is non-zero."""
    n = ranks.n
    r_loc = ids[0].shape[0]
    g_ids = all_gather(ranks, ids)
    contrib = []
    for o in range(n):
        with ranks.on(o):
            base = o * t_loc
            mine = (g_ids[o] >= base) & (g_ids[o] < base + t_loc)
            loc = torch.clamp(g_ids[o] - base, 0, t_loc - 1).long()
            rows = tables[o][loc]
            keep = mine[:, None] if rows.dim() > 1 else mine
            contrib.append(torch.where(keep, rows, torch.zeros_like(rows)))
    out = []
    for h in range(n):
        parts = [send(ranks, contrib[o][h * r_loc:(h + 1) * r_loc], o, h)
                 for o in range(n)]
        with ranks.on(h):
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            out.append(acc)
    return out


def copy_async(ranks: Ranks, r: int, src: torch.Tensor, dst: torch.Tensor,
               after=()):
    """Rank r sends: dst.copy_(src) on r's copy stream once the events in
    `after` have completed; returns the event of the copy's completion
    (None for CPU ranks, which copy at once). It overlaps whatever the
    compute streams run."""
    if not ranks.cuda:
        dst.copy_(src)
        return None
    stream = ranks.copy[r]
    ranks.wait(r, *after, stream=stream)
    with torch.cuda.stream(stream):
        dst.copy_(src, non_blocking=True)
    return ranks.record(r, stream=stream)


def gather(ranks: Ranks, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The concatenation of every rank's part (dim 0) on rank 0's device,
    made on the caller's current stream, which waits for the ranks' work."""
    dst = ranks.mesh[0]
    if not ranks.cuda:
        return torch.cat([p.to(dst) for p in parts])
    here = torch.cuda.current_stream(dst)
    moved = []
    for r, p in enumerate(parts):
        ev = ranks.record(r)
        here.wait_event(ev)
        p.record_stream(here)
        if p.device != dst:
            # The peer copy runs on p's device's current stream.
            src_stream = torch.cuda.current_stream(p.device)
            src_stream.wait_event(ev)
            p.record_stream(src_stream)
        moved.append(p.to(dst, non_blocking=True))
    return torch.cat(moved)
