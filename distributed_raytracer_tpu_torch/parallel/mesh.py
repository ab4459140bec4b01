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

Several processes (`--multihost`, parallel/multihost.py): a `ProcessMesh`
is the mesh of every rank of the job, each rank's device as its own
process names it, with the process that runs each rank and the transport
between processes. A process runs only its own ranks, `ranks.local`
(rank i runs in process i // (n / processes)); per-rank lists are indexed
by the global rank and hold None at the ranks of other processes. Every
collective keeps its signature and its result at the local ranks: chunks
between local ranks move as above, and the chunks that cross processes
move in ONE `torch.distributed.all_to_all_single` per collective, in which
every process takes part (each pair of processes' chunks packed as bytes,
in an order every process derives from the same list of pairs; a pair of
send/recv per chunk would deadlock once two processes post them in
different orders). `gather` brings the result to process 0 only (None
elsewhere) unless asked for it everywhere. The transport is chosen once,
before the first frame: NCCL when every process owns a card of its own,
else gloo, with every crossing chunk staged through host memory by an
explicit copy. On CUDA the exchange runs on the process's own `comm`
stream: it waits for the events of the sending ranks' compute streams,
which marks their chunks with `record_stream(comm)`; the packed buffers
are made on `comm`, and the call makes `comm` wait for the transport's
own stream, so the caching allocator never reuses them early; the
receiving ranks' compute streams wait for an event recorded on `comm`
after the call, and the received buffer is marked with `record_stream`
for each of them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

# Bytes this process sent to other processes in collectives, and the
# process-level calls that sent them (reset by the caller).
CROSSED = {"bytes": 0, "calls": 0}


class Transport(NamedTuple):
    """How the processes of a job reach each other: this process's index,
    the process count, the backend of the device collectives ("nccl" or
    "gloo"), its group, and the gloo group of small host-side values."""

    process: int
    n_procs: int
    backend: str
    group: object
    host_group: object


class ProcessMesh(tuple):
    """The devices of every rank of a multi-process job (each as its own
    process names it), with `procs`, the process of every rank, and
    `transport`."""

    def __new__(cls, devices, procs, transport: Transport):
        self = super().__new__(cls, devices)
        self.procs = tuple(int(p) for p in procs)
        self.transport = transport
        if len(self.procs) != len(self):
            raise ValueError("a process mesh names the process of every rank")
        return self


def check_mesh(mesh: Sequence) -> tuple:
    """The mesh as a tuple of torch.devices (a ProcessMesh stays one);
    raises if it is empty or mixes CPU and CUDA ranks."""
    devices = tuple(torch.device(d) for d in mesh)
    if not devices:
        raise ValueError("a mesh needs at least one rank")
    kinds = {d.type for d in devices}
    if kinds - {"cpu", "cuda"} or len(kinds) > 1:
        raise ValueError(f"a mesh is all cpu or all cuda ranks, got "
                         f"{[str(d) for d in devices]}")
    if "cuda" in kinds and any(d.index is None for d in devices):
        raise ValueError("cuda ranks need a device index (cuda:N)")
    if isinstance(mesh, ProcessMesh):
        return ProcessMesh(devices, mesh.procs, mesh.transport)
    return devices


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
    this process's CUDA ranks (none for CPU ranks), and, over a
    ProcessMesh, the process layout: `local` (the ranks this process
    runs), `procs`, `process`, `n_procs`, `transport` (None in one
    process) and `comm`, the stream of the exchanges between
    processes."""

    def __init__(self, mesh: Sequence):
        self.mesh = check_mesh(mesh)
        self.n = len(self.mesh)
        self.cuda = self.mesh[0].type == "cuda"
        self.transport = getattr(self.mesh, "transport", None)
        self.procs = getattr(self.mesh, "procs", (0,) * self.n)
        self.process = self.transport.process if self.transport else 0
        self.n_procs = self.transport.n_procs if self.transport else 1
        self.local = tuple(r for r in range(self.n)
                           if self.procs[r] == self.process)
        if not self.local:
            raise ValueError(f"process {self.process} runs no rank of the "
                             "mesh")
        # This process's device: its first rank's (rank 0's in process 0).
        self.device = self.mesh[self.local[0]]
        streams = lambda: [torch.cuda.Stream(d)
                           if self.cuda and r in self.local else None
                           for r, d in enumerate(self.mesh)]
        self.compute = streams()
        self.copy = streams()
        self.comm = (torch.cuda.Stream(self.device)
                     if self.cuda and self.transport is not None else None)

    def is_local(self, r: int) -> bool:
        return self.procs[r] == self.process

    def per_rank(self, fn) -> list:
        """[fn(r) for every rank]: fn runs under on(r), as rank r's work,
        for this process's ranks only (None at the others')."""
        out = [None] * self.n
        for r in self.local:
            with self.on(r):
                out[r] = fn(r)
        return out

    @contextlib.contextmanager
    def on(self, r: int):
        """Enqueue the block's work as rank r's: on its device, on its
        compute stream."""
        if not self.is_local(r):
            raise ValueError(f"rank {r} runs in process {self.procs[r]}, "
                             f"not in this one ({self.process})")
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
        """Every local compute stream waits for the work already enqueued
        on its device's current stream: inputs the caller made are
        ready."""
        if self.cuda:
            for r in self.local:
                self.compute[r].wait_stream(
                    torch.cuda.current_stream(self.mesh[r]))

    def max_over_processes(self, values) -> np.ndarray:
        """The elementwise max of an integer array over every process (the
        array itself in one process): host values every process must agree
        on, such as work-list counts."""
        a = np.asarray(values, dtype=np.int64)
        if self.transport is None:
            return a
        t = torch.from_numpy(a.copy())
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                     group=self.transport.host_group)
        return t.numpy()

    def broadcast(self, values, src_rank: int) -> np.ndarray:
        """The integer array of the process that runs `src_rank`, in every
        process (the array itself in one process)."""
        a = np.asarray(values, dtype=np.int64)
        if self.transport is None:
            return a
        t = torch.from_numpy(a.copy())
        torch.distributed.broadcast(t, src=self.procs[src_rank],
                                    group=self.transport.host_group)
        return t.numpy()


def _cross(ranks: Ranks, pairs: Sequence, chunk_of, like: torch.Tensor):
    """Moves one chunk per (src, dst) rank pair of `pairs` (ranks of
    different processes; the same list in every process) in one
    all_to_all_single over the processes. chunk_of(src, dst) is the tensor
    a local src sends, shaped and typed like `like`. Returns ({(src, dst):
    tensor} for the pairs whose dst is local, the event after which they
    may be read, None on the CPU); {} without a call when no pair crosses.
    Each process's chunks to one process are packed as bytes in the
    order of `pairs`."""
    if not pairs:
        return {}, None
    tr = ranks.transport
    me, n_procs = ranks.process, ranks.n_procs
    nbytes = like.numel() * like.element_size()
    dev = ranks.device
    sends = [[] for _ in range(n_procs)]
    recvs = [[] for _ in range(n_procs)]
    for src, dst in pairs:
        if ranks.procs[src] == me:
            sends[ranks.procs[dst]].append((src, dst))
        elif ranks.procs[dst] == me:
            recvs[ranks.procs[src]].append((src, dst))
    stream = ranks.comm
    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    chunks = []
    for q in range(n_procs):
        for src, dst in sends[q]:
            c = chunk_of(src, dst)
            if tuple(c.shape) != tuple(like.shape) or c.dtype != like.dtype:
                raise ValueError(f"rank {src}'s chunk {tuple(c.shape)} "
                                 f"{c.dtype} differs from the collective's "
                                 f"{tuple(like.shape)} {like.dtype}")
            if stream is not None:
                ranks.wait(src, ranks.record(src), stream=stream)
                c.record_stream(stream)
            chunks.append(c)
    stage = ranks.cuda and tr.backend == "gloo"
    with ctx:
        flat = [c.contiguous().view(torch.uint8).reshape(-1) for c in chunks]
        buf = (torch.cat(flat) if flat
               else torch.empty(0, dtype=torch.uint8, device=dev))
        out = torch.empty(sum(map(len, recvs)) * nbytes, dtype=torch.uint8,
                          device=dev)
        if stage:
            buf, out_host = buf.cpu(), torch.empty(out.shape,
                                                   dtype=torch.uint8)
        torch.distributed.all_to_all_single(
            out_host if stage else out, buf,
            output_split_sizes=[len(r) * nbytes for r in recvs],
            input_split_sizes=[len(s) * nbytes for s in sends],
            group=tr.group)
        if stage:
            out.copy_(out_host)
        ev = ranks.record(ranks.local[0], stream=stream)
    CROSSED["bytes"] += buf.numel()
    CROSSED["calls"] += 1
    got, at = {}, 0
    for q in range(n_procs):
        for key in recvs[q]:
            got[key] = out[at:at + nbytes].view(like.dtype).reshape(
                like.shape)
            at += nbytes
    if stream is not None:
        for r in ranks.local:
            out.record_stream(ranks.compute[r])
    return got, ev


def _rep(ranks: Ranks, proc: int) -> int:
    """The first rank of process `proc`: the destination that stands for
    the whole process in a collective every rank of it reads."""
    return ranks.procs.index(proc)


def _crossing(ranks: Ranks, src: int, dst: int) -> bool:
    return ranks.procs[src] != ranks.procs[dst]


def send(ranks: Ranks, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """x, made on rank src's compute stream, as a tensor rank dst's compute
    stream may read: dst waits for src's work so far, and x is copied when
    the two ranks are on different devices (ranks on one device share it
    as it is). Both ranks run in this process; the collectives move the
    chunks that cross processes."""
    if _crossing(ranks, src, dst):
        raise ValueError(f"send: ranks {src} and {dst} run in different "
                         "processes")
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


def _received(ranks: Ranks, got: Dict, ev, key, dst: int) -> torch.Tensor:
    """A chunk `_cross` brought in, readable by rank dst's compute
    stream."""
    ranks.wait(dst, ev)
    return got[key]


def rotate_right(ranks: Ranks, xs: Sequence[torch.Tensor]) -> List:
    """`ppermute` with (i, i+1 mod n): out[(i+1) % n] = xs[i]."""
    n = ranks.n
    pairs = [(s, (s + 1) % n) for s in range(n)
             if _crossing(ranks, s, (s + 1) % n)]
    got, ev = _cross(ranks, pairs, lambda s, d: xs[s],
                     xs[ranks.local[0]])
    out = [None] * n
    for i in ranks.local:
        s = (i - 1) % n
        out[i] = (_received(ranks, got, ev, (s, i), i)
                  if _crossing(ranks, s, i) else send(ranks, xs[s], s, i))
    return out


def all_gather(ranks: Ranks, xs: Sequence[torch.Tensor],
               dim: int = 0) -> List:
    """Every rank gets the concatenation of all ranks' xs along `dim`, made
    on its own compute stream. A chunk crosses to each other process once,
    and every rank there reads it."""
    n = ranks.n
    n_procs = ranks.n_procs
    pairs = [(s, _rep(ranks, q)) for s in range(n) for q in range(n_procs)
             if q != ranks.procs[s]]
    got, ev = _cross(ranks, pairs, lambda s, d: xs[s], xs[ranks.local[0]])
    out, me = [None] * n, _rep(ranks, ranks.process)
    for dst in ranks.local:
        parts = [_received(ranks, got, ev, (src, me), dst)
                 if _crossing(ranks, src, dst)
                 else send(ranks, xs[src], src, dst) for src in range(n)]
        with ranks.on(dst):
            out[dst] = torch.cat(parts, dim=dim)
    return out


def all_to_all(ranks: Ranks, parts: Sequence[torch.Tensor]) -> List:
    """`jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`:
    dim 0 of every parts[src] splits into n equal chunks, and out[dst] is
    the concatenation of chunk dst of parts[src] over src = 0..n-1, made on
    dst's compute stream. Chunks cross cards by `send`'s copies (ranks on
    one card pass views) and processes by one exchange."""
    n = ranks.n
    for src in ranks.local:
        if parts[src].shape[0] % n:
            raise ValueError(f"all_to_all: dim 0 of rank {src}'s part "
                             f"({parts[src].shape[0]}) does not split "
                             f"into {n} chunks")
    c = parts[ranks.local[0]].shape[0] // n
    chunk = lambda src, dst: parts[src][dst * c:(dst + 1) * c]
    pairs = [(s, d) for s in range(n) for d in range(n)
             if _crossing(ranks, s, d)]
    got, ev = _cross(ranks, pairs, chunk, chunk(ranks.local[0], 0))
    out = [None] * n
    for dst in ranks.local:
        pieces = [_received(ranks, got, ev, (src, dst), dst)
                  if _crossing(ranks, src, dst)
                  else send(ranks, chunk(src, dst), src, dst)
                  for src in range(n)]
        with ranks.on(dst):
            out[dst] = torch.cat(pieces)
    return out


def fetch_rows(ranks: Ranks, ids: Sequence[torch.Tensor],
               tables: Sequence[torch.Tensor], t_loc: int) -> List:
    """The owner-row fetch of the ring's kernel transport (`all_gather`
    plus `psum_scatter` in the JAX package): rank o's `tables[o]` holds the
    rows of global ids [o*t_loc, (o+1)*t_loc); each rank gets, per id of
    its `ids` (R,), the row of the rank that owns the id, and zeros where no
    rank owns it. Every owner contributes its rows (zeros elsewhere), an
    `all_to_all` brings each rank's share home, and the home rank sums the
    contributions in rank order: only one is non-zero."""
    n = ranks.n
    g_ids = all_gather(ranks, ids)
    contrib = [None] * n
    for o in ranks.local:
        with ranks.on(o):
            base = o * t_loc
            mine = (g_ids[o] >= base) & (g_ids[o] < base + t_loc)
            loc = torch.clamp(g_ids[o] - base, 0, t_loc - 1).long()
            rows = tables[o][loc]
            keep = mine[:, None] if rows.dim() > 1 else mine
            contrib[o] = torch.where(keep, rows, torch.zeros_like(rows))
    homed = all_to_all(ranks, contrib)
    out = [None] * n
    for h in ranks.local:
        with ranks.on(h):
            parts = homed[h].reshape(n, -1, *homed[h].shape[1:])
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            out[h] = acc
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


def gather(ranks: Ranks, parts: Sequence[torch.Tensor],
           everywhere: bool = False) -> Optional[torch.Tensor]:
    """The concatenation of every rank's part (dim 0) on rank 0's device,
    made on the caller's current stream, which waits for the ranks' work.
    Over several processes it lands on process 0 (None in the others), or
    with everywhere=True on every process's device."""
    n = ranks.n
    n_procs = ranks.n_procs
    dests = range(n_procs) if everywhere else (0,)
    pairs = [(s, _rep(ranks, q)) for s in range(n) for q in dests
             if q != ranks.procs[s]]
    got, ev = _cross(ranks, pairs, lambda s, d: parts[s],
                     parts[ranks.local[0]])
    if ranks.process not in dests:
        return None
    dst = ranks.device
    me = _rep(ranks, ranks.process)
    if not ranks.cuda:
        return torch.cat([got[(r, me)] if _crossing(ranks, r, me)
                          else parts[r].to(dst) for r in range(n)])
    here = torch.cuda.current_stream(dst)
    if ev is not None:
        here.wait_event(ev)
    moved = []
    for r in range(n):
        if _crossing(ranks, r, me):
            got[(r, me)].record_stream(here)
            moved.append(got[(r, me)])
            continue
        p = parts[r]
        ev_r = ranks.record(r)
        here.wait_event(ev_r)
        p.record_stream(here)
        if p.device != dst:
            # The peer copy runs on p's device's current stream.
            src_stream = torch.cuda.current_stream(p.device)
            src_stream.wait_event(ev_r)
            p.record_stream(src_stream)
        moved.append(p.to(dst, non_blocking=True))
    return torch.cat(moved)
