"""Frozen frames as CUDA graphs.

The JAX package compiles each frozen pipeline into one dispatch with
`jax.jit` (ops/render_bvh.py freeze() and freeze_bounced(),
ops/render_dynamic.py render_dynamic()). PyTorch runs eagerly, so a frozen
frame here is several hundred small launches enqueued from Python, and the
host sets the pace. A CUDA graph is the counterpart: the frame's launches
are captured once per shape and replayed with one launch.

`FrameGraph` holds one kind of frozen frame on one card:
  - static input buffers (the camera, a scene diff), written before each
    replay by a stream-ordered copy outside the graph;
  - the graph captured for the current shape key (the buckets, exit_every,
    the kernel form), after a warm-up run on a side stream; a new key
    releases the old graph and its memory pool and captures again;
  - the graph's output tensors, which the next replay overwrites: callers
    copy them out (`fresh`), as each jitted call returns new arrays.
A capture that fails raises; nothing falls back to the eager frame.

Nothing is captured on the CPU: there the renderers run the eager stages.
`COUNTS` (the tracer's counters, utils/tracing.py) counts captures and
replays. It also counts the kernel wrappers' host launches (`bsr_nearest`
... `shade_prep`): they count while a graph is warmed up and captured, and
not when it is replayed, so an eager launch during a replay still shows
in them (chip_smoke.py's check that a replay launches nothing eagerly
reads them). With the tracer on, a capture is the span `frozen.capture` and a
replay `frozen.replay`; the device stamps a frame marks while it is
captured (tracing.Stamps) fill a new row at each replay, which `run`
notes.

The bucket check. A frozen frame runs with fixed work-list buckets
(`Buckets`: one renderer's rule, grow-only state and fit test) and returns
its true counts; a verify frame holds the counts against the buckets and,
on overflow, refreezes (grow-only) and renders again, at most 8 rounds
(`Check`). Every verify site (CulledRenderer's render_fast, render_dynamic
and freeze_bounced's render, the bands, the culled ring and halo) hands
its check (`Buckets.check`) to `verify`, which runs it at once, as a
caller of `render_fast(verify=True)` expects, unless a deferral is open on
this thread (`deferred()`): the frame loop (runtime/loop.py) opens one
around each render call and settles the checks it collects when it drains
the frame (`settle`), where it waits for the frame's pixels anyway. The
check is the span `frozen.verify` (attributes: its refreeze `rounds`; a
bounced frame's per-bounce work-list counts, ops/render_bvh.py). A deferred
check starts a non-blocking copy of the counts to pinned host memory and
records an event after it, so the render call returns without a host
sync. A multi-process mesh checks at once: every process must take the
refreeze decision at the same point of its stream. `COUNTS` counts the
checks settled at a drain (`verify_deferred`); the loop counts the frames
it issued again after an overflow found there (`verify_reissued`).
"""

from __future__ import annotations

import contextlib
import gc
import logging
import threading
import time

import torch

from distributed_raytracer_tpu_torch.utils import tracing

# The tracer's counters (captures, replays, deferred checks, kernel
# launches), which count on or off; a caller reads differences (or resets
# them to 0).
COUNTS = tracing.COUNTS
# The JAX package's work-list bucket granule (its SMEM segment length); kept
# so both packages size identical buckets from identical counts.
BUCKET_SEGMENT = 16384

_log = logging.getLogger(__name__)
_local = threading.local()


def bucket_w_pad(n: int, margin: float = 1.0) -> int:
    """Static work-list capacity for a measured count: small counts round to
    a power of two, larger ones to a 2048-multiple per 16384-item segment
    (the JAX package's policy, unchanged)."""
    n = max(256, int(n * margin))
    if n <= 2048:
        return 1 << (n - 1).bit_length()
    n_seg = -(-n // BUCKET_SEGMENT)
    g = 2048 * n_seg
    return -(-n // g) * g


def tile_bucket(n: int, n_tiles: int) -> int:
    """Capacity for the compacted hit-TILE set: pow2, floor 8, capped at
    the full tile count (cap = no compaction, overflow impossible)."""
    return min(n_tiles, max(8, 1 << max(0, int(n - 1).bit_length())))


def fresh(outputs):
    """Contiguous copies of a replay's outputs, stream-ordered: a later
    replay leaves them unchanged."""
    return tuple(o.clone(memory_format=torch.contiguous_format)
                 for o in outputs)


def write(buf: torch.Tensor, src: torch.Tensor) -> None:
    """Copies src into the static input buffer: a host tensor from pinned
    memory, non-blocking (the caching host allocator keeps the pinned block
    until the copy has run); a device tensor device to device."""
    if src.device.type == "cpu":
        src = src.pin_memory()
    buf.copy_(src.reshape(buf.shape), non_blocking=True)


class FrameGraph:
    """One kind of frozen frame on one CUDA device."""

    def __init__(self, device, inputs: dict, kind: str = ""):
        """`inputs` maps each static input's name to its (shape, dtype);
        `kind` names the frame in spans."""
        self.device = torch.device(device)
        self.kind = kind
        self.inputs = {name: torch.empty(shape, dtype=dtype,
                                         device=self.device)
                       for name, (shape, dtype) in inputs.items()}
        self.key = None
        self._graph = None
        self._outputs = None
        self._stamps = ()           # tracing.Stamps marked in the graph
        # Of the last capture: the bytes the graph's private pool reserved
        # and the capture's wall time (warm-up included).
        self.pool_bytes = 0
        self.capture_ms = 0.0

    def run(self, key, fn):
        """Runs the frame on the current stream: captures fn (which reads
        `self.inputs` and returns a tuple of tensors) when `key` differs
        from the captured one, then replays. Returns the graph's own output
        tensors, valid until the next replay."""
        if key != self.key:
            with tracing.span("frozen.capture", kind=self.kind,
                              card=self.device.index):
                self._capture(key, fn)
        with tracing.span("frozen.replay", kind=self.kind,
                          card=self.device.index):
            issued = time.perf_counter_ns()
            self._graph.replay()
            COUNTS["replays"] += 1
            for stamps in self._stamps:
                stamps.replayed(issued)
        return self._outputs

    def _capture(self, key, fn) -> None:
        self.release()
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            # Warm-up off the capture: loads the kernels' modules, sets
            # their shared-memory opt-ins and fills the allocator's caches.
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            gc.collect()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            tracing.take_captured()
            with torch.cuda.graph(graph, stream=side):
                outputs = tuple(fn())
            self._stamps = tracing.take_captured()
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self._graph, self._outputs, self.key = graph, outputs, key
        COUNTS["captures"] += 1

    def release(self) -> None:
        """Frees the captured graph and its memory pool."""
        if self._graph is not None:
            self._outputs = None
            self._graph.reset()
        self._graph = self._outputs = self.key = None
        self._stamps = ()


class Check:
    """One verify frame's bucket check. `out` and `counts` are the frame's
    output and its true counts; `fits(host counts)` holds counts against
    the current buckets; `grow(host counts)` refreezes from them,
    grow-only; `again()` renders the frame again with the current buckets,
    writing its own inputs anew, and returns (out, counts). `name` labels
    the span `frozen.verify` and the warning of a loop that does not
    converge, `card` the span; `attrs(host counts)`, when given, names
    more of the span's attributes, read from the counts of the frame `out`
    holds, while the tracer is on."""

    def __init__(self, out, counts: torch.Tensor, fits, grow, again,
                 name: str, card=None, attrs=None):
        self.out, self.counts = out, counts
        self._fits, self._grow, self._again = fits, grow, again
        self.name, self.card, self._attrs = name, card, attrs
        self._host = self._done = None

    def start_copy(self) -> None:
        """Copies the counts as they are now, which later frames may
        overwrite: on CUDA a non-blocking copy into pinned memory on the
        stream the frame ends on, and an event after it."""
        c = self.counts
        if not c.is_cuda:
            self._host = c.clone()
            return
        with torch.cuda.device(c.device):
            self._host = torch.empty(c.shape, dtype=c.dtype,
                                     pin_memory=True)
            self._host.copy_(c, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()

    def _read(self) -> torch.Tensor:
        if self._host is None:
            return self.counts.cpu()
        if self._done is not None:
            self._done.synchronize()
        return self._host

    def settle(self, frame=None) -> bool:
        """Reads the counts and, while they overflow, refreezes and renders
        again (each round strictly grows some bucket), at most 8 rounds;
        warns when the last frame's counts still overflow. Returns True
        when the frame's own counts fit (`out` is the frame as issued),
        False when the buckets grew (`out` and `counts` are the last
        round's)."""
        with tracing.span("frozen.verify", frame=frame, kind=self.name,
                          card=self.card) as span:
            got = self._read()
            fit = ok = self._fits(got)
            rounds = 0
            while not ok and rounds < 8:
                self._grow(got)
                self.out, self.counts = self._again()
                got = self.counts.cpu()
                ok = self._fits(got)
                rounds += 1
            span.set(rounds=rounds)
            if self._attrs is not None and tracing.enabled():
                span.set(**self._attrs(got))
            if not ok:
                _log.warning("%s verify did not converge in 8 rounds "
                             "(counts %s); image may drop blocks",
                             self.name, got.tolist())
        return fit


def verify(check: Check, now: bool = False) -> Check:
    """Runs `check` at once (`now`, or no deferral open on this thread), or
    starts its counts' host copy and hands it to the open deferral.
    Returns the check: its `out` is the frame to return."""
    pending = getattr(_local, "checks", None)
    if now or pending is None:
        check.settle()
    else:
        check.start_copy()
        pending.append(check)
    return check


@contextlib.contextmanager
def deferred():
    """While open, the verify checks made on this thread are collected in
    the list it yields, unsettled, instead of run at once."""
    prev = getattr(_local, "checks", None)
    _local.checks = checks = []
    try:
        yield checks
    finally:
        _local.checks = prev


def settle(checks, frame=None) -> bool:
    """Settles deferred checks in order (`frame`: the drained frame's id,
    for the spans); True when every frame's own counts fit."""
    fit = True
    for check in checks:
        COUNTS["verify_deferred"] += 1
        fit = check.settle(frame) and fit
    return fit


def _grown(new, old):
    return (tuple(map(_grown, new, old)) if isinstance(new, tuple)
            else max(new, old))


def _within(counts, pads) -> bool:
    return (all(map(_within, counts, pads)) if isinstance(pads, tuple)
            else counts <= pads)


class Buckets:
    """One renderer's work-list buckets, `pads`: nested tuples of ints
    (graph keys hash them) in its counts' layout, one vector (the culled
    frame's levels, the hit-TILE count at index `hit`) or one per bounce
    (`hit` None: the halo's and ring's primary then shadow levels).

    The rule: each count x margin through bucket_w_pad, the hit-TILE slot
    through tile_bucket, capped at `n_tiles`. Buckets only grow, or the
    verify loop could not rely on each round growing one. `margin` is the
    refreeze margin: the bands', halo's and ring's build margin;
    CulledRenderer's is freeze()'s default whatever its first freeze took
    (render_fast's refreeze calls freeze() with no margin in the JAX
    package). `worst(host counts)` gives the nested counts held against
    the buckets (the max over bands or ranks, the columns they bound);
    `on_grow(counts)` hears each refreeze of a check."""

    def __init__(self, margin: float, hit=None, n_tiles: int = 0,
                 worst=None, on_grow=None):
        self.margin, self.hit, self.n_tiles = margin, hit, n_tiles
        self.worst = worst or (lambda c: c.tolist())
        self.on_grow, self.pads = on_grow, None

    def rule(self, counts, margin: float) -> tuple:
        if isinstance(counts[0], (list, tuple)):
            return tuple(self.rule(c, margin) for c in counts)
        return tuple(tile_bucket(int(c * margin), self.n_tiles)
                     if k == self.hit else bucket_w_pad(c, margin)
                     for k, c in enumerate(counts))

    def grow(self, counts, margin=None) -> None:
        """The rule's buckets of `counts` (default margin: the refreeze
        margin), never below the current ones: the first is the freeze."""
        pads = self.rule(counts, self.margin if margin is None else margin)
        self.pads = pads if self.pads is None else _grown(pads, self.pads)

    def fits(self, counts) -> bool:
        return _within(counts, self.pads)

    def check(self, out, counts, again, name: str, card=None,
              now: bool = False, attrs=None) -> Check:
        """`verify`(Check) of one frame: its output, its true counts and
        again() -> (out, counts) with the current buckets (`attrs`: the
        Check's span attributes)."""
        def grow(got):
            worst = self.worst(got)
            if self.on_grow is not None:
                self.on_grow(worst)
            self.grow(worst)

        fits = lambda got: self.fits(self.worst(got))
        return verify(Check(out, counts, fits, grow, again, name, card,
                            attrs), now)
