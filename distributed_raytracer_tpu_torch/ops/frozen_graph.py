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
replays. The kernel wrappers' launch counters (ops/bsr_trace.LAUNCHES)
count host issues: they count while a graph is warmed up and captured, and
not when it is replayed, so an eager launch during a replay still shows
in them (chip_smoke.py's check that a replay launches nothing eagerly
reads them). With the tracer on, a capture is the span `frozen.capture` and a
replay `frozen.replay`; the device stamps a frame marks while it is
captured (tracing.Stamps) fill a new row at each replay, which `run`
notes.
"""

from __future__ import annotations

import gc
import time

import torch

from distributed_raytracer_tpu_torch.utils import tracing

# Captures and replays of every FrameGraph: the tracer's counters, which
# count on or off; a caller reads differences (or resets them to 0).
COUNTS = tracing.COUNTS


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
