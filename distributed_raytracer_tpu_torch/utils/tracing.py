"""Spans, counters and device stage stamps of the program; off by default.

Spans. `span(name, **attrs)` is a context manager at the boundary of a
layer: the frame loop (`loop.*`, runtime/loop.py), the frozen frame's host
side (`frozen.*`, ops/frozen_graph.py, ops/render_bvh.py) and the band
schedule (`bands.*`, parallel/render_sharded_bvh.py). While the tracer is
on (`enable()`), each span is kept in memory with its name, its start and
end on the host's `time.perf_counter_ns()` clock, its parent span, its
frame id and its attributes. While a torch.profiler window records, a span
is also a `torch.profiler.record_function` range (a `user_annotation`
event), on or off, so the device trace names the host's work under each
idle gap. Otherwise `span` returns one shared no-op context.

Frame id. `set_frame(k)` names the frame the loop works on. A span takes
`frame=` when given (a drain names the frame it drains), else that one,
and so does a stamp row: the spans and stamps of one frame share its id.

Counters. `COUNTS` (ops/frozen_graph.COUNTS is this dict) counts graph
captures and replays, the verify checks settled when the frame loop
drains their frame (`verify_deferred`), the frames the loop issued
again after such a check overflowed (`verify_reissued`), the frames
the dynamic renderer issued with a scene diff (`scene_diffs`,
ops/render_dynamic.py), the bounced frames issued by `freeze_bounced`'s
render (`bounced_frames`, ops/render_bvh.py), the static bakes that chose
the per-object leaf-block layout (`bake_by_object`, models/scene.py) and
the host launches of the hand-written kernels, one key per wrapper and
triangle form, on or off; a caller reads differences, or sets keys to 0
to count one run.

Device stamps. `Stamps` marks points of a renderer's frame (five for the
culled frame, kind "stages": before stage A and after A, B1, B2 and C,
`STAGES`; 4 D + 5 for the frame of D Whitted bounces, kind "bounced":
before stage A, after A, then for each bounce b after B1.b, B2.b and C.b
and, but for the last, after R.b, its reflection rays (`BOUNCE_STAGES`,
`bounce_stages(D)`); two for the dynamic frame's scene-diff fold, kind
"fold", before and after it; one after the band gather, kind "gather"). On
CUDA each mark is a one-thread kernel (csrc/stamp.cu, built and loaded
only when the tracer first marks) that writes the card's %globaltimer
into a row of the renderer's device ring. Captured into a frozen frame's
graph (ops/frozen_graph.py), the marks of every replay fill a new row with
no host work; the host notes, in order, the frame of each replay. On the
CPU a mark reads the host clock. `export()` reads each ring once and maps
each card's clock to the host's by two offsets, one measured when the
recording starts (or when a card's first ring is made) and one at the
export (a few rounds of host time, a stamp, a synchronize, host time;
the tightest round kept), linear between them.

`export()` returns the recording as plain data; `write_chrome_trace(path)`
writes it as a chrome trace (tools/xprof.py and a browser open it).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
import weakref
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

# Graph captures and replays of every FrameGraph (ops/frozen_graph.py);
# deferred verify checks settled, and frames issued again after one
# overflowed (runtime/loop.py); frames issued with a scene diff
# (ops/render_dynamic.py); bounced frames issued by freeze_bounced's
# render (ops/render_bvh.py); static bakes that chose the per-object
# leaf-block layout (models/scene.Scene.bake_blocks). Then kernel
# launches, counted only where a CUDA kernel is launched, never by a
# plain version, and by a frozen frame's CUDA graph when it is warmed up
# and captured, never when it is replayed: the traversal kernels per
# triangle form (ops/bsr_trace.launch_key), the ring's step kernels
# (ops/ring_trace.py: one per rank and step; K6's seed and unpack
# launches are not counted) and stage B2's (ops/shade_prep.py).
COUNTS = {"captures": 0, "replays": 0, "verify_deferred": 0,
          "verify_reissued": 0, "scene_diffs": 0, "bounced_frames": 0,
          "bake_by_object": 0, "bsr_nearest": 0, "bsr_any": 0,
          "bsr_nearest_rays": 0, "bsr_any_rays": 0, "bsr_nearest_mxu": 0,
          "bsr_any_mxu": 0, "ring_nearest": 0, "ring_any": 0,
          "shade_prep": 0}

# The culled frame's stages, between its five marks.
STAGES = ("A", "B1", "B2", "C")
# The stages a bounced frame repeats for each bounce b, named "B1.b" ...:
# the nearest query (B1), stage B2, the shadow query and shading (C) and,
# but for the last bounce, the reflection rays and their cull (R).
BOUNCE_STAGES = ("B1", "B2", "C", "R")
# Rows of a device ring: frames a recording keeps per renderer.
RING_ROWS = 4096

_on = False
_epoch = 0                  # one recording per enable()
_frame: Optional[int] = None
_spans: list = []           # closed spans of the recording
_stamps: list = []          # Stamps that wrote rows in the recording
_clock: dict = {}           # card -> [(host ns, device ns, round ns)]
_captured: list = []        # Stamps marked inside the graph being captured
_rings = weakref.WeakSet()  # every live Stamps on a card
_ids = itertools.count()
_local = threading.local()


class _NoSpan:
    def set(self, **attrs) -> None:
        pass


_NULL = contextlib.nullcontext(_NoSpan())


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "frame", "attrs", "epoch", "id", "parent", "start")

    def __init__(self, name: str, frame, attrs: dict):
        self.name, self.frame, self.attrs = name, frame, attrs
        self.epoch = None

    def set(self, **attrs) -> None:
        """Adds attributes known only at the span's end."""
        self.attrs.update(attrs)

    def __enter__(self):
        if _on:
            stack = _stack()
            parent = stack[-1] if stack else None
            if self.frame is None:
                self.frame = _frame
            self.parent = parent.id if parent is not None else None
            self.id, self.epoch = next(_ids), _epoch
            stack.append(self)
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.epoch is None:
            return False
        end = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.epoch == _epoch:
            _spans.append({"name": self.name, "id": self.id,
                           "parent": self.parent, "frame": self.frame,
                           "start_ns": self.start, "end_ns": end,
                           "attrs": self.attrs})
        return False


class _ProfiledSpan(_Span):
    """A span that is also a record_function range of the profiler."""

    __slots__ = ("rf",)

    def __enter__(self):
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.rf.__exit__(*exc)
        return False


def span(name: str, frame: Optional[int] = None, **attrs):
    """A span named `name` (module docstring), with `frame` as its frame id
    when given; the context's value has `set(**attrs)`."""
    prof = _profiler._is_profiler_enabled
    if not (_on or prof):
        return _NULL
    return (_ProfiledSpan if prof else _Span)(name, frame, attrs)


def enabled() -> bool:
    return _on


def set_frame(k: Optional[int]) -> None:
    """The frame the loop works on (None between frames)."""
    global _frame
    _frame = k


def enable() -> None:
    """Starts a new recording: what the last one kept is dropped (device
    rings are kept, and their cards' clocks measured again)."""
    global _on, _epoch
    _epoch += 1
    _spans.clear()
    _stamps.clear()
    _clock.clear()
    _captured.clear()
    for card in sorted({str(s.device) for s in _rings}):
        _calibrated(torch.device(card))
    _on = True


def disable() -> None:
    """Stops recording; what was kept stays for `export()`."""
    global _on
    _on = False


# -- device stamps --------------------------------------------------------

def _lib():
    from distributed_raytracer_tpu_torch.ops import _build

    return _build, _build.load_library("stamp")


def _launch(ring, slot, capacity: int, width: int, point: int,
            last: bool, device) -> None:
    build, lib = _lib()
    with torch.cuda.device(device):
        build.launch("stamp", lib.drt_stamp, ring.data_ptr(),
                     slot.data_ptr(), capacity, width, point, int(last),
                     torch.cuda.current_stream(device).cuda_stream)


def _measure_clock(device, rounds: int = 5) -> tuple:
    """(host ns, device ns, round ns) of the tightest of `rounds` rounds of
    host time, a stamp, a synchronize, host time; the host time is the
    round's middle."""
    buf = torch.zeros((1, 1), dtype=torch.int64, device=device)
    slot = torch.zeros((1,), dtype=torch.int32, device=device)
    torch.cuda.synchronize(device)
    best = None
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        _launch(buf, slot, 1, 1, 0, True, device)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
        if best is None or t1 - t0 < best[1] - best[0]:
            best = (t0, t1, int(buf.item()))
    t0, t1, dev = best
    return ((t0 + t1) // 2, dev, t1 - t0)


def _calibrated(device) -> None:
    key = str(device)
    if key not in _clock:
        _clock[key] = [_measure_clock(device)]


def _to_host(card: str, dev_ns: int) -> int:
    """A card's %globaltimer reading on the host's clock."""
    points = _clock[card]
    (h0, d0, _), (h1, d1, _) = points[0], points[-1]
    if d1 == d0:
        return dev_ns + h0 - d0
    off0, off1 = h0 - d0, h1 - d1
    return dev_ns + round(off0 + (off1 - off0) * (dev_ns - d0) / (d1 - d0))


def bounce_stages(depth: int) -> tuple:
    """The stages between the 4 * depth + 5 marks of a frame of `depth`
    bounces: A, then B1.b, B2.b, C.b and, for b < depth, R.b."""
    return ("A",) + tuple(f"{stage}.{b}" for b in range(depth + 1)
                          for stage in BOUNCE_STAGES
                          if b < depth or stage != "R")


class Stamps:
    """The marks of one renderer's frames on its device: `points` per row
    (5 for the culled frame's stages, 4 D + 5 for the frame of D bounces,
    2 around the dynamic frame's fold, 1 for a mark after the band
    gather), `kind` ("stages", "bounced", "fold" or "gather") and `rank`
    (the band's, or None) name the rows in the export."""

    def __init__(self, device, points: int = 5, kind: str = "stages",
                 rank: Optional[int] = None):
        self.device = torch.device(device)
        self.points, self.kind, self.rank = points, kind, rank
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.ring = torch.zeros((RING_ROWS, points), dtype=torch.int64,
                                    device=self.device)
            self.slot = torch.zeros((1,), dtype=torch.int32,
                                    device=self.device)
            _rings.add(self)
            _calibrated(self.device)
        self.written = 0        # rows the device was asked to write
        self.rows: list = []    # (index, frame, issued ns, host ns or None)
        self.epoch = None
        self._host: list = []

    def mark(self, point: int) -> None:
        """Marks point `point` of the current row (the last point closes
        the row). Call only while the tracer is on."""
        last = point == self.points - 1
        if not self.cuda:
            if point == 0:
                self._host = []
            self._host.append(time.perf_counter_ns())
            if last:
                self._row(None, self._host)
            return
        _launch(self.ring, self.slot, RING_ROWS, self.points, point, last,
                self.device)
        if last:
            if torch.cuda.is_current_stream_capturing():
                _captured.append(self)
            else:
                self._row(None, None)

    def replayed(self, issued_ns: int) -> None:
        """A graph holding this ring's marks was replayed, issued at
        `issued_ns` on the host's clock."""
        self._row(issued_ns, None)

    def _row(self, issued_ns, host) -> None:
        if self.epoch != _epoch:
            self.epoch, self.rows = _epoch, []
            _stamps.append(self)
            if self.cuda:
                _calibrated(self.device)
        self.rows.append((self.written, _frame, issued_ns, host))
        self.written += 1

    def _read(self) -> list:
        """The recording's rows as dicts, device times on the host's
        clock; rows the ring has since overwritten are left out."""
        ring = None
        if self.cuda:
            torch.cuda.synchronize(self.device)
            ring = self.ring.cpu().tolist()
        card = str(self.device)
        out = []
        for index, frame, issued, host in self.rows:
            if host is None:
                if index < self.written - RING_ROWS:
                    continue
                host = [_to_host(card, d) for d in ring[index % RING_ROWS]]
            out.append({"kind": self.kind, "card": card, "rank": self.rank,
                        "frame": frame, "issued_ns": issued,
                        "ns": list(host)})
        return out


def take_captured() -> list:
    """The Stamps marked inside the graph just captured (each once); the
    graph's replays call their `replayed`."""
    out = list(dict.fromkeys(_captured))
    _captured.clear()
    return out


def export() -> dict:
    """The recording: spans and stamp rows (each sorted by start), the
    counters and each card's clock points."""
    for card in _clock:
        _clock[card].append(_measure_clock(torch.device(card)))
    stamps = sorted((row for s in _stamps for row in s._read()),
                    key=lambda row: row["ns"][0])
    return {"spans": sorted(_spans, key=lambda s: s["start_ns"]),
            "stamps": stamps, "counters": dict(COUNTS),
            "clock": {card: [list(p) for p in points]
                      for card, points in _clock.items()}}


def write_chrome_trace(path: str) -> None:
    """The recording (`export()`) as a chrome trace: spans on the host's
    row, each renderer's stages (a bounced frame's per bounce, "stage
    B1.0" ...) and folds on its card's row, the counters at the end; times
    in microseconds on the host's clock."""
    rec = export()
    events = []
    for s in rec["spans"]:
        events.append({"name": s["name"], "cat": "span", "ph": "X",
                       "pid": "host", "tid": 0, "ts": s["start_ns"] / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": dict(s["attrs"], frame=s["frame"])})
    for r in rec["stamps"]:
        tid = "gather" if r["kind"] == "gather" else f"rank {r['rank']}"
        ns = r["ns"]
        if r["kind"] == "gather":
            events.append({"name": "gathered", "cat": "stamp", "ph": "i",
                           "s": "t", "pid": r["card"], "tid": tid,
                           "ts": ns[0] / 1e3, "args": {"frame": r["frame"]}})
            continue
        if r["kind"] == "fold":
            events.append({"name": "fold", "cat": "fold", "ph": "X",
                           "pid": r["card"], "tid": tid, "ts": ns[0] / 1e3,
                           "dur": (ns[1] - ns[0]) / 1e3,
                           "args": {"frame": r["frame"]}})
            continue
        names = (STAGES if r["kind"] == "stages"
                 else bounce_stages((len(ns) - 5) // 4))
        for k, stage in enumerate(names):
            events.append({"name": f"stage {stage}", "cat": "stage",
                           "ph": "X", "pid": r["card"], "tid": tid,
                           "ts": ns[k] / 1e3,
                           "dur": (ns[k + 1] - ns[k]) / 1e3,
                           "args": {"frame": r["frame"]}})
    end = max((e["ts"] + e.get("dur", 0) for e in events), default=0.0)
    events.append({"name": "counts", "ph": "C", "pid": "host", "tid": 0,
                   "ts": end, "args": rec["counters"]})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
