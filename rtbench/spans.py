"""The program's own spans and device stage stamps over frames of the loop
(the program's utils/tracing.py), and the readings of them.

`window(b, start, first)`: once a run's timed window and profiler window
are done, turns the program's tracer on, runs a warm loop of 2 x
verify_period frames (the frozen frames' graphs are captured again, now
with their stage stamps), starts a new recording, runs 8 x verify_period
frames of the loop from tick `first` (the profiler window's first tick:
its frames are the recording's first 2 x verify_period), turns the
tracer off and returns its export. A program without a tracer gives
None.

The per-layer readers `metrics/stage_a_ms.py` ... `metrics/gather_ms.py`
read that export (`records.trace`) through the functions below and give
None where it holds nothing for them; `metrics/recaptures.py` reads
`records.recaptures`, the graph captures across the timed window.
`violations(trace)` counts the frames whose stamps disagree with the
host's spans on the host's clock.

    python3 -m rtbench.spans --workload NAME --seed N --seconds S

runs one cell as `python3 -m rtbench ... --trace 1` does up to its
per-layer metrics (set-up, the timed window, the profiler window on
CUDA), then the tracer window, and prints one JSON line: the cell's
per-layer metrics, those read from the tracer, the stamp/span clock
check and the profiler window's idle gaps. It holds no frame to the
reference; `python3 -m rtbench` does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

# The per-layer readers (metrics/<name>.py) of the tracer's export.
READERS = ("stage_a_ms", "stage_b1_ms", "stage_b2_ms", "stage_c_ms",
           "verify_sync_ms", "drain_wait_ms", "band_issue_ms", "gather_ms",
           "recaptures")
SLACK_NS = 50_000


def _tracing():
    try:
        from distributed_raytracer_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def captures() -> int:
    """The program's graph captures so far."""
    from distributed_raytracer_tpu_torch.ops import frozen_graph

    return frozen_graph.COUNTS["captures"]


def window(b, start: int, first: int) -> Optional[dict]:
    """The tracer's export over 8 x verify_period frames of the loop from
    tick `first` of the run starting at cycle position `start` (after a
    warm loop over the first 2 x verify_period of them), or None without
    a tracer."""
    from rtbench import window as win

    tracing = _tracing()
    if tracing is None:
        return None
    period = b.traffic.verify_period
    tracing.enable()
    try:
        win.loop(b.layout, b.traffic, start, ticks=2 * period, first=first)
        win.sync(b.layout)
        tracing.enable()            # a new recording: the frames alone
        win.loop(b.layout, b.traffic, start, ticks=8 * period, first=first)
    finally:
        tracing.disable()
    return tracing.export()


# -- readings -------------------------------------------------------------

def stage_ms(trace: Optional[dict], k: int) -> Optional[float]:
    """Device ms of stage k (A, B1, B2, C) per frame: stamps k to k + 1 of
    every band's frame, mean over the frames and cards."""
    if not trace:
        return None
    rows = [r for r in trace["stamps"]
            if r["kind"] == "stages" and r["frame"] is not None]
    if not rows:
        return None
    return sum(r["ns"][k + 1] - r["ns"][k] for r in rows) / len(rows) / 1e6


def frames_ms(trace: Optional[dict], frames: int) -> Optional[float]:
    """Device ms from stage A's start to stage C's end per band frame,
    mean over the cards and the recording's first `frames` frames."""
    rows = [r for r in (trace or {}).get("stamps", [])
            if r["kind"] == "stages" and r["frame"] is not None
            and r["frame"] < frames]
    if not rows:
        return None
    return sum(r["ns"][-1] - r["ns"][0] for r in rows) / len(rows) / 1e6


def span_ms(trace: Optional[dict], name: str) -> Optional[float]:
    """Mean host ms of the spans named `name`."""
    if not trace:
        return None
    spans = [s for s in trace["spans"] if s["name"] == name]
    if not spans:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / len(spans) / 1e6


def band_issue_ms(trace: Optional[dict]) -> Optional[float]:
    """Host ms per frame from the first rank's replay issue to the last
    rank's (the first round of replays of each frame)."""
    if not trace:
        return None
    rounds = {}
    for s in trace["spans"]:
        if s["name"] == "bands.replay":
            rounds.setdefault((s["frame"], s["parent"]), []).append(s)
    per_frame = {}
    for (frame, _), spans in sorted(rounds.items(),
                                    key=lambda kv: kv[1][0]["start_ns"]):
        per_frame.setdefault(frame, spans)
    if not per_frame:
        return None
    ms = [(max(s["end_ns"] for s in spans)
           - min(s["start_ns"] for s in spans)) / 1e6
          for spans in per_frame.values()]
    return sum(ms) / len(ms)


def gather_ms(trace: Optional[dict]) -> Optional[float]:
    """Device ms per frame from the end of band 0's stage C to the stamp
    after the gather, both on rank 0's card."""
    if not trace:
        return None
    gathers = [r for r in trace["stamps"] if r["kind"] == "gather"]
    ms = []
    for g in gathers:
        band0 = [r["ns"][-1] for r in trace["stamps"]
                 if r["kind"] == "stages" and r["rank"] == 0
                 and r["frame"] == g["frame"] and r["ns"][-1] <= g["ns"][0]]
        if band0:
            ms.append((g["ns"][0] - max(band0)) / 1e6)
    return sum(ms) / len(ms) if ms else None


def violations(trace: Optional[dict], slack_ns: int = SLACK_NS) -> int:
    """Stage rows whose stage A starts before their replay was issued (on
    the CPU: before their frame's loop.issue began), or whose stage C ends
    after their frame's loop.drain ended, by more than `slack_ns`."""
    if not trace:
        return 0
    issue = {s["frame"]: s["start_ns"] for s in trace["spans"]
             if s["name"] == "loop.issue"}
    drain = {s["frame"]: s["end_ns"] for s in trace["spans"]
             if s["name"] == "loop.drain"}
    bad = 0
    for r in trace["stamps"]:
        if r["kind"] != "stages" or r["frame"] not in drain:
            continue
        issued = r["issued_ns"] if r["issued_ns"] is not None else issue.get(
            r["frame"])
        early = issued is not None and r["ns"][0] < issued - slack_ns
        late = r["ns"][-1] > drain[r["frame"]] + slack_ns
        bad += early or late
    return bad


# -- one cell -------------------------------------------------------------

def run(cell, seed: int, seconds: float, device: str = "cuda",
        t0: Optional[float] = None) -> dict:
    """The cell's per-layer readings, those of the tracer among them."""
    import torch

    from rtbench import devtrace, port, spec
    from rtbench import run as rtrun
    from rtbench import window as win

    t0 = time.perf_counter() if t0 is None else t0
    b = rtrun.setup(cell, device, t0)
    layout, traffic = b.layout, b.traffic
    caps = captures()
    start, events, render, dropped, marks, display, t_end = rtrun.measure(
        b, seed, seconds)
    t_begin = events.stamps[0]
    shown = sorted(display.shown)
    rec = rtrun.Records(
        setup_s=t_begin - t0, window_s=t_end - t_begin, shown=len(shown),
        latencies_s=[display.shown[i] - events.stamps[i] for i in shown],
        enqueue_s=[c.enqueue_s for c in render.calls if not c.verify],
        intervals=(win.card_intervals(render, marks)
                   if marks is not None else None),
        profile=None, pairs=None)
    rec.recaptures = captures() - caps
    first = len(render.calls)
    n = len(traffic.cycle)
    line = {"workload": cell.name, "seed": seed, "failed": dropped}
    if render.cuda:
        frames = 2 * traffic.verify_period
        trace_events = devtrace.record(lambda: win.loop(
            layout, traffic, start, ticks=frames, first=first))
        rec.profile = devtrace.read(trace_events, layout.cards, frames,
                                    replays=frames * len(layout.cards))
        rec.pairs = layout.pairs([
            port.camera(traffic.poses[(start + first + k) % n + 1])
            for k in range(frames)])
        line["idle_gaps"] = rec.profile["idle_gaps"]
        line["device"] = {"kind": torch.cuda.get_device_name(0),
                          "count": len(layout.cards)}
    rec.trace = window(b, start, first)
    names = [m["name"] for m in cell.per_layer]
    names += [m for m in READERS if m not in names]
    metrics = {}
    for name in names:
        value = spec.load_module("metrics", name).read(rec)
        if value is not None:
            metrics[name] = value
    line["metrics"] = metrics
    line["violations"] = violations(rec.trace)
    if rec.profile is not None:
        # Stages A..C over the profiler window's own frames, beside its
        # glue and traversal kernels.
        line["profiled_frames_stages_ms"] = frames_ms(
            rec.trace, rec.profile["frames"])
    if rec.trace is not None:
        line["frames_traced"] = len({s["frame"] for s in rec.trace["spans"]
                                     if s["name"] == "loop.drain"})
    rtrun.release(b)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m rtbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from rtbench import spec

    line = run(spec.cell(args.workload), args.seed, args.seconds,
               args.device)
    print(f"stamp/span clock violations: {line['violations']}",
          file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
