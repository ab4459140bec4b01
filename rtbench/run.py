"""One run of one cell:

    python3 -m rtbench --workload NAME --seed N --seconds S --trace 0|1

Set-up (timed as setup_s, from process start): the scene's triangles, the
program's renderer over the configuration's layout (bake, upload, sizing
render, freeze), every pose of one cycle of the traffic (with its scene
state, where the traffic moves the scene) rendered with verify=True in
the cycle's order (so the grow-only buckets and the CUDA graphs are final
before the window, alike for every seed), then a warm
run of the loop. The window: the program's loop for S seconds (window.py).
With --trace 1, a torch.profiler window of a few more frames follows,
and the per-layer metrics are reported instead of the end-to-end ones.
Then the program's state is freed and the sampled frames are held to the
plain reference (judge.py). The last line of stdout is the result; the
numbers compared, each beside its limit, are the last lines of stderr.

The run fails, printing no result, without enough CUDA cards, and when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np

from rtbench import spec

CACHE = os.path.join(spec.HERE, ".cache")
BANNED = ("jax", "jaxlib", "flax", "distributed_raytracer_tpu")


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


@dataclasses.dataclass
class Records:
    """What a run measured, for the metric readers (metrics/<name>.py)."""
    setup_s: float
    window_s: float
    shown: int
    latencies_s: list
    enqueue_s: list            # host seconds of each non-verify frame call
    intervals: Optional[list]  # per card (window ms, [(start, end) ms])
    profile: Optional[dict]    # devtrace.read of the traced frames
    pairs: Optional[list]      # scheduled pairs of each traced frame
    # Scheduled per-ray-origin pairs of each traced frame: a layout's
    # ray_pairs (None for a layout without one).
    ray_pairs: Optional[list] = None


def _seed_seq(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, stream])


@dataclasses.dataclass
class Bench:
    """What set-up made: the scene, the program's layout, the traffic."""
    cell: spec.Cell
    scene: object
    layout: object
    traffic: object


def traced_pairs(layout, traffic, start: int, first: int, frames: int,
                 kind: str = "pairs"):
    """The scheduled pairs of frames first .. first + frames - 1 of the run
    starting at `start`, each at its pose and scene state, by the layout's
    method `kind` ("pairs", or "ray_pairs": those of the per-ray-origin
    kernel)."""
    from rtbench import port

    n = len(traffic.cycle)
    return getattr(layout, kind)(
        [port.camera(traffic.poses[(start + first + k) % n + 1])
         for k in range(frames)],
        [traffic.frame_state(start, first + k) for k in range(frames)])


def setup(cell: spec.Cell, device: str, t0: float) -> Bench:
    """The scene, the program's layout over it, and every (pose, scene
    state) of one traffic cycle rendered with verify=True, in the cycle's
    order."""
    from rtbench import port, scenes, window
    from rtbench.traffic import Traffic

    cfg = cell.config
    sc = scenes.make(cfg["scene"], CACHE)
    t_scene = time.perf_counter()
    layout = spec.load_module(
        "layouts", cfg["layout"][str(cell.chips)]).build(
            port.scene(sc), cfg, device, cell.chips)
    traffic = Traffic(cell.traffic, sc, cfg["width"])
    t_built = time.perf_counter()
    for pose, state in zip(traffic.settle_poses(), traffic.settle_states()):
        layout.render(port.camera(pose), True, state)
    window.sync(layout)
    say(f"setup: scene {t_scene - t0:.2f} s, renderer "
        f"{t_built - t_scene:.2f} s, {len(traffic.cycle)} poses settled "
        f"in {time.perf_counter() - t_built:.2f} s")
    return Bench(cell, sc, layout, traffic)


def measure(b: Bench, seed: int, seconds: float,
            wrap: Optional[Callable] = None):
    """A warm loop, then the window of `seed`: (start, events, renderer,
    frames dropped, device marks, display, window end)."""
    from rtbench import window

    n = len(b.traffic.cycle)
    start = b.traffic.offset(seed)
    warm = 2 * b.traffic.verify_period
    window.loop(b.layout, b.traffic, (start - warm) % n, ticks=warm)
    window.sync(b.layout)
    display = window.Display(int(b.cell.config["check"]["frames"]),
                             _seed_seq(seed, 1))
    events, render, dropped, marks = window.loop(
        b.layout, b.traffic, start, seconds=seconds, display=display,
        wrap=wrap)
    return start, events, render, dropped, marks, display, time.perf_counter()


def release(b: Bench):
    """Frees the program's state; returns the device the reference runs
    on (the layout's first card)."""
    import torch

    device = b.layout.cards[0]
    b.layout.release()
    b.layout = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return device


def numbers(b: Bench, ref, start: int, sample: dict, ar=None) -> dict:
    """The compared numbers of a run's sampled frames (frame index ->
    uint8 frame) against `ref` (a judge.Reference), or, with ar =
    reference.Arith("tf32"), those of the control: the reference in TF32
    in the program's place, at the same frames' poses and scene states."""
    from rtbench import judge

    cfg = b.cell.config
    poses = b.traffic.frame_poses(start, max(sample) + 1)
    states = {i: b.traffic.frame_state(start, i) for i in sample}
    if ar is not None:
        sample = {i: judge.reference_frame(ref.at(states[i]), poses[i],
                                           cfg["width"], cfg["height"],
                                           ar, ref.bounces)[0]
                  for i in judge.by_state(sample, states)}
    return judge.judge(ref, sample, {i: poses[i] for i in sample}, states,
                       cfg["width"], cfg["height"])


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: Optional[float] = None,
        wrap: Optional[Callable] = None) -> dict:
    """The result of one run (the dict printed as the last line). `wrap`,
    when given, wraps the layout's render call in the window (the tests'
    faults)."""
    import torch

    from rtbench import devtrace, judge, window

    t0 = time.perf_counter() if t0 is None else t0
    b = setup(cell, device, t0)
    layout, traffic = b.layout, b.traffic
    start, events, render, dropped, marks, display, t_end = measure(
        b, seed, seconds, wrap)
    t_begin = events.stamps[0]
    shown = sorted(display.shown)
    rec = Records(
        setup_s=t_begin - t0,
        window_s=t_end - t_begin, shown=len(shown),
        latencies_s=[display.shown[i] - events.stamps[i] for i in shown],
        enqueue_s=[c.enqueue_s for c in render.calls if not c.verify],
        intervals=(window.card_intervals(render, marks)
                   if marks is not None else None),
        profile=None, pairs=None)
    found = banned_modules()
    if found:
        raise SystemExit(f"modules loaded in the window: {found}")

    dev_info = {"platform": "cpu" if device == "cpu" else "gpu",
                "kind": ("cpu" if device == "cpu"
                         else torch.cuda.get_device_name(0)),
                "count": len(layout.cards)}
    if trace and render.cuda:
        frames = 2 * traffic.verify_period
        first = len(render.calls)
        trace_events = devtrace.record(lambda: window.loop(
            layout, traffic, start, ticks=frames, first=first))
        rec.profile = devtrace.read(
            trace_events, layout.cards, frames,
            replays=frames * len(layout.cards),
            traversal=getattr(layout, "TRAVERSAL", devtrace.TRAVERSAL))
        rec.pairs = traced_pairs(layout, traffic, start, first, frames)
        if hasattr(layout, "ray_pairs"):
            rec.ray_pairs = traced_pairs(layout, traffic, start, first,
                                         frames, "ray_pairs")
        busy = [c["busy_s"] for c in rec.profile["cards"].values()]
        dev_info["busy_s"] = sum(busy) / len(busy)
        dev_info["window_s"] = rec.profile["window_s"]
    if render.cuda:
        window.sync(layout)
        dev_info["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(d) for d in layout.cards)
    else:
        dev_info["memory_peak_bytes"] = 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    del render, layout
    ref_device = release(b)
    t_ref = time.perf_counter()
    got = numbers(b, judge.Reference(b.scene, ref_device,
                                     judge.bounces(cell.config)),
                  start, display.sample)
    say(f"reference: {got['frames']} frames in "
        f"{time.perf_counter() - t_ref:.1f} s")
    limits = cell.config["check"]["limits"]
    checks = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    checks["dropped"] = {"value": dropped, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    line = {"correct": correct, "attempted": len(events.stamps),
            "failed": dropped, "metrics": metrics, "device": dev_info}
    if rec.profile is not None:
        line["breakdown"] = {"device_ops": rec.profile["device_ops"],
                             "idle_gaps": rec.profile["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv=None, t0: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m rtbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    import distributed_raytracer_tpu_torch  # noqa: F401  (the program)

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        say(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count()}: no result")
        return 2
    line = run(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    found = banned_modules()
    if found:
        say(f"modules of JAX or the JAX package are loaded: {found}; "
            "no result")
        return 3
    for name, c in line["checks"].items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
