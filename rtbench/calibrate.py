"""The readings the limits of `configs/<config>.json` are set from, at a
cell's own size, in one process:

    python3 -m rtbench.calibrate --workload NAME --seeds 1,2,3 \\
        [--seconds 3] [--control 3]

One set-up; for each seed a short window of the cell's own load from the
seed's start (the frames it samples are those a run of that seed
samples); then, with the program's state freed, each seed's compared
numbers against the plain reference, and for the first `--control`
seeds those of the control: the reference computed in TF32 in the
program's place, at the same poses and scene states. One JSON line per
reading.
"""

from __future__ import annotations

import argparse
import json
import time

from rtbench import judge, reference, run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m rtbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    b = run.setup(cell, "cuda", time.perf_counter())
    windows = []
    for seed in seeds:
        start, events, _, dropped, _, display, _ = run.measure(
            b, seed, args.seconds)
        windows.append((seed, start, dropped, len(events.stamps),
                        display.sample))
    device = run.release(b)
    ref = judge.Reference(b.scene, device, judge.bounces(cell.config))
    for k, (seed, start, dropped, ticks, sample) in enumerate(windows):
        got = run.numbers(b, ref, start, sample)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "side": "program", "ticks": ticks,
                          "dropped": dropped, **got}), flush=True)
        if k < args.control:
            ctl = run.numbers(b, ref, start, sample, reference.Arith("tf32"))
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": "control", **ctl}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
