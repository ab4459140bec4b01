"""Reading one torch.profiler window of the program's frames.

The kernel classes and the idle-gap reading are copied from
distributed_raytracer_tpu_torch/utils/profiling.py:92-122 (`_CLASSES`,
`_DEVICE`, `_HOST`, `kernel_class`), :209-231 (`_merged`, `_under`) and
:234-265 (`anatomy`'s busy and gap reading), the patterns unchanged; here
they are split by card (a kernel event's "device"), and every graph
replay's traversal kernels are counted, so a window that lost kernels is
found and not read.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

_CLASSES = (
    ("K6", r"ring_nearest_chunks|ring_(seed|unpack)_keys|"
           r"ring_step_kernel<\d+, false>"),
    ("K7", r"ring_any_chunks|ring_step_kernel<\d+, true>"),
    ("K4", r"nearest_mxu|(seed|unpack)_keys<true, true>"),
    ("K5", r"any_mxu"),
    ("K3n", r"nearest_chunk_kernel<\d+, false>|(seed|unpack)_keys<false|"
            r"nearest_rays_kernel|nearest_kernel<\d+, false>"),
    ("K3a", r"any_chunk_kernel<\d+, false>|any_rays_kernel|"
            r"any_kernel<\d+, false>"),
    ("K1", r"nearest_chunk_kernel|seed_keys|unpack_keys|"
           r"nearest_kernel<\d+, true>"),
    ("K2", r"any_chunk_kernel|any_kernel<\d+, true>"),
)
TRAVERSAL = ("K1", "K2")
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "python_function", "cuda_runtime", "cuda_driver",
         "user_annotation")


def kernel_class(name: str) -> str:
    """K1-K7 by a kernel's name, else "other" (the glue)."""
    for k, pat in _CLASSES:
        if re.search(pat, name):
            return k
    return "other"


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _under(host, a: float, b: float):
    mid = (a + b) / 2
    best = None
    for e in host:
        if e["ts"] <= mid <= e["ts"] + e["dur"] and (
                best is None or e["dur"] < best["dur"]):
            best = e
    return best


def record(fn) -> list:
    """The complete events of a torch.profiler window (CPU and CUDA) over
    fn(), written as a chrome trace under TMPDIR and read back."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "window.pt.trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return [e for e in events if "ts" in e and "dur" in e]


def read(events: list, cards: list, frames: int, replays: int,
         n_gaps: int = 10, traversal: tuple = TRAVERSAL) -> dict:
    """The window's reading: per card ("cuda:N") busy seconds and device
    seconds by kernel class; the window's seconds; `whole`, whether every
    graph replay (the window should hold `replays`) ran the same nonzero
    number of kernels of each class in `traversal` (the traversal kernels
    the layout's frame runs: K1 and K2 on the main path); the top device
    operations and the longest idle gaps on any card, with the host event
    under each."""
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    dev = [e for e in events if e.get("cat") in _DEVICE]
    host = [e for e in events if e.get("cat") in _HOST]
    index = {c.index for c in cards}
    per_card, gaps, ops = {}, [], {}
    for i in sorted(index):
        mine = [e for e in dev if e.get("args", {}).get("device") == i]
        busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in mine)
        by_class = {}
        for e in mine:
            if e.get("cat") != "kernel":
                continue
            k = kernel_class(e["name"])
            by_class[k] = by_class.get(k, 0.0) + e["dur"] / 1e6
            name = k if k != "other" else e["name"][:120]
            ops[name] = ops.get(name, 0.0) + e["dur"] / 1e6
        per_card[f"cuda:{i}"] = {
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "by_class_s": by_class}
        t = start
        for a, b in busy + [[end, end]]:
            if a > t:
                gaps.append((t, a, i))
            t = max(t, b)
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "GraphLaunch" in e.get("name", "")]
    corr = {e.get("args", {}).get("correlation") for e in launches}
    counts = {c: [0] * len(traversal) for c in corr}
    for e in dev:
        k = kernel_class(e["name"]) if e.get("cat") == "kernel" else None
        c = e.get("args", {}).get("correlation")
        if k in traversal and c in counts:
            counts[c][traversal.index(k)] += 1
    shapes = {tuple(v) for v in counts.values()}
    whole = (len(launches) == replays and None not in corr
             and len(shapes) == 1 and min(next(iter(shapes))) > 0)
    return {"window_s": (end - start) / 1e6, "frames": frames,
            "cards": per_card, "whole": whole,
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": [_gap(host, *g) for g in
                          sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]]}


def _gap(host, a: float, b: float, card: int) -> list:
    """[card and the host event under the idle span, its seconds]."""
    h = _under(host, a, b)
    return [f"cuda:{card} {h['name'] if h else 'no host event'}",
            (b - a) / 1e6]
