"""Profiling and roofline accounting on an NVIDIA H100.

The counterpart of the JAX package's utils/profiling.py, with the H100's
figures in place of a TPU's:
  - `trace(log_dir)`: a torch.profiler window (CPU and CUDA activities)
    written as a chrome trace into log_dir (the jax.profiler trace's
    counterpart; tools/xprof.py reads it);
  - `anatomy(events, frames)`: the one parser of such a trace: the card's
    busy share of the window, device ms and launches per kernel class per
    frame, host launch calls per frame, and the card's longest idle gaps,
    each with the host event under it;
  - `FrameWork` / `frame_work` / `orbit_work`: the work of block-sparse
    frames (scheduled pairs) against the pair-throughput roofline of the
    kernel form they ran.

Roofline (hardware peaks, not the code's own ceiling): NVIDIA's published
dense rates for one H100 SXM at its 700 W power limit, 67 TFLOP/s FP32
outside the tensor cores, 495 TFLOP/s TF32 on them, 3.35 TB/s of HBM3.
  - The shared-origin pair math (K1, K2; csrc/pair_math.cuh) is 21 FP32
    operations per (ray, triangle) pair: den 5, the division 1, u 7, v 7,
    u + v 1. With per-ray origins (K3n, K3a) the three origin dots and
    their folds add 18: 39.
  - The tensor-core form (K4, K5) takes 3 passes x 3 dots x 3
    multiply-adds = 54 tensor operations per pair at the TF32 peak, beside
    the epilogue's 6 FP32 operations (the division, two products, three
    sums): the larger of the two times bounds it. As issued, with K padded
    to 8, the dots are 144 operations per pair.
So the frame's ceilings are 67e12 / 21 ~ 3,190 Gpairs/s (shared origin),
67e12 / 39 ~ 1,718 (per-ray origins) and min(495e12 / 54, 67e12 / 6) ~
9,167 (tensor cores). A card set below 700 W runs below these.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import re
import time
import types

PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# FP32 operations per pair by origin form (shared origin: True).
OPS_PER_PAIR = {True: 21, False: 39}
MXU_TENSOR_OPS, MXU_FP32_OPS, MXU_ISSUED_OPS = 54, 6, 144
SOL_GPAIRS_SHARED = PEAK_FP32 / OPS_PER_PAIR[True] / 1e9          # ~3190
SOL_GPAIRS_MXU = min(PEAK_TF32 / MXU_TENSOR_OPS,
                     PEAK_FP32 / MXU_FP32_OPS) / 1e9              # ~9167


def sol_gpairs(use_mxu: bool = False) -> float:
    """The pair-throughput ceiling of a culled frame's kernel form (its
    primary and shadow launches share the origin), Gpairs/s."""
    return SOL_GPAIRS_MXU if use_mxu else SOL_GPAIRS_SHARED


def bound_ms(pairs: int, shared: bool, n_bytes: int):
    """(least time in ms, "operations" or "bytes") of a CUDA-core launch:
    the larger of the pair math over the FP32 peak and the bytes moved
    over the memory rate."""
    ops = pairs * OPS_PER_PAIR[shared] / PEAK_FP32 * 1e3
    mem = n_bytes / PEAK_BYTES * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def mxu_bounds(pairs: int) -> dict:
    """K4/K5's bounds in ms: the tensor-core one (the larger of the tensor
    and the FP32 epilogue times), the tensor work as issued, and the
    21-operation FP32 bound that K1/K2 are held to."""
    return {"tensor": max(pairs * MXU_TENSOR_OPS / PEAK_TF32,
                          pairs * MXU_FP32_OPS / PEAK_FP32) * 1e3,
            "issued": pairs * MXU_ISSUED_OPS / PEAK_TF32 * 1e3,
            "fp32": pairs * OPS_PER_PAIR[True] / PEAK_FP32 * 1e3}


# -- traces ----------------------------------------------------------------

# Kernel classes by name, as the profiler reports them (this tree's and
# earlier trees' instantiations), the per-ray forms first: an earlier
# tree's bare seed_keys / unpack_keys and chunk kernels without the origin
# flag are K1's and K2's.
_CLASSES = (
    # The ring's step kernels (this tree's and the first design's) come
    # first: ring_seed_keys and ring_unpack_keys would match K1's pattern.
    ("K6", r"ring_nearest_chunks|ring_(seed|unpack)_keys|"
           r"ring_step_kernel<\d+, false>"),
    ("K7", r"ring_any_chunks|ring_step_kernel<\d+, true>"),
    # The tensor-core forms, and their key launches (<true, true>).
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
TRAVERSAL = re.compile("|".join(p for _, p in _CLASSES))
# The CUDA runtime calls that put work on a stream.
_HOST_LAUNCH = r"LaunchKernel|GraphLaunch|Memcpy|Memset"
# Trace categories: work on the card, and the host events a gap can lie
# under.
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "python_function", "cuda_runtime", "cuda_driver",
         "user_annotation")


def kernel_class(name: str) -> str:
    """K1-K7 by a kernel's name, else "other"."""
    for k, pat in _CLASSES:
        if re.search(pat, name):
            return k
    return "other"


def _sync_all() -> None:
    import torch

    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler window (CPU and, where there is a card, CUDA
    activities) over the enclosed block; every card is synchronized before
    it closes, and its chrome trace is written into log_dir. Yields an
    object whose `path` names that file."""
    import torch

    os.makedirs(log_dir, exist_ok=True)
    out = types.SimpleNamespace(path=os.path.join(
        log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield out
        _sync_all()
    prof.export_chrome_trace(out.path)


def find_trace(path: str) -> str:
    """A chrome trace file: `path` itself, or the newest *.json under the
    directory `path`."""
    if os.path.isfile(path):
        return path
    found = glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
    if not found:
        raise FileNotFoundError(f"no chrome trace (*.json) under {path}")
    return max(found, key=os.path.getmtime)


def load_events(path: str) -> list:
    """The complete events (with a time stamp and a duration) of a chrome
    trace file or of the newest one under a directory."""
    with open(find_trace(path)) as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events if "ts" in e and "dur" in e]


def profile_events(fn, n: int) -> list:
    """The events of one profiler window of n calls of fn (after one
    warm-up call), every card synchronized before and inside the
    window."""
    import tempfile

    fn()
    _sync_all()
    with tempfile.TemporaryDirectory() as d:
        with trace(d) as t:
            for _ in range(n):
                fn()
        return load_events(t.path)


def _merged(spans):
    """Sorted, disjoint (start, end) intervals covering `spans`."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _under(host, a: float, b: float):
    """The innermost (shortest) host event spanning the middle of [a, b],
    or None."""
    mid = (a + b) / 2
    best = None
    for e in host:
        if e["ts"] <= mid <= e["ts"] + e["dur"] and (
                best is None or e["dur"] < best["dur"]):
            best = e
    return best


def anatomy(events, frames: int, n_gaps: int = 5) -> dict:
    """The anatomy of a profiler window of `frames` frames (chrome trace
    events, times in us): {"window_ms" (per frame), "busy" (the share of
    the window with a kernel, copy or set on any card), "device_ms" and
    "launches" (per kernel class per frame, kernels only), "copy_ms"
    (copies and sets per frame), "kernels" (per frame), "by_name" ({kernel
    name: (device ms per frame, launches in the window)}),
    "host_launch_calls" (the CUDA runtime's kernel, graph, copy and set
    launches per frame), "gaps" (the n_gaps longest idle spans of the
    window: {"ms", "at_ms" from the window's start, "host": the innermost
    CPU op, Python function or CUDA runtime call under it, or None,
    "cat"})}."""
    events = [e for e in events if "ts" in e and "dur" in e]
    if not events:
        raise ValueError("the trace holds no complete events")
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    window = end - start
    dev = [e for e in events if e.get("cat") in _DEVICE]
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in dev)
    idle, t = [], start
    for a, b in busy + [[end, end]]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    host = [e for e in events if e.get("cat") in _HOST]
    gaps = []
    for a, b in sorted(idle, key=lambda s: s[0] - s[1])[:n_gaps]:
        e = _under(host, a, b)
        gaps.append({"ms": (b - a) / 1e3, "at_ms": (a - start) / 1e3,
                     "host": e["name"] if e else None,
                     "cat": e.get("cat") if e else None})
    device_ms, launches, by_name, copy_ms = {}, {}, {}, 0.0
    for e in dev:
        if e.get("cat") != "kernel":
            copy_ms += e["dur"] / 1e3 / frames
            continue
        k = kernel_class(e["name"])
        device_ms[k] = device_ms.get(k, 0.0) + e["dur"] / 1e3 / frames
        launches[k] = launches.get(k, 0) + 1 / frames
        ms, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3 / frames, count + 1)
    calls = sum(e.get("cat") == "cuda_runtime"
                and re.search(_HOST_LAUNCH, e.get("name", "")) is not None
                for e in events)
    return {"window_ms": window / 1e3 / frames,
            "busy": sum(b - a for a, b in busy) / window if window > 0
            else 0.0,
            "device_ms": device_ms, "launches": launches,
            "copy_ms": copy_ms, "kernels": sum(launches.values()),
            "by_name": by_name, "host_launch_calls": calls / frames,
            "gaps": gaps}


# -- frame work ------------------------------------------------------------

def _num(x):
    """A count as a Python number (numpy and torch scalars converted), so
    products of counts never wrap in 32 bits."""
    return x.item() if hasattr(x, "item") else x


@dataclasses.dataclass
class FrameWork:
    """Work accounting for one block-sparse frame."""

    primary_cells: float
    shadow_cells: float
    rays: int
    ray_tile: int
    tri_block: int
    seconds: float
    # Roofline for the kernel form this frame actually ran
    # (sol_gpairs(use_mxu)).
    sol_gpairs: float = SOL_GPAIRS_SHARED

    @property
    def pairs(self):
        """Scheduled (post-cull, pre-early-exit) pairs, in Python numbers:
        a 5 M-triangle frame schedules more than 2^31."""
        return ((_num(self.primary_cells) + _num(self.shadow_cells))
                * int(self.ray_tile) * int(self.tri_block))

    @property
    def gpairs_per_sec(self) -> float:
        return self.pairs / self.seconds / 1e9

    @property
    def sol_fraction(self) -> float:
        """Fraction of the H100's pair-throughput ceiling (`sol_gpairs`,
        module docstring) achieved, counting scheduled pairs. Frame time
        includes cull, compaction and shading, so this is an end-to-end
        fraction; the kernel-only fraction is higher."""
        return self.gpairs_per_sec / self.sol_gpairs

    def report(self) -> str:
        return (f"{self.rays} rays, {self.primary_cells}+{self.shadow_cells} "
                f"work cells ({self.pairs / 1e9:.2f} G pairs scheduled) in "
                f"{self.seconds * 1e3:.1f} ms -> {self.gpairs_per_sec:.1f} "
                f"Gpairs/s ({self.sol_fraction:.2%} of the H100 roofline)")


def frame_work(renderer, seconds: float) -> FrameWork:
    """FrameWork of a CulledRenderer's last sync render's counts (the
    finest primary and shadow levels) over `seconds` per frame."""
    lc = renderer._last_counts
    return FrameWork(primary_cells=int(lc[renderer.n_levels - 1]),
                     shadow_cells=int(lc[-1]),
                     rays=renderer.width * renderer.height,
                     ray_tile=renderer.rt, tri_block=renderer.tb,
                     seconds=seconds,
                     sol_gpairs=sol_gpairs(use_mxu=renderer.use_mxu))


def orbit_work(renderer, cameras, seconds: float) -> FrameWork:
    """FrameWork of a frozen CulledRenderer's frames of `cameras` over
    `seconds` per frame: the finest primary and shadow cells of each
    frame (render_many's counts), averaged over the cameras. Raises if a
    frame overflowed its buckets (its counts would undercount): render
    each camera with verify=True first."""
    _, counts = renderer.render_many(cameras)
    rows = counts.cpu().tolist()
    pads = renderer.buckets()
    if any(c > p for row in rows for c, p in zip(row, pads)):
        raise ValueError("a frame overflowed the frozen buckets: its "
                         "counts are not exact")
    nl = renderer.n_levels
    return FrameWork(primary_cells=sum(r[nl - 1] for r in rows) / len(rows),
                     shadow_cells=sum(r[-1] for r in rows) / len(rows),
                     rays=renderer.width * renderer.height,
                     ray_tile=renderer.rt, tri_block=renderer.tb,
                     seconds=seconds,
                     sol_gpairs=sol_gpairs(use_mxu=renderer.use_mxu))

