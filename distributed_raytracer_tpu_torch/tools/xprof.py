"""Frame anatomy of a torch.profiler chrome trace.

The counterpart of the JAX package's tools/xprof.py, which sums device op
times from an XSpace protobuf. This reads the chrome trace that
utils/profiling.trace writes (a file, or the newest *.json under a
directory) and prints, per frame, through utils/profiling.anatomy:

  - the card's device ms (kernels, copies and sets) and its busy share of
    the window;
  - the top_k kernels by device ms, with their launches in the window and
    their class (K1-K7, or other);
  - the longest idle gaps of the card, with the host event under each
    (the innermost CPU op, Python function or CUDA runtime call).

    python -m distributed_raytracer_tpu_torch.tools.xprof TRACE \\
        [n_frames] [top_k]
"""

from __future__ import annotations

import sys

from distributed_raytracer_tpu_torch.utils import profiling


def report(events, frames: int = 1, top_k: int = 25) -> list:
    """The report's lines for a window of `frames` frames."""
    a = profiling.anatomy(events, frames)
    kernel_ms = sum(a["device_ms"].values())
    lines = [f"== device: {kernel_ms + a['copy_ms']:.3f} ms/frame "
             f"(kernels {kernel_ms:.3f}, copies {a['copy_ms']:.3f}) of a "
             f"{a['window_ms']:.3f} ms/frame window; busy {a['busy']:.4f}; "
             f"{a['kernels']:.1f} kernels and {a['host_launch_calls']:.1f} "
             f"host launch calls per frame",
             "== kernels by device ms/frame (launches in the window)"]
    top = sorted(a["by_name"].items(), key=lambda kv: -kv[1][0])[:top_k]
    for name, (ms, count) in top:
        lines.append(f"  {ms:9.4f} ms x{count:5d}  "
                     f"[{profiling.kernel_class(name)}] {name[:120]}")
    lines.append("== idle gaps of the card, longest first")
    for g in a["gaps"]:
        host = (g["host"] or "no host event")[:100]
        lines.append(f"  {g['ms']:9.4f} ms at +{g['at_ms']:.3f} ms under "
                     f"{g['cat'] or '-'} {host}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: xprof.py TRACE [n_frames] [top_k]", file=sys.stderr)
        return 2
    frames = int(argv[1]) if len(argv) > 1 else 1
    top_k = int(argv[2]) if len(argv) > 2 else 25
    path = profiling.find_trace(argv[0])
    print(f"trace: {path}")
    for line in report(profiling.load_events(path), frames, top_k):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
