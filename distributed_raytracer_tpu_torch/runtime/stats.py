"""FPS statistics, reproducing the master's exit report exactly.

master/main.go:285-325 records a timestamp after each displayed frame and at
exit computes *cumulative-average* FPS values: with completion timestamps
t_0..t_n, duration_i = t_{i+1} - t_i and fps_i = (i+1) / max(sum_{k<=i}
duration_k / 1000, 0.001) — i.e. the first frame is dropped and each entry is
the running average frame rate. Mean/median/stddev/range are taken over that
series (median is the element at index n/2 of the sorted series, as in Go;
stddev is the population form). This module reproduces those numbers so
benchmark output is directly comparable with final_report.pdf §3.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class FrameStats:
    frames_drawn: int
    frames_total: int
    mean_fps: float
    median_fps: float
    stddev_fps: float
    fps_range: tuple
    fps_per_frame: List[float]
    # Successful render-path rebuilds during the run (runtime/loop.py
    # recovery — the reference's worker re-registration analog). Not part
    # of the Go exit report; kept out of report().
    recoveries: int = 0

    def report(self) -> str:
        lines = [
            f"Total frames drawn: {self.frames_drawn}.",
            f"Total frames: {self.frames_total}.",
            f"Mean FPS: {self.mean_fps:f}.",
            f"Median FPS: {self.median_fps:f}.",
            f"FPS Standard Deviation: {self.stddev_fps:f}.",
            f"FPS Range: [{self.fps_range[0]:f}, {self.fps_range[1]:f}].",
        ]
        return "\n".join(lines)


class FrameTimer:
    """Records per-frame completion timestamps (master/main.go:178-179)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self.timestamps_ms: List[float] = []
        self.frames_total = 0

    def frame_issued(self) -> None:
        self.frames_total += 1

    def frame_drawn(self, at: Optional[float] = None) -> None:
        t = self._clock() if at is None else at
        self.timestamps_ms.append(t * 1000.0)

    def stats(self) -> Optional[FrameStats]:
        """Compute the exit report (master/main.go:289-324 semantics)."""
        n_drawn = len(self.timestamps_ms)
        usable = n_drawn - 1
        if usable <= 0:
            return None
        ends = self.timestamps_ms[1:]
        starts = self.timestamps_ms[:-1]
        duration_sum = 0.0
        fps = []
        for i in range(usable):
            duration_sum += ends[i] - starts[i]
            fps.append((i + 1) / max(duration_sum / 1000.0, 0.001))
        fps_sorted = sorted(fps)
        mean = sum(fps_sorted) / usable
        var = sum((f - mean) ** 2 for f in fps_sorted) / usable
        return FrameStats(
            frames_drawn=n_drawn,
            frames_total=self.frames_total,
            mean_fps=mean,
            median_fps=fps_sorted[usable // 2],
            stddev_fps=var ** 0.5,
            fps_range=(fps_sorted[0], fps_sorted[-1]),
            fps_per_frame=fps,
        )
