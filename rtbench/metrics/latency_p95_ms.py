"""latency_p95_ms: the 95th percentile, over every frame displayed in the
window, of the time from the frame's input tick to its display. Host
clock."""

import numpy as np


def read(rec):
    if not rec.latencies_s:
        return None
    return float(np.percentile(np.asarray(rec.latencies_s) * 1e3, 95))
