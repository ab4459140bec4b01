"""bounce_ms: device ms per frame of the per-ray-origin nearest kernel K3n
(with its key launches), which every bounce's nearest query of a bounced
frame runs, bounce 0's included; mean over the cell's cards, from the
traced window. Missing when the window lost kernels or ran no K3n."""


def read(rec):
    p = rec.profile
    if p is None or not p["whole"]:
        return None
    ms = [c["by_class_s"].get("K3n", 0.0) * 1e3 / p["frames"]
          for c in p["cards"].values()]
    if not any(ms):
        return None
    return sum(ms) / len(ms)
