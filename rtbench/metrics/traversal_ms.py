"""traversal_ms: device ms per frame of the traversal kernels K1 and K2
(with their key launches), mean over the cell's cards, from the traced
window. Missing when the window lost kernels."""


def read(rec):
    p = rec.profile
    if p is None or not p["whole"]:
        return None
    ms = [(c["by_class_s"].get("K1", 0.0) + c["by_class_s"].get("K2", 0.0))
          * 1e3 / p["frames"] for c in p["cards"].values()]
    return sum(ms) / len(ms)
