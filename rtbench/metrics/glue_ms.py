"""glue_ms: device ms per frame of every kernel outside the traversal and
ring kernels (K1-K7 by name, devtrace.kernel_class): raygen, the cull and
work lists, compaction, shading prep, shading, assembly and the uint8
conversion; mean over the cell's cards, from the traced window. Missing
when the window lost kernels."""


def read(rec):
    p = rec.profile
    if p is None or not p["whole"]:
        return None
    ms = [c["by_class_s"].get("other", 0.0) * 1e3 / p["frames"]
          for c in p["cards"].values()]
    return sum(ms) / len(ms)
