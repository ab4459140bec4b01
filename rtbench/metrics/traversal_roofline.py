"""traversal_roofline: the traversal kernels' share of their H100 roofline,
in %: the least time of the traced frames' scheduled pairs (their frozen
counts' finest primary and shadow cells x ray tile x block, summed over
the bands) at 21 FP32 operations a pair over 67 TFLOP/s (roofline.py),
over the K1 and K2 device time of those frames summed over the cards.
Missing when the window lost kernels."""

from rtbench import roofline


def read(rec):
    p = rec.profile
    if p is None or not p["whole"] or not rec.pairs:
        return None
    busy = sum(c["by_class_s"].get("K1", 0.0) + c["by_class_s"].get("K2", 0.0)
               for c in p["cards"].values())
    if busy <= 0:
        return None
    return 100.0 * roofline.bound_s(sum(rec.pairs)) / busy
