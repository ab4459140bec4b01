"""bounce_roofline: K3n's share of its H100 roofline, in %: the least time
of the traced frames' scheduled per-ray-origin pairs (every bounce's
finest nearest-query cells x ray tile x block, the layout's ray_pairs) at
39 FP32 operations a pair over 67 TFLOP/s (roofline.py), over the K3n
device time of those frames summed over the cards. Missing when the
layout counts no such pairs, or the window lost kernels or ran no K3n."""

from rtbench import roofline


def read(rec):
    p = rec.profile
    if p is None or not p["whole"] or not rec.ray_pairs:
        return None
    busy = sum(c["by_class_s"].get("K3n", 0.0) for c in p["cards"].values())
    if busy <= 0:
        return None
    return 100.0 * roofline.bound_ray_s(sum(rec.ray_pairs)) / busy
