"""The H100 roofline of the traversal kernels.

Copied from distributed_raytracer_tpu_torch/utils/profiling.py:18-21 (the
operation counts), :44-48 (`PEAK_FP32`, `OPS_PER_PAIR`) and :58-65
(`bound_ms`'s operation bound), the figures unchanged: NVIDIA's published
dense FP32 rate of one H100 SXM at its 700 W limit, 67 TFLOP/s outside the
tensor cores; the 21 FP32 operations of the shared-origin pair math
(csrc/pair_math.cuh: den 5, the division 1, u 7, v 7, u + v 1) that K1 and
K2 run for every scheduled (ray, triangle) pair; and the 39 of the
per-ray-origin pair math that K3n and K3a run (the three origin dots and
their folds add 18). Bytes never bind these kernels (profiling.py's
docstring), so the bound is the operations'.
"""

PEAK_FP32 = 67e12
OPS_PER_PAIR_SHARED = 21
OPS_PER_PAIR_RAY = 39


def bound_s(pairs: int) -> float:
    """The least time, in seconds, in which one card runs the pair math
    of `pairs` shared-origin pairs."""
    return pairs * OPS_PER_PAIR_SHARED / PEAK_FP32


def bound_ray_s(pairs: int) -> float:
    """The least time, in seconds, in which one card runs the pair math
    of `pairs` per-ray-origin pairs."""
    return pairs * OPS_PER_PAIR_RAY / PEAK_FP32
