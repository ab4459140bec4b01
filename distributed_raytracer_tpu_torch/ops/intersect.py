"""Ray-triangle hit records and the barycentric inclusion tolerance.

The counterparts of distributed_raytracer_tpu/ops/intersect.py's `BARY_EPS`
and `Hits`; the dense queries of that module are not part of this package
yet. Boundary semantics (shared by the BSR kernels, ops/bsr_trace.py) match
the reference's triangle.go exactly — inclusive 0/1 bounds, den != 0,
t >= 0, no backface culling — with the bounds expanded by BARY_EPS.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Barycentric inclusion tolerance for float32 watertightness: sized to
# dominate |x|*|k|*2^-23 rounding for scene coordinates up to O(100) units.
# Exact bounds let float32 rays on a shared edge be rejected by BOTH
# adjacent triangles ("cracks" — black speckle along mesh edges).
BARY_EPS = 1e-4


class Hits(NamedTuple):
    t: torch.Tensor      # (C,) float32 ray parameter of nearest hit (inf if none)
    tri: torch.Tensor    # (C,) int32 triangle index (garbage if no hit)
    valid: torch.Tensor  # (C,) bool
