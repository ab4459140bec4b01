"""Saturating colour algebra on (..., 3) float tensors.

The torch counterpart of distributed_raytracer_tpu/ops/colour.py; semantics
mirror shared/colour/colour.go:
  sat_add   — per-channel add clamped at 1.0 (colour.go:38-41)
  sat_scale — scalar multiply clamped to [0, 1] (colour.go:43-46)
  multiply  — componentwise product, unclamped (colour.go:48-51)
  to_u8     — truncating conversion to 8-bit, uint8(255 * c) (colour.go:59-61)

Because all shading contributions are non-negative and only the upper
clamp can engage, a chain of sat_adds equals a single clamp of the sum:
min(a + b + ..., 1). The shading path relies on this.
"""

from __future__ import annotations

import torch


def sat_add(a, b):
    return torch.clamp_max(a + b, 1.0)


def sat_scale(a, s):
    return torch.clamp(s * a, 0.0, 1.0)


def multiply(a, b):
    return a * b


def to_u8(c):
    """uint8(255 * channel) with truncation, as in colour.go:59-61. Inputs
    are clipped defensively (the Go code relies on [0,1] by construction)."""
    return (255.0 * torch.clamp(c, 0.0, 1.0)).to(torch.uint8)
