"""Batched ray-triangle intersection (dense path) and hit records.

The torch counterpart of distributed_raytracer_tpu/ops/intersect.py: a
dense rays x triangles sweep over precomputed per-triangle plane and
barycentric projectors (Baldwin–Weber, baked in models/scene.py). The
inner loop is three batched dot products, [C,3] x [3,T] matmuls, plus
elementwise masking and an argmin.

Boundary semantics (shared by the BSR and ring kernels, ops/bsr_trace.py
and ops/ring_trace.py) match the reference's triangle.go exactly —
inclusive 0/1 bounds, den != 0, t >= 0, no backface culling — with the
bounds expanded by BARY_EPS:
    den = n . d
    t   = (plane_d - n . o) / den,  t >= 0
    u   = (o . k_u + c_u) + t * (d . k_u),  0 <= u <= 1
    v   = (o . k_v + c_v) + t * (d . k_v),  0 <= u + v <= 1, v >= 0

The matmuls are full FP32 (the JAX package's Precision.HIGHEST): on CUDA
the entry points turn TF32 off (`fp32_matmuls`), which is also PyTorch's
default. `scene` is a SceneArrays of tensors on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = float("inf")

# Barycentric inclusion tolerance for float32 watertightness: sized to
# dominate |x|*|k|*2^-23 rounding for scene coordinates up to O(100) units.
# Exact bounds let float32 rays on a shared edge be rejected by BOTH
# adjacent triangles ("cracks" — black speckle along mesh edges).
BARY_EPS = 1e-4


class Hits(NamedTuple):
    t: torch.Tensor      # (C,) float32 ray parameter of nearest hit (inf if none)
    tri: torch.Tensor    # (C,) int32 triangle index (garbage if no hit)
    valid: torch.Tensor  # (C,) bool


def fp32_matmuls(device) -> None:
    """The hit test's products must be full FP32: a TF32 product corrupts
    hit tests (wrong nearest triangle, edge misses). Turns TF32 off for a
    CUDA device (PyTorch's default; the call makes it explicit)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _pair_quantities(scene, origins: torch.Tensor, dirs: torch.Tensor):
    """Per (ray, tri) t/u/v/valid arrays, shape (C, T).

    origins: (C, 3) or (3,) shared origin; dirs: (C, 3) unit directions.
    """
    n_t = scene.geo_n.T          # (3, T)
    ku_t = scene.k_u.T
    kv_t = scene.k_v.T

    den = dirs @ n_t             # (C, T)
    d_ku = dirs @ ku_t
    d_kv = dirs @ kv_t

    if origins.dim() == 1:       # shared origin (primary rays): per-tri scalars
        o_n = (origins @ n_t)[None, :]
        o_ku = (origins @ ku_t)[None, :]
        o_kv = (origins @ kv_t)[None, :]
    else:
        o_n = origins @ n_t
        o_ku = origins @ ku_t
        o_kv = origins @ kv_t

    t = (scene.plane_d[None, :] - o_n) / den
    u = (o_ku + scene.c_u[None, :]) + t * d_ku
    v = (o_kv + scene.c_v[None, :]) + t * d_kv

    eps = BARY_EPS
    valid = ((den != 0.0) & (t >= 0.0)
             & (u >= -eps) & (u <= 1.0 + eps)
             & (u + v >= -eps) & (u + v <= 1.0 + eps)
             & (v >= -eps))
    return t, u, v, valid


def _excluded(valid, scene, exclude):
    if exclude is None:
        return valid
    tri_ids = torch.arange(scene.num_tris, dtype=torch.int32,
                           device=valid.device)[None, :]
    return valid & (tri_ids != exclude[:, None])


def nearest_hit(scene, origins: torch.Tensor, dirs: torch.Tensor,
                exclude: torch.Tensor | None = None) -> Hits:
    """Nearest intersection of each ray with the whole triangle soup: the
    first index wins a tie in t. `exclude` (C,) int32 masks a per-ray
    triangle (the surface a secondary ray starts on)."""
    t, _, _, valid = _pair_quantities(scene, origins, dirs)
    valid = _excluded(valid, scene, exclude)
    cand = torch.where(valid, t, INF)
    tri = torch.argmin(cand, dim=1)
    tmin = torch.gather(cand, 1, tri[:, None])[:, 0]
    return Hits(t=tmin, tri=tri.to(torch.int32), valid=torch.isfinite(tmin))


def any_hit(scene, origins: torch.Tensor, dirs: torch.Tensor,
            t_max: torch.Tensor,
            exclude: torch.Tensor | None = None) -> torch.Tensor:
    """True where some triangle is hit with t <= t_max (shadow query);
    `exclude` masks the triangle the shadow ray starts on."""
    t, _, _, valid = _pair_quantities(scene, origins, dirs)
    valid = _excluded(valid, scene, exclude)
    return torch.any(valid & (t <= t_max[:, None]), dim=1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot of (C, 3) arrays, summed x, y, z in order (the order
    jnp.einsum's three-term reduction takes), so every backend agrees."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def barycentrics_at(scene, origins: torch.Tensor, dirs: torch.Tensor,
                    t: torch.Tensor, tri: torch.Tensor):
    """(u, v, x) of the winning triangle of each ray, from gathered (C, 3)
    rows. (x - p0) . k is better conditioned than x . k + c: the relative
    vector is edge-scale."""
    idx = tri.long()
    k_u, k_v, p0 = scene.k_u[idx], scene.k_v[idx], scene.p0[idx]
    if origins.dim() == 1:
        origins = origins[None, :]
    x = origins + t[:, None] * dirs
    rel = x - p0
    return _dot3(rel, k_u), _dot3(rel, k_v), x
