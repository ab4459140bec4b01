"""Phong shading with hard shadows, on packed (row-layout) rays.

The torch counterpart of distributed_raytracer_tpu/ops/shade.py's packed
path (`table_rows_device`, `prepare_packed(_rows)`, `light_gates(_rows)`,
`shade_core_packed`, `shade_core_rows`), operation for operation.
Reproduces worker/shared/tracer/tracer.go:53-77 `phong`:
  - colour starts at the material's ambient Ka (tracer.go:56)
  - per light: a shadow ray from the hit point, offset by 1e-4 along the
    light direction (tracer.go:64); the point is lit iff there is no blocker
    closer than the light
  - diffuse:  Kd * max(L.N, 0) * Lcol       (tracer.go:70)
  - specular: Ks * max(R.V, 0)^Ns * Lcol    (tracer.go:73), R the reflection
    of L about N, V toward the camera; 0^0 = 1 as in Go's math.Pow
  - all additions saturate at 1.0 per channel (colour.go:38-41); every
    contribution is non-negative, so one clamp of the sum is the same
  - the normal is the interpolated vertex normal (the face normal for
    meshes without normals, baked into all three vertex slots)

The shadow *queries* are separate from the shadow *answers*: the renderer
answers them with the any-hit traversal (ops/bsr_trace.py).

Every (3, C) row sum of three products is written out in x, y, z order,
the order jnp.sum reduces three terms in, so all backends agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_raytracer_tpu_torch.ops.intersect import Hits
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """Sum of the three rows of (3, C) -> (C,), in order."""
    return v[0] + v[1] + v[2]


def _normalize_rows(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize of (3, C) rows: zero vectors stay zero instead of
    poisoning downstream math with NaNs."""
    n = torch.sqrt(_sum3(v * v))[None, :]
    return v / torch.where(n > 0.0, n, 1.0)


def table_rows_device(tris16, p0_t, n_t, mat_id, mat_ka, mat_kd, mat_ks,
                      mat_ns) -> torch.Tensor:
    """The (32, T) shading table assembled on the device from the packed
    triangle rows (k_u, k_v and the face normal are already there), p0, the
    vertex normals and the material ids. Rows: p0 0:3, k_u 3:6, k_v 6:9,
    n0 9:12, n1 12:15, n2 15:18, unit face normal 18:21, ka 21:24,
    kd 24:27, ks 27:30, ns 30, zero 31 — every per-hit quantity the shader
    needs, gathered by winning triangle id in one gather.

    tris16: (T, 16) bsr_trace.pack_tris rows; p0_t (3, T); n_t (9, T)
    stacked n0/n1/n2 rows, or None for a flat bake (n == geo_n); material
    tables as in SceneArrays.
    """
    t = tris16.shape[0]
    geo = tris16[:, 0:3].T                       # (3, T) raw face normals
    glen = torch.sqrt(_sum3(geo * geo))[None, :]
    geo_unit = geo / torch.where(glen > 0.0, glen, 1.0)
    ku = tris16[:, 4:7].T
    kv = tris16[:, 8:11].T
    if n_t is None:                              # flat bake: n == geo_n
        n_t = torch.cat([geo, geo, geo], dim=0)
    mat = torch.clamp(mat_id.long(), 0, mat_ka.shape[0] - 1)
    ka = mat_ka[mat].T
    kd = mat_kd[mat].T
    ks = mat_ks[mat].T
    ns = mat_ns[mat][None, :]
    zero = tris16.new_zeros((1, t))
    return torch.cat([p0_t, ku, kv, n_t, geo_unit, ka, kd, ks, ns, zero],
                     dim=0).contiguous()


class PackedPrep(NamedTuple):
    """Per-ray shading inputs in row layout: every per-ray vector is (3, C)
    rows, shadow queries are kernel-ready (L, 8, C) packed rays."""

    x: torch.Tensor        # (3, C) hit points
    normal: torch.Tensor   # (3, C) shading normals
    geo_n: torch.Tensor    # (3, C) unit geometric normals
    ka: torch.Tensor       # (3, C)
    kd: torch.Tensor       # (3, C)
    ks: torch.Tensor       # (3, C)
    ns: torch.Tensor       # (C,)
    q: torch.Tensor        # (L, 8, C) packed shadow rays (t_max in row 6)
    q_rev: torch.Tensor    # (L, 8, C) REVERSED shadow rays: origin = the
    #   light, direction toward the (offset) surface point, t_max = the full
    #   segment length. Occlusion over [light, offset point] equals the
    #   forward query's [offset point, light] segment, but every ray of a
    #   light then has the SAME origin (the shared-origin kernels) and the
    #   cull gets exact point origin hulls. Sole divergence: an occluder
    #   within shadow_offset (1e-4) of the light itself is seen by the
    #   reversed ray only.


def prepare_packed(scene, rays: torch.Tensor, hits: Hits,
                   cfg: RenderConfig = DEFAULT_CONFIG,
                   table: torch.Tensor | None = None) -> PackedPrep:
    """Hit points, normals, material rows and shadow queries for packed
    (8, C) rays. `table` is the (32, T) table_rows_device table; the one
    gather is the exact `table[:, tri]` (the JAX package's one-hot matmul
    form of it is a TPU layout trick and is not carried over)."""
    if table is None:
        raise ValueError("prepare_packed needs the (32, T) table from "
                         "table_rows_device")
    t = torch.where(hits.valid, hits.t, 0.0)
    tri = torch.clamp_min(hits.tri, 0).long()
    g = table[:, tri]                            # (32, C)
    return prepare_packed_rows(scene.light_pos, rays, t, g, cfg)


def prepare_packed_rows(light_pos: torch.Tensor, rays: torch.Tensor,
                        t: torch.Tensor, g: torch.Tensor,
                        cfg: RenderConfig = DEFAULT_CONFIG) -> PackedPrep:
    """prepare_packed from pre-gathered (32, C) table rows. `t` must already
    be zeroed for miss rays (keeps the hit-point math finite)."""
    o, d = rays[0:3], rays[3:6]

    x = o + t[None, :] * d                 # (3, C)
    rel = x - g[0:3]
    u = _sum3(rel * g[3:6])
    v = _sum3(rel * g[6:9])
    r1 = 1.0 - u - v
    normal = _normalize_rows(r1[None, :] * g[9:12] + u[None, :] * g[12:15]
                             + v[None, :] * g[15:18])
    geo = g[18:21]

    zero = x.new_zeros((1, x.shape[1]))
    qs, qrs = [], []
    for li in range(light_pos.shape[0]):
        lpos = light_pos[li]
        to_light = lpos[:, None] - x
        ldist = torch.sqrt(_sum3(to_light * to_light))
        ldir = to_light / ldist[None, :]
        side = torch.where(_sum3(geo * ldir) >= 0.0, 1.0, -1.0)
        origin = (x + cfg.shadow_offset * ldir
                  + (cfg.shadow_normal_offset * side)[None, :] * geo)
        tmax = (ldist - cfg.shadow_offset)[None, :]
        qs.append(torch.cat([origin, ldir, tmax, zero], dim=0))
        # Reversed query: light -> offset surface point (see q_rev).
        back = origin - lpos[:, None]
        blen = torch.sqrt(_sum3(back * back))[None, :]
        bdir = back / torch.where(blen > 0, blen, 1.0)
        lorg = lpos[:, None].expand_as(origin)
        qrs.append(torch.cat([lorg, bdir, blen, zero], dim=0))
    empty = x.new_zeros((0, 8, x.shape[1]))
    q = torch.stack(qs) if qs else empty
    q_rev = torch.stack(qrs) if qrs else empty
    return PackedPrep(x=x, normal=normal, geo_n=geo,
                      ka=g[21:24], kd=g[24:27], ks=g[27:30], ns=g[30],
                      q=q, q_rev=q_rev)


def _light_terms(ldir, normal, cam_dir, ns):
    """(diffuse, specular) factors of one light, (C,) each."""
    l_dot_n = _sum3(ldir * normal)
    diff = torch.clamp_min(l_dot_n, 0.0)
    refl = 2.0 * l_dot_n[None, :] * normal - ldir
    spec = torch.pow(torch.clamp_min(_sum3(refl * cam_dir), 0.0), ns)
    return diff, spec


def light_gates(scene, view: torch.Tensor, prep: PackedPrep,
                valid: torch.Tensor) -> torch.Tensor:
    """(L, C) bool: can light li contribute a nonzero Phong term to ray c?

    An exactness-preserving shadow-work cull: where the potential
    contribution (kd*diff + ks*spec) * lcol is exactly zero on every
    channel, the lit/shadowed answer cannot change the image, so the
    shadow query is skipped. `view` must be the viewer shade_core_packed
    uses, so the gate matches the shading exactly."""
    return light_gates_rows(scene.light_col, view, prep, valid)


def light_gates_rows(light_col: torch.Tensor, view: torch.Tensor,
                     prep: PackedPrep, valid: torch.Tensor) -> torch.Tensor:
    """light_gates from the light-colour rows alone."""
    v = view[:, None] if view.dim() == 1 else view
    cam_dir = _normalize_rows(v - prep.x)
    gates = []
    for li in range(light_col.shape[0]):
        diff, spec = _light_terms(prep.q[li, 3:6], prep.normal, cam_dir,
                                  prep.ns)
        contrib = ((prep.kd * diff[None, :] + prep.ks * spec[None, :])
                   * light_col[li][:, None])
        gates.append(valid & (contrib.amax(dim=0) > 0.0))
    return (torch.stack(gates) if gates
            else torch.zeros((0, prep.x.shape[1]), dtype=torch.bool,
                             device=prep.x.device))


def shade_core_packed(scene, view: torch.Tensor, prep: PackedPrep,
                      hits: Hits, lit: torch.Tensor) -> torch.Tensor:
    """Phong accumulation given per-light lit flags (L, C); returns (3, C)
    colour rows. view: (3,) shared viewer (primary rays) or (3, C)."""
    return shade_core_rows(scene.light_col, view, prep, hits.valid, lit)


def shade_core_rows(light_col: torch.Tensor, view: torch.Tensor,
                    prep: PackedPrep, valid: torch.Tensor,
                    lit: torch.Tensor) -> torch.Tensor:
    """shade_core_packed from light-colour rows and a validity mask."""
    v = view[:, None] if view.dim() == 1 else view
    cam_dir = _normalize_rows(v - prep.x)

    colour = prep.ka
    for li in range(light_col.shape[0]):
        diff, spec = _light_terms(prep.q[li, 3:6], prep.normal, cam_dir,
                                  prep.ns)
        contrib = ((prep.kd * diff[None, :] + prep.ks * spec[None, :])
                   * light_col[li][:, None])
        colour = colour + torch.where(lit[li][None, :], contrib, 0.0)
    colour = torch.clamp_max(colour, 1.0)  # saturating adds -> one clamp
    return torch.where(valid[None, :], colour, 0.0)
