"""Phong shading with hard shadows.

The torch counterpart of distributed_raytracer_tpu/ops/shade.py, operation
for operation: the dense path on (C, 3) rays (`pack_table`, `prepare`,
`shade_core`, `shade`) and the packed path on (3, C) row-layout rays
(`table_rows_device`, `prepare_packed(_rows)`, `light_gates(_rows)`,
`shade_core_packed`, `shade_core_rows`).
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

The shadow *queries* are separate from the shadow *answers*: the dense
path answers them with intersect.any_hit, the culled renderer with the
any-hit traversal (ops/bsr_trace.py).

Every sum of three products (a (3, C) row sum, a (C, 3) row dot, a norm) is
written out in x, y, z order, the order jnp.sum reduces three terms in, so
all backends agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

import numpy as np

from distributed_raytracer_tpu_torch.ops import intersect
from distributed_raytracer_tpu_torch.ops.intersect import Hits, _dot3
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


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize of (C, 3) vectors: zero vectors (padding-triangle
    normals gathered for miss rays) stay zero."""
    n = torch.sqrt(_dot3(v, v))[:, None]
    return v / torch.where(n > 0.0, n, 1.0)


class ShadowQueries(NamedTuple):
    """Per-light shadow rays for a batch of C shaded points."""

    origin: torch.Tensor   # (L, C, 3) offset shadow-ray origins
    ldir: torch.Tensor     # (L, C, 3) unit directions toward each light
    t_max: torch.Tensor    # (L, C) blocker range (light distance - offset)


class ShadePrep(NamedTuple):
    x: torch.Tensor        # (C, 3) hit points
    normal: torch.Tensor   # (C, 3) shading normals
    geo_n: torch.Tensor    # (C, 3) unit geometric normals of the hit triangle
    ka: torch.Tensor       # (C, 3) hit-material ambient
    kd: torch.Tensor       # (C, 3) hit-material diffuse
    ks: torch.Tensor       # (C, 3) hit-material specular
    ns: torch.Tensor       # (C,) hit-material shininess
    queries: ShadowQueries


# Columns of the packed per-triangle shading table: every per-hit quantity
# the shader needs, gathered by winning triangle id in ONE (C, 32) gather,
# with materials folded per triangle.
_TBL = {"p0": 0, "k_u": 3, "k_v": 6, "n0": 9, "n1": 12, "n2": 15,
        "geo_n": 18, "ka": 21, "kd": 24, "ks": 27, "ns": 30}
TABLE_WIDTH = 32


def pack_table(scene, xp=torch):
    """(T, 32) float32 per-triangle shading rows (static per scene):
    p0, k_u, k_v, n0, n1, n2, the unit face normal, ka, kd, ks, ns, 0.
    With xp=numpy it is built on the host from numpy arrays; with torch, on
    the scene tensors' device."""
    if xp is np:
        geo = np.asarray(scene.geo_n, np.float32)
        glen = np.linalg.norm(geo, axis=-1, keepdims=True)
        mat = np.asarray(scene.mat_id)
        zero = np.zeros((geo.shape[0], 1), np.float32)
        cat = lambda cols: np.concatenate(
            [np.asarray(c, np.float32) for c in cols], axis=1)
    else:
        geo = scene.geo_n
        glen = torch.sqrt(_dot3(geo, geo))[:, None]
        mat = scene.mat_id.long()
        zero = geo.new_zeros((geo.shape[0], 1))
        cat = lambda cols: torch.cat([c.to(torch.float32) for c in cols],
                                     dim=1)
    geo_unit = geo / xp.where(glen > 0.0, glen, 1.0)
    return cat([scene.p0, scene.k_u, scene.k_v, scene.n0, scene.n1,
                scene.n2, geo_unit, scene.mat_ka[mat], scene.mat_kd[mat],
                scene.mat_ks[mat], scene.mat_ns[mat][:, None], zero])


def prepare(scene, origins: torch.Tensor, dirs: torch.Tensor, hits: Hits,
            cfg: RenderConfig = DEFAULT_CONFIG,
            table: torch.Tensor | None = None) -> ShadePrep:
    """Hit points, normals, material rows and shadow queries for every ray
    (origins (3,) shared or (C, 3); dirs (C, 3)). `table` is pack_table()
    on the scene's device; pass it pre-built, or it is built here. The one
    gather `table[tri]` is an exact index."""
    if table is None:
        table = pack_table(scene)
    t = torch.where(hits.valid, hits.t, 0.0)  # keep hit-point math finite
    tri = torch.clamp_min(hits.tri, 0).long() # clamp miss sentinels
    g = table[tri]                            # (C, 32) the one gather

    def col(name, w=3):
        return g[:, _TBL[name]:_TBL[name] + w]

    if origins.dim() == 1:
        origins = origins[None, :]
    x = origins + t[:, None] * dirs
    # (x - p0) . k is better conditioned than x . k + c (edge-scale).
    rel = x - col("p0")
    u = _dot3(rel, col("k_u"))
    v = _dot3(rel, col("k_v"))
    r1 = 1.0 - u - v
    normal = _normalize(r1[:, None] * col("n0") + u[:, None] * col("n1")
                        + v[:, None] * col("n2"))

    # Shadow ray per light: origin offset along the light direction
    # (tracer.go:64) plus a float32-robustness lift along the geometric
    # normal, signed toward the light's side of the surface.
    geo = col("geo_n")
    origin, ldir, t_max = [], [], []
    for li in range(scene.light_pos.shape[0]):
        to_light = scene.light_pos[li][None, :] - x
        ldist = torch.sqrt(_dot3(to_light, to_light))
        d = to_light / ldist[:, None]
        side = torch.where(_dot3(geo, d) >= 0.0, 1.0, -1.0)
        origin.append(x + cfg.shadow_offset * d
                      + (cfg.shadow_normal_offset * side)[:, None] * geo)
        ldir.append(d)
        t_max.append(ldist - cfg.shadow_offset)
    stack = lambda a, shape: (torch.stack(a) if a
                              else x.new_zeros((0,) + shape))
    c = x.shape[0]
    return ShadePrep(x=x, normal=normal, geo_n=geo,
                     ka=col("ka"), kd=col("kd"), ks=col("ks"),
                     ns=col("ns", 1)[:, 0],
                     queries=ShadowQueries(origin=stack(origin, (c, 3)),
                                           ldir=stack(ldir, (c, 3)),
                                           t_max=stack(t_max, (c,))))


def shade_core(scene, cam_pos: torch.Tensor, prep: ShadePrep, hits: Hits,
               lit: torch.Tensor) -> torch.Tensor:
    """Accumulate Phong lighting given per-light lit flags (L, C). cam_pos
    is the specular viewer: (3,) for primary rays (the camera) or (C, 3)
    per ray for reflection bounces (the previous hit point)."""
    view = cam_pos[None, :] if cam_pos.dim() == 1 else cam_pos
    cam_dir = _normalize(view - prep.x)        # V, toward the viewer
    colour = prep.ka
    for li in range(scene.light_col.shape[0]):
        ldir = prep.queries.ldir[li]
        l_dot_n = _dot3(ldir, prep.normal)
        diff = torch.clamp_min(l_dot_n, 0.0)
        refl = 2.0 * l_dot_n[:, None] * prep.normal - ldir
        spec = torch.pow(torch.clamp_min(_dot3(refl, cam_dir), 0.0),
                         prep.ns)
        contrib = ((prep.kd * diff[:, None] + prep.ks * spec[:, None])
                   * scene.light_col[li][None, :])
        colour = colour + torch.where(lit[li][:, None], contrib, 0.0)
    colour = torch.clamp_max(colour, 1.0)  # saturating adds -> one clamp
    return torch.where(hits.valid[:, None], colour, 0.0)


def shade(scene, cam_pos: torch.Tensor, origins: torch.Tensor,
          dirs: torch.Tensor, hits: Hits, cfg: RenderConfig = DEFAULT_CONFIG,
          table: torch.Tensor | None = None) -> torch.Tensor:
    """Dense-path shading: answers the shadow queries with
    intersect.any_hit. origins (3,) shared or (C, 3); dirs (C, 3); returns
    (C, 3) float32, black for rays that hit nothing."""
    prep = prepare(scene, origins, dirs, hits, cfg, table)
    q = prep.queries
    lit = [~intersect.any_hit(scene, q.origin[li], q.ldir[li], q.t_max[li],
                              exclude=hits.tri)
           for li in range(q.origin.shape[0])]
    lit = (torch.stack(lit) if lit
           else torch.zeros((0, dirs.shape[0]), dtype=torch.bool,
                            device=dirs.device))
    return shade_core(scene, cam_pos, prep, hits, lit)


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
