"""The PyTorch port's shading (ops/shade.py) against the JAX package's.

Inputs are one real frame: icosphere_scene(3)'s primary rays at 64x48 and
their nearest hits from the JAX package's dense intersection. Each port
function gets exactly the inputs its JAX counterpart gets (converted from
numpy), so the comparison isolates one function at a time. Tolerance 1e-6
(relative and absolute): both sides are elementwise float32 in the same
operation order; sqrt, division and pow may round differently by an ulp.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops import intersect as jintersect
from distributed_raytracer_tpu.ops import raygen as jraygen
from distributed_raytracer_tpu.ops import shade as jshade
from distributed_raytracer_tpu.ops.pallas import bsr_trace as jbsr
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.ops import shade as tshade
from distributed_raytracer_tpu_torch.ops.intersect import Hits

TOL = dict(rtol=1e-6, atol=1e-6)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def frame():
    scene = jscenes.icosphere_scene(3)
    arrays = scene.bake()
    cam = scene.camera.to_arrays()
    idx = jnp.arange(64 * 48, dtype=jnp.int32)
    d_rows = jraygen.ray_rows_flat(cam, 64, 48, idx)
    rays = np.asarray(jbsr.pack_rays_rows(jnp.asarray(cam.pos), d_rows))
    hits = jintersect.nearest_hit(arrays, jnp.asarray(cam.pos),
                                  jnp.asarray(rays[3:6].T))
    hits = jintersect.Hits(*(np.asarray(h) for h in hits))
    assert 0.2 < hits.valid.mean() < 0.8
    tris16 = jbsr.pack_tris(arrays)
    smooth_n = np.concatenate([arrays.n0.T, arrays.n1.T, arrays.n2.T])
    return dict(scene=scene, arrays=arrays, cam=cam, rays=rays, hits=hits,
                tris16=tris16, smooth_n=smooth_n)


def table_args(frame, smooth):
    a = frame["arrays"]
    n_t = frame["smooth_n"] if smooth else None
    return (frame["tris16"], np.ascontiguousarray(a.p0.T), n_t, a.mat_id,
            a.mat_ka, a.mat_kd, a.mat_ks, a.mat_ns)


@pytest.mark.parametrize("smooth", [True, False])
def test_table_rows_device_matches(frame, smooth):
    args = table_args(frame, smooth)
    want = np.asarray(jshade.table_rows_device(
        *(None if x is None else jnp.asarray(x) for x in args)))
    got = tshade.table_rows_device(*(None if x is None else t(x)
                                     for x in args))
    assert got.shape == (32, frame["tris16"].shape[0])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def jax_prep(frame):
    table = jshade.table_rows_device(
        *(None if x is None else jnp.asarray(x)
          for x in table_args(frame, True)))
    return np.asarray(table), jshade.prepare_packed(
        frame["arrays"], jnp.asarray(frame["rays"]),
        jintersect.Hits(*(jnp.asarray(h) for h in frame["hits"])),
        table=table)


def port_scene(a):
    return types.SimpleNamespace(light_pos=t(a.light_pos),
                                 light_col=t(a.light_col))


def port_hits(h):
    return Hits(t=t(h.t), tri=t(h.tri), valid=t(h.valid))


def test_prepare_packed_matches(frame):
    table, want = jax_prep(frame)
    got = tshade.prepare_packed(port_scene(frame["arrays"]),
                                t(frame["rays"]), port_hits(frame["hits"]),
                                table=t(table))
    assert got._fields == want._fields
    for f in want._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        np.testing.assert_allclose(g, w, err_msg=f, **TOL)


def port_prep(prep):
    return tshade.PackedPrep(*(t(np.asarray(f)) for f in prep))


def test_light_gates_match(frame):
    _, prep = jax_prep(frame)
    valid = frame["hits"].valid
    want = np.asarray(jshade.light_gates(
        frame["arrays"], jnp.asarray(frame["cam"].pos), prep,
        jnp.asarray(valid)))
    got = tshade.light_gates(port_scene(frame["arrays"]),
                             t(frame["cam"].pos), port_prep(prep),
                             t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < valid.sum() * want.shape[0]


def test_shade_core_packed_matches(frame):
    _, prep = jax_prep(frame)
    hits = frame["hits"]
    rng = np.random.default_rng(2)
    lit = rng.uniform(size=(prep.q.shape[0], hits.valid.size)) < 0.6
    want = np.asarray(jshade.shade_core_packed(
        frame["arrays"], jnp.asarray(frame["cam"].pos), prep,
        jintersect.Hits(*(jnp.asarray(h) for h in hits)), jnp.asarray(lit)))
    got = tshade.shade_core_packed(port_scene(frame["arrays"]),
                                   t(frame["cam"].pos), port_prep(prep),
                                   port_hits(hits), t(lit)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert want.max() > 0.2
