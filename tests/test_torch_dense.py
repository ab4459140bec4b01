"""The PyTorch port's dense path (ops/intersect.py, ops/shade.py,
ops/render.py, ops/colour.py) against the JAX package's.

Both sides start from ONE bake by the JAX package (the port's through
models.scene.arrays_from_reference). The dense queries use FP32 matmuls on
both sides (XLA's Precision.HIGHEST, torch's default FP32), whose sums may
round differently by an ulp: t agrees to rtol 1e-6, ids and flags exactly
on these scenes; frames to atol 2e-5 (the repository's bound for identical
arrays). The dense frame also holds against the float64 oracle with the
golden tests' discontinuity-aware tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops import colour as jcolour
from distributed_raytracer_tpu.ops import intersect as jintersect
from distributed_raytracer_tpu.ops import raygen as jraygen
from distributed_raytracer_tpu.ops import render as jrender
from distributed_raytracer_tpu.ops import shade as jshade
from distributed_raytracer_tpu.utils import oracle
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import arrays_from_reference
from distributed_raytracer_tpu_torch.ops import colour, intersect, raygen
from distributed_raytracer_tpu_torch.ops import render, shade
from tests.test_render_golden import assert_images_close

W, H = 64, 48


def scene_of(request, name):
    if name == "tetra":
        return request.getfixturevalue("tetra_scene")
    if name == "ico2":
        return jscenes.icosphere_scene(2)
    return jscenes.instanced_grid(jscenes.icosphere_scene(1), 2)


def both(scene):
    """(JAX bake, the port's SceneArrays of CPU tensors from it)."""
    a = scene.bake()
    return a, render.scene_on(arrays_from_reference(a), "cpu")


@pytest.mark.parametrize("name", ["tetra", "ico2", "grid"])
def test_render_frame_matches_jax(request, name):
    scene = scene_of(request, name)
    a, ta = both(scene)
    want = np.asarray(jrender.render_frame(a, scene.camera.to_arrays(), W, H))
    got = render.render_frame(ta, scene.camera, W, H)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert (want.sum(-1) > 0).mean() > 0.05


@pytest.mark.parametrize("name", ["tetra", "grid"])
def test_render_frame_bounced_matches_jax(request, name):
    scene = scene_of(request, name)
    a, ta = both(scene)
    cam = scene.camera.to_arrays()
    want = np.asarray(jrender.render_frame_bounced(a, cam, W, H, 1))
    got = render.render_frame_bounced(ta, scene.camera, W, H, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # Depth 0 is the plain frame.
    np.testing.assert_array_equal(
        render.render_frame_bounced(ta, scene.camera, W, H, 0).numpy(),
        render.render_frame(ta, scene.camera, W, H).numpy())


def test_small_ray_chunk_gives_the_same_frame(tetra_scene):
    """Chunking only bounds memory: a last chunk shorter than the others
    (here 3072 = 7 * 400 + 272 rays) changes no pixel."""
    from distributed_raytracer_tpu_torch.utils.config import RenderConfig

    _, ta = both(tetra_scene)
    full = render.render_frame(ta, tetra_scene.camera, W, H)
    small = render.render_frame(ta, tetra_scene.camera, W, H,
                                RenderConfig(ray_chunk=400))
    assert torch.equal(full, small)


def test_ray_directions_match_jax(tetra_scene):
    """(H, W, 3) directions: within 2e-7 of JAX's (XLA's CPU backend
    contracts forward + a*left + b*up into fused multiply-adds), and bit
    for bit the port's flat and row forms, which the dense and block-sparse
    paths use."""
    cam = tetra_scene.camera
    want = np.asarray(jraygen.ray_directions(cam.to_arrays(), 37, 23))
    c = raygen.camera_arrays(cam, "cpu")
    got = raygen.ray_directions(c, 37, 23)
    assert got.shape == (23, 37, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-7)
    idx = torch.arange(37 * 23, dtype=torch.int32)
    assert torch.equal(got.reshape(-1, 3),
                       raygen.ray_directions_flat(c, 37, 23, idx))
    assert torch.equal(got.reshape(-1, 3).T,
                       raygen.ray_rows_flat(c, 37, 23, idx))


@pytest.mark.parametrize("name", ["tetra", "grid"])
def test_nearest_and_any_hit_match_jax(request, name):
    """The dense queries on primary rays (shared origin) and on per-ray
    origins with an exclusion and a t_max."""
    scene = scene_of(request, name)
    a, ta = both(scene)
    cam = scene.camera.to_arrays()
    dirs = np.array(jraygen.ray_directions(cam, W, H)).reshape(-1, 3)
    jhits = jintersect.nearest_hit(a, jnp.asarray(cam.pos), jnp.asarray(dirs))
    hits = intersect.nearest_hit(ta, torch.from_numpy(cam.pos),
                                 torch.from_numpy(dirs))
    np.testing.assert_array_equal(hits.valid.numpy(), np.asarray(jhits.valid))
    v = hits.valid.numpy()
    assert v.sum() > 100
    np.testing.assert_array_equal(hits.tri.numpy()[v],
                                  np.asarray(jhits.tri)[v])
    np.testing.assert_allclose(hits.t.numpy()[v], np.asarray(jhits.t)[v],
                               rtol=1e-6, atol=0)
    u, vv, x = intersect.barycentrics_at(ta, torch.from_numpy(cam.pos),
                                         torch.from_numpy(dirs), hits.t,
                                         hits.tri.clamp_min(0))
    ju, jv, jx = jintersect.barycentrics_at(
        a, jnp.asarray(cam.pos), jnp.asarray(dirs), jhits.t,
        jnp.maximum(jhits.tri, 0))
    np.testing.assert_allclose(u.numpy()[v], np.asarray(ju)[v], atol=1e-5)
    np.testing.assert_allclose(vv.numpy()[v], np.asarray(jv)[v], atol=1e-5)

    # Per-ray origins: the hit points lifted off the surface, back toward
    # the camera, jittered, excluding their own triangle; t_max random.
    rng = np.random.default_rng(2)
    o = np.asarray(jx, np.float32)[v] - 0.05 * dirs[v]
    d = (-dirs[v] + rng.normal(0, 0.3, (v.sum(), 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = np.asarray(jhits.tri, np.int32)[v]
    tmax = rng.uniform(0.5, 3.0, v.sum()).astype(np.float32)
    jh = jintersect.nearest_hit(a, jnp.asarray(o), jnp.asarray(d),
                                exclude=jnp.asarray(excl))
    th = intersect.nearest_hit(ta, torch.from_numpy(o), torch.from_numpy(d),
                               exclude=torch.from_numpy(excl))
    hv = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), hv)
    np.testing.assert_array_equal(th.tri.numpy()[hv], np.asarray(jh.tri)[hv])
    np.testing.assert_allclose(th.t.numpy()[hv], np.asarray(jh.t)[hv],
                               rtol=1e-6, atol=0)
    want = np.asarray(jintersect.any_hit(a, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(tmax),
                                         exclude=jnp.asarray(excl)))
    got = intersect.any_hit(ta, torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(tmax),
                            exclude=torch.from_numpy(excl)).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "grid":
        assert 0 < want.sum() < want.size


def test_shading_pieces_match_jax(request):
    """pack_table (host and device), prepare and shade on the grid's
    primary hits."""
    scene = scene_of(request, "grid")
    a, ta = both(scene)
    want_tbl = np.asarray(jshade.pack_table(a))
    np.testing.assert_allclose(shade.pack_table(a, xp=np), want_tbl,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(shade.pack_table(ta).numpy(), want_tbl,
                               rtol=1e-6, atol=1e-7)
    cam = scene.camera.to_arrays()
    dirs = np.array(jraygen.ray_directions(cam, W, H)).reshape(-1, 3)
    jhits = jintersect.nearest_hit(a, jnp.asarray(cam.pos), jnp.asarray(dirs))
    hits = intersect.nearest_hit(ta, torch.from_numpy(cam.pos),
                                 torch.from_numpy(dirs))
    jprep = jshade.prepare(a, jnp.asarray(cam.pos), jnp.asarray(dirs), jhits)
    prep = shade.prepare(ta, torch.from_numpy(cam.pos),
                         torch.from_numpy(dirs), hits)
    for f in ("x", "normal", "geo_n", "ka", "kd", "ks", "ns"):
        np.testing.assert_allclose(getattr(prep, f).numpy(),
                                   np.asarray(getattr(jprep, f)), atol=2e-5,
                                   err_msg=f)
    for f in ("origin", "ldir", "t_max"):
        np.testing.assert_allclose(getattr(prep.queries, f).numpy(),
                                   np.asarray(getattr(jprep.queries, f)),
                                   atol=2e-5, err_msg=f)
    want = np.asarray(jshade.shade(a, jnp.asarray(cam.pos),
                                   jnp.asarray(cam.pos), jnp.asarray(dirs),
                                   jhits))
    got = shade.shade(ta, torch.from_numpy(cam.pos), torch.from_numpy(cam.pos),
                      torch.from_numpy(dirs), hits).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_colour_ops_match_jax():
    rng = np.random.default_rng(7)
    a = rng.uniform(-0.3, 1.3, (5, 7, 3)).astype(np.float32)
    b = rng.uniform(-0.3, 1.3, (5, 7, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(colour.sat_add(ta, tb).numpy(),
                                  np.asarray(jcolour.sat_add(a, b)))
    np.testing.assert_array_equal(colour.sat_scale(ta, 0.7).numpy(),
                                  np.asarray(jcolour.sat_scale(a, 0.7)))
    np.testing.assert_array_equal(colour.multiply(ta, tb).numpy(),
                                  np.asarray(jcolour.multiply(a, b)))
    np.testing.assert_array_equal(colour.to_u8(ta).numpy(),
                                  np.asarray(jcolour.to_u8(a)))


def test_dense_frame_matches_oracle(tetra_scene):
    w, h = 72, 54
    want, aux = oracle.render_oracle(tetra_scene, w, h, return_aux=True)
    _, ta = both(tetra_scene)
    got = render.render_frame(ta, tetra_scene.camera, w, h).numpy()
    assert_images_close(got, want, aux)
    assert (want.sum(axis=-1) > 0).mean() > 0.05
