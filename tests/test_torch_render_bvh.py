"""The PyTorch port's CulledRenderer against the JAX package's.

Both renderers are built from ONE bake by the JAX package (the port through
models.scene.from_reference), so they see the same triangle order and leaf
blocks; the JAX renderer runs its Pallas kernels in interpret mode, the
port's runs on device="cpu" (the plain versions). Images agree to atol 2e-5
(the repository's culled-vs-dense bound for identical arrays: the shading
math may round differently by an ulp); the raw work counts of the sizing
render are exactly equal.
"""

import numpy as np
import pytest

from distributed_raytracer_tpu.models.camera import Camera
from distributed_raytracer_tpu.ops.render_bvh import CulledRenderer as JaxRenderer
from distributed_raytracer_tpu.utils import oracle
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import from_reference
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from tests.test_render_golden import assert_images_close

W, H = 64, 48


@pytest.fixture(scope="module")
def ico():
    return jscenes.icosphere_scene(3)


def pair(scene, block_size=64, **kw):
    bake = scene.bake_bvh(block_size=block_size)
    return (JaxRenderer(None, W, H, interpret=True, prebaked=bake, **kw),
            CulledRenderer(None, W, H, prebaked=from_reference(*bake),
                           device="cpu", **kw))


def compare(jr, tr, cam):
    want = np.asarray(jr.render(cam.to_arrays()))
    got = tr.render(cam).numpy()
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert tr._last_counts == jr._last_counts
    return got


@pytest.mark.parametrize("name", ["tetra", "ico"])
def test_frame_matches_jax(request, ico, name):
    scene = request.getfixturevalue("tetra_scene") if name == "tetra" else ico
    jr, tr = pair(scene)
    img = compare(jr, tr, scene.camera)
    assert (img.sum(-1) > 0).mean() > 0.05
    # The frozen no-sync path reproduces the sizing render.
    tr.freeze(scene.camera)
    fast = tr.render_fast(scene.camera, verify=True).numpy()
    np.testing.assert_allclose(fast, img, atol=2e-5, rtol=0)
    assert all(c <= p for c, p in zip(tr._last_counts, tr.buckets()))


def test_moved_camera_matches_jax(tetra_scene):
    jr, tr = pair(tetra_scene, block_size=128)
    compare(jr, tr, tetra_scene.camera.move(0.8, backward=True).yaw(0.3))


def test_three_level_cull_matches_jax(ico):
    jr, tr = pair(ico, cull_group=2, cull_levels=3)
    assert tr.groups == (2, 2) and tr.n_levels == 3
    compare(jr, tr, ico.camera.yaw(0.15))
    assert len(tr._last_counts) == 7


def test_offview_camera_is_black(tetra_scene):
    """Ray tiles with no work-list entries come out as misses."""
    away = Camera.create(np.asarray(tetra_scene.camera.pos),
                         np.array([0.9, 0.3, 0.3]), tetra_scene.camera.fov)
    jr, tr = pair(tetra_scene)
    img = compare(jr, tr, away)
    assert (img.sum(-1) > 0).mean() < 0.02


def test_verify_loops_until_counts_fit():
    """Freeze on a camera that sees nothing, with no margin, then verify-
    render one that sees the sphere: the buckets overflow (a truncated
    level also undercounts the next), and the verify loop must converge to
    the sync render's image."""
    scene = jscenes.icosphere_scene(4)
    tr = CulledRenderer(None, 128, 96, prebaked=from_reference(
        *scene.bake_bvh(block_size=64)), device="cpu", cull_group=2)
    away = scene.camera.yaw(3.14159)
    tr.render(away, block=True)
    tr.freeze(away, margin=1.0)
    small = tr.buckets()
    fast = tr.render_fast(scene.camera, verify=True).numpy()
    sync = tr.render(scene.camera, block=True).numpy()
    np.testing.assert_allclose(fast, sync, atol=2e-5, rtol=0)
    assert any(c > p for c, p in zip(tr._last_counts, small))
    assert all(c <= p for c, p in zip(tr._last_counts, tr.buckets()))


def test_auto_exit_every_decision(ico):
    tr = CulledRenderer(None, W, H, prebaked=from_reference(
        *ico.bake_bvh(block_size=64)), device="cpu")
    assert tr._exit_auto and tr.exit_every == 0
    tr._resolve_exit(tr.n_tiles * tr._EXIT_DENSITY)
    assert tr.exit_every == tr._EXIT_STEP
    tr._resolve_exit(tr.n_tiles * (tr._EXIT_DENSITY - 1))
    assert tr.exit_every == 0
    fixed = CulledRenderer(None, W, H, prebaked=from_reference(
        *ico.bake_bvh(block_size=64)), device="cpu", exit_every=8)
    fixed._resolve_exit(10 ** 9)
    assert fixed.exit_every == 8


def test_tetra_matches_oracle(tetra_scene):
    """The port's image against the float64 NumPy oracle, with the golden
    tests' discontinuity-aware tolerance."""
    w, h = 72, 54
    want, aux = oracle.render_oracle(tetra_scene, w, h, return_aux=True)
    r = CulledRenderer(None, w, h, prebaked=from_reference(
        *tetra_scene.bake_bvh(block_size=128)), device="cpu")
    got = r.render(tetra_scene.camera.to_arrays()).numpy()
    assert_images_close(got, want, aux)
    assert (want.sum(axis=-1) > 0).mean() > 0.05


def test_scene_without_lights_matches_oracle():
    """Ambient only. (The JAX renderer raises on such a scene: its shadow
    work-list sizing reduces an empty mask.)"""
    scene = jscenes.icosphere_scene(2, n_lights=0)
    want, aux = oracle.render_oracle(scene, W, H, return_aux=True)
    r = CulledRenderer(None, W, H, prebaked=from_reference(
        *scene.bake_bvh(block_size=64)), device="cpu")
    got = r.render(scene.camera).numpy()
    assert_images_close(got, want, aux)
    assert r._last_counts[r.n_levels + 1:] == (0, 0)
    r.freeze(scene.camera)
    np.testing.assert_array_equal(
        r.render_fast(scene.camera, verify=True).numpy(), got)


def test_grid_gap_is_the_ray_directions():
    """The 16-sphere grid at 96x64 is where the two packages' frames part
    by more than 2e-5 (a few specular highlights). Given the JAX package's
    own primary rays, whose directions XLA's fused multiply-adds round
    differently (ROADMAP Queue 3), the port's frame comes back within
    2e-5: the gap is the ray directions raised by the shading, not the
    culled pipeline."""
    import torch

    from distributed_raytracer_tpu_torch.ops import cull

    grid = jscenes.instanced_grid(jscenes.icosphere_scene(3), 4)
    w, h = 96, 64
    bake = grid.bake_bvh(block_size=128)
    jr = JaxRenderer(None, w, h, interpret=True, prebaked=bake)
    tr = CulledRenderer(None, w, h, prebaked=from_reference(*bake),
                        device="cpu")
    cam = grid.camera.to_arrays()
    want = np.asarray(jr.render(cam))
    own = tr.render(cam).numpy()
    assert np.abs(own - want).max() > 2e-5
    jax_rays = torch.from_numpy(np.array(
        jr._stage_a(cam, jr._perm, jr.block_lo, jr.block_hi)[0]))

    def stage_a(sc, _):
        ti = cull.tile_intervals_packed(jax_rays, tr.rt)
        return (jax_rays, ti, *cull.multilevel_mask(ti, sc.block_lo,
                                                    sc.block_hi, tr.groups))

    tr._stage_a = stage_a
    np.testing.assert_allclose(tr.render(cam).numpy(), want, atol=2e-5,
                               rtol=0)
