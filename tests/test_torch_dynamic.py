"""The PyTorch port's per-frame scene diffs (`bake_bvh_grouped`, `SceneDiff`,
`orbit_object_diffs`, `ops/render_dynamic.DynamicCulledRenderer`) against
the JAX package's, whose Pallas kernels run here in interpret mode.

The grouped bake is a numpy copy: all five outputs bit-equal to JAX's, on
the native and the NumPy paths, so both dynamic renderers bake the same
scene themselves. Frames move an object AND a light each (the JAX
package's tests/test_dynamic.py pattern) on two tetrahedra at 64x48, with
both kernel forms (use_mxu False and True). Tolerances: images to atol
2e-5 against the JAX renderer (the repository's bound for identical
arrays; the diff fold's three-term dots round in order here and fused in
XLA) with the frozen buckets and raw counts exactly equal; a zero diff
reproduces render_fast exactly; each moved frame within JAX's bound
(tests/test_dynamic.py: > 2/255 on < 0.5% of pixels, mean |diff| < 1e-3)
of the port's CulledRenderer.render of the moved scene's fresh bake.
"""

import copy

import numpy as np
import pytest

from distributed_raytracer_tpu.models import native as jnative
from distributed_raytracer_tpu.models import scene as jscene
from distributed_raytracer_tpu.ops.render_dynamic import (
    DynamicCulledRenderer as JaxDynamic)
from distributed_raytracer_tpu.runtime import animation as janimation
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models import native as tnative
from distributed_raytracer_tpu_torch.models import scene as tscene
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.ops.render_dynamic import (
    DynamicCulledRenderer)
from distributed_raytracer_tpu_torch.runtime import animation
from distributed_raytracer_tpu_torch.utils import scenes as tscenes
from tests.test_torch_models import assert_tuple_equal

W, H = 64, 48


@pytest.fixture(scope="module")
def two_tetra_path(tmp_path_factory):
    from tests.conftest import make_tetra_obj

    d = tmp_path_factory.mktemp("torch_dyn")
    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(
        '{"objs": ['
        '{"model": "tetra.obj", "pos": {"x": 0, "y": 0, "z": 0}},'
        '{"model": "tetra.obj", "pos": {"x": -1.6, "y": 0.4, "z": -0.8}}],'
        '"lights": ['
        '{"pos": {"x": 3, "y": 4, "z": 5}, "col": {"r": 255, "g": 255, "b": 255}},'
        '{"pos": {"x": -4, "y": 2, "z": 3}, "col": {"r": 64, "g": 128, "b": 255}}],'
        '"cam": {"pos": {"x": 0.4, "y": 1.0, "z": 4.2},'
        '"dir": {"x": -0.1, "y": -0.25, "z": -1.0}, "fov": 1.0472}}')
    return str(p)


def moved(scene, k):
    """Frame k's scene: object 2 slid, light 0 moved (tests/test_dynamic)."""
    m = copy.deepcopy(scene)
    m.set_object_pos(2, [-1.6 + 0.5 * (k + 1), 0.4, -0.8 - 0.3 * k])
    m.light_pos = m.light_pos.copy()
    m.light_pos[0] = [3 - 1.2 * k, 4, 5 + 0.8 * k]
    return m


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", ["two_tetra", "grid"])
def test_bake_bvh_grouped_matches(two_tetra_path, monkeypatch, name, native):
    if name == "grid":
        want_scene = jscenes.instanced_grid(jscenes.icosphere_scene(1), 2)
        got_scene = tscenes.instanced_grid(tscenes.icosphere_scene(1), 2)
    else:
        want_scene = jscene.load_scene(two_tetra_path)
        got_scene = tscene.load_scene(two_tetra_path)
    if native:
        assert tnative.available() and jnative.available()
    else:
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    for block_size in (64, 128):
        want = want_scene.bake_bvh_grouped(block_size=block_size)
        got = got_scene.bake_bvh_grouped(block_size=block_size)
        assert_tuple_equal(got[0], want[0])
        assert_tuple_equal(got[1], want[1])
        for g, w in zip(got[2:], want[2:]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        # No leaf block spans two objects.
        obj_id = got[2].reshape(-1, block_size)
        assert (obj_id == obj_id[:, :1]).all()


def test_diffs_match(two_tetra_path):
    want_scene = jscene.load_scene(two_tetra_path)
    got_scene = tscene.load_scene(two_tetra_path)
    for s in (want_scene, got_scene):
        s.set_object_pos(2, [0.3, 0.2, -0.5])
    with pytest.raises(KeyError):
        got_scene.set_object_pos(9, [0, 0, 0])
    assert_tuple_equal(got_scene.make_diff(), want_scene.make_diff())
    assert tscene.SceneDiff._fields == jscene.SceneDiff._fields
    want = janimation.orbit_object_diffs(want_scene, 5, obj_index=1,
                                         radius=0.7, revolutions=0.5)
    got = animation.orbit_object_diffs(got_scene, 5, obj_index=1,
                                       radius=0.7, revolutions=0.5)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_tuple_equal(g, w)


@pytest.fixture(scope="module")
def scenes_pair(two_tetra_path):
    return jscene.load_scene(two_tetra_path), tscene.load_scene(two_tetra_path)


@pytest.mark.parametrize("use_mxu", [False, True])
def test_render_dynamic_matches_jax(scenes_pair, use_mxu):
    jsc, tsc = scenes_pair
    jr = JaxDynamic(jsc, W, H, interpret=True, use_mxu=use_mxu)
    tr = DynamicCulledRenderer(tsc, W, H, device="cpu", use_mxu=use_mxu)
    jr.freeze(jsc.camera, margin=3.0)
    tr.freeze(tsc.camera, margin=3.0)
    assert tr._last_counts == jr._last_counts
    assert tr.buckets() == tuple(jr._frozen_pads)
    for k in range(3):
        diff = moved(jsc, k).make_diff()
        want = np.asarray(jr.render_dynamic(jsc.camera, diff, verify=True))
        got = tr.render_dynamic(tsc.camera, diff, verify=True).numpy()
        assert got.shape == (H, W, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        assert tr.buckets() == tuple(jr._frozen_pads)
        assert tr._last_counts == tuple(jr._last_counts)
        assert (got.sum(-1) > 0).mean() > 0.05


@pytest.mark.parametrize("use_mxu", [False, True])
def test_moved_frames_match_fresh_bakes(scenes_pair, use_mxu):
    _, tsc = scenes_pair
    tr = DynamicCulledRenderer(tsc, W, H, device="cpu", use_mxu=use_mxu)
    tr.freeze(tsc.camera, margin=3.0)
    for k in range(3):
        m = moved(tsc, k)
        got = tr.render_dynamic(tsc.camera, m.make_diff(),
                                verify=True).numpy()
        want = CulledRenderer(m, W, H, device="cpu").render(
            m.camera).numpy()
        diff = np.abs(got - want)
        assert (diff.max(-1) > 2 / 255).mean() < 0.005, k
        assert diff.mean() < 1e-3, k


def test_zero_diff_equals_render_fast(scenes_pair):
    _, tsc = scenes_pair
    tr = DynamicCulledRenderer(tsc, W, H, device="cpu")
    tr.freeze(tsc.camera)
    cam = tsc.camera.yaw(0.05)
    static = tr.render_fast(cam).numpy()
    dyn = tr.render_dynamic(cam, tsc.make_diff()).numpy()
    np.testing.assert_array_equal(dyn, static)
    assert (static.sum(-1) > 0).mean() > 0.05


def test_verify_grows_buckets_after_a_large_move():
    """Freeze with no margin on a camera that sees nothing, then render the
    four spheres with one of them moved: buckets overflow (a truncated
    level also undercounts the next), and the verify loop must grow them,
    grow-only, until the frame matches the moved scene's fresh bake."""
    scene = tscenes.instanced_grid(tscenes.icosphere_scene(2), 2)
    w, h = 128, 96
    tr = DynamicCulledRenderer(scene, w, h, device="cpu", block_size=64,
                               cull_group=2)
    away = scene.camera.yaw(3.14159)
    tr.render(away, block=True)
    tr.freeze(away, margin=1.0)
    small = tr.buckets()
    m = copy.deepcopy(scene)
    m.set_object_pos(1, m.objects[0].pos + [0.4, 0.3, 0.5])
    got = tr.render_dynamic(scene.camera, m.make_diff(), verify=True).numpy()
    grown = tr.buckets()
    assert any(g > s for g, s in zip(grown, small))
    assert all(g >= s for g, s in zip(grown, small))
    assert all(c <= p for c, p in zip(tr._last_counts, grown))
    want = CulledRenderer(m, w, h, device="cpu", block_size=64).render(
        m.camera).numpy()
    diff = np.abs(got - want)
    assert (diff.max(-1) > 2 / 255).mean() < 0.005
    assert diff.mean() < 1e-3
    assert (want.sum(-1) > 0).mean() > 0.05


def test_dynamic_renderer_needs_a_scene(scenes_pair):
    _, tsc = scenes_pair
    bake = tsc.bake_bvh(block_size=128)
    with pytest.raises(ValueError, match="prebaked"):
        DynamicCulledRenderer(tsc, W, H, device="cpu", prebaked=bake)
