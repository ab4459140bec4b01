"""The port's culled geometry ring (parallel/ring_bvh.RingCulledRenderer)
against the JAX package's.

Ranks are [cpu] * n in the port and conftest's virtual CPU devices in JAX,
whose Pallas kernels run in interpret mode. Both renderers bake the same
scene themselves (both packages load one scene file; their bakes are
bit-equal, tests/test_torch_models.py), so they number the triangles alike
and the carried (t, gid) fold picks the same winners. Every JAX work list
stays far below its 16,384-item segment: at most tiles x blocks items,
asserted.

Tolerances: images to atol 2e-5 against JAX and against the port's
single-rank CulledRenderer built from the ring's own bake; buckets equal;
per-rank counts equal in the primary columns and within
tests/test_torch_sharded_bvh.py's SHADOW_SLACK in the shadow columns (the
light gate at a light in a face's plane, rounded by XLA's fused
multiply-adds). scheduled_pairs() is None before the first frame.
"""

import json

import jax
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.models import scene as jscene
from distributed_raytracer_tpu.parallel import ring_bvh as jring
from distributed_raytracer_tpu.runtime import animation as janimation
from distributed_raytracer_tpu_torch.models import scene as tscene
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.ops.render_dynamic import (
    DynamicCulledRenderer)
from distributed_raytracer_tpu_torch.parallel import ring_bvh
from distributed_raytracer_tpu_torch.utils import scenes
from tests.test_torch_sharded_bvh import SHADOW_SLACK

W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_scene(d, objs, cam):
    from tests.conftest import make_tetra_obj

    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(json.dumps({
        "objs": [{"model": "tetra.obj", "pos": dict(zip("xyz", o))}
                 for o in objs],
        "lights": [
            {"pos": {"x": 3.0, "y": 4.0, "z": 5.0},
             "col": {"r": 255, "g": 255, "b": 255}},
            {"pos": {"x": -4.0, "y": 2.0, "z": 3.0},
             "col": {"r": 64, "g": 128, "b": 255}}],
        "cam": cam}))
    return jscene.load_scene(str(p)), tscene.load_scene(str(p))


@pytest.fixture(scope="module")
def tetra(tmp_path_factory):
    """conftest's tetra_scene, loaded by both packages."""
    return write_scene(tmp_path_factory.mktemp("ring_tetra"), [(0, 0, 0)], {
        "pos": {"x": 1.5, "y": 1.2, "z": 3.0},
        "dir": {"x": -0.35, "y": -0.3, "z": -1.0}, "fov": 1.04719755})


@pytest.fixture(scope="module")
def two_tetra(tmp_path_factory):
    """conftest's two_tetra_scene, loaded by both packages."""
    return write_scene(tmp_path_factory.mktemp("ring_two"),
                       [(0, 0, 0), (-1.6, 0.4, -0.8)], {
                           "pos": {"x": 0.4, "y": 1.0, "z": 4.2},
                           "dir": {"x": -0.1, "y": -0.25, "z": -1.0},
                           "fov": 1.0472})


def jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jax.make_mesh((n,), (jring.AXIS,), devices=jax.devices()[:n])


def assert_matches_jax(got_r, want_r, img, want_img):
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), atol=2e-5,
                               rtol=0)
    assert (got_r.w_pads, got_r.w_pads_sh) == (want_r.w_pads,
                                               want_r.w_pads_sh)
    got, want = got_r.last_counts.numpy(), np.asarray(want_r.last_counts)
    nl = got_r.n_levels
    primary = list(range(nl)) + [2 * nl]
    shadow = list(range(nl, 2 * nl)) + [2 * nl + 1]
    np.testing.assert_array_equal(got[..., primary], want[..., primary])
    assert np.abs(got[..., shadow] - want[..., shadow]).max() <= SHADOW_SLACK
    assert got_r.scheduled_pairs() == want_r.scheduled_pairs()
    # JAX's lists hold at most tiles x blocks items (its flat sizing list
    # too): below one segment.
    assert (got_r.n_pad_ext // got_r.rt) * got_r.nb_ext <= 16384


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_and_one_rank(tetra, n):
    js, ts = tetra
    want = jring.RingCulledRenderer(js, W, H, mesh=jax_mesh(n),
                                    interpret=True)
    want_img = want.render(js.camera)
    got = ring_bvh.RingCulledRenderer(ts, W, H, mesh=["cpu"] * n)
    assert got.scheduled_pairs() is None and got.last_counts is None
    img = got.render(ts.camera)
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    assert tuple(got.last_counts.shape) == (n, 1, 2 * got.n_levels + 2)
    assert_matches_jax(got, want, img, want_img)
    assert got.scheduled_pairs() > 0
    single = CulledRenderer(None, W, H, prebaked=got.bake, device="cpu")
    np.testing.assert_allclose(img.numpy(), single.render(ts.camera).numpy(),
                               atol=2e-5, rtol=0)
    rows, counts = got.device_fn(ts.camera)
    assert rows.shape == (3, got.n_pad_ext)
    assert torch.equal(got._assemble(rows), img)


def test_ring_bounced_matches_jax_and_one_rank(tetra):
    js, ts = tetra
    want = jring.RingCulledRenderer(js, W, H, mesh=jax_mesh(2),
                                    interpret=True, bounces=1)
    want_img = want.render(js.camera, verify=True)
    got = ring_bvh.RingCulledRenderer(ts, W, H, mesh=["cpu"] * 2, bounces=1)
    img = got.render(ts.camera, verify=True)
    assert tuple(got.last_counts.shape) == (2, 2, 2 * got.n_levels + 2)
    assert_matches_jax(got, want, img, want_img)
    single = CulledRenderer(None, W, H, prebaked=got.bake, device="cpu")
    np.testing.assert_allclose(
        img.numpy(), single.render_bounced(ts.camera, 1).numpy(), atol=2e-5,
        rtol=0)


@pytest.mark.parametrize("variant", [{"local_levels": 2}, {"tile_w": 16}],
                         ids=["local_levels_2", "tile_w_16"])
def test_ring_variants_match_jax(tetra, variant):
    """Two local cull levels (superblocks of the rotating shard) and square
    16x32 ray tiles."""
    js, ts = tetra
    want = jring.RingCulledRenderer(js, W, H, mesh=jax_mesh(2),
                                    interpret=True, **variant)
    want_img = want.render(js.camera)
    got = ring_bvh.RingCulledRenderer(ts, W, H, mesh=["cpu"] * 2, **variant)
    assert got.n_levels == variant.get("local_levels", 1)
    img = got.render(ts.camera)
    assert_matches_jax(got, want, img, want_img)


def test_ring_dynamic_matches_jax(two_tetra):
    """An orbit diff of object 0 (runtime/animation.orbit_object_diffs,
    the CLI's --animate-objects) and a moved light, folded into every shard
    before the rotation."""
    js, ts = two_tetra
    diff = janimation.orbit_object_diffs(js, 4, radius=0.6)[1]
    diff = diff._replace(light_pos=np.array(diff.light_pos, copy=True))
    diff.light_pos[0] = [1.5, 4.5, 5.5]
    want = jring.RingCulledRenderer(js, W, H, mesh=jax_mesh(2),
                                    interpret=True, dynamic=True, margin=4.0)
    want_img = want.render_dynamic(js.camera, diff, verify=True)
    got = ring_bvh.RingCulledRenderer(ts, W, H, mesh=["cpu"] * 2,
                                      dynamic=True, margin=4.0)
    img = got.render_dynamic(ts.camera, diff, verify=True)
    assert_matches_jax(got, want, img, want_img)
    dyn = DynamicCulledRenderer(ts, W, H, device="cpu")
    dyn.freeze(ts.camera)
    np.testing.assert_allclose(
        img.numpy(), dyn.render_dynamic(ts.camera, tscene.SceneDiff(*diff),
                                        verify=True).numpy(),
        atol=2e-5, rtol=0)
    assert not torch.equal(img, got.render(ts.camera))     # it moved
    with pytest.raises(ValueError, match="dynamic=True"):
        ring_bvh.RingCulledRenderer(ts, W, H, mesh=["cpu"]).render_dynamic(
            ts.camera, tscene.SceneDiff(*diff))


def test_ring_verify_grows_buckets_until_counts_fit():
    """Sized with margin 1.0 on a pose that sees nothing, a frame of 9
    spheres (11,520 triangles in 720 blocks of 16, two local levels of
    groups of 4) overflows the fine buckets; verify refreezes, grow-only,
    until every count fits, and the frame equals the one-rank frame."""
    grid = scenes.instanced_grid(scenes.icosphere_scene(3), 3)
    got = ring_bvh.RingCulledRenderer(
        grid, W, H, mesh=["cpu"] * 2, margin=1.0, block_size=16,
        local_levels=2, local_group=4, sizing_camera=grid.camera.yaw(3.14159))
    small = (got.w_pads, got.w_pads_sh)
    img = got.render(grid.camera, verify=True)
    grown = (got.w_pads, got.w_pads_sh)
    flat = lambda p: [x for q in p for row in q for x in row]
    assert all(g >= s for g, s in zip(flat(grown), flat(small)))
    assert any(g > s for g, s in zip(flat(grown), flat(small)))
    assert got._buckets.fits(got._buckets.worst(got.last_counts))
    single = CulledRenderer(None, W, H, prebaked=got.bake, device="cpu")
    np.testing.assert_allclose(img.numpy(),
                               single.render(grid.camera).numpy(),
                               atol=2e-5, rtol=0)
