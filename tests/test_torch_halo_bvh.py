"""The port's culled halo schedule (parallel/halo_bvh.HaloCulledRenderer)
against the JAX package's.

Ranks are [cpu] * n in the port and conftest's virtual CPU devices in JAX,
whose Pallas kernels run in interpret mode. Both renderers bake the same
scene themselves (both packages load one scene file, or build one scene
from their utils/scenes; their bakes are bit-equal,
tests/test_torch_models.py), so they number the triangles alike and the
(t, gid) fold picks the same winners. Every JAX work list stays below its
16,384-item segment: at most tiles x blocks items, asserted.

Tolerances: images to atol 2e-5 against JAX, and bit for bit against the
port's single-rank CulledRenderer frame of the halo's own bake (render,
render_bounced; the dynamic renderer's render_dynamic); buckets equal;
per-rank counts equal in the primary columns and within
tests/test_torch_sharded_bvh.py's SHADOW_SLACK in the shadow columns (the
light gate at a light in a face's plane, rounded by XLA's fused
multiply-adds); scheduled_pairs() equal, before the first frame too.
"""

import numpy as np
import pytest
import torch

import jax
from distributed_raytracer_tpu.ops import render as jrender
from distributed_raytracer_tpu.parallel import halo_bvh as jhalo
from distributed_raytracer_tpu.runtime import animation as janimation
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models import scene as tscene
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.ops.render_dynamic import (
    DynamicCulledRenderer)
from distributed_raytracer_tpu_torch.parallel import halo_bvh
from distributed_raytracer_tpu_torch.utils import scenes
from tests.test_torch_ring_bvh import write_scene
from tests.test_torch_sharded_bvh import SHADOW_SLACK

W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tetra(tmp_path_factory):
    """conftest's tetra_scene, loaded by both packages."""
    return write_scene(tmp_path_factory.mktemp("halo_tetra"), [(0, 0, 0)], {
        "pos": {"x": 1.5, "y": 1.2, "z": 3.0},
        "dir": {"x": -0.35, "y": -0.3, "z": -1.0}, "fov": 1.04719755})


@pytest.fixture(scope="module")
def two_tetra(tmp_path_factory):
    """conftest's two_tetra_scene, loaded by both packages."""
    return write_scene(tmp_path_factory.mktemp("halo_two"),
                       [(0, 0, 0), (-1.6, 0.4, -0.8)], {
                           "pos": {"x": 0.4, "y": 1.0, "z": 4.2},
                           "dir": {"x": -0.1, "y": -0.25, "z": -1.0},
                           "fov": 1.0472})


@pytest.fixture(scope="module")
def grid():
    """Four mirrored spheres (instanced_grid(icosphere_scene(2), 2), 1,280
    triangles), built by both packages."""
    return (jscenes.instanced_grid(jscenes.icosphere_scene(2), 2),
            scenes.instanced_grid(scenes.icosphere_scene(2), 2))


def jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jax.make_mesh((n,), (jhalo.AXIS,), devices=jax.devices()[:n])


def pair(scenes_, n, **kw):
    """(JAX renderer, the port's renderer) of one configuration."""
    js, ts = scenes_
    want = jhalo.HaloCulledRenderer(js, W, H, mesh=jax_mesh(n),
                                    interpret=True, **kw)
    got = halo_bvh.HaloCulledRenderer(ts, W, H, mesh=["cpu"] * n, **kw)
    return want, got


def assert_matches_jax(got, want, img=None, want_img=None):
    """Image, buckets, counts and scheduled pairs; without an image, the
    sizing counts (JAX holds its bounced ones as (B+1, n, 2nl) until a
    frame runs, the port in the frame's (n, B+1, 2nl))."""
    w = np.asarray(want.last_counts)
    if img is None and want.bounces:
        w = w.transpose(1, 0, 2)
    if img is not None:
        np.testing.assert_allclose(img.numpy(), np.asarray(want_img),
                                   atol=2e-5, rtol=0)
    pads = ((want.w_pads,), (want.w_pads_sh,)) if not want.bounces else (
        want.w_pads, want.w_pads_sh)
    assert (got.w_pads, got.w_pads_sh) == pads
    c = got.last_counts.numpy()
    assert c.shape == w.shape
    nl = got.n_levels
    np.testing.assert_array_equal(c[..., :nl], w[..., :nl])
    assert np.abs(c[..., nl:] - w[..., nl:]).max() <= SHADOW_SLACK
    assert got.scheduled_pairs() == want.scheduled_pairs()
    assert got.n_tiles * got.nb_ext <= 16384


@pytest.mark.parametrize("n", [2, 4])
def test_halo_matches_jax_and_one_rank(tetra, n):
    want, got = pair(tetra, n)
    assert_matches_jax(got, want)                 # the sizing counts
    assert got.scheduled_pairs() > 0
    js, ts = tetra
    img = got.render(ts.camera)
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    assert tuple(got.last_counts.shape) == (n, 2 * got.n_levels)
    assert_matches_jax(got, want, img, want.render(js.camera))
    single = CulledRenderer(None, W, H, prebaked=got.bake, device="cpu")
    assert torch.equal(img, single.render(ts.camera))
    rows, counts = got.device_fn(ts.camera)
    assert rows.shape == (3, got.n_pad_ext)
    assert torch.equal(got._assemble(rows), img)
    assert torch.equal(counts, got.last_counts)


def test_halo_two_objects_across_shards(two_tetra):
    """Two objects in blocks of 4 triangles: 2 blocks, one per rank, so
    each rank's winners are folded against the other's."""
    want, got = pair(two_tetra, 2, block_size=4)
    js, ts = two_tetra
    assert got.nb_loc == 1
    img = got.render(ts.camera, verify=True)
    assert_matches_jax(got, want, img, want.render(js.camera, verify=True))
    assert (got.last_counts[:, 0] > 0).all()       # both ranks have work
    single = CulledRenderer(None, W, H, prebaked=got.bake, device="cpu")
    assert torch.equal(img, single.render(ts.camera))


def test_halo_two_local_levels(grid):
    """Superblocks of 4 leaf blocks of 16 triangles inside each of 4
    shards (local_levels=2): per-level counts equal JAX's."""
    kw = dict(block_size=16, local_levels=2, local_group=4)
    want, got = pair(grid, 4, **kw)
    assert got.loc_groups == (4,) and got.nb_loc % 4 == 0
    js, ts = grid
    img = got.render(ts.camera, verify=True)
    assert tuple(got.last_counts.shape) == (4, 4)
    assert_matches_jax(got, want, img, want.render(js.camera, verify=True))
    single = CulledRenderer(None, W, H, prebaked=got.bake, device="cpu")
    assert torch.equal(img, single.render(ts.camera))


@pytest.mark.parametrize("bounces", [1, 2])
def test_halo_bounces_match_jax_and_one_rank(grid, bounces):
    """Reflection rays leave their shard: each bounce gathers them, culls
    them against every shard and folds the candidates home."""
    want, got = pair(grid, 2, bounces=bounces, block_size=64)
    assert_matches_jax(got, want)                 # the sizing counts
    js, ts = grid
    img = got.render(ts.camera, verify=True)
    assert tuple(got.last_counts.shape) == (2, bounces + 1,
                                            2 * got.n_levels)
    assert_matches_jax(got, want, img, want.render(js.camera, verify=True))
    assert int(got.last_counts[:, bounces, 0].sum()) > 0   # live bounces
    single = CulledRenderer(None, W, H, prebaked=got.bake, device="cpu")
    assert torch.equal(img, single.render_bounced(ts.camera, bounces))


@pytest.mark.parametrize("bounces", [0, 1])
def test_halo_dynamic_matches_jax(two_tetra, bounces):
    """An orbit diff of object 0 (runtime/animation.orbit_object_diffs,
    the CLI's --animate-objects) and a moved light, folded into every shard
    before the first cull."""
    js, ts = two_tetra
    diff = janimation.orbit_object_diffs(js, 4, radius=0.6)[1]
    diff = diff._replace(light_pos=np.array(diff.light_pos, copy=True))
    diff.light_pos[0] = [1.5, 4.5, 5.5]
    want, got = pair(two_tetra, 2, dynamic=True, margin=4.0,
                     bounces=bounces, block_size=4)
    img = got.render_dynamic(ts.camera, diff, verify=True)
    assert_matches_jax(got, want, img,
                       want.render_dynamic(js.camera, diff, verify=True))
    if bounces:
        ref = np.asarray(jrender.render_frame_bounced(
            jax.device_put(_moved_bake(js, diff)), js.camera.to_arrays(), W,
            H, bounces))
        np.testing.assert_allclose(img.numpy(), ref, atol=2e-5, rtol=0)
    else:
        dyn = DynamicCulledRenderer(ts, W, H, device="cpu")
        dyn.freeze(ts.camera)
        assert torch.equal(img, dyn.render_dynamic(
            ts.camera, tscene.SceneDiff(*diff), verify=True))
    assert not torch.equal(img, got.render(ts.camera))     # it moved
    with pytest.raises(ValueError, match="dynamic=True"):
        halo_bvh.HaloCulledRenderer(ts, W, H, mesh=["cpu"]).render_dynamic(
            ts.camera, tscene.SceneDiff(*diff))


def _moved_bake(js, diff):
    """The JAX scene with the diff's object positions and lights, baked
    afresh."""
    import copy

    moved = copy.deepcopy(js)
    for o, pos in zip(moved.objects, np.asarray(diff.obj_pos)):
        moved.set_object_pos(o.obj_id, pos)
    moved.light_pos = np.asarray(diff.light_pos, np.float32).copy()
    moved.light_col = np.asarray(diff.light_col, np.float32).copy()
    return moved.bake()


def test_halo_overflow_refreeze(tetra):
    """tests/test_halo_bvh.py's overflow case: margin 1.0, a camera moved
    close to the geometry; verify re-sizes (grow-only) instead of dropping
    blocks, the counts fit, and the frame equals JAX's and the dense
    frame's."""
    want, got = pair(tetra, 2, margin=1.0)
    js, ts = tetra
    close_j = js.camera.move(2.4, forward=True)
    close_t = ts.camera.move(2.4, forward=True)
    before = (got.w_pads, got.w_pads_sh)
    img = got.render(close_t, verify=True)
    after = (got.w_pads, got.w_pads_sh)
    flat = lambda p: [x for q in p for row in q for x in row]
    assert all(a >= b for a, b in zip(flat(after), flat(before)))
    assert got._buckets.fits(got._buckets.worst(got.last_counts))
    assert_matches_jax(got, want, img, want.render(close_j, verify=True))
    dense = np.asarray(jrender.render_frame(
        jax.device_put(js.bake()), close_j.to_arrays(), W, H))
    np.testing.assert_allclose(img.numpy(), dense, atol=2e-5, rtol=0)


def test_halo_verify_grows_buckets_until_counts_fit():
    """Sized with margin 1.0 on a pose that sees nothing, a frame of 9
    spheres (11,520 triangles in 720 blocks of 16, two local levels of
    groups of 4) overflows the fine buckets; verify refreezes, grow-only,
    until every count fits, and the frame equals the one-rank frame."""
    grid = scenes.instanced_grid(scenes.icosphere_scene(3), 3)
    got = halo_bvh.HaloCulledRenderer(
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
    assert torch.equal(img, single.render(grid.camera))
