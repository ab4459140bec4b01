"""The port's band-sharded culled renderer (parallel/render_sharded_bvh.py)
and CulledRenderer.per_tile_cells, against the JAX package's.

Ranks are [cpu] * n in the port and conftest's virtual CPU devices in JAX,
whose Pallas kernels run in interpret mode. Both sides render from ONE
bake by the JAX package (the port through models.scene.from_reference;
the JAX functions bake the same scene with the same block size). Every JAX
work list stays far below its 16,384-item segment (asserted).

Tolerances: images to atol 2e-5 against JAX (the repository's bound for
identical arrays) and against the port's single-rank frame; buckets, the
primary count columns and the hit-tile column equal. The shadow count
columns are held to SHADOW_SLACK: where a light lies in the plane of a
face, l.n is 0 in real arithmetic and its rounding decides the light gate;
XLA fuses the hit point and the gate's dot products into multiply-adds
under jit, so JAX's gate can open on a few such rays where the port's (and
JAX's own op-by-op) gate stays shut. Their contribution is ~1e-8, which no
image shows, but their tiles widen the shadow hulls by a cell
(tests/test_torch_render_many.py::
test_shadow_gap_is_the_light_gate_under_xla_fusion). Balanced bands equal
the port's equal bands bit for bit.
"""

import json

import jax
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.models import scene as jscene
from distributed_raytracer_tpu.ops.render_bvh import CulledRenderer as JaxRenderer
from distributed_raytracer_tpu.parallel import render_sharded_bvh as jbands
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import from_reference
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.parallel import render_sharded_bvh as bands

# Shadow count columns may differ from JAX's by this many cells (see the
# module docstring).
SHADOW_SLACK = 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jax.make_mesh((n,), (jbands.AXIS,), devices=jax.devices()[:n])


def port_bake(scene, block_size=128):
    return from_reference(*scene.bake_bvh(block_size=block_size))


def assert_counts_close(got, want, n_levels):
    """Per-band counts (n, K) in the counts layout: primary levels and hit
    tiles equal, shadow levels within SHADOW_SLACK."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., :n_levels + 1],
                                  want[..., :n_levels + 1])
    assert np.abs(got[..., n_levels + 1:]
                  - want[..., n_levels + 1:]).max() <= SHADOW_SLACK
    assert want.max() <= 16384


def test_bands_match_jax_and_one_rank(tetra_scene):
    """Equal bands, n = 4, 40x30 (30 % 4 != 0: the last band overhangs)."""
    w, h, n = 40, 30, 4
    want = jbands.make_sharded_culled_renderer(
        tetra_scene, w, h, mesh=jax_mesh(n), interpret=True)
    want_img = want(tetra_scene.camera)
    cam = tetra_scene.camera.to_arrays()
    got = bands.make_sharded_culled_renderer(
        None, w, h, mesh=["cpu"] * n, prebaked=port_bake(tetra_scene),
        sizing_camera=cam)
    assert got.last_counts is None and got.mesh == (torch.device("cpu"),) * n
    img = got(cam)
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), want_img, atol=2e-5, rtol=0)
    assert got.buckets() == want.buckets()
    assert_counts_close(got.last_counts, want.last_counts, got.band.n_levels)
    single = CulledRenderer(None, w, h, prebaked=port_bake(tetra_scene),
                            device="cpu")
    np.testing.assert_allclose(img.numpy(), single.render(cam).numpy(),
                               atol=2e-5, rtol=0)
    out, counts = got.device_fn(cam)
    assert out.shape == (n * -(-h // n), w, 3) and counts.shape[0] == n
    assert [b.raygen_height for b in got.bands] == [h] * n


def test_per_tile_cells_matches_jax(tetra_scene):
    bake = tetra_scene.bake_bvh(block_size=64)
    jr = JaxRenderer(None, 96, 64, interpret=True, prebaked=bake)
    tr = CulledRenderer(None, 96, 64, prebaked=from_reference(*bake),
                        device="cpu")
    for cam in (tetra_scene.camera, tetra_scene.camera.yaw(0.3)):
        want = jr.per_tile_cells(cam)
        got = tr.per_tile_cells(cam.to_arrays())
        assert got.dtype == torch.int32 and got.shape == (tr.n_tiles,)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.sum() > 0


@pytest.fixture(scope="module")
def skewed_path(tmp_path_factory):
    """tests/test_balance.py's skewed scene: the tetra projects entirely
    inside equal band 1 of a 4-band 64x256 frame."""
    from tests.conftest import make_tetra_obj

    d = tmp_path_factory.mktemp("torch_skew")
    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(json.dumps({
        "objs": [{"model": "tetra.obj",
                  "pos": {"x": 0.0, "y": 0.0, "z": 0.0}}],
        "lights": [{"pos": {"x": 3.0, "y": 4.0, "z": 5.0},
                    "col": {"r": 255, "g": 255, "b": 255}}],
        "cam": {"pos": {"x": 0.5, "y": -0.6, "z": 3.0},
                "dir": {"x": 0.0, "y": 0.0, "z": -1.0},
                "fov": 1.04719755},
    }))
    return str(p)


def test_balanced_bands_match_jax_layout_and_equal_split(skewed_path):
    w, h, n = 64, 256, 4
    scene = jscene.load_scene(skewed_path)
    cam = scene.camera.to_arrays()
    want = jbands.make_sharded_culled_renderer(
        scene, w, h, mesh=jax_mesh(n), interpret=True, balance=True)
    want(scene.camera)
    bake = port_bake(scene)
    bal = bands.make_sharded_culled_renderer(
        None, w, h, mesh=["cpu"] * n, prebaked=bake, sizing_camera=cam,
        balance=True)
    for g, j in zip(bal.layout(), want.layout()):
        np.testing.assert_array_equal(g, j)
    eq = bands.make_sharded_culled_renderer(
        None, w, h, mesh=["cpu"] * n, prebaked=bake, sizing_camera=cam)
    img = bal(cam)
    assert torch.equal(img, eq(cam))
    assert bal.buckets() == want.buckets()
    assert_counts_close(bal.last_counts, want.last_counts,
                        bal.band.n_levels)
    # The balanced split halves the worst band's fine cells (test_balance).
    assert 2 * int(bal.last_counts[:, 1].max()) <= int(
        eq.last_counts[:, 1].max())


def test_rebalance_moves_rows_without_a_rebuild(skewed_path):
    """rebalance() re-probes and writes the bands' permutations and live
    slots in place (the renderers and their buffers stay); verify catches
    the buckets the move overflows."""
    w, h, n = 64, 256, 4
    scene = jscene.load_scene(skewed_path)
    bake = port_bake(scene)
    bal = bands.make_sharded_culled_renderer(
        None, w, h, mesh=["cpu"] * n, prebaked=bake,
        sizing_camera=scene.camera.to_arrays(), balance=True, margin=1.0)
    renderers = list(bal.bands)
    buffers = [(b._perm.data_ptr(), b._live.data_ptr()) for b in bal.bands]
    before = bal.layout()
    moved = scene.camera.move(1.2, forward=True)
    bal.rebalance(moved.to_arrays())
    assert bal.bands == renderers
    assert [(b._perm.data_ptr(), b._live.data_ptr())
            for b in bal.bands] == buffers
    assert any(not np.array_equal(a, b)
               for a, b in zip(before, bal.layout()))
    out = bal(moved.to_arrays(), verify=True)
    pads = bal.buckets()
    assert all(int(c) <= p for c, p in zip(bal.last_counts.amax(0), pads))
    single = CulledRenderer(None, w, h, prebaked=bake, device="cpu")
    np.testing.assert_allclose(out.numpy(),
                               single.render(moved.to_arrays()).numpy(),
                               atol=2e-5, rtol=0)


def test_overflow_refreeze():
    """tests/test_sharded.py's overflow case, on a scene where it overflows:
    margin 1.0, buckets sized on a pose that sees nothing, then a frame of
    9 spheres (11,520 triangles, 93 blocks) with verify=True. The buckets
    grow to JAX's, the counts fit, and the frame equals JAX's and the
    port's one-rank frame."""
    w, h, n = 64, 48, 2
    grid = jscenes.instanced_grid(jscenes.icosphere_scene(3), 3)
    away = grid.camera.yaw(3.14159)
    want = jbands.make_sharded_culled_renderer(
        grid, w, h, mesh=jax_mesh(n), sizing_camera=away, margin=1.0,
        interpret=True)
    want_img = want(grid.camera, verify=True)
    bake = port_bake(grid)
    got = bands.make_sharded_culled_renderer(
        None, w, h, mesh=["cpu"] * n, prebaked=bake, margin=1.0,
        sizing_camera=away.to_arrays())
    before = got.buckets()
    img = got(grid.camera.to_arrays(), verify=True)
    after = got.buckets()
    assert any(a > b for a, b in zip(after, before))
    assert all(a >= b for a, b in zip(after, before))
    assert after == want.buckets()
    assert all(int(c) <= p for c, p in zip(got.last_counts.amax(0), after))
    assert_counts_close(got.last_counts, want.last_counts,
                        got.band.n_levels)
    single = CulledRenderer(None, w, h, prebaked=bake, device="cpu")
    assert torch.equal(img, single.render(grid.camera.to_arrays()))
    np.testing.assert_allclose(img.numpy(), want_img, atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def grid():
    return jscenes.instanced_grid(jscenes.icosphere_scene(1), 2)


def test_bounced_bands_match_jax_and_one_rank(grid):
    """Depth 1 on four mirrored spheres, 2 bands at 64x48."""
    w, h, n = 64, 48, 2
    want = jbands.make_sharded_bounced_renderer(
        grid, w, h, 1, mesh=jax_mesh(n), interpret=True)
    want_img = want(grid.camera)
    bake = port_bake(grid)
    cam = grid.camera.to_arrays()
    got = bands.make_sharded_bounced_renderer(
        None, w, h, 1, mesh=["cpu"] * n, prebaked=bake, sizing_camera=cam)
    img = got(cam, verify=True)
    np.testing.assert_allclose(img.numpy(), want_img, atol=2e-5, rtol=0)
    assert got.buckets() == want.buckets()
    counts = got.last_counts
    assert counts.shape == (n, 2, 2 * got.band.n_levels + 1)
    assert_counts_close(counts, want.last_counts, got.band.n_levels)
    assert int(counts[:, 1, got.band.n_levels].sum()) > 0   # bounce 1 hits
    single = CulledRenderer(None, w, h, prebaked=bake, device="cpu")
    np.testing.assert_allclose(img.numpy(),
                               single.render_bounced(cam, 1).numpy(),
                               atol=2e-5, rtol=0)
