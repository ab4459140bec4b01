"""The PyTorch port's rank model (parallel/mesh.py), its ray-sharded dense
renderer (parallel/render_sharded.py) and its copy of parallel/tile.py,
against the JAX package's.

A mesh is a tuple of devices; here every rank is the CPU (as the JAX
tests' 8 virtual devices share one CPU). The sharded frame must equal
JAX's on a 4-device mesh and the port's own render_frame to atol 2e-5 (the
check of __graft_entry__.dryrun_multichip): sharding only re-partitions
the rays. The tile partitioners are pure Python and must agree exactly.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.parallel import render_sharded as jsharded
from distributed_raytracer_tpu.parallel import tile as jtile
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import arrays_from_reference
from distributed_raytracer_tpu_torch.ops import render
from distributed_raytracer_tpu_torch.parallel import mesh, render_sharded
from distributed_raytracer_tpu_torch.parallel import tile


@pytest.fixture(scope="module")
def grid():
    return jscenes.instanced_grid(jscenes.icosphere_scene(1), 2)


def jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jsharded.default_mesh(n)


@pytest.mark.parametrize("size", [(64, 48), (53, 31)])
def test_sharded_matches_jax_and_dense(grid, size):
    w, h = size
    a = grid.bake()
    want = np.asarray(jsharded.make_sharded_renderer(w, h, mesh=jax_mesh(4))(
        a, grid.camera.to_arrays()))
    r = render_sharded.make_sharded_renderer(w, h,
                                             mesh=mesh.make_mesh(4, "cpu"))
    assert r.mesh == (torch.device("cpu"),) * 4
    got = r(arrays_from_reference(a), grid.camera)
    assert got.shape == (h, w, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    dense = render.render_frame(render.scene_on(arrays_from_reference(a),
                                                "cpu"), grid.camera, w, h)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=0)
    padded = r.device_fn(arrays_from_reference(a), grid.camera)
    assert padded.shape[0] % 4 == 0 and padded.shape[0] >= w * h


def test_render_frame_sharded_caches_renderers(tetra_scene):
    a = arrays_from_reference(tetra_scene.bake())
    img = render_sharded.render_frame_sharded(a, tetra_scene.camera, 40, 30,
                                              n_devices=3, device="cpu")
    again = render_sharded.render_frame_sharded(a, tetra_scene.camera, 40,
                                                30, n_devices=3, device="cpu")
    assert torch.equal(img, again)
    assert render_sharded._cached_renderer.cache_info().hits >= 1
    dense = render.render_frame(render.scene_on(a, "cpu"), tetra_scene.camera,
                                40, 30)
    np.testing.assert_allclose(img.numpy(), dense.numpy(), atol=2e-5)


def test_make_mesh_places_ranks():
    assert mesh.make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert mesh.default_mesh(device="cpu") == (torch.device("cpu"),)
    assert mesh.check_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        mesh.check_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one rank"):
        mesh.make_mesh(0, "cpu")
    with pytest.raises(ValueError, match="at least one rank"):
        mesh.check_mesh([])
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        mesh.check_mesh(["meta"])


def test_cuda_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(2, "cuda")


def test_collectives_on_cpu_ranks():
    """rotate_right is ppermute (i -> i+1), all_gather concatenates in rank
    order, fetch_rows returns the owner's row (zeros for ids nobody owns),
    gather concatenates on rank 0, copy_async copies."""
    ranks = mesh.Ranks(mesh.make_mesh(4, "cpu"))
    xs = [torch.full((2,), float(i)) for i in range(4)]
    assert [float(x[0]) for x in mesh.rotate_right(ranks, xs)] == [3, 0, 1, 2]
    g = mesh.all_gather(ranks, xs)
    assert all(torch.equal(t, torch.cat(xs)) for t in g)
    t_loc = 5
    tables = [torch.arange(o * t_loc, (o + 1) * t_loc, dtype=torch.float32)
              [:, None].repeat(1, 3) for o in range(4)]
    rng = np.random.default_rng(1)
    ids = [torch.from_numpy(rng.integers(-2, 22, 6).astype(np.int32))
           for _ in range(4)]
    got = mesh.fetch_rows(ranks, ids, tables, t_loc)
    for h in range(4):
        want = torch.where(((ids[h] >= 0) & (ids[h] < 20))[:, None],
                           ids[h].float()[:, None].repeat(1, 3), 0.0)
        assert torch.equal(got[h], want)
    assert torch.equal(mesh.gather(ranks, xs), torch.cat(xs))
    dst = torch.zeros(2)
    assert mesh.copy_async(ranks, 1, xs[1], dst) is None
    assert torch.equal(dst, xs[1])


def test_tile_partitioners_match_jax():
    for args in [(640, 480, 8), (100, 100, 3, 1), (640, 480, 16, 2),
                 (37, 23, 5)]:
        got, rem = tile.partition_bisect(*args)
        want, wrem = jtile.partition_bisect(*args)
        assert [dataclass_tuple(t) for t in got] == [dataclass_tuple(t)
                                                     for t in want]
        assert rem == wrem
    for n_rays, n, chunk in [(3072, 4, 768), (1643, 8, 1), (307200, 3, 8192)]:
        assert tile.row_partition(n_rays, n, chunk) == jtile.row_partition(
            n_rays, n, chunk)
    cost = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    assert tile.balanced_rows(cost, 3, 4) == jtile.balanced_rows(cost, 3, 4)
    with pytest.raises(ValueError, match="too small"):
        tile.balanced_rows(cost, 2, 3)


def dataclass_tuple(t):
    return (t.x, t.y, t.width, t.height)
