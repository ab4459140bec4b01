"""The static renderers' choice of leaf-block layout
(`models/scene.Scene.bake_blocks`): bake_bvh's global Morton order or
bake_bvh_grouped's per-object one, whichever has the smaller sum of block
box surface areas (the global one on a tie; a one-object scene skips the
comparison). `tracing.COUNTS["bake_by_object"]` counts the bakes that chose
the per-object layout.

Both layouts hold the same triangles and the kernels' tests are exact, so
a frame is the same bit for bit whichever layout the renderer baked; only
the scheduled (ray tile, block) cells change. Plain versions on the CPU.
"""

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch.models import native
from distributed_raytracer_tpu_torch.models.scene import Scene, SceneObject
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.ops.render_dynamic import (
    DynamicCulledRenderer)
from distributed_raytracer_tpu_torch.parallel import render_sharded_bvh
from distributed_raytracer_tpu_torch.utils import scenes, tracing
from tests.test_torch_models import assert_tuple_equal

BLOCK = 128


def summed_area(tree) -> float:
    d = tree.block_hi.astype(np.float64) - tree.block_lo
    return float(2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                        + d[:, 2] * d[:, 0]).sum())


@pytest.fixture
def counted():
    """COUNTS["bake_by_object"] from 0, restored after the test."""
    before = tracing.COUNTS["bake_by_object"]
    tracing.COUNTS["bake_by_object"] = 0
    yield tracing.COUNTS
    tracing.COUNTS["bake_by_object"] = before


@pytest.fixture(params=["native", "numpy"])
def bake_path(request, monkeypatch):
    """The native bake, or the NumPy chain with NumPy's slot maps."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    return request.param


@pytest.fixture(scope="module")
def grid():
    """16 spheres of 80 triangles 3 apart in the plane z = 0."""
    return scenes.instanced_grid(scenes.icosphere_scene(1), 4)


def test_one_object_keeps_the_global_bake(counted):
    scene = scenes.icosphere_scene(3)
    arrays, tree, layout = scene.bake_blocks(BLOCK)
    want_arrays, want_tree = scene.bake_bvh(BLOCK)
    assert layout == "global"
    assert_tuple_equal(arrays, want_arrays)
    assert_tuple_equal(tree, want_tree)
    assert counted["bake_by_object"] == 0


def test_grid_takes_the_per_object_layout(grid, counted, bake_path):
    arrays, tree, layout = grid.bake_blocks(BLOCK)
    assert layout == "object" and counted["bake_by_object"] == 1
    grouped = grid.bake_bvh_grouped(BLOCK)
    assert_tuple_equal(arrays, grouped[0])
    assert_tuple_equal(tree, grouped[1])
    assert summed_area(tree) < summed_area(grid.bake_bvh(BLOCK)[1])
    # No block holds real triangles of two spheres: each real triangle's
    # centroid lies nearest its own sphere's centre.
    real = np.abs(arrays.geo_n).sum(axis=1) > 0
    cent = arrays.p0 + (arrays.e1 + arrays.e2) / 3.0
    centres = np.stack([o.pos for o in grid.objects])
    owner = np.argmin(((cent[:, None] - centres[None]) ** 2).sum(-1), axis=1)
    for blk_real, blk_owner in zip(real.reshape(-1, BLOCK),
                                   owner.reshape(-1, BLOCK)):
        assert len(set(blk_owner[blk_real].tolist())) == 1


def test_per_object_frame_equals_the_global_one_with_fewer_cells(grid,
                                                                 counted):
    w, h = 128, 96
    cam = grid.camera.to_arrays()
    got = CulledRenderer(grid, w, h, device="cpu")
    want = CulledRenderer(None, w, h, prebaked=grid.bake_bvh(BLOCK),
                          device="cpu")
    assert got.block_layout == "object" and want.block_layout is None
    assert counted["bake_by_object"] == 1
    assert torch.equal(got.render(cam), want.render(cam))
    finest = got.n_levels - 1
    assert got._last_counts[finest] < want._last_counts[finest]


def test_overlapping_objects_keep_the_global_layout(counted, bake_path):
    """Four spheres a tenth apart, each spread over about the same volume:
    each one's blocks span its whole sphere, while the global Morton
    blocks stay local."""
    base = scenes.icosphere_scene(3)
    offsets = [(0, 0, 0), (0.1, 0, 0), (0, 0.1, 0), (0, 0, 0.1)]
    scene = Scene(meshes=base.meshes,
                  objects=[SceneObject(i, "ico", np.asarray(p, np.float64))
                           for i, p in enumerate(offsets)],
                  light_pos=base.light_pos, light_col=base.light_col,
                  camera=base.camera)
    arrays, tree, layout = scene.bake_blocks(BLOCK)
    assert layout == "global" and counted["bake_by_object"] == 0
    want_arrays, want_tree = scene.bake_bvh(BLOCK)
    assert_tuple_equal(arrays, want_arrays)
    assert_tuple_equal(tree, want_tree)
    assert summed_area(tree) < summed_area(scene.bake_bvh_grouped(BLOCK)[1])


def test_bands_share_one_bake_in_the_single_renderers_layout(grid, counted):
    w, h = 64, 48
    cam = grid.camera.to_arrays()
    br = render_sharded_bvh.make_sharded_culled_renderer(
        grid, w, h, mesh=["cpu"] * 2, sizing_camera=cam)
    assert counted["bake_by_object"] == 1       # one bake for every rank
    single = CulledRenderer(grid, w, h, device="cpu")
    assert [b.block_layout for b in br.bands] == [single.block_layout] * 2
    assert all(b.arrays_host is br.band.arrays_host for b in br.bands)
    assert_tuple_equal(br.band.tree, single.tree)
    assert torch.equal(br(cam), single.render(cam))


def test_dynamic_renderer_keeps_its_own_bake(grid, counted):
    r = DynamicCulledRenderer(grid, 64, 48, device="cpu")
    assert r.block_layout == "object" and counted["bake_by_object"] == 0


def test_the_4k_grid_scene_takes_the_per_object_layout(counted):
    """The 12 x 12 grid of 1,280-triangle spheres (the 4K grid's scene):
    1,440 full blocks instead of the global layout's 1,688, with about
    half the summed area."""
    scene = scenes.instanced_grid(scenes.icosphere_scene(3), 12)
    _, tree, layout = scene.bake_blocks(BLOCK)
    _, global_tree = scene.bake_bvh(BLOCK)
    assert layout == "object" and counted["bake_by_object"] == 1
    assert (tree.num_blocks, global_tree.num_blocks) == (1440, 1688)
    assert 2 * summed_area(tree) < summed_area(global_tree)
