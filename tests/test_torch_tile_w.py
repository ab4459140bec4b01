"""The port's CulledRenderer with screen tiles narrower than 32 pixels
(`tile_w`) against the JAX package's.

Both renderers are built from ONE bake by the JAX package (the port
through models.scene.from_reference); the JAX renderer runs its Pallas
kernels in interpret mode, the port's runs on device="cpu" (the plain
versions). The shapes are the JAX bench's config-5 tiles (ray_tile 256,
tile_w 16: 16x16) and tools/config5_ab.py's rt128 (16x8), at 64x48 and at
72x40 (a width that is not a multiple of 16: the last tile column is
padded). Images agree to atol 2e-5 (the repository's bound for identical
arrays); the sizing render's primary and hit-tile counts are exactly
equal, its shadow counts within SHADOW_SLACK (a light in a face's plane,
ROADMAP Queue 3). The frozen path (render_fast, render_many) and the
dynamic renderer with a zero diff reproduce the sync render with the same
tiles. A ray_tile that tile_w does not divide is refused.
"""

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.render_bvh import CulledRenderer as JaxRenderer
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import from_reference
from distributed_raytracer_tpu_torch.ops import cull
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.ops.render_dynamic import (
    DynamicCulledRenderer)
from distributed_raytracer_tpu_torch.utils import scenes
from tests.test_torch_sharded_bvh import SHADOW_SLACK

CASES = [(64, 48, 256), (72, 40, 256), (64, 48, 128)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ico():
    return jscenes.icosphere_scene(2)


def counts_match(got, want, n_levels: int) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(got[:n_levels + 1], want[:n_levels + 1])
    assert np.abs(got[n_levels + 1:] - want[n_levels + 1:]).max() \
        <= SHADOW_SLACK


@pytest.mark.parametrize("w,h,rt", CASES)
def test_tiles_match_jax(ico, w, h, rt):
    bake = ico.bake_bvh(block_size=64)
    jr = JaxRenderer(None, w, h, interpret=True, prebaked=bake, ray_tile=rt,
                     tile_w=16)
    tr = CulledRenderer(None, w, h, prebaked=from_reference(*bake),
                        ray_tile=rt, tile_w=16, device="cpu")
    assert (tr.tile_w, tr.tile_h) == (jr.tile_w, jr.tile_h) == (16, rt // 16)
    assert tr.n_pad == jr.n_pad and tr.n_tiles == jr.n_tiles
    cam = ico.camera.yaw(0.1)
    want = np.asarray(jr.render(cam.to_arrays()))
    got = tr.render(cam).numpy()
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    counts_match(tr._last_counts, jr._last_counts, tr.n_levels)
    assert (got.sum(-1) > 0).mean() > 0.05

    tr.freeze(cam)
    fast = tr.render_fast(cam, verify=True).numpy()
    np.testing.assert_array_equal(fast, got)
    poses = [cam, ico.camera.yaw(-0.1)]
    imgs, counts = tr.render_many(poses)
    assert tuple(imgs.shape) == (2, h, w, 3)
    np.testing.assert_array_equal(imgs[0].numpy(), got)
    np.testing.assert_array_equal(imgs[1].numpy(),
                                  tr.render_fast(poses[1]).numpy())
    assert tuple(counts[0].tolist()) == tr._last_counts


@pytest.mark.parametrize("w,h,rt", CASES)
def test_assemble_is_the_tiled_order(w, h, rt):
    """_assemble's reshape puts every slot's colour at the pixel
    cull.tiled_ray_order assigned it, the padded slots of a partial tile
    column or row dropped."""
    tr = CulledRenderer(scenes.icosphere_scene(0), w, h, ray_tile=rt,
                        tile_w=16, device="cpu")
    perm, _, n_slots = cull.tiled_ray_order(w, h, 16, rt // 16)
    assert n_slots == tr.n_pad and n_slots % rt == 0
    rows = torch.arange(3 * n_slots, dtype=torch.float32).reshape(3, -1)
    img = tr._assemble(rows).numpy()
    tx = -(-w // 16)
    s = np.arange(n_slots)
    tile, within = s // rt, s % rt
    y = (tile // tx) * (rt // 16) + within // 16
    x = (tile % tx) * 16 + within % 16
    real = (y < h) & (x < w)
    assert np.array_equal(perm[real], y[real] * w + x[real])
    for c in range(3):
        np.testing.assert_array_equal(img[y[real], x[real], c],
                                      rows[c].numpy()[real])


def test_dynamic_zero_diff_equals_render_fast():
    scene = scenes.icosphere_scene(2)
    tr = DynamicCulledRenderer(scene, 72, 40, ray_tile=256, tile_w=16,
                               device="cpu")
    assert (tr.tile_w, tr.tile_h) == (16, 16)
    cam = scene.camera.yaw(0.05)
    tr.freeze(cam)
    static = tr.render_fast(cam).numpy()
    dyn = tr.render_dynamic(cam, scene.make_diff()).numpy()
    np.testing.assert_array_equal(dyn, static)
    assert (static.sum(-1) > 0).mean() > 0.05


@pytest.mark.parametrize("rt,tile_w", [(256, 24), (128, 0), (512, 1024)])
def test_tile_w_must_divide_ray_tile(rt, tile_w):
    with pytest.raises(ValueError, match="does not divide"):
        CulledRenderer(scenes.icosphere_scene(0), 64, 48, ray_tile=rt,
                       tile_w=tile_w, device="cpu")
