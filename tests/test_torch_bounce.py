"""The PyTorch port's bounced (Whitted) culled renderer against the JAX
package's `CulledRenderer.render_bounced` and the float64 oracle.

Scene: instanced_grid(icosphere_scene(2), 2), four mirrored spheres (1,280
triangles, Ks 0.4, 3 lights) whose reflections hit each other, so bounce 1
has hit tiles and the per-ray-origin traversal does real work (one convex
mesh reflects nothing back onto itself). Both renderers are built from ONE
bake by the JAX package (the port through models.scene.from_reference);
the JAX renderer runs its Pallas kernels in interpret mode, the port's runs
on device="cpu" (the plain versions). Every work list stays far below the
JAX kernels' 16,384-item segment: past one segment the JAX reference leaves
some tiles' outputs undefined. Images agree to atol 2e-5 (the repository's
culled-vs-dense bound for identical arrays), raw per-bounce counts exactly.
"""

import numpy as np
import pytest

from distributed_raytracer_tpu.ops.render_bvh import CulledRenderer as JaxRenderer
from distributed_raytracer_tpu.utils import oracle
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import from_reference
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.utils import tracing

W, H = 64, 48


@pytest.fixture(scope="module")
def grid():
    scene = jscenes.instanced_grid(jscenes.icosphere_scene(2), 2)
    return scene, scene.bake_bvh(block_size=64)


@pytest.fixture(scope="module")
def port(grid):
    return CulledRenderer(None, W, H, prebaked=from_reference(*grid[1]),
                          device="cpu")


@pytest.fixture(scope="module")
def jax_renderer(grid):
    return JaxRenderer(None, W, H, interpret=True, prebaked=grid[1])


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_render_bounced_matches_jax(grid, port, jax_renderer, depth):
    scene = grid[0]
    want = np.asarray(jax_renderer.render_bounced(scene.camera, depth=depth))
    before = dict(tracing.COUNTS)
    got = port.render_bounced(scene.camera, depth).numpy()
    assert tracing.COUNTS == before         # plain versions on the CPU
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    counts = port._last_bounce_counts
    assert counts == jax_renderer._last_bounce_counts
    assert len(counts) == depth + 1 and len(port._last_bounce_pads) == depth + 1
    assert all(max(c) <= 16384 for c in counts)
    if depth:
        assert counts[1][port.n_levels] > 0      # bounce 1 has hit tiles


def test_depth_zero_equals_render(grid, port):
    cam = grid[0].camera.yaw(0.05)
    np.testing.assert_allclose(port.render_bounced(cam, 0).numpy(),
                               port.render(cam).numpy(), atol=2e-5, rtol=0)


def test_bounces_add_light(grid, port):
    """The JAX package's test_bounce_adds_light_on_specular on the port:
    reflections raise some pixels and lower none (throughput >= 0)."""
    d0 = port.render_bounced(grid[0].camera, 0).numpy()
    d2 = port.render_bounced(grid[0].camera, 2).numpy()
    assert d2.min() >= 0.0 and d2.max() <= 1.0
    assert (d2 - d0).max() > 0.01
    assert (d2 >= d0 - 1e-5).all()


def test_frozen_bounced_matches_sync(grid):
    """freeze_bounced's no-sync pipeline reproduces render_bounced, at the
    sizing pose and at a moved one."""
    scene, bake = grid
    r = CulledRenderer(None, W, H, prebaked=from_reference(*bake),
                       device="cpu")
    fast = r.freeze_bounced(scene.camera, 2)
    pads = fast.pads()
    assert len(pads) == 3 and all(len(p) == 2 * r.n_levels + 1 for p in pads)
    for cam in (scene.camera, scene.camera.yaw(0.1)):
        got = fast(cam, verify=True).numpy()
        want = r.render_bounced(cam, 2).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        assert all(c <= p for cb, pb in zip(r._last_bounce_counts,
                                             fast.pads())
                   for c, p in zip(cb, pb))
    np.testing.assert_array_equal(fast(scene.camera).numpy(),
                                  fast(scene.camera, verify=True).numpy())


def test_bounced_verify_loops_until_counts_fit(grid):
    """Freeze on a camera that sees nothing, with no margin, then verify-
    render one that sees the spheres: buckets of every bounce overflow (a
    truncated level also undercounts the next), and the verify loop must
    converge to the sync render's image."""
    scene, bake = grid
    r = CulledRenderer(None, 128, 96, prebaked=from_reference(*bake),
                       device="cpu", cull_group=2)
    fast = r.freeze_bounced(scene.camera.yaw(3.14159), 2, margin=1.0)
    assert r._last_bounce_counts == ((0,) * (2 * r.n_levels + 1),) * 3
    small = fast.pads()
    got = fast(scene.camera, verify=True).numpy()
    want = r.render_bounced(scene.camera, 2).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    grown = fast.pads()
    assert any(g > s for gb, sb in zip(grown, small) for g, s in zip(gb, sb))
    assert all(g >= s for gb, sb in zip(grown, small) for g, s in zip(gb, sb))
    assert all(c <= p for cb, pb in zip(r._last_bounce_counts, grown)
               for c, p in zip(cb, pb))


def test_bounced_matches_oracle(grid, port):
    """The port's depth-2 image against the float64 oracle, with the JAX
    package's bounced-oracle tolerance (tests/test_bounce.py)."""
    scene = grid[0]
    want = oracle.render_oracle_bounced(scene, W, H, depth=2)
    got = port.render_bounced(scene.camera, 2).numpy()
    diff = np.abs(got - want).max(-1)
    assert (diff > 3 / 255).mean() < 0.02
    assert np.abs(got - want).mean() < 0.01
    assert (want.sum(-1) > 0).mean() > 0.1
