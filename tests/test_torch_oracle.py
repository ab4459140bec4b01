"""The port's copy of the float64 oracle (utils/oracle.py) against the JAX
package's, and the port's culled frame against the copy.

The copy swaps only its imports (the port's camera, scene and tile
modules), so every image must equal the original's bit for bit; its
`assert_images_close` (copied from tests/test_render_golden.py) must give
the original's verdict.
"""

import numpy as np
import pytest

from distributed_raytracer_tpu_torch.models.scene import load_scene
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.utils import oracle

from distributed_raytracer_tpu.models.scene import load_scene as jload
from distributed_raytracer_tpu.utils import oracle as joracle
from tests import test_render_golden as golden
from tests.conftest import make_tetra_obj

TETRA = (
    '{"objs": [{"model": "tetra.obj", "pos": {"x": 0.0, "y": 0.0, '
    '"z": 0.0}}],'
    '"lights": ['
    '{"pos": {"x": 3.0, "y": 4.0, "z": 5.0}, "col": {"r": 255, "g": 255, '
    '"b": 255}},'
    '{"pos": {"x": -4.0, "y": 2.0, "z": 3.0}, "col": {"r": 64, "g": 128, '
    '"b": 255}}],'
    '"cam": {"pos": {"x": 1.5, "y": 1.2, "z": 3.0},'
    '"dir": {"x": -0.35, "y": -0.3, "z": -1.0}, "fov": 1.04719755}}')
TWO_TETRA = (
    '{"objs": ['
    '{"model": "tetra.obj", "pos": {"x": 0, "y": 0, "z": 0}},'
    '{"model": "tetra.obj", "pos": {"x": -1.6, "y": 0.4, "z": -0.8}}],'
    '"lights": ['
    '{"pos": {"x": 3, "y": 4, "z": 5}, "col": {"r": 255, "g": 255, '
    '"b": 255}},'
    '{"pos": {"x": -4, "y": 2, "z": 3}, "col": {"r": 64, "g": 128, '
    '"b": 255}}],'
    '"cam": {"pos": {"x": 0.4, "y": 1.0, "z": 4.2},'
    '"dir": {"x": -0.1, "y": -0.25, "z": -1.0}, "fov": 1.0472}}')


@pytest.fixture(scope="module", params=["tetra", "two_tetra"])
def scenes(request, tmp_path_factory):
    """(the port's scene, the JAX package's scene) from one scene.json."""
    d = tmp_path_factory.mktemp(request.param)
    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(TETRA if request.param == "tetra" else TWO_TETRA)
    return load_scene(str(p)), jload(str(p))


def test_render_oracle_equals_the_original(scenes):
    port, ref = scenes
    got, aux = oracle.render_oracle(port, 40, 30, return_aux=True)
    want, jaux = joracle.render_oracle(ref, 40, 30, return_aux=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(aux["tri"], jaux["tri"])
    np.testing.assert_array_equal(aux["lit"], jaux["lit"])
    assert want.max() > 0.2
    cam = port.camera.yaw(0.2)
    np.testing.assert_array_equal(
        oracle.render_oracle(port, 24, 18, camera=cam),
        joracle.render_oracle(ref, 24, 18, camera=ref.camera.yaw(0.2)))


@pytest.mark.parametrize("depth", [1, 2])
def test_render_oracle_bounced_equals_the_original(scenes, depth):
    port, ref = scenes
    np.testing.assert_array_equal(
        oracle.render_oracle_bounced(port, 24, 18, depth),
        joracle.render_oracle_bounced(ref, 24, 18, depth))


def test_render_oracle_tiles_equals_the_original(scenes):
    port, ref = scenes
    got, tiles = oracle.render_oracle_tiles(port, 32, 24, 4, only=[0, 2])
    want, jtiles = joracle.render_oracle_tiles(ref, 32, 24, 4, only=[0, 2])
    np.testing.assert_array_equal(got, want)
    assert [(t.x, t.y, t.width, t.height) for t in tiles] == \
        [(t.x, t.y, t.width, t.height) for t in jtiles]
    np.testing.assert_array_equal(oracle.to_u8(got), joracle.to_u8(want))


def _verdict(check, *args) -> str:
    """"pass", or "fail: " and the first line of the assertion's message
    (pytest rewrites the asserts of test modules, and adds lines)."""
    try:
        check(*args)
    except AssertionError as e:
        return f"fail: {(str(e).splitlines() or [''])[0]}"
    return "pass"


def test_assert_images_close_gives_the_originals_verdict(scenes):
    """A passing pair (the oracle against itself plus float32 rounding and
    a small offset) and failing pairs (a bright band on continuity pixels;
    a global offset over the mean tolerance)."""
    port, _ = scenes
    want, aux = oracle.render_oracle(port, 40, 30, return_aux=True)
    near = want.astype(np.float32) + 1e-3
    band = want.copy()
    band[10:14] += 0.2
    shifted = want + 0.02
    np.testing.assert_array_equal(oracle.discontinuity_mask(aux),
                                  golden.discontinuity_mask(aux))
    verdicts = []
    for got in (near, band, shifted):
        mine = _verdict(oracle.assert_images_close, got, want, aux)
        theirs = _verdict(golden.assert_images_close, got, want, aux)
        assert mine == theirs
        verdicts.append(mine.split(":")[0])
    assert verdicts == ["pass", "fail", "fail"]


def test_culled_cpu_frame_passes_the_copied_oracle(scenes):
    """The port's culled frame (the plain versions on the CPU) within the
    copied golden tolerance of the copied oracle."""
    port, _ = scenes
    w, h = 72, 54
    want, aux = oracle.render_oracle(port, w, h, return_aux=True)
    got = CulledRenderer(port, w, h, device="cpu").render(port.camera)
    oracle.assert_images_close(got.numpy(), want, aux)
    assert (want.sum(axis=-1) > 0).mean() > 0.05
