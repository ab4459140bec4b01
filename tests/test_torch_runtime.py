"""The port's runtime layer: controller, framebuffer, event streams, the
frame loop with its failure containment and recovery, and the loop over
the port's renderer against the JAX package's loop over its renderer.

The cases and their asserted numbers are the JAX package's
tests/test_runtime.py, run against the port's modules (runtime/controller,
runtime/framebuffer, runtime/animation, runtime/loop). The parity case
drives both loops with the same scripted events at 32x24: the port's
run_loop over its CPU render_fast, JAX's over its render_fast (Pallas in
interpret mode), both renderers built from one bake; the final cameras and
displayed indices are equal, the images within atol 2e-5 (the
repository's bound for identical arrays).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.render_bvh import CulledRenderer as JaxRenderer
from distributed_raytracer_tpu.runtime import animation as janimation
from distributed_raytracer_tpu.runtime.loop import run_loop as jax_run_loop
from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import from_reference
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.runtime import animation, framebuffer
from distributed_raytracer_tpu_torch.runtime.controller import CameraController
from distributed_raytracer_tpu_torch.runtime.loop import (make_culled_recoverer,
                                                          run_loop)
from distributed_raytracer_tpu_torch.utils.config import DEFAULT_CONFIG
from tests.test_torch_render_many import port_camera


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def camera(tetra_scene):
    return port_camera(tetra_scene.camera)


# ---- controller (input.go + master/main.go:246-258) ------------------------

def test_controller_opposing_keys_cancel():
    c = CameraController(width=320, height=240)
    c.key_down("w")
    assert c.move_dirs != 0
    c.key_down("s")  # opposing press clears both (input.go:47-52)
    assert c.move_dirs == 0


def test_controller_key_up():
    c = CameraController(width=320, height=240)
    c.key_down("a")
    c.key_up("a")
    assert c.move_dirs == 0 and not c.dirty


def test_controller_esc_stops():
    c = CameraController(width=320, height=240)
    c.key_down("esc")
    assert not c.running


def test_controller_mouse_units():
    # yaw in units of width/2, pitch negated in units of height/2
    c = CameraController(width=320, height=240)
    c.mouse_motion(160, -120)
    assert np.isclose(c._yaw, 1.0)
    assert np.isclose(c._pitch, 1.0)


def test_controller_apply_matches_master_scaling():
    cam = Camera.create([0, 0, 0], [0, 0, -1], 1.0)
    c = CameraController(width=320, height=240)
    c.mouse_motion(160, 0)  # yaw unit 1 -> rotation fov/2 = 0.5 rad
    cam2 = c.apply(cam)
    expected = cam.yaw(0.5)
    assert np.allclose(cam2.forward, expected.forward)
    assert not c.dirty  # deltas consumed


def test_controller_move_only_when_dirty():
    cam = Camera.create([0, 0, 0], [0, 0, -1], 1.0)
    c = CameraController(width=320, height=240)
    c.key_down("w")
    cam2 = c.apply(cam)
    assert np.allclose(cam2.pos, [0, 0, -0.1])  # move_step 0.1 (main.go:254)
    assert c.dirty  # key still held -> next frame moves again


# ---- framebuffer -----------------------------------------------------------

def test_ppm_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(size=(7, 5, 3)).astype(np.float32)
    p = str(tmp_path / "x.ppm")
    framebuffer.write_ppm(p, img)
    back = framebuffer.read_ppm(p)
    assert np.array_equal(back, framebuffer.to_u8(img))


def test_png_roundtrip(tmp_path):
    img = np.zeros((4, 6, 3), dtype=np.uint8)
    img[1, 2] = [255, 128, 0]
    p = str(tmp_path / "x.png")
    framebuffer.write_png(p, img)
    back = framebuffer.read_png(p)
    assert back.shape == (4, 6, 3)
    assert back[1, 2].tolist() == [255, 128, 0]
    assert np.array_equal(back, img)


# ---- animation -------------------------------------------------------------

def test_orbit_events_shape():
    evs = list(animation.orbit_events(320, 10, fov=1.0))
    assert evs[0][0] == ("key_down", "a")
    assert evs[-1] == [("key_up", "a")]
    assert evs == list(janimation.orbit_events(320, 10, fov=1.0))


def test_event_streams_match_jax():
    assert (list(animation.constant_motion(["w", "d"], 4))
            == list(janimation.constant_motion(["w", "d"], 4)))
    assert (list(animation.mouse_pan(3.5, 5, 320))
            == list(janimation.mouse_pan(3.5, 5, 320)))


# ---- frame loop ------------------------------------------------------------

def test_loop_renders_only_on_input(camera):
    calls = []

    def fake_render(scene, cam_arrays):
        calls.append(np.asarray(cam_arrays.pos))
        return np.zeros((4, 4, 3), dtype=np.float32)

    displayed = []
    events = [[], [("key_down", "w")], [], [("key_up", "w")], [], []]
    cam, stats, dropped = run_loop(
        None, camera, fake_render, 32, 24,
        events=events, display=lambda i, img: displayed.append(i))
    # The key_down tick and the next tick; the key_up is processed before
    # the dirty check on its own tick -> 2 frames.
    assert len(calls) == 2
    assert displayed == [0, 1]
    assert dropped == 0
    expected = camera.pos + 0.2 * camera.forward
    assert np.allclose(cam.pos, expected, atol=1e-9)


def test_loop_displays_host_tensors(camera):
    """A render_fn may return a CPU tensor: the display gets its values."""
    shown = []
    img = torch.arange(4 * 4 * 3, dtype=torch.float32).reshape(4, 4, 3)
    run_loop(None, camera, lambda s, c: img, 32, 24,
             events=[[("key_down", "w")], [("key_up", "w")]],
             display=lambda i, a: shown.append(a))
    assert len(shown) == 1 and np.array_equal(shown[0], img.numpy())


def test_loop_esc_stops(camera):
    events = [[("key_down", "w")], [("key_down", "esc")], [("key_down", "w")]]
    n = [0]

    def fake_render(scene, cam_arrays):
        n[0] += 1
        return np.zeros((2, 2, 3), dtype=np.float32)

    run_loop(None, camera, fake_render, 32, 24, events=events)
    assert n[0] == 1  # stopped at esc


# ---- failure containment ----------------------------------------------------

def test_loop_survives_dispatch_failure(camera):
    calls = []

    def flaky_render(scene, cam_arrays):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected dispatch failure")
        return np.zeros((4, 4, 3), dtype=np.float32)

    displayed = []
    events = [[("key_down", "w")], [], [], [("key_up", "w")]]
    cam, stats, dropped = run_loop(
        None, camera, flaky_render, 32, 24,
        events=events, display=lambda i, img: displayed.append(i))
    assert len(calls) == 3
    assert dropped == 1
    assert displayed == [1, 2]
    assert stats.frames_drawn == 2


def test_loop_survives_completion_failure(camera):
    class Poisoned:
        def __array__(self, *a, **k):
            raise RuntimeError("injected device failure")

    count = [0]

    def flaky_render(scene, cam_arrays):
        count[0] += 1
        if count[0] == 2:
            return Poisoned()
        return np.zeros((4, 4, 3), dtype=np.float32)

    displayed = []
    events = [[("key_down", "w")], [], [], [], [("key_up", "w")]]
    cam, stats, dropped = run_loop(
        None, camera, flaky_render, 32, 24,
        events=events, display=lambda i, img: displayed.append(i))
    assert dropped == 1
    assert displayed == [0, 2, 3]   # frame 1 dropped whole, in-order display
    assert stats.frames_drawn == 3


def dead_render(scene, cam_arrays):
    raise RuntimeError("device gone")


def test_loop_aborts_on_permanent_failure(camera):
    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=5)
    events = ([[("key_down", "w")]] + [[]] * 999)
    cam, stats, dropped = run_loop(
        None, camera, dead_render, 32, 24, events=events, cfg=cfg)
    assert dropped == 5


def test_loop_recovers_after_drop_run(camera):
    def good_render(scene, cam_arrays):
        return np.zeros((4, 4, 3), dtype=np.float32)

    attempts = []

    def recover(attempt):
        attempts.append(attempt)
        return good_render

    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=4)
    events = [[("key_down", "w")]] + [[]] * 19
    cam, stats, dropped = run_loop(
        None, camera, dead_render, 32, 24,
        events=events, cfg=cfg, recover=recover)
    assert attempts == [1]
    assert dropped == 4
    assert stats.frames_drawn == 20 - 4
    assert stats.recoveries == 1


def test_loop_aborts_when_recovery_fails(camera):
    def bad_recover(attempt):
        raise RuntimeError("rebuild also failed")

    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=3)
    events = [[("key_down", "w")]] + [[]] * 99
    cam, stats, dropped = run_loop(
        None, camera, dead_render, 32, 24,
        events=events, cfg=cfg, recover=bad_recover)
    assert dropped == 3


def test_loop_exhausts_recovery_budget(camera):
    attempts = []

    def recover(attempt):
        attempts.append(attempt)
        return dead_render

    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=2,
                              max_recoveries=2)
    events = [[("key_down", "w")]] + [[]] * 99
    cam, stats, dropped = run_loop(
        None, camera, dead_render, 32, 24,
        events=events, cfg=cfg, recover=recover)
    assert attempts == [1, 2]
    assert dropped == 6             # 3 drop runs of max_consecutive_drops=2


# ---- the loop over the renderers ---------------------------------------------

LW, LH = 32, 24


def test_loop_matches_jax(tetra_scene):
    """Both loops over their own frozen renderers, same scripted events."""
    bake = tetra_scene.bake_bvh(block_size=64)
    jr = JaxRenderer(None, LW, LH, interpret=True, prebaked=bake)
    tr = CulledRenderer(None, LW, LH, prebaked=from_reference(*bake),
                        device="cpu")
    jr.render(tetra_scene.camera.to_arrays(), block=True)
    jr.freeze(tetra_scene.camera)
    cam0 = port_camera(tetra_scene.camera)
    tr.render(cam0, block=True)
    tr.freeze(cam0)
    events = list(janimation.orbit_events(LW, 4, fov=tetra_scene.camera.fov,
                                          revolutions=0.1))
    events.insert(2, [])        # no events, but "a" is held: a frame
    jshown, tshown = [], []
    jcam, jstats, jdropped = jax_run_loop(
        None, tetra_scene.camera, lambda s, c: jr.render_fast(c), LW, LH,
        events=events, display=lambda i, img: jshown.append((i, img)))
    tcam, tstats, tdropped = run_loop(
        None, cam0, lambda s, c: tr.render_fast(c), LW, LH,
        events=events, display=lambda i, img: tshown.append((i, img)))
    assert jdropped == tdropped == 0
    assert [i for i, _ in tshown] == [i for i, _ in jshown] == [0, 1, 2, 3, 4]
    for f in ("pos", "forward", "left", "up"):
        np.testing.assert_array_equal(getattr(tcam, f), getattr(jcam, f))
    for (_, got), (_, want) in zip(tshown, jshown):
        assert got.shape == (LH, LW, 3)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)
    assert tstats.frames_drawn == jstats.frames_drawn == 5


def test_culled_recoverer_rebuilds(tetra_scene):
    """make_culled_recoverer builds a fresh frozen renderer on the device
    of the one it replaces; its frames equal that renderer's."""
    prebaked = from_reference(*tetra_scene.bake_bvh(block_size=64))
    cam = port_camera(tetra_scene.camera)
    old = CulledRenderer(None, LW, LH, prebaked=prebaked, device="cpu")
    old.render(cam, block=True)
    old.freeze(cam)
    scene = types.SimpleNamespace(camera=cam)   # sizes on scene.camera
    recover = make_culled_recoverer(scene, LW, LH, renderer=old,
                                    prebaked=prebaked)
    fn = recover(1)
    moved = cam.yaw(0.1)
    assert torch.equal(fn(None, moved.to_arrays()), old.render_fast(moved))
    fn2 = recover(2)
    assert torch.equal(fn2(None, moved.to_arrays()), old.render_fast(moved))
