"""A scene that moves, through the frame loop: each frame is drawn at the
scene state of its own tick, also when a verify frame's overflow makes
the loop issue it, and the frames behind it, again.

runtime/loop.run_loop takes ("scene", state) events beside the input and
hands each frame's state to render_fn; a frame in flight keeps its state
beside its camera. Cases:

  - a 3x3 grid of icosphere(1) at 64x48 through DynamicCulledRenderer,
    driven by rtbench's `arc-moving` traffic (every object circling, the
    lights turning) from seed-drawn cycle positions, with buckets frozen
    too small: a verify frame overflows, is issued again with the frames
    behind it, and every displayed frame holds to rtbench's plain float64
    reference rebuilt at that frame's scene state (assert_images_close);
    a recording render_fn shows each call got its own frame's state;
  - with no scene event the calls are those of the loop before scene
    states came (the JAX package's loop, which has none): the scene
    argument is `scene_arrays` itself and the cameras are bit-equal;
  - the CLI's served dynamic path (`--serve --animate-objects`,
    run.served_dynamic through runtime/viewer.with_scenes): one diff a
    frame, and a frame issued again keeps its diff.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.models.camera import Camera as JaxCamera
from distributed_raytracer_tpu.runtime.loop import run_loop as jax_run_loop
from distributed_raytracer_tpu_torch import run as cli
from distributed_raytracer_tpu_torch.models.scene import SceneDiff
from distributed_raytracer_tpu_torch.ops import frozen_graph
from distributed_raytracer_tpu_torch.ops.render_dynamic import (
    DynamicCulledRenderer)
from distributed_raytracer_tpu_torch.runtime import animation, viewer
from distributed_raytracer_tpu_torch.runtime.loop import run_loop
from distributed_raytracer_tpu_torch.utils.config import DEFAULT_CONFIG
from distributed_raytracer_tpu_torch.utils.oracle import assert_images_close
from rtbench import judge, port, scenes, spec
from rtbench.traffic import Events, Traffic

W, H = 64, 48
GRID = {"generator": "instanced_grid", "n": 3,
        "base": {"generator": "icosphere", "subdivisions": 1}}
TICKS = 14
PERIOD = 2
SEEDS = [3100000019, 2**31 + 77]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(the SceneSpec, its Traffic under arc-moving, the program's Scene)."""
    sc = scenes.make(GRID, str(tmp_path_factory.mktemp("moving_loop")))
    mix = spec._json("traffic", "arc-moving")
    return sc, Traffic(mix, sc, W), port.scene(sc)


def scene_diff(scene, state) -> SceneDiff:
    """The program's SceneDiff of a traffic state (rtbench/layouts/dynamic.py's
    conversion): each object at its position plus the state's offset."""
    base = scene.make_diff()
    return SceneDiff(
        obj_pos=(np.stack([o.pos for o in scene.objects])
                 + state.offsets).astype(np.float32),
        light_pos=np.asarray(state.lights, np.float32),
        light_col=base.light_col)


def moving_ticks(traffic, scene, start: int):
    """The traffic's input ticks from cycle position `start`, each with
    ("scene", its frame's SceneDiff) appended."""
    ticks = list(Events(traffic, start, ticks=TICKS))
    diffs = [scene_diff(scene, traffic.frame_state(start, k))
             for k in range(TICKS)]
    return [t + [("scene", d)] for t, d in zip(ticks, diffs)], diffs


def counts_since(before: dict) -> dict:
    return {k: frozen_graph.COUNTS[k] - before[k] for k in before}


@pytest.mark.parametrize("seed", SEEDS)
def test_each_frame_is_drawn_at_its_own_scene_state(grid, seed):
    sc, traffic, scene = grid
    start = traffic.offset(seed)
    assert traffic.moves
    r = DynamicCulledRenderer(scene, W, H, device="cpu", block_size=32,
                              ray_tile=128, tile_w=16)
    # Frozen far back with no margin: the first verify frame overflows.
    far = scene.camera.move(4.0, backward=True)
    r.render(far, block=True)
    r.freeze(far, margin=1.0)
    small = r.buckets()
    events, diffs = moving_ticks(traffic, scene, start)
    calls = []          # (camera arrays, scene state) of each render call
    k = [0]

    def render(state, cam):
        verify = k[0] % PERIOD == 0
        k[0] += 1
        calls.append((cam, state))
        return r.render_dynamic(cam, state, verify=verify)

    shown = {}
    cfg = dataclasses.replace(DEFAULT_CONFIG, move_step=traffic.move_step,
                              frames_in_flight=traffic.frames_in_flight)
    before = dict(frozen_graph.COUNTS)
    _, _, dropped = run_loop(
        None, port.camera(traffic.poses[start]), render, W, H,
        events=events, cfg=cfg,
        display=lambda idx, img: shown.__setitem__(idx, img.copy()))
    counts = counts_since(before)
    assert dropped == 0 and sorted(shown) == list(range(TICKS))
    assert r.buckets() != small
    # Frame 0 overflowed at its drain: it and the two frames in flight
    # behind it were issued again.
    assert counts["verify_reissued"] == len(calls) - TICKS >= 3
    assert counts["scene_diffs"] == len(calls)
    # Each call's state is its frame's: a new camera is the next frame; a
    # camera seen before is that frame issued again, with its own state.
    frame_of = {}
    for cam, state in calls:
        idx = frame_of.setdefault(id(cam), len(frame_of))
        assert state is diffs[idx], idx
    assert len(frame_of) == TICKS
    # Every displayed frame against the plain reference at its pose and
    # state.
    poses = traffic.frame_poses(start, TICKS)
    ref = judge.Reference(sc, "cpu")
    for idx in range(TICKS):
        want, code = judge.reference_frame(
            ref.at(traffic.frame_state(start, idx)), poses[idx], W, H)
        code = code.numpy()
        assert_images_close(
            shown[idx], want.numpy() / 255.0,
            {"tri": code - 1, "lit": np.zeros(code.shape + (0,), bool)})
        assert (want.numpy().sum(-1) > 0).mean() > 0.05


def test_without_scene_events_the_calls_are_as_before(grid):
    """The loop's calls with no scene event: the scene argument is the one
    passed in, every call, and the cameras are those of the JAX package's
    loop (the loop before scene states), bit for bit."""
    sc, traffic, scene = grid
    start = traffic.offset(SEEDS[0])
    ticks = list(Events(traffic, start, ticks=TICKS))
    img = np.zeros((H, W, 3), np.float32)
    sentinel = object()
    got, want = [], []

    def recorder(calls):
        def render(state, cam):
            calls.append((state, cam))
            return img
        return render

    cfg = dataclasses.replace(DEFAULT_CONFIG, move_step=traffic.move_step)
    pose = traffic.poses[start]
    run_loop(sentinel, port.camera(pose), recorder(got), W, H,
             events=ticks, cfg=cfg)
    jax_run_loop(sentinel, JaxCamera(pos=pose.pos.copy(),
                                     forward=pose.forward.copy(),
                                     left=pose.left.copy(),
                                     up=pose.up.copy(), fov=pose.fov),
                 recorder(want), W, H, events=ticks, cfg=cfg)
    assert len(got) == len(want) == TICKS
    for (s, cam), (js, jcam) in zip(got, want):
        assert s is sentinel and js is sentinel
        for f in ("pos", "forward", "left", "up", "fov"):
            np.testing.assert_array_equal(np.asarray(getattr(cam, f)),
                                          np.asarray(getattr(jcam, f)))


def test_served_dynamic_path_moves_one_diff_a_frame(grid):
    """`--serve --animate-objects`: each viewer tick carries the next
    (index, diff) (viewer.with_scenes over run.served_dynamic's states);
    with buckets frozen too small, the frames issued again keep their own
    diff, the scene advances one diff a frame, and every 8th diff's frame
    verifies."""
    _, _, scene = grid
    r = DynamicCulledRenderer(scene, W, H, device="cpu", block_size=32,
                              ray_tile=128, tile_w=16)
    far = scene.camera.move(4.0, backward=True)
    r.render(far, block=True)
    r.freeze(far, margin=1.0)
    diffs = animation.orbit_object_diffs(scene, 5, radius=1.0)
    states, render = cli.served_dynamic(r, diffs)
    calls = []
    dynamic = r.render_dynamic

    def recording(cam, diff, verify=False):
        calls.append((cam, diff, verify))
        return dynamic(cam, diff, verify=verify)

    r.render_dynamic = recording
    # The viewer's ticks: "w" held for 10 ticks, then Esc.
    ticks = ([[("key_down", "w")]] + [[] for _ in range(9)]
             + [[("key_down", "esc")]])
    shown = []
    _, _, dropped = run_loop(None, scene.camera, render, W, H,
                             events=viewer.with_scenes(ticks, states),
                             display=lambda idx, img: shown.append(idx))
    assert dropped == 0 and shown == list(range(10))
    frame_of = {}
    for cam, diff, verify in calls:
        k = frame_of.setdefault(id(cam), len(frame_of))
        assert diff is diffs[k % len(diffs)] and verify == (k % 8 == 0)
    assert len(frame_of) == 10 and len(calls) > 10
    # Esc's tick took the eleventh state; the next is the twelfth.
    assert next(states)[0] == 11
