"""The verify frame's bucket check runs when the frame loop drains the frame.

Inside runtime/loop.run_loop every render call runs under a deferral
(ops/frozen_graph.deferred): a verify frame's check (frozen_graph.Check)
is collected, its counts' host copy started, and the call returns at once;
the loop settles the check after the frame's host copy, before the frame is
displayed. On an overflow the check has grown the buckets, and the loop
issues the frame again, then every frame in flight behind it. Cases:

  - with a stand-in renderer, a verify frame's counts are read at its
    drain, after the two frames ahead of it are displayed and the two
    behind it issued; display order, indices and drops are those of the
    check run at once;
  - a real CPU CulledRenderer frozen far from the scene and driven closer:
    every displayed verify frame equals the exactly sized render at its
    pose, the frames behind an overflowing verify frame are issued again
    with grown buckets, and `verify_reissued` counts them;
  - a check that raises drops its frame, and the stream goes on;
  - each of the five verify sites defers under an open deferral and
    refreezes when settled; outside one, render_fast(verify=True) and the
    bands refreeze before they return, and a multi-process mesh checks at
    once even under a deferral.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch.ops import frozen_graph
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.parallel import (halo_bvh,
                                                      render_sharded_bvh,
                                                      ring_bvh)
from distributed_raytracer_tpu_torch.runtime.loop import run_loop
from distributed_raytracer_tpu_torch.utils import scenes
from distributed_raytracer_tpu_torch.utils.config import DEFAULT_CONFIG

# The five verify sites, as tests/test_torch_verify_loops.py drives them
# (imported in the tests that use it: the card's run of this file loads no
# other test module).
LOOPS = ["render_fast", "freeze_bounced", "bands", "ring", "halo"]
FRAMES = 12
PERIOD = 4
W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def counts_since(before: dict) -> dict:
    return {k: frozen_graph.COUNTS[k] - before[k] for k in before}


def forward_events(n: int):
    """n ticks holding the forward key: every tick makes a frame."""
    return [[("key_down", "w")]] + [[] for _ in range(n - 1)]


def stand_in(log: list, now: bool, fail_at=None):
    """A render_fn whose frame k is an image filled with k; every
    PERIOD-th frame makes a check whose counts ([k]) always fit, or raise
    when they are frame `fail_at`'s. `log` records each issue, each read of
    a check's counts and each display, in order. `now` runs the checks at
    once, as outside the loop."""
    k = [0]

    def fits(got):
        log.append(("read", int(got[0])))
        if int(got[0]) == fail_at:
            raise RuntimeError("injected check failure")
        return True

    def render(scene_arrays, cam):
        i = k[0]
        k[0] += 1
        log.append(("issue", i))
        img = torch.full((2, 2, 3), float(i))
        if i % PERIOD == 0:
            frozen_graph.verify(frozen_graph.Check(
                img, torch.tensor([i]), fits, None, None, "stand-in"),
                now=now)
        return img
    return render


def drive_stand_in(now: bool, fail_at=None):
    log = []

    def display(idx, img):
        assert img[0, 0, 0] == idx
        log.append(("display", idx))
    camera = scenes.icosphere_scene(1).camera
    _, _, dropped = run_loop(None, camera, stand_in(log, now, fail_at),
                             32, 24, events=forward_events(FRAMES),
                             display=display)
    return log, dropped


def test_check_is_read_at_the_drain_not_at_the_issue():
    log, dropped = drive_stand_in(now=False)
    at = {e: n for n, e in enumerate(log)}
    verify_frames = range(0, FRAMES, PERIOD)
    for v in verify_frames:
        # Two frames in flight: frame v drains once v + 2 is issued; the
        # frames ahead of it are shown before its counts are read.
        assert at[("issue", min(v + 2, FRAMES - 1))] < at[("read", v)]
        for ahead in (v - 2, v - 1):
            if ahead >= 0:
                assert at[("display", ahead)] < at[("read", v)]
        assert at[("read", v)] < at[("display", v)]
    # Run at once, each check is read inside its own render call.
    now_log, now_dropped = drive_stand_in(now=True)
    now_at = {e: n for n, e in enumerate(now_log)}
    for v in verify_frames:
        assert now_at[("read", v)] == now_at[("issue", v)] + 1
    shown = [e[1] for e in log if e[0] == "display"]
    assert shown == [e[1] for e in now_log if e[0] == "display"]
    assert shown == list(range(FRAMES))
    assert dropped == now_dropped == 0


def test_a_check_that_raises_drops_its_frame():
    before = dict(frozen_graph.COUNTS)
    log, dropped = drive_stand_in(now=False, fail_at=PERIOD)
    shown = [e[1] for e in log if e[0] == "display"]
    assert dropped == 1
    assert shown == [i for i in range(FRAMES) if i != PERIOD]
    assert counts_since(before)["verify_reissued"] == 0
    # Run at once, the raise fails the render call: the same drop.
    now_log, now_dropped = drive_stand_in(now=True, fail_at=PERIOD)
    assert now_dropped == 1
    assert [e[1] for e in now_log if e[0] == "display"] == shown


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_overflow_at_the_drain_issues_the_frames_again(device):
    """Frozen at a far pose with no margin, then driven towards the scene:
    the counts outgrow the buckets, and each overflow is found at a verify
    frame's drain."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    scene = scenes.icosphere_scene(4)
    r = CulledRenderer(scene, W, H, device=device, block_size=32,
                       ray_tile=128, tile_w=16)
    far = scene.camera.move(4.0, backward=True)
    r.render(far, block=True)
    r.freeze(far, margin=1.0)
    calls = []          # (pose, verify, buckets at the call, camera)
    k = [0]

    def render(scene_arrays, cam):
        verify = k[0] % 2 == 0
        k[0] += 1
        calls.append((float(np.asarray(cam.pos).ravel()[2]), verify,
                      r.buckets(), cam))
        return r.render_fast(cam, verify=verify)

    shown = {}
    cfg = dataclasses.replace(DEFAULT_CONFIG, move_step=0.5)
    before = dict(frozen_graph.COUNTS)
    try:
        _, _, dropped = run_loop(
            None, far, render, W, H, events=forward_events(10), cfg=cfg,
            display=lambda idx, img: shown.__setitem__(idx, img.copy()))
        counts = counts_since(before)
        poses = list(dict.fromkeys(c[0] for c in calls))   # frame order
        assert sorted(shown) == list(range(len(poses))) and dropped == 0
        assert counts["verify_reissued"] == len(calls) - len(poses) > 0
        # Settled: every verify call but those abandoned behind an
        # overflow.
        assert 0 < counts["verify_deferred"] <= sum(c[1] for c in calls)
        first = {}
        for pose, verify, pads, cam in calls:
            if pose in first:           # issued again: with grown buckets
                old = first[pose]
                assert pads != old and all(map(int.__ge__, pads, old))
            first.setdefault(pose, pads)
        verified = {c[0]: c[3] for c in calls if c[1]}
        for idx, pose in enumerate(poses):
            if pose in verified:
                want = r.render(verified[pose], block=True).cpu().numpy()
                assert np.array_equal(shown[idx], want), idx
    finally:
        r.release_graphs()


@pytest.mark.parametrize("loop", LOOPS)
def test_each_verify_site_defers_under_an_open_deferral(loop):
    from tests.test_torch_verify_loops import Frames, drive

    frames = Frames(over=1)
    with frozen_graph.deferred() as checks:
        drive(loop, scenes.icosphere_scene(1), frames)
    assert frames.calls == 1 and len(checks) == 1    # no refreeze yet
    before = dict(frozen_graph.COUNTS)
    assert frozen_graph.settle(checks) is False     # the buckets grew
    assert frames.calls == 2                          # one round
    assert counts_since(before)["verify_deferred"] == 1


def test_outside_the_loop_verify_refreezes_before_it_returns():
    scene = scenes.icosphere_scene(4)
    far = scene.camera.move(4.0, backward=True)
    near = scene.camera.move(1.0, backward=True)
    before = dict(frozen_graph.COUNTS)
    r = CulledRenderer(scene, W, H, device="cpu", block_size=32,
                       ray_tile=128, tile_w=16)
    r.render(far, block=True)
    r.freeze(far, margin=1.0)
    pads = r.buckets()
    img = r.render_fast(near, verify=True)
    assert r.buckets() != pads
    assert torch.equal(img, r.render(near, block=True))
    br = render_sharded_bvh.make_sharded_culled_renderer(
        scene, W, H, mesh=["cpu"] * 2, sizing_camera=far, margin=1.0,
        prebaked=scene.bake_bvh(block_size=32))
    pads = br.buckets()
    br(near, verify=True)
    assert br.buckets() != pads and br._buckets.fits(
        br._buckets.worst(br.last_counts))
    assert counts_since(before)["verify_deferred"] == 0


@pytest.mark.parametrize("loop", ["bands", "ring", "halo"])
def test_a_multi_process_mesh_checks_at_once(loop):
    """Every process must refreeze at the same point of its stream, so a
    mesh over several processes runs the check before the call returns
    even under a deferral (the mesh's process count is set by hand on a
    one-process mesh; the frames are stand-ins)."""
    from tests.test_torch_verify_loops import Frames

    scene = scenes.icosphere_scene(1)
    frames = Frames(over=1)
    if loop == "bands":
        r = render_sharded_bvh.make_sharded_culled_renderer(
            scene, 32, 24, mesh=["cpu"] * 2)
        r.device_fn = lambda c: (torch.zeros(24, 32, 3), frames.counts(
            torch.tensor(r.buckets())[None].expand(2, -1)))
        call = lambda: r(scene.camera, verify=True)
    else:
        cls = (ring_bvh.RingCulledRenderer if loop == "ring"
               else halo_bvh.HaloCulledRenderer)
        r = cls(scene, 32, 24, mesh=["cpu"] * 2)
        extra = [0, 0] if loop == "ring" else []

        def dispatch(camera, diff=None):
            pads = torch.tensor([list(p + q) + extra for p, q in
                                 zip(r.w_pads, r.w_pads_sh)])
            if loop == "halo":
                pads = pads[0]
            return torch.zeros(3, r.n_pad_ext), frames.counts(
                pads[None].expand(2, *pads.shape))
        r.device_fn = dispatch
        call = lambda: r.render(scene.camera, verify=True)
    r.ranks.n_procs = 2
    with frozen_graph.deferred() as checks:
        call()
    assert checks == [] and frames.calls == 2
