"""The metric readers and the traffic generator on synthetic inputs."""

import math

import numpy as np
import pytest

from rtbench import devtrace, roofline, spec
from rtbench.run import Records
from rtbench.scenes import SceneSpec
from rtbench.traffic import Events, Traffic


def rec(**kw):
    base = dict(setup_s=1.0, window_s=2.0, shown=4,
                latencies_s=[], enqueue_s=[], intervals=None, profile=None,
                pairs=None)
    base.update(kw)
    return Records(**base)


def read(name, r):
    return spec.load_module("metrics", name).read(r)


def test_p95_is_over_every_frame():
    lat = [0.01] * 95 + [0.5] * 5     # a stall in 5 frames of 100
    got = read("latency_p95_ms", rec(latencies_s=lat, shown=100))
    assert got == pytest.approx(np.percentile(np.array(lat) * 1e3, 95))
    assert got > 10.0                  # the stall shows
    assert read("frame_ms", rec(window_s=2.0, shown=100)) == 20.0


def test_idle_share_is_the_union_of_the_intervals():
    # Two cards over a 100 ms window: card 0's frames overlap (union 60 ms),
    # card 1's run past the window's end (clipped: 30 ms).
    card0 = (100.0, [(0.0, 40.0), (30.0, 60.0)])
    card1 = (100.0, [(10.0, 20.0), (80.0, 120.0)])
    got = read("device_idle_share", rec(intervals=[card0, card1]))
    assert got == pytest.approx(((1 - 0.6) + (1 - 0.3)) / 2)
    # Skew: per-card mean frame length 35 and 25 ms -> 35 / 30.
    assert read("band_skew", rec(intervals=[card0, card1])) == (
        pytest.approx(35 / 30))
    assert read("band_skew", rec(intervals=[card0])) is None


def test_roofline_arithmetic():
    assert roofline.bound_s(67e12 / 21) == pytest.approx(1.0)
    prof = {"whole": True, "frames": 2,
            "cards": {"cuda:0": {"by_class_s": {"K1": 0.3, "K2": 0.2,
                                                "other": 0.1}}}}
    pairs = [67e12 / 21 * 0.05] * 2    # 0.1 s of pair math at the peak
    r = rec(profile=prof, pairs=pairs)
    assert read("traversal_roofline", r) == pytest.approx(20.0)
    assert read("traversal_ms", r) == pytest.approx(250.0)
    assert read("glue_ms", r) == pytest.approx(50.0)
    prof["whole"] = False              # a window that lost kernels
    assert read("traversal_roofline", r) is None
    assert read("glue_ms", r) is None


def test_kernel_classes_and_lost_replays():
    assert devtrace.kernel_class("void nearest_chunk_kernel<4, true>(") == "K1"
    assert devtrace.kernel_class("seed_keys<true>") == "K1"
    assert devtrace.kernel_class("any_chunk_kernel<4, true>") == "K2"
    assert devtrace.kernel_class("elementwise_kernel") == "other"

    class Card:
        index = 0

    def ev(cat, name, ts, corr, dur=1.0):
        return {"cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"device": 0, "correlation": corr}}

    events = []
    for f in range(2):
        events.append(ev("cuda_runtime", "cudaGraphLaunch", 10 * f, f))
        events += [ev("kernel", "nearest_chunk_kernel<4, true>", 10 * f + 1,
                      f), ev("kernel", "any_chunk_kernel<4, true>",
                             10 * f + 2, f), ev("kernel", "glue", 10 * f + 3,
                                                f)]
    got = devtrace.read(events, [Card()], frames=2, replays=2)
    assert got["whole"]
    assert got["cards"]["cuda:0"]["by_class_s"]["other"] == pytest.approx(
        2e-6)
    lost = [e for e in events if not (e["ts"] == 12)]   # replay 1 lost K2
    assert not devtrace.read(lost, [Card()], frames=2, replays=2)["whole"]


def scene(d):
    return SceneSpec(meshes={}, instances=[], light_pos=np.zeros((1, 3)),
                     light_col=np.ones((1, 3)), cam_pos=np.array([0, 0, d]),
                     cam_dir=np.array([0.0, 0.0, -1.0]), fov=1.04719755)


def test_orbit_pass_closes_and_keeps_its_distance():
    t = Traffic(spec._json("traffic", "orbit"), scene(3.0), 640)
    assert t.ticks_per_pass == 188 and len(t.cycle) == 188
    end, start = t.poses[-1], t.poses[0]
    assert np.allclose(end.pos, start.pos, atol=1e-9)
    assert np.allclose(end.forward, start.forward, atol=1e-9)
    radii = [np.linalg.norm(p.pos) for p in t.poses]
    assert max(radii) - min(radii) < 0.12     # about a point 0.05 off centre
    # The camera keeps the centre near the middle of its view.
    for p in t.poses:
        to_centre = -p.pos / np.linalg.norm(p.pos)
        assert float(to_centre @ p.forward) > math.cos(0.05)


def test_arc_goes_back_over_its_poses():
    t = Traffic(spec._json("traffic", "arc"), scene(31.8), 3840)
    p = t.ticks_per_pass
    assert p == 200 and len(t.cycle) == 2 * p + 2
    assert np.allclose(t.poses[-1].pos, t.poses[0].pos, atol=1e-9)
    assert np.allclose(t.poses[-1].forward, t.poses[0].forward, atol=1e-9)
    # Back, the camera stands where it stood forth.
    for k in range(p + 1):
        assert np.allclose(t.poses[p + 1 + k].pos, t.poses[p - k].pos,
                           atol=1e-9)


def test_seed_moves_the_start_not_the_poses():
    t = Traffic(spec._json("traffic", "arc"), scene(31.8), 3840)
    starts = {t.offset(s) for s in (1, 2, 3, 2**31 + 7, 2**40)}
    assert len(starts) > 1 and all(0 <= s < len(t.cycle) for s in starts)
    assert t.offset(2**31 + 7) == t.offset(2**31 + 7)
    # A run from any start frames only poses of the cycle.
    cycle = {tuple(np.round(p.pos, 6)) for p in t.settle_poses()}
    start = t.offset(2**31 + 7)
    seen = {tuple(np.round(p.pos, 6)) for p in t.frame_poses(start, 500)}
    assert seen <= cycle


def test_events_hold_keys_and_stop():
    t = Traffic(spec._json("traffic", "arc"), scene(31.8), 3840)
    ev = Events(t, start=198, ticks=6)
    ticks = list(ev)
    assert len(ticks) == 6 and len(ev.stamps) == 6
    assert ticks[0][0] == ("key_down", "a")
    assert ("key_up", "a") in ticks[2]          # the turn at the arc's end
    assert ("key_down", "d") in ticks[3]
    assert all(e[-1][0] == "mouse" for e in ticks)
    timed = Events(t, start=0, seconds=0.05)
    n = sum(1 for _ in timed)
    assert n > 0 and timed.stamps[-1] - timed.stamps[0] < 0.05
