"""Frames with Whitted reflection bounces: the plain reference's bounces
(its depth-0 frame bit for bit the frame of the reference before they
came), the program's bounced frame held to them and to the port's float64
oracle, a missing bounce and the TF32 control failing the comparison, a
whole bounced run on the CPU, the bounced layout's pair counts, and the
bounce readers."""

import json
import math
import os

import numpy as np
import pytest
import torch

from rtbench import devtrace, judge, port, reference, roofline, scenes, spec
from rtbench import run as rtrun
from rtbench.traffic import Traffic

CACHE = os.path.join(spec.HERE, ".cache")
W, H = 64, 48
LIMITS = spec._json("configs", "grid12-4k")["check"]["limits"]
# Two rows of two spheres 0.2 apart, so each reflects its neighbours over
# tens of pixels at 64x48.
NEAR = {"generator": "instanced_grid", "n": 2, "spacing": 2.2,
        "base": {"generator": "icosphere", "subdivisions": 2}}
# Close views, looking down -z, of the gap between the lower two spheres
# and of the middle of the four.
CLOSE = [((0.0, -1.1, 2.5), (0.0, 0.0, -1.0)),
         ((0.0, 0.0, 3.0), (0.0, 0.0, -1.0))]
FOV = 1.04719755
# The program's CPU path runs its kernels' plain versions over whole ray
# tiles and blocks: smaller ones are quicker here.
RENDERER = {"ray_tile": 128, "block_size": 32}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the reference's render, nearest and occluded as they stood before
# bounces came (rtbench/reference.py), frozen here so that depth 0 is held
# to them bit for bit.

def nearest0(ar: reference.Arith, acc: reference.Accel, o, d,
             chunk: int = None):
    """Nearest hit of each ray: (t (inf on a miss), triangle (-1), r1, r2,
    r3); ties go to the lower triangle index."""
    r = o.shape[0]
    dev = o.device
    chunk = chunk or reference.CHUNK
    t_best = torch.full((r,), math.inf, dtype=ar.dtype, device=dev)
    tri_best = torch.full((r,), reference._NO_TRI, dtype=torch.int64,
                          device=dev)
    o64 = o.to(torch.float64)
    d64 = d.to(torch.float64)
    far = torch.full((r,), math.inf, dtype=torch.float64, device=dev)
    for a in range(0, r, chunk):
        b = min(r, a + chunk)
        ray, tri = reference._pairs(acc, o64[a:b], d64[a:b], far[a:b])
        ray = ray + a
        valid, t, _, _, _ = reference._intersect(ar, acc.soup, o[ray],
                                                 d[ray], tri)
        ray, tri, t = ray[valid], tri[valid], t[valid]
        t_best.scatter_reduce_(0, ray, t, "amin")
        best = t == t_best[ray]
        tri_best.scatter_reduce_(0, ray[best], tri[best], "amin")
    hit = tri_best != reference._NO_TRI
    tri = torch.where(hit, tri_best, 0)
    _, t, r1, r2, r3 = reference._intersect(ar, acc.soup, o, d, tri)
    return (torch.where(hit, t, math.inf), torch.where(hit, tri_best, -1),
            r1, r2, r3)


def occluded0(ar: reference.Arith, acc: reference.Accel, o, d, tmax,
              chunk: int = None):
    """Whether each ray meets a triangle at 0 <= t <= tmax."""
    r = o.shape[0]
    chunk = chunk or reference.CHUNK
    out = torch.zeros(r, dtype=torch.bool, device=o.device)
    o64, d64 = o.to(torch.float64), d.to(torch.float64)
    tmax64 = tmax.to(torch.float64)
    for a in range(0, r, chunk):
        b = min(r, a + chunk)
        ray, tri = reference._pairs(acc, o64[a:b], d64[a:b], tmax64[a:b])
        ray = ray + a
        valid, t, _, _, _ = reference._intersect(ar, acc.soup, o[ray],
                                                 d[ray], tri)
        out[ray[valid & (t <= tmax[ray])]] = True
    return out


def render0(acc: reference.Accel, pose: reference.Pose, width: int,
            height: int, ys, xs, ar: reference.Arith = reference.Arith()):
    """The pixels (ys, xs) of the frame at `pose`: (rgb uint8 (N, 3),
    decision code (N,) int64: which object was hit (0 = none) and which
    lights light it, where their light could change the pixel)."""
    s = acc.soup
    dev = s.p1.device
    vec = lambda a: torch.as_tensor(np.asarray(a), dtype=ar.dtype,
                                    device=dev)
    half_w, half_h = width // 2, height // 2
    phw = math.tan(pose.fov / 2.0)
    phh = phw * height / width
    i = xs.to(ar.dtype)
    j = ys.to(ar.dtype)
    a = ar.mul(phw, (half_w - i) - 0.5) / half_w
    b = ar.mul(phh, (half_h - j) - 0.5) / half_h
    d = ar.unit(vec(pose.forward)[None, :] + ar.mul(a[:, None],
                                                    vec(pose.left)[None, :])
                + ar.mul(b[:, None], vec(pose.up)[None, :]))
    cam = vec(pose.pos)
    o = cam.expand_as(d)
    t, tri, r1, r2, r3 = nearest0(ar, acc, o, d)
    hit = tri >= 0
    idx = torch.nonzero(hit).squeeze(1)
    ti = tri[idx]
    x = o[idx] + ar.mul(t[idx, None], d[idx])
    nv = s.n[ti].to(ar.dtype)
    n = ar.unit(ar.mul(r1[idx, None], nv[:, 0]) + ar.mul(r2[idx, None],
                                                         nv[:, 1])
                + ar.mul(r3[idx, None], nv[:, 2]))
    mat = s.mat[ti]
    ka, kd, ks = (s.ka[mat].to(ar.dtype), s.kd[mat].to(ar.dtype),
                  s.ks[mat].to(ar.dtype))
    ns = s.ns[mat].to(ar.dtype)
    view = ar.unit(cam[None, :] - x)
    colour = ka
    code = s.obj[ti] + 1
    for li in range(s.light_pos.shape[0]):
        to_light = s.light_pos[li].to(ar.dtype)[None, :] - x
        ldist = torch.sqrt(ar.dot(to_light, to_light))
        ldir = to_light / ldist[:, None]
        ldn = ar.dot(ldir, n)
        refl = ar.mul(ar.mul(2.0, ldn)[:, None], n) - ldir
        spec = torch.pow(torch.clamp_min(ar.dot(refl, view), 0.0), ns)
        contrib = ar.mul(ar.mul(kd, torch.clamp_min(ldn, 0.0)[:, None])
                         + ar.mul(ks, spec[:, None]),
                         s.light_col[li].to(ar.dtype)[None, :])
        matters = contrib.amax(1) > 0.0
        lit = matters.clone()
        q = torch.nonzero(matters).squeeze(1)
        origin = x[q] + ar.mul(reference.SHADOW_OFFSET, ldir[q])
        lit[q] = ~occluded0(ar, acc, origin, ldir[q],
                            ldist[q] - reference.SHADOW_OFFSET)
        colour = colour + torch.where(lit[:, None], contrib, 0.0)
        code = code * 2 + lit.to(torch.int64)
    rgb = torch.zeros((d.shape[0], 3), dtype=ar.dtype, device=dev)
    rgb[idx] = torch.clamp(colour, 0.0, 1.0)
    full_code = torch.zeros(d.shape[0], dtype=torch.int64, device=dev)
    full_code[idx] = code
    return (ar.mul(255.0, rgb)).to(torch.uint8), full_code


# -- the tests ----------------------------------------------------------------

def pixels():
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    return ys.reshape(-1), xs.reshape(-1)


def near():
    sc = scenes.make(NEAR, CACHE)
    return sc, reference.build(reference.soup(sc, "cpu"))


def close_poses():
    return [reference.Pose.create(np.array(p), np.array(d), FOV)
            for p, d in CLOSE]


def program_frame(r, pose, depth: int):
    """The program's bounced frame on the CPU (eager stages), uint8."""
    from distributed_raytracer_tpu_torch.runtime import framebuffer

    return framebuffer.to_u8_device(r.render_bounced(port.camera(pose),
                                                     depth))


def renderer(sc):
    from distributed_raytracer_tpu_torch.ops.render_bvh import (
        CulledRenderer)

    return CulledRenderer(port.scene(sc), W, H, device="cpu", **RENDERER)


def within(numbers) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


@pytest.mark.parametrize("precision", ["float64", "tf32"])
@pytest.mark.parametrize("scene", ["ico4", "grid3"])
def test_depth_0_is_the_reference_before_bounces_bit_for_bit(scene,
                                                              precision):
    """The scenes and poses of test_rtbench_reference.py, in float64 and
    in the control: rgb and decision code equal bit for bit."""
    sc = scenes.make(
        {"generator": "icosphere", "subdivisions": 4} if scene == "ico4"
        else {"generator": "instanced_grid", "n": 3,
              "base": {"generator": "icosphere", "subdivisions": 2}}, CACHE)
    acc = reference.build(reference.soup(sc, "cpu"))
    t = Traffic(spec._json("traffic", "orbit"), sc, W)
    ar = reference.Arith(precision)
    ys, xs = pixels()
    for k in (0, 5, len(t.cycle) // 3):
        pose = t.poses[k + 1]
        want = render0(acc, pose, W, H, ys, xs, ar)
        for got in (reference.render(acc, pose, W, H, ys, xs, ar),
                    reference.render(acc, pose, W, H, ys, xs, ar, 0)):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        assert int((want[1] > 0).sum()) > 100       # the scene is in view
    frame = judge.reference_frame(acc, t.poses[1], W, H, ar)
    assert torch.equal(frame[0].reshape(-1, 3),
                       render0(acc, t.poses[1], W, H, ys, xs, ar)[0])


def test_the_program_bounced_frame_holds_to_the_reference_and_the_oracle():
    from distributed_raytracer_tpu_torch.utils import oracle

    sc, acc = near()
    r = renderer(sc)
    arc = Traffic(spec._json("traffic", "arc"), sc, W)
    for pose in [arc.poses[1]] + close_poses():
        want, code = judge.reference_frame(acc, pose, W, H, bounces=2)
        got = program_frame(r, pose, 2)
        assert within(judge.compare(got, want, code)), judge.compare(
            got, want, code)
        img = oracle.render_oracle_bounced(port.scene(sc), W, H, 2,
                                           camera=port.camera(pose))
        by_oracle = torch.as_tensor((np.clip(img, 0.0, 1.0) * 255.0)
                                    .astype(np.uint8))
        assert within(judge.compare(got, by_oracle, code)), (
            judge.compare(got, by_oracle, code))


def test_a_missing_bounce_and_the_control_fail():
    """Against the depth-2 reference: the program's depth-0 frame fails
    bad_share, its depth-1 frame fails a number, and the reference in TF32
    at depth 2 fails both."""
    sc, acc = near()
    r = renderer(sc)
    d1_numbers = []
    for pose in close_poses():
        want, code = judge.reference_frame(acc, pose, W, H, bounces=2)
        flat = judge.compare(program_frame(r, pose, 0), want, code)
        assert flat["bad_share"] > LIMITS["bad_share"], flat
        d1_numbers.append(judge.compare(program_frame(r, pose, 1), want,
                                        code))
        control, _ = judge.reference_frame(acc, pose, W, H,
                                           reference.Arith("tf32"), 2)
        ctl = judge.compare(control, want, code)
        assert all(ctl[k] > LIMITS[k] for k in LIMITS), ctl
    assert not all(within(n) for n in d1_numbers), d1_numbers


def test_bounces_reach_the_control_and_only_the_reference_reads_them():
    """run.numbers' control is drawn at the configuration's depth: the
    reference in float64 in the program's place reads 0; judge.bounces
    takes a whole number >= 0, 0 where the key is absent."""
    sc, _ = near()
    cfg = {"width": W, "height": H, "bounces": 2,
           "check": {"frames": 2, "limits": LIMITS}}
    t = Traffic(spec._json("traffic", "arc"), sc, W)
    cell = spec.Cell("c", 1, "c", cfg, spec._json("traffic", "arc"), [], [])
    b = rtrun.Bench(cell, sc, None, t)
    ref = judge.Reference(sc, "cpu", judge.bounces(cfg))
    got = rtrun.numbers(b, ref, 3, {0: None, 4: None}, reference.Arith())
    assert got == {"bad_share": 0.0, "mean_abs": 0.0, "frames": 2}
    assert judge.bounces({}) == 0 and judge.bounces({"bounces": 3}) == 3
    for bad in (-1, 1.5, True, "2"):
        with pytest.raises(ValueError):
            judge.bounces({"bounces": bad})


# 18 ticks a cycle at NEAR's distance.
SHORT = dict(spec._json("traffic", "arc"), share_of_revolution=0.02,
             verify_period=2)


def flat(render):
    """The frame without its reflections: the program's depth-0 frame."""
    r = render.__self__.r

    def f(cam, verify, state):
        return r.render_bounced(cam, 0)
    return f


def test_whole_bounced_runs(tmp_path):
    """A cell written as data (a bench dict and a configuration on the
    bounced layout with "bounces": 2): a sound run on the CPU is correct;
    one whose frames lack their reflections is not."""
    for folder in ("configs", "traffic"):
        os.makedirs(tmp_path / folder)
    (tmp_path / "traffic" / "arc.short.json").write_text(json.dumps(SHORT))
    scene = dict(NEAR, base={"generator": "icosphere", "subdivisions": 1})
    cfg = {"scene": scene, "width": W, "height": H,
           "layout": {"1": "bounced"}, "renderer": RENDERER, "bounces": 2,
           "check": {"frames": 3, "limits": LIMITS}}
    (tmp_path / "configs" / "near-bounce2.json").write_text(json.dumps(cfg))
    bench = dict(spec.load_benchmark(), workloads=[
        {"name": "near.bounce2", "config": "near-bounce2",
         "traffic": "arc.short", "chips": 1, "why": "x"}])
    cell = spec.cell("near.bounce2", bench, here=str(tmp_path))
    sound = rtrun.run(cell, 2**31 + 13, 3.0, False, device="cpu")
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] >= 2
    assert set(sound["metrics"]) == {"frame_ms", "latency_p95_ms",
                                     "setup_s"}
    assert rtrun.banned_modules() == []
    faulty = rtrun.run(cell, 2**31 + 14, 3.0, False, device="cpu",
                       wrap=flat)
    assert not faulty["correct"], faulty["checks"]


def test_the_bounced_layout_counts_every_bounce(monkeypatch):
    """pairs and ray_pairs of one camera list render each camera once;
    bounce 0's nearest cells are the primary cells of the program's
    render() at that camera; a scene state is refused."""
    sc, _ = near()
    cfg = {"width": W, "height": H, "renderer": RENDERER, "bounces": 2}
    lay = spec.load_module("layouts", "bounced").build(port.scene(sc), cfg,
                                                       "cpu", 1)
    assert lay.TRAVERSAL == ("K3n", "K2")
    r = lay.r
    t = Traffic(SHORT, sc, W)
    cams = [port.camera(p) for p in t.poses[1:4]]
    calls = []
    real = r.render_bounced
    monkeypatch.setattr(r, "render_bounced", lambda cam, depth: (
        calls.append(depth), real(cam, depth))[1])
    shared, rays = lay.pairs(cams), lay.ray_pairs(cams, [None] * 3)
    assert calls == [2] * 3
    nl, unit = r.n_levels, r.rt * r.tb
    for cam, p, q in zip(cams, shared, rays):
        real(cam, 2)
        rows = r._last_bounce_counts
        assert len(rows) == 3 and p > 0 and q > 0
        assert p == sum(row[-1] for row in rows) * unit
        assert q == sum(row[nl - 1] for row in rows) * unit
        r.render(cam)
        assert rows[0][nl - 1] == r._last_counts[nl - 1]
    moved = reference.State(np.zeros((4, 3)), np.zeros((3, 3)))
    with pytest.raises(ValueError, match="does not move"):
        lay.render(cams[0], True, moved)
    with pytest.raises(ValueError, match="does not move"):
        lay.pairs(cams[:1], [moved])


class Card:
    index = 0


def ev(cat, name, ts, corr, dur=1.0):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"device": 0, "correlation": corr}}


def test_a_bounced_window_is_whole_by_its_own_kernels():
    """Every replay runs K3n and K2 and no K1: whole by the bounced
    layout's TRAVERSAL, not by the main path's; a replay that lost its K3n
    is not whole."""
    assert devtrace.kernel_class("nearest_chunk_kernel<4, false>") == "K3n"
    assert devtrace.kernel_class("seed_keys<false>") == "K3n"
    events = []
    for f in range(2):
        events.append(ev("cuda_runtime", "cudaGraphLaunch", 10 * f, f))
        events += [ev("kernel", "nearest_chunk_kernel<4, false>",
                      10 * f + 1, f),
                   ev("kernel", "any_chunk_kernel<4, true>", 10 * f + 2, f)]
    bounced = ("K3n", "K2")
    got = devtrace.read(events, [Card()], 2, 2, traversal=bounced)
    assert got["whole"]
    assert got["cards"]["cuda:0"]["by_class_s"]["K3n"] == pytest.approx(
        2e-6)
    assert not devtrace.read(events, [Card()], 2, 2)["whole"]
    lost = [e for e in events if e["ts"] != 11]
    assert not devtrace.read(lost, [Card()], 2, 2, traversal=bounced)[
        "whole"]


def rec(**kw):
    base = dict(setup_s=1.0, window_s=2.0, shown=4, latencies_s=[],
                enqueue_s=[], intervals=None, profile=None, pairs=None)
    base.update(kw)
    return rtrun.Records(**base)


def read(name, r):
    return spec.load_module("metrics", name).read(r)


def test_bounce_readers():
    from distributed_raytracer_tpu_torch.utils import profiling

    assert roofline.OPS_PER_PAIR_RAY == profiling.OPS_PER_PAIR[False] == 39
    assert roofline.PEAK_FP32 == profiling.PEAK_FP32
    assert roofline.bound_ray_s(67e12 / 39) == pytest.approx(1.0)
    prof = {"whole": True, "frames": 2,
            "cards": {"cuda:0": {"by_class_s": {"K3n": 0.4, "K2": 0.2,
                                                "other": 0.1}}}}
    rays = [67e12 / 39 * 0.05] * 2     # 0.1 s of pair math at the peak
    r = rec(profile=prof, pairs=[1, 1], ray_pairs=rays)
    assert read("bounce_roofline", r) == pytest.approx(25.0)
    assert read("bounce_ms", r) == pytest.approx(200.0)
    assert rec().ray_pairs is None
    assert read("bounce_roofline", rec(profile=prof, pairs=[1, 1])) is None
    assert read("bounce_roofline", rec(profile=prof, ray_pairs=[])) is None
    main_path = {"whole": True, "frames": 2,
                 "cards": {"cuda:0": {"by_class_s": {"K1": 0.3, "K2": 0.2}}}}
    assert read("bounce_ms", rec(profile=main_path)) is None
    assert read("bounce_roofline", rec(profile=main_path,
                                       ray_pairs=rays)) is None
    assert read("bounce_ms", rec()) is None
    assert read("bounce_roofline", rec(ray_pairs=rays)) is None
    prof["whole"] = False              # a window that lost kernels
    assert read("bounce_ms", r) is None
    assert read("bounce_roofline", r) is None
