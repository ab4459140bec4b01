"""The program's tracer (utils/tracing.py) on the CPU, and its device stamps
on the card.

Off, the loop and the frozen frame keep no span, open no profiler range
and mark no stamp. On, a run_loop of ten frames gives, per frame,
`loop.tick` over `loop.issue`, `loop.drain`, `frozen.verify` (on verify
frames: the check, settled after the frame's drain and before its
display) and `loop.display`, all with the frame's id; each frame's five
stage stamps rise in order; the band schedule adds a `bands.replay` per
rank, `bands.gather` and a stamp after the gather; the graph counters count
as before, and the verify frames' checks count as deferred. A moving scene
(DynamicCulledRenderer through the loop's scene events) adds per frame a
`dynamic.diff` span and a "fold" stamp row of two marks, before the five
"stages" marks; `scene_diffs` counts its frames, on or off; the benchmark's
`fold_ms` reader and tools/xprof.py read the fold from the recording.
Under a profiler window the spans are `user_annotation` events, and the
trace parser names an idle gap by the span under it. The command
line writes the recording as a chrome trace. On the card (`cuda` marker):
the stamps of replayed graphs lie inside each replay's CUDA-event interval
and, on the host's clock, after the replay was issued and before the
frame's drain ended. Nothing here imports JAX, so on a machine with a card
and no JAX the card's test runs with

    python -m pytest -o addopts="" --noconftest -m cuda \
        tests/test_torch_tracing.py
"""

import json
import time
import types

import pytest
import torch

from distributed_raytracer_tpu_torch import run as cli
from distributed_raytracer_tpu_torch.ops import frozen_graph
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.ops.render_dynamic import (
    DynamicCulledRenderer)
from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
from distributed_raytracer_tpu_torch.parallel import render_sharded_bvh
from distributed_raytracer_tpu_torch.runtime import animation
from distributed_raytracer_tpu_torch.runtime.loop import run_loop
from distributed_raytracer_tpu_torch.tools import xprof
from distributed_raytracer_tpu_torch.utils import profiling, scenes, tracing

W, H = 32, 24
FRAMES = 10
PERIOD = 4


@pytest.fixture
def tracer():
    """The tracer on for one test (a new recording), off after it."""
    tracing.enable()
    yield tracing
    tracing.disable()


@pytest.fixture(scope="module")
def renderer():
    scene = scenes.icosphere_scene(2)
    r = CulledRenderer(scene, W, H, device="cpu", block_size=32,
                       ray_tile=128, tile_w=16)
    r.render(scene.camera, block=True)
    r.freeze(scene.camera, margin=2.0)
    return scene, r


def orbit_events(n: int):
    """n ticks, each a mouse move (every tick makes a frame)."""
    return [[("mouse", 2.0, 0.0)] for _ in range(n)]


def periodic(r):
    k = [0]

    def render(scene_arrays, cam):
        verify = k[0] % PERIOD == 0
        k[0] += 1
        return r.render_fast(cam, verify=verify)
    return render


def loop(scene, r, display=None):
    """run_loop of FRAMES frames over r, verifying every PERIOD-th; returns
    the displayed frames by index."""
    shown = {}

    def show(idx, img):
        shown[idx] = img
        if display is not None:
            display(idx, img)
    run_loop(None, scene.camera, periodic(r), W, H,
             events=orbit_events(FRAMES), display=show)
    return shown


def by_id(spans):
    return {s["id"]: s for s in spans}


@pytest.fixture
def dynamic():
    """A dynamic renderer of four spheres, frozen with room to spare."""
    scene = scenes.instanced_grid(scenes.icosphere_scene(1), 2)
    r = DynamicCulledRenderer(scene, W, H, device="cpu", block_size=32,
                              ray_tile=128, tile_w=16)
    r.render(scene.camera, block=True)
    r.freeze(scene.camera, margin=2.0)
    return scene, r


def moving_loop(scene, r):
    """run_loop of FRAMES frames of r, each tick a mouse move and the next
    scene diff (object 0 orbiting), verifying every PERIOD-th frame."""
    diffs = animation.orbit_object_diffs(scene, FRAMES, radius=0.5)
    k = [0]

    def render(state, cam):
        verify = k[0] % PERIOD == 0
        k[0] += 1
        return r.render_dynamic(cam, state, verify=verify)
    run_loop(None, scene.camera, render, W, H,
             events=[[("mouse", 2.0, 0.0), ("scene", d)] for d in diffs])


def test_off_keeps_no_span_and_opens_no_profiler_range(renderer,
                                                       monkeypatch):
    """Tracer off and no profiler: every span is the one shared no-op
    context, nothing is recorded and no stamp is made."""
    tracing.enable()
    tracing.disable()

    def refuse(*a, **k):
        raise AssertionError("a span or profiler range was made")

    monkeypatch.setattr(tracing, "_Span", refuse)
    monkeypatch.setattr(tracing, "_ProfiledSpan", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    scene, r = renderer
    before = dict(frozen_graph.COUNTS)
    shown = loop(scene, r)
    assert sorted(shown) == list(range(FRAMES))
    assert tracing.span("loop.tick") is tracing.span("frozen.verify")
    rec = tracing.export()
    assert rec["spans"] == [] and rec["stamps"] == []
    assert r._stamps is None
    # Nothing captured and no kernel launched on the CPU; the three verify
    # frames' checks settled at their drains.
    assert frozen_graph.COUNTS == dict(
        before, verify_deferred=before["verify_deferred"] + 3)


def test_on_spans_nest_per_frame_with_one_frame_id(renderer, tracer):
    scene, r = renderer
    before = dict(frozen_graph.COUNTS)
    tracer.set_frame(99)                     # a frame id left from before
    loop(scene, r)
    tracer.disable()
    rec = tracer.export()
    spans = rec["spans"]
    ids = by_id(spans)
    (run,) = [s for s in spans if s["name"] == "loop.run"]
    assert run["frame"] is None
    for f in range(FRAMES):
        mine = {}
        for s in spans:
            if s["frame"] == f:
                mine.setdefault(s["name"], []).append(s)
        (tick,) = mine["loop.tick"]
        (issue,) = mine["loop.issue"]
        (drain,) = mine["loop.drain"]
        (show,) = mine["loop.display"]
        assert tick["parent"] == run["id"] and issue["parent"] == tick["id"]
        assert tick["start_ns"] <= issue["start_ns"] <= issue["end_ns"] \
            <= tick["end_ns"]
        assert drain["end_ns"] <= show["start_ns"]
        verifies = mine.get("frozen.verify", [])
        if f % PERIOD == 0:
            (v,) = verifies
            assert v["parent"] == drain["parent"]
            assert drain["end_ns"] <= v["start_ns"] <= v["end_ns"] \
                <= show["start_ns"]
            assert v["attrs"] == {"kind": "render_fast", "card": None,
                                  "rounds": 0}
        else:
            assert verifies == []
        # A frame is drained by a later tick or by the loop's end.
        assert ids[drain["parent"]]["name"] in ("loop.tick", "loop.run")
    rows = rec["stamps"]
    assert [row["frame"] for row in rows] == list(range(FRAMES))
    for row in rows:
        assert row["kind"] == "stages" and row["card"] == "cpu"
        ns = row["ns"]
        assert len(ns) == 5 and ns == sorted(ns) and ns[0] < ns[-1]
        (issue,) = [s for s in spans if s["name"] == "loop.issue"
                    and s["frame"] == row["frame"]]
        assert issue["start_ns"] <= ns[0] and ns[-1] <= issue["end_ns"]
    assert frozen_graph.COUNTS == dict(
        before, verify_deferred=before["verify_deferred"] + 3)
    assert rec["counters"] is not frozen_graph.COUNTS
    assert rec["counters"] == frozen_graph.COUNTS


def test_off_a_moving_frame_records_nothing_and_counts_its_diff(
        dynamic, monkeypatch):
    tracing.enable()
    tracing.disable()

    def refuse(*a, **k):
        raise AssertionError("a span or profiler range was made")

    monkeypatch.setattr(tracing, "_Span", refuse)
    monkeypatch.setattr(tracing, "_ProfiledSpan", refuse)
    scene, r = dynamic
    before = dict(frozen_graph.COUNTS)
    moving_loop(scene, r)
    rec = tracing.export()
    assert rec["spans"] == [] and rec["stamps"] == []
    assert r._fold_stamps is None and r._stamps is None
    assert frozen_graph.COUNTS == dict(
        before, verify_deferred=before["verify_deferred"] + 3,
        scene_diffs=before["scene_diffs"] + FRAMES)


def test_on_a_moving_frame_stamps_its_fold_before_its_stages(
        dynamic, tracer, tmp_path, capsys):
    scene, r = dynamic
    before = dict(frozen_graph.COUNTS)
    moving_loop(scene, r)
    tracer.disable()
    rec = tracer.export()
    assert frozen_graph.COUNTS["scene_diffs"] - before["scene_diffs"] \
        == FRAMES
    folds = [row for row in rec["stamps"] if row["kind"] == "fold"]
    stages = {row["frame"]: row for row in rec["stamps"]
              if row["kind"] == "stages"}
    assert [row["frame"] for row in folds] == list(range(FRAMES))
    assert sorted(stages) == list(range(FRAMES))
    diffs = [s for s in rec["spans"] if s["name"] == "dynamic.diff"]
    assert [s["frame"] for s in diffs] == list(range(FRAMES))
    for row, span in zip(folds, diffs):
        ns, after = row["ns"], stages[row["frame"]]["ns"]
        assert row["card"] == "cpu" and len(ns) == 2 and ns[0] < ns[1]
        assert len(after) == 5 and after == sorted(after)
        assert span["end_ns"] <= ns[0] and ns[1] <= after[0]
    fold_ms = sum(row["ns"][1] - row["ns"][0] for row in folds) / FRAMES / 1e6
    from rtbench import spec as rtspec

    reader = rtspec.load_module("metrics", "fold_ms")
    assert reader.read(types.SimpleNamespace(trace=rec)) == fold_ms > 0
    static = dict(rec, stamps=list(stages.values()))
    assert reader.read(types.SimpleNamespace(trace=static)) is None
    assert reader.read(types.SimpleNamespace(trace=None)) is None
    # The chrome trace holds one fold per frame, and xprof reports it.
    path = tmp_path / "trace.json"
    tracer.write_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["args"]["frame"] for e in events
            if e.get("cat") == "fold"] == list(range(FRAMES))
    assert xprof.main([str(path)]) == 0
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines() if " fold " in ln]
    assert line.split()[0] == f"{fold_ms:.4f}" and f"{FRAMES} frames" in line
    assert sum(" stage " in ln for ln in out.splitlines()) == 4


def test_graph_key_and_counters_follow_the_tracer(renderer, tracer):
    """The graph key names whether the tracer is on (a graph with stamps is
    a graph of its own); COUNTS is the one counter registry, the kernel
    launch counts included."""
    _, r = renderer
    on = r._graph_key("fast", r.buckets())
    tracer.disable()
    assert r._graph_key("fast", r.buckets()) != on
    assert frozen_graph.COUNTS is tracing.COUNTS
    assert set(tracing.COUNTS) == {
        "captures", "replays", "verify_deferred", "verify_reissued",
        "scene_diffs", "bake_by_object", "bsr_nearest", "bsr_any",
        "bsr_nearest_rays",
        "bsr_any_rays", "bsr_nearest_mxu", "bsr_any_mxu", "ring_nearest",
        "ring_any", "shade_prep"}


def test_buckets_are_the_frozen_buckets():
    scene = scenes.icosphere_scene(1)
    r = CulledRenderer(scene, W, H, device="cpu")
    assert r.buckets() is None
    r.render(scene.camera)
    r.freeze()
    assert r.buckets() == r._buckets.pads == r._buckets.rule(
        r._last_counts, 1.4)
    assert len(r.buckets()) == 2 * r.n_levels + 1


def test_bands_span_each_rank_and_stamp_the_gather(tracer):
    scene = scenes.icosphere_scene(2)
    br = render_sharded_bvh.make_sharded_culled_renderer(
        scene, W, H, mesh=mesh_mod.make_mesh(2, "cpu"))
    tracer.set_frame(7)
    cams = animation.orbit_camera_path(scene.camera, 2, radius=3.0)
    br(cams[0], verify=True)
    tracer.set_frame(8)
    br(cams[1])
    tracer.disable()
    rec = tracer.export()
    names = [(s["name"], s["frame"], s["attrs"].get("rank"))
             for s in rec["spans"]]
    for f in (7, 8):
        assert [n for n in names if n[0] == "bands.replay" and n[1] == f] \
            == [("bands.replay", f, 0), ("bands.replay", f, 1)]
        assert ("bands.gather", f, None) in names
    (v,) = [s for s in rec["spans"] if s["name"] == "frozen.verify"]
    assert v["frame"] == 7 and v["attrs"]["kind"] == "bands"
    stages = [(row["frame"], row["rank"]) for row in rec["stamps"]
              if row["kind"] == "stages"]
    gathers = [row for row in rec["stamps"] if row["kind"] == "gather"]
    assert stages == [(7, 0), (7, 1), (8, 0), (8, 1)]
    assert [g["frame"] for g in gathers] == [7, 8]
    for g in gathers:
        (last,) = [row["ns"][-1] for row in rec["stamps"]
                   if row["kind"] == "stages" and row["rank"] == 1
                   and row["frame"] == g["frame"]]
        assert len(g["ns"]) == 1 and g["ns"][0] >= last


def test_profiler_window_holds_the_spans_and_names_a_gap(renderer):
    """Tracer off, a profiler window on: every span is a user_annotation
    event, and an idle gap of the card (two hand-placed kernel events
    around the slow display of frame 3) is named by the span under it."""
    scene, r = renderer

    def slow(idx, img):
        if idx == 3:
            time.sleep(0.03)

    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        loop(scene, r, display=slow)
    trace = [{"name": e.name, "cat": "user_annotation",
              "ts": e.time_range.start,
              "dur": e.time_range.end - e.time_range.start}
             for e in prof.events()
             if e.name.startswith(("loop.", "frozen."))]
    for name in ("loop.run", "loop.tick", "loop.issue", "loop.drain",
                 "loop.display", "frozen.verify"):
        assert name in {e["name"] for e in trace}, name
    (slowest,) = [e for e in trace if e["name"] == "loop.display"
                  and e["dur"] >= 29e3]
    a, b = slowest["ts"], slowest["ts"] + slowest["dur"]
    start = min(e["ts"] for e in trace)
    end = max(e["ts"] + e["dur"] for e in trace)
    # The card busy all through the window but for the slow display.
    trace += [{"name": "k0", "cat": "kernel", "ts": start, "dur": a - start},
              {"name": "k1", "cat": "kernel", "ts": b, "dur": end - b}]
    gap = profiling.anatomy(trace, 1, n_gaps=1)["gaps"][0]
    assert gap["host"] == "loop.display" and gap["ms"] >= 29.0
    assert gap["cat"] == "user_annotation"


def test_chrome_trace_holds_spans_stages_and_counters(renderer, tracer,
                                                      tmp_path):
    scene, r = renderer
    loop(scene, r)
    tracer.disable()
    path = tmp_path / "trace.json"
    tracer.write_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    stages = [e for e in events if e.get("cat") == "stage"]
    assert {e["name"] for e in spans} >= {"loop.run", "loop.tick",
                                          "loop.issue", "loop.drain",
                                          "loop.display", "frozen.verify"}
    assert len(stages) == 4 * FRAMES
    assert {e["name"] for e in stages} == {f"stage {s}"
                                           for s in tracing.STAGES}
    assert all(e["dur"] >= 0 for e in spans + stages)
    (counts,) = [e for e in events if e.get("ph") == "C"]
    assert counts["args"] == frozen_graph.COUNTS


def test_cli_trace_out_writes_the_recording(tmp_path, capsys):
    (tmp_path / "tetra.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
        "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    scene = tmp_path / "scene.json"
    scene.write_text(
        '{"objs": [{"model": "tetra.obj", "pos": {"x": 0, "y": 0, "z": 0}}],'
        '"lights": [{"pos": {"x": 3, "y": 4, "z": 5},'
        '"col": {"r": 255, "g": 255, "b": 255}}],'
        '"cam": {"pos": {"x": 1.5, "y": 1.2, "z": 3.0},'
        '"dir": {"x": -0.35, "y": -0.3, "z": -1.0}, "fov": 1.0472}}')
    path = tmp_path / "cli.trace.json"
    assert cli.main([str(scene), "32", "24", "--frames", "3",
                     "--fps-target", "0", "--device", "cpu",
                     "--trace-out", str(path)]) == 0
    assert not tracing.enabled()
    events = json.loads(path.read_text())["traceEvents"]
    stages = [e for e in events if e.get("cat") == "stage"]
    verifies = [e for e in events if e.get("name") == "frozen.verify"]
    # The warm-up frame (no frame id) and three frames, each with its four
    # stages; the warm-up verifies (every 8th frame does).
    frames = [e["args"]["frame"] for e in stages]
    assert frames == [None] * 4 + [0] * 4 + [1] * 4 + [2] * 4
    assert [e["args"]["frame"] for e in verifies] == [None]


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_renderer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    scene = scenes.icosphere_scene(4)
    r = CulledRenderer(scene, 256, 192, device="cuda")
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    yield scene, r
    r.release_graphs()
    tracing.disable()


@pytest.mark.cuda
def test_cuda_stamps_lie_in_the_replay_and_on_the_host_clock(cuda_renderer):
    """Replayed graphs: each replay's five stamps rise and span most of,
    and no more than, its CUDA-event interval; in a loop, each frame's
    stage A starts after its replay was issued and its stage C ends before
    its drain ended, on the host's clock, within 50 us."""
    scene, r = cuda_renderer
    cams = animation.orbit_camera_path(scene.camera, 6, radius=3.0)
    tracing.enable()
    r.render_fast(cams[0])                       # captures with stamps
    torch.cuda.synchronize()
    tracing.enable()                             # a new recording
    stream = torch.cuda.current_stream()
    intervals = []
    # The frames queue behind a long kernel, so each event interval holds
    # its frame's device work and no wait for the host.
    torch.cuda._sleep(200_000_000)
    for k, cam in enumerate(cams):
        tracing.set_frame(k)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record(stream)
        r.render_fast(cam)
        e1.record(stream)
        intervals.append((e0, e1))
    torch.cuda.synchronize()
    rows = tracing.export()["stamps"]
    assert [row["frame"] for row in rows] == list(range(len(cams)))
    for row, (e0, e1) in zip(rows, intervals):
        ns = row["ns"]
        assert row["issued_ns"] is not None
        assert ns == sorted(ns) and ns[0] < ns[-1]
        event_ms = e0.elapsed_time(e1)
        assert 0.5 * event_ms <= (ns[-1] - ns[0]) / 1e6 <= event_ms + 0.05

    tracing.enable()
    run_loop(None, scene.camera, lambda s, cam: r.render_fast(cam), 256,
             192, events=orbit_events(FRAMES))
    tracing.disable()
    rec = tracing.export()
    drains = {s["frame"]: s for s in rec["spans"]
              if s["name"] == "loop.drain"}
    rows = rec["stamps"]
    assert sorted(row["frame"] for row in rows) == list(range(FRAMES))
    slack = 50_000
    for row in rows:
        assert row["ns"][0] >= row["issued_ns"] - slack
        assert row["ns"][-1] <= drains[row["frame"]]["end_ns"] + slack


@pytest.mark.cuda
def test_cuda_dynamic_replays_stamp_the_fold_before_the_stages():
    """render_dynamic's graph captured with the tracer on: each replay
    fills one "fold" row and one "stages" row; the fold's two marks rise
    and end before stage A starts, and the counter counts the frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    scene = scenes.instanced_grid(scenes.icosphere_scene(2), 3)
    r = DynamicCulledRenderer(scene, 256, 192, device="cuda")
    try:
        r.render(scene.camera, block=True)
        r.freeze(scene.camera)
        diffs = animation.orbit_object_diffs(scene, 6, radius=0.5)
        tracing.enable()
        r.render_dynamic(scene.camera, diffs[0])     # captures with stamps
        torch.cuda.synchronize()
        tracing.enable()                             # a new recording
        before = frozen_graph.COUNTS["scene_diffs"]
        for k, d in enumerate(diffs):
            tracing.set_frame(k)
            r.render_dynamic(scene.camera, d)
        torch.cuda.synchronize()
        tracing.disable()
        rec = tracing.export()
        assert frozen_graph.COUNTS["scene_diffs"] - before == len(diffs)
        folds = [row for row in rec["stamps"] if row["kind"] == "fold"]
        stages = {row["frame"]: row["ns"] for row in rec["stamps"]
                  if row["kind"] == "stages"}
        assert [row["frame"] for row in folds] == list(range(len(diffs)))
        assert sorted(stages) == list(range(len(diffs)))
        for row in folds:
            ns = row["ns"]
            assert row["issued_ns"] is not None and ns[0] < ns[1]
            assert ns[1] <= stages[row["frame"]][0]
            assert len(stages[row["frame"]]) == 5
    finally:
        r.release_graphs()
        tracing.disable()
