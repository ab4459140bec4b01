"""Scenes that move: a traffic mix's "scene_motion" as data, each frame's
scene state handed to a moving layout and to the plain reference, and the
static cells reading what they read before motion came."""

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtbench import judge, reference, scenes, spec, window
from rtbench import run as rtrun
from rtbench.traffic import Traffic

MOTION = {"object_radius": 1.0, "object_revolutions": 1,
          "light_revolutions": 1}
# 12 ticks a cycle at the icosphere's distance: an object moves ~10 pixels
# a frame at 64x48, a light 30 degrees.
MIX = dict(spec._json("traffic", "arc"), share_of_revolution=0.025,
           verify_period=2, scene_motion=MOTION)
GRID = {"generator": "instanced_grid", "n": 2,
        "base": {"generator": "icosphere", "subdivisions": 1}}
ICO = {"generator": "icosphere", "subdivisions": 1}

# Of each accepted cell, before scene motion: the count and a digest of
# its traffic's poses, and a digest of the reference's soup of its scene
# (every icosphere capped at 3 subdivisions; the camera does not depend on
# them).
BEFORE = {
    "ico9.orbit": (189, "fe44c036475787515664ab86b1349842",
                   "8af42546482fb2698cc804b184b9b63f"),
    "grid12.arc": (403, "b24209e5d4a9688652533dd4f29a5f80",
                   "a2cb4e9bc4f52644c54322c1f4ca6505"),
    "grid12.bands4": (403, "b24209e5d4a9688652533dd4f29a5f80",
                      "a2cb4e9bc4f52644c54322c1f4ca6505"),
}
SOUP_FIELDS = ("p1", "e1", "e2", "n", "obj", "mat", "ka", "kd", "ks", "ns",
               "light_pos", "light_col")


def capped(scene: dict, cap: int = 3) -> dict:
    s = copy.deepcopy(scene)
    d = s
    while d is not None:
        if "subdivisions" in d:
            d["subdivisions"] = min(d["subdivisions"], cap)
        d = d.get("base")
    return s


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_static_cells_read_what_they_read_before(name, tmp_path):
    cell = spec.cell(name)
    sc = scenes.make(capped(cell.config["scene"]), str(tmp_path))
    t = Traffic(cell.traffic, sc, cell.config["width"])
    assert not t.moves and t.state(0) is None
    assert t.settle_states() == [None] * len(t.cycle)
    poses = hashlib.sha256()
    for p in t.poses:
        for a in (p.pos, p.forward, p.left, p.up):
            poses.update(np.ascontiguousarray(a, np.float64).tobytes())
        poses.update(repr(p.fov).encode())
    s = reference.soup(sc, "cpu", state=None)
    soup = hashlib.sha256()
    for f in SOUP_FIELDS:
        soup.update(getattr(s, f).numpy().tobytes())
    assert (len(t.poses), poses.hexdigest()[:32],
            soup.hexdigest()[:32]) == BEFORE[name]


def test_states_close_the_cycle_and_set_up_settles_each(monkeypatch):
    """state(n) is state(0) bit for bit; set-up renders every (pose,
    state) of the cycle with verify=True, in the cycle's order."""
    sc = scenes.make(GRID, "")
    t = Traffic(MIX, sc, 64)
    n = len(t.cycle)
    assert t.moves
    for a, b in zip(t.state(n), t.state(0)):
        assert np.array_equal(a, b)
    assert not np.array_equal(t.state(1).offsets, t.state(0).offsets)
    assert not np.array_equal(t.state(1).lights, t.state(0).lights)
    keys = {(s.offsets.tobytes(), s.lights.tobytes())
            for s in (t.state(c) for c in range(n))}
    assert len(keys) == n
    # Object j of k starts at 2 pi j / k on its circle.
    k = len(sc.instances)
    a = 2 * np.pi * np.arange(k) / k
    np.testing.assert_allclose(t.state(0).offsets[:, 0], np.cos(a) - 1.0)
    np.testing.assert_allclose(t.state(0).offsets[:, 2], np.sin(a))

    calls = []

    class Recorder:
        MOVES = True

        def __init__(self, *args):
            self.cards = [torch.device("cpu")]

        def render(self, cam, verify, state=None):
            calls.append((cam, verify, state))

    class Layouts:
        build = Recorder

    real = spec.load_module
    monkeypatch.setattr(spec, "load_module", lambda folder, name: (
        Layouts if folder == "layouts" else real(folder, name)))
    cfg = {"scene": GRID, "width": 64, "height": 48,
           "layout": {"1": "recorder"}}
    b = rtrun.setup(spec.Cell("m", 1, "m", cfg, MIX, [], []), "cpu", 0.0)
    assert [v for _, v, _ in calls] == [True] * n
    assert [s for _, _, s in calls] == b.traffic.settle_states()
    for c, (cam, _, state) in enumerate(calls, 1):
        assert state is b.traffic.state(c)
        assert np.array_equal(cam.pos, b.traffic.poses[c].pos)


class Reissuing:
    """A moving layout whose first verify frame's check finds its buckets
    outgrown, so that run_loop issues that frame, and those behind it,
    again with their own camera objects."""
    MOVES = True

    def __init__(self):
        self.cards = [torch.device("cpu")]
        self.width, self.height = 8, 6
        self.grown = False
        self.calls = []

    def render(self, cam, verify, state=None):
        from distributed_raytracer_tpu_torch.ops import frozen_graph

        self.calls.append((cam, state))
        img = torch.zeros((self.height, self.width, 3))
        if not verify:
            return img
        counts = torch.zeros(1)

        def grow(_):
            self.grown = True
        return frozen_graph.verify(frozen_graph.Check(
            img, counts, lambda _: self.grown, grow, lambda: (img, counts),
            "reissuing")).out


def test_each_call_gets_the_state_its_frame_is_judged_at():
    sc = scenes.make(ICO, "")
    t = Traffic(MIX, sc, 64)
    lay = Reissuing()
    start, ticks = 5, 9
    window.loop(lay, t, start, ticks=ticks,
                display=window.Display(ticks, np.random.default_rng(0)))
    # The k-th camera object seen is frame k's; a frame issued again
    # passes its own object back.
    frames, seen = [], []
    for cam, state in lay.calls:
        hit = [k for k, c in enumerate(seen) if c is cam]
        if not hit:
            seen.append(cam)
        frames.append((hit or [len(seen) - 1])[0])
    assert len(seen) == ticks and len(frames) > ticks   # one reissue at least
    assert frames[:2] == [0, 1] and sorted(set(frames)) == list(range(ticks))
    # Frame k's state is the one run.numbers judges frame k at.
    b = rtrun.Bench(spec.Cell("m", 1, "m", {}, MIX, [], []), sc, lay, t)
    judged = {k: b.traffic.frame_state(start, k) for k in range(ticks)}
    for (_, state), k in zip(lay.calls, frames):
        assert state is judged[k]


def test_a_moving_cell_is_data_alone_and_refused_on_a_static_layout(
        tmp_path):
    for folder in ("configs", "traffic"):
        shutil.copytree(os.path.join(spec.HERE, folder), tmp_path / folder)
    (tmp_path / "traffic" / "arc.moving.json").write_text(json.dumps(
        dict(spec._json("traffic", "arc"), scene_motion=MOTION,
             why="the arc with every object and light moving")))
    cfg = dict(spec._json("configs", "grid12-4k"), layout={"1": "dynamic"})
    (tmp_path / "configs" / "grid12-4k-dynamic.json").write_text(
        json.dumps(cfg))
    b = spec.load_benchmark()
    b["workloads"] += [
        {"name": "grid12.moving", "config": "grid12-4k-dynamic",
         "traffic": "arc.moving", "chips": 1, "why": "x"},
        {"name": "grid12.moving.static", "config": "grid12-4k",
         "traffic": "arc.moving", "chips": 1, "why": "x"}]
    cell = spec.cell("grid12.moving", b, here=str(tmp_path))
    assert cell.traffic["scene_motion"] == MOTION
    assert cell.config["layout"] == {"1": "dynamic"}
    with pytest.raises(ValueError, match="arc.moving.*single"):
        spec.cell("grid12.moving.static", b, here=str(tmp_path))


def test_a_static_layout_refuses_a_scene_state():
    from rtbench import port

    sc = scenes.make(ICO, "")
    t = Traffic(MIX, sc, 16)
    lay = spec.load_module("layouts", "single").build(
        port.scene(sc), {"width": 16, "height": 12, "renderer": {}}, "cpu",
        1)
    cam = port.camera(t.poses[1])
    with pytest.raises(ValueError, match="does not move"):
        lay.render(cam, True, t.state(1))
    with pytest.raises(ValueError, match="does not move"):
        lay.pairs([cam], [t.state(1)])


def test_reference_at_a_state_is_the_scene_moved_by_hand():
    sc = scenes.make(GRID, "")
    t = Traffic(MIX, sc, 64)
    state = t.state(3)
    moved = copy.deepcopy(sc)
    moved.instances = [(name, pos + off) for (name, pos), off
                       in zip(sc.instances, state.offsets)]
    moved.light_pos = state.lights.copy()

    def frame(scene, st):
        acc = reference.build(reference.soup(scene, "cpu", st))
        return judge.reference_frame(acc, t.poses[3], 64, 48)

    got, by_hand, still = frame(sc, state), frame(moved, None), frame(sc,
                                                                    None)
    assert torch.equal(got[0], by_hand[0])
    assert torch.equal(got[1], by_hand[1])
    assert not torch.equal(got[0], still[0])


RUNS = """
import json, sys
import torch
torch.set_num_threads(1)
from rtbench import run, spec
mix, scene, limits = json.loads(sys.argv[1])
cfg = {"scene": scene, "width": 64, "height": 48,
       "layout": {"1": "dynamic"}, "renderer": {},
       "check": {"frames": 3, "limits": limits}}
cell = spec.Cell("tiny.moving", 1, "tiny", cfg, mix, [], [])
baked = lambda render: (lambda cam, verify, state: render(cam, verify))
for wrap in (None, baked):
    line = run.run(cell, 2**31 + 41, 1.5, False, device="cpu", wrap=wrap)
    print(json.dumps(line), flush=True)
"""


def test_whole_moving_runs():
    """In a fresh process (a test process may hold jax, which the run's
    guard refuses): a sound run over the dynamic layout is correct with no
    frame dropped; one whose layout renders the scene as made, unmoved, is
    not."""
    limits = spec._json("configs", "grid12-4k")["check"]["limits"]
    done = subprocess.run(
        [sys.executable, "-c", RUNS, json.dumps([MIX, GRID, limits])],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    sound, unmoved = [json.loads(x) for x in done.stdout.splitlines()[-2:]]
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] >= 2
    assert not unmoved["correct"], unmoved["checks"]
