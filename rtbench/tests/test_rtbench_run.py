"""Whole runs on the CPU at a tiny size (the harness's look for a card
skipped): a sound run comes out correct, and each fault the timed path can
have makes it come out not correct. And what a run does without a card
or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from rtbench import run as rtrun
from rtbench import spec

# The limits of the configurations the tiny cells stand for.
LIMITS = {1: spec._json("configs", "ico9-640")["check"]["limits"],
          2: spec._json("configs", "grid12-4k-bands4")["check"]["limits"]}
TRAFFIC = dict(spec._json("traffic", "arc"), share_of_revolution=0.05,
               verify_period=2)
# The icosphere circles a unit radius once in the 20 ticks of a cycle
# (~6 pixels a frame at 64x48) and the lights turn 18 degrees a frame.
MOVING = dict(TRAFFIC, scene_motion={
    "object_radius": 1.0, "object_revolutions": 1, "light_revolutions": 1})


def cell(chips, moving=False):
    scene = ({"generator": "icosphere", "subdivisions": 3} if chips == 1
             else {"generator": "instanced_grid", "n": 2,
                   "base": {"generator": "icosphere", "subdivisions": 1}})
    cfg = {"scene": scene, "width": 64, "height": 48,
           "layout": {"1": "dynamic" if moving else "single", "2": "bands"},
           "renderer": {}, "check": {"frames": 3, "limits": LIMITS[chips]}}
    return spec.Cell("tiny", chips, "tiny", cfg,
                     MOVING if moving else TRAFFIC, [], [])


def stale(render):
    first = []

    def f(cam, verify, state):
        img = render(cam, verify, state)
        if not first:
            first.append(img)
        return first[0]
    return f


def half(render):
    def f(cam, verify, state):
        img = render(cam, verify, state).clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    return f


def exchange(render):
    """Only band 0's rows arrive (the bands of the other cards are not
    gathered)."""
    def f(cam, verify, state):
        img = render(cam, verify, state).clone()
        img[-(-img.shape[0] // 2):] = 0.0
        return img
    return f


def altered(render):
    def f(cam, verify, state):
        img = render(cam, verify, state).clone()
        h, w = img.shape[0] // 2, img.shape[1] // 2
        img[h - 4:h + 4, w - 4:w + 4] = (img[h - 4:h + 4, w - 4:w + 4]
                                         + 0.2).clamp(0.0, 1.0)
        return img
    return f


def off_by_one(render):
    """A moving layout that renders each frame at the scene of the call
    before it."""
    last = []

    def f(cam, verify, state):
        img = render(cam, verify, last[-1] if last else state)
        last.append(state)
        return img
    return f


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("chips,moving", [
    pytest.param(1, False, id="1"), pytest.param(2, False, id="2"),
    pytest.param(1, True, id="1-moving")])
def test_sound_run_is_correct(chips, moving):
    """Each cell of a fault below, run sound: the moving one is the
    off_by_one fault's."""
    line = rtrun.run(cell(chips, moving), 2**31 + 11, 4.0, False,
                     device="cpu")
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("chips,fault", [
    (1, stale), (1, half), (1, altered), (2, exchange), (2, stale),
    (1, off_by_one)])
def test_fault_is_not_correct(chips, fault):
    line = rtrun.run(cell(chips, fault is off_by_one), 2**31 + 12, 4.0,
                     False, device="cpu", wrap=fault)
    assert not line["correct"], line["checks"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = rtrun.main(["--workload", "ico9.orbit", "--seed", "1",
                     "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    fails, printing no result."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run(
        [sys.executable, "-m", "rtbench", "--workload", "ico9.orbit",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""
    assert "distributed_raytracer_tpu_torch" in done.stderr


def test_imports_leave_no_jax():
    """A cell's modules, the program's included, load no module whose
    top-level name is jax, jaxlib, flax or the JAX package; the reference
    loads nothing of the program."""
    code = (
        "import sys\n"
        "from rtbench import run, spec, port, scenes, judge, devtrace\n"
        "for w in spec.load_benchmark()['workloads']:\n"
        "    c = spec.cell(w['name'])\n"
        "    spec.load_module('layouts', c.config['layout'][str(c.chips)])\n"
        "    for m in c.end_to_end + c.per_layer:\n"
        "        spec.load_module('metrics', m['name'])\n"
        "sc = scenes.make({'generator': 'icosphere', 'subdivisions': 1}, '')\n"
        "cfg = {'width': 16, 'height': 16, 'renderer': {}}\n"
        "lay = spec.load_module('layouts', 'single').build(port.scene(sc), "
        "cfg, 'cpu', 1)\n"
        "from distributed_raytracer_tpu_torch.runtime import loop\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', "
        "'distributed_raytracer_tpu', 'distributed_raytracer_tpu_torch'}))\n")
    ref = ("import sys\nfrom rtbench import reference, judge, traffic\n"
           "print(sorted({m.split('.')[0] for m in sys.modules} & "
           "{'distributed_raytracer_tpu', 'distributed_raytracer_tpu_torch', "
           "'jax'}))\n")
    outs = []
    for c in (code, ref):
        done = subprocess.run([sys.executable, "-c", c], cwd=spec.ROOT,
                              capture_output=True, text=True, timeout=300)
        assert done.returncode == 0, done.stderr
        outs.append(json.loads(done.stdout.strip().replace("'", '"')))
    assert outs[0] == ["distributed_raytracer_tpu_torch"]
    assert outs[1] == []
    assert rtrun.BANNED == ("jax", "jaxlib", "flax",
                            "distributed_raytracer_tpu")


@pytest.mark.cuda
def test_a_short_cell_on_the_card(cuda_card):
    """On the card: a short run of the first cell is correct."""
    line = rtrun.run(spec.cell("ico9.orbit"), 7, 2.0, False)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
