"""The benchmark's Whitted-bounced frames, in the tier-1 run.

rtbench/tests/test_rtbench_bounces.py (the depth-0 reference bit for bit
as before bounces came, the program's bounced frame against the plain
reference and the port's float64 oracle at 64x48, a missing bounce and
the TF32 control failing, whole bounced runs on the CPU, the bounced
layout's pair counts, the bounce readers) runs in a fresh process, apart
from this one's JAX; its limit, 300 s, leaves a slower machine room. The
cell `grid4.bounce2` is the bounced layout at depth 2 on one card under
`arc`'s input, and its configuration's limits tell the program's frame
from one that lost its last bounce.
"""

import os
import subprocess
import sys

import pytest
import torch

from rtbench import judge, port, reference, scenes, spec
from rtbench.traffic import Traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(spec.HERE, ".cache")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rtbench_bounce_tests_pass_in_a_fresh_process():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest",
         "rtbench/tests/test_rtbench_bounces.py", "-q", "-o", "addopts=",
         "-p", "no:cacheprovider", "-p", "no:randomly"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]


def test_the_bounced_cell_is_the_arc_mix_on_the_bounced_layout():
    cell, arc = spec.cell("grid4.bounce2"), spec.cell("grid12.arc")
    cfg = cell.config
    assert cell.config_name == "grid4-1080-bounce2" and cell.chips == 1
    assert cfg["layout"] == {"1": "bounced"} and cfg["bounces"] == 2
    assert judge.bounces(cfg) == 2
    assert spec.load_module("layouts", "bounced").Bounced.TRAVERSAL == (
        "K3n", "K2")
    assert (cfg["width"], cfg["height"]) == (1920, 1080)
    assert cfg["scene"] == {"generator": "instanced_grid", "n": 4,
                            "spacing": 3.0,
                            "base": {"generator": "icosphere",
                                     "subdivisions": 3, "lights": 3}}
    assert cfg["renderer"] == {"block_size": "auto"}
    assert cfg["reduced"] == []
    assert cfg["check"]["frames"] == 3
    assert cfg["check"]["limits"] == {"bad_share": 0.0002, "mean_abs": 0.02}
    assert cell.traffic == arc.traffic
    assert {m["name"] for m in cell.end_to_end} == {
        "frame_ms", "latency_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "enqueue_ms", "device_idle_share", "glue_ms", "traversal_ms",
        "traversal_roofline", "bounce_ms", "bounce_roofline"}
    (entry,) = [c for c in spec.load_benchmark()["configs"]
                if c["name"] == "grid4-1080-bounce2"]
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


def test_the_configuration_limits_fail_a_lost_bounce(one_thread):
    """The cell's scene at 64x48 at a pose of `arc`: against the depth-2
    reference the program's depth-2 frame is within the configuration's
    limits, its depth-1 frame (the last bounce lost) is not (~20 s)."""
    from distributed_raytracer_tpu_torch.ops.render_bvh import (
        CulledRenderer)
    from distributed_raytracer_tpu_torch.runtime import framebuffer

    w, h = 64, 48
    cfg = spec.cell("grid4.bounce2").config
    limits = cfg["check"]["limits"]
    sc = scenes.make(cfg["scene"], CACHE)
    acc = reference.build(reference.soup(sc, "cpu"))
    r = CulledRenderer(port.scene(sc), w, h, device="cpu", ray_tile=128,
                       block_size=32)
    arc = Traffic(spec._json("traffic", "arc"), sc, w)
    pose = arc.poses[len(arc.cycle) // 4]
    want, code = judge.reference_frame(acc, pose, w, h, bounces=2)
    got = {}
    for depth in (1, 2):
        img = r.render_bounced(port.camera(pose), depth)
        got[depth] = judge.compare(framebuffer.to_u8_device(img), want, code)
    assert all(got[2][m] <= limits[m] for m in limits), got
    assert any(got[1][m] > limits[m] for m in limits), got
