"""The benchmark's scenes that move, in the tier-1 run.

rtbench/tests/test_rtbench_motion.py (the static cells' poses and soups
as before motion came, the states of a cycle, the state each render call
gets across a frame issued again, a moving cell as data, the reference at
a state, whole moving runs on the CPU) runs in a fresh process, apart
from this one's JAX: ~22 s alone, ~43 s beside five other test workers;
its limit, 120 s, leaves a slower machine room. The cell `grid12.moving`
is `grid12.arc`'s frame on the dynamic layout under `arc`'s input with
every object and light moving.
"""

import os
import subprocess
import sys

from rtbench import spec, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rtbench_motion_tests_pass_in_a_fresh_process():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest",
         "rtbench/tests/test_rtbench_motion.py", "-q", "-o", "addopts=",
         "-p", "no:cacheprovider", "-p", "no:randomly"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]


def test_the_moving_cell_is_the_arc_frame_on_the_dynamic_layout():
    moving, arc = spec.cell("grid12.moving"), spec.cell("grid12.arc")
    assert moving.config_name == "grid12-4k-moving" and moving.chips == 1
    assert moving.config["layout"] == {"1": "dynamic"}
    assert spec.load_module("layouts", "dynamic").MOVES is True
    for key in ("scene", "width", "height", "renderer", "check", "reduced"):
        assert moving.config[key] == arc.config[key], key
    assert moving.config["reduced"] == []
    mix = dict(moving.traffic)
    assert mix.pop("scene_motion") == {"object_radius": 1.0,
                                       "object_revolutions": 1,
                                       "light_revolutions": 1}
    assert traffic.moves(moving.traffic)
    assert {k: v for k, v in mix.items() if k != "why"} == {
        k: v for k, v in arc.traffic.items() if k != "why"}
    assert {m["name"] for m in moving.end_to_end} == {
        "frame_ms", "latency_p95_ms", "setup_s"}
    assert {m["name"] for m in moving.per_layer} == {
        "enqueue_ms", "device_idle_share", "glue_ms", "traversal_ms",
        "traversal_roofline"}
