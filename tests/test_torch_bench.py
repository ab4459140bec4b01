"""The port's bench entry point (distributed_raytracer_tpu_torch/bench.py)
against the repository's root bench.py (the JAX package's bench), on the
CPU.

The port's table of configurations holds bench.py's literal values (read
from bench.py's source); its child groups and config keys are bench.py's;
each config's scene bakes to the JAX scene's arrays and its orbit poses are
runtime/animation's; its pair accounting equals the JAX
utils/profiling.FrameWork's. Each config then runs end to end at 64x48
(dataclasses.replace of its table entry, 1-2 frames) and returns exactly
the extras keys bench.py emits for it, less the keys of the tunnel-link
probe and of the budget (LEFT_OUT); the whole bench runs as a command at
that size and prints one line; and a failed, a timed-out and a card-less
run each leave the line the JAX bench leaves.
"""

import dataclasses
import inspect
import io
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bench as jbench
from __graft_entry__ import _example_scene
from distributed_raytracer_tpu.runtime import animation as janimation
from distributed_raytracer_tpu.utils import profiling as jprofiling
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch import bench
from distributed_raytracer_tpu_torch.runtime import animation
from distributed_raytracer_tpu_torch.tools import bake_cache
from distributed_raytracer_tpu_torch.utils import scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Keys of bench.py that the port leaves out: the tunnel-link probe and the
# icosphere-8 fallback of config 5, and the budget's markers.
LEFT_OUT = {"config5_link_mbps", "config5_ico{sub}_skipped", "config5_scene",
            "config5_skipped", "config1_dense_skipped",
            "config{name}_skipped"}
HEADLINE = ["metric", "value", "unit", "vs_baseline", "fps", "resolution",
            "n_tris", "n_lights", "total_rays_per_frame_incl_shadow",
            "device", "power_limit"]
# The JAX bench's function of each config (config 1 lives in its main).
JAX_FN = {"1": jbench.main, "2": jbench.config2, "3": jbench.config3,
          "4": jbench.config4, "5": jbench.config5,
          "loop": jbench.config_loop}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(cfg: bench.Config) -> bench.Config:
    return dataclasses.replace(cfg, width=64, height=48,
                               frames=min(cfg.frames, 2))


SMALL = {k: small(c) for k, c in bench.TABLE.items()}


def jax_source(config: str) -> str:
    return inspect.getsource(JAX_FN[config])


def jax_keys(config: str) -> set:
    """The extras keys bench.py's function of `config` writes, less the
    error markers and LEFT_OUT."""
    src = jax_source(config)
    keys = set(re.findall(r'extras\[f?"([^"]+)"\]', src))
    for k in re.findall(r'_culled_extras\(\s*extras, "(\w+)"', src):
        keys |= {f"{k}_gpairs_per_s", f"{k}_sol_fraction",
                 f"{k}_pairs_scheduled"}
    return {k for k in keys - LEFT_OUT if not k.endswith("_error")}


# -- the table -----------------------------------------------------------

def jax_literals(config: str) -> dict:
    """bench.py's literal size, orbits, frame count and CulledRenderer
    kwargs of one config, read from its source."""
    src = jax_source(config)
    size = re.search(r"\w+, \w+ = (\d+), (\d+)\n", src).groups()
    orbits = [(int(n), float(r), float(v)) for n, r, v in re.findall(
        r"orbit_camera_path\([\w.]+, (\d+), radius=([\d.]+),\s*"
        r"revolutions=([\d.]+)\)", src)]
    frames = re.findall(r"_bench_frames\(.*?, (\w+)\)\n", src, re.S)
    frames = [int(f) if f.isdigit() else
              int(re.search(rf"{f} = (\d+)", src).group(1)) for f in frames]
    kwargs = [dict(re.findall(r'(\w+)=("?[\w.]+"?)', call))
              for call in re.findall(r"CulledRenderer\((.*?)\)\n", src, re.S)]
    return {"size": tuple(map(int, size)), "orbits": orbits,
            "frames": frames, "kwargs": [
                {k: v.strip('"') if v.startswith('"') else int(v)
                 for k, v in kw.items()} for kw in kwargs]}


def test_config_table_holds_bench_py_values():
    t = bench.TABLE
    # bench.py:422-546, config 1 in main: the culled renderer (defaults),
    # the batched calls over 32 poses, the bs64 renderer, the dense frame.
    got = jax_literals("1")
    assert got["size"] == (t["1"].width, t["1"].height) == (640, 480)
    assert got["orbits"] == [t["1"].orbit, t["1_batched"].orbit] == [
        (8, 6.0, 0.05), (32, 6.0, 0.05)]
    assert t["1_bs64"].orbit == t["1_batched"].orbit
    assert t["1_dense"].orbit == t["1"].orbit
    assert got["frames"] == [t["1"].frames, t["1_dense"].frames] == [20, 20]
    assert got["kwargs"] == [t["1"].renderer, t["1_bs64"].renderer] == [
        {}, {"block_size": "auto"}]
    assert t["1_batched"].renderer == {}
    assert t["1_batched"].frames == t["1_bs64"].frames == 32
    assert "for _ in range(3):" in jax_source("1")      # best of 3 calls
    assert [t[k].path for k in ("1", "1_batched", "1_bs64", "1_dense")] == [
        "fast", "many", "many", "dense"]
    # bench.py:247-264 (2), :222-244 (3), :267-297 (4), :138-219 (5).
    for name, scene in (("2", "example"), ("3", "grid:8"), ("4", "grid:12"),
                        ("5", "icosphere:9")):
        got, c = jax_literals(name), t[name]
        assert got["size"] == (c.width, c.height), name
        assert got["orbits"] == [c.orbit], name
        assert got["frames"] == [c.frames], name
        kw = {k: v for k, v in got["kwargs"][0].items() if k != "prebaked"}
        assert kw == c.renderer, name
        assert c.scene == scene
    assert re.search(r"freeze_bounced\([\w.]+, depth=2\)", jax_source("2"))
    assert (t["2"].path, t["2"].depth) == ("bounced", 2)
    assert "instanced_grid(_example_scene(), 8)" in jax_source("3")
    assert "instanced_grid(_example_scene(), 12)" in jax_source("4")
    assert "for sub, slots in ((9," in jax_source("5")
    assert "load_icosphere(sub" in jax_source("5")
    # bench.py:300-347: the loop's renderer and its frame count.
    src = jax_source("loop")
    got = jax_literals("loop")
    assert got["size"] == (t["loop"].width, t["loop"].height)
    assert got["kwargs"] == [t["loop"].renderer]
    n, lo, secs = re.search(r"min\((\d+), max\((\d+), ([\d.]+) / probe_s\)\)",
                            src).groups()
    assert (int(n), int(lo), float(secs)) == (
        t["loop"].frames, bench.LOOP_MIN_FRAMES, bench.LOOP_SECONDS)
    assert bench.BASELINE_MRAYS == jbench.BASELINE_MRAYS


def test_groups_and_configs_are_bench_py_s():
    assert bench.CHILD_GROUPS == jbench.CHILD_GROUPS
    assert set(bench.CONFIGS) == set(jbench.CONFIGS)
    assert set(bench.GROUP_TIMEOUT_S) == set(bench.CHILD_GROUPS)


@pytest.mark.parametrize("key,want", [
    ("example", lambda: _example_scene()),
    ("grid:8", lambda: jscenes.instanced_grid(_example_scene(), 8)),
    ("grid:12", lambda: jscenes.instanced_grid(_example_scene(), 12))])
def test_scenes_bake_to_the_jax_bench_s(key, want):
    scene, prebaked, cam = bench.load_scene(key)
    jscene = want()
    assert prebaked is None and cam is scene.camera
    assert scene.num_tris == jscene.num_tris == {
        "example": 20, "grid:8": 1280, "grid:12": 2880}[key]
    got, ref = scene.bake(), jscene.bake()
    for f in ref._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    for f in ("pos", "forward", "left", "up"):
        assert np.array_equal(getattr(cam, f), getattr(jscene.camera, f)), f


@pytest.mark.parametrize("name", [k for k, c in bench.TABLE.items()
                                  if c.orbit is not None])
def test_orbit_poses_are_animation_s(name):
    cfg = bench.TABLE[name]
    base = scenes.example_scene() if cfg.scene != "icosphere:9" else \
        scenes.icosphere_scene(1)
    jbase = _example_scene() if cfg.scene != "icosphere:9" else \
        jscenes.icosphere_scene(1)
    n, radius, rev = cfg.orbit
    got = animation.orbit_camera_path(base.camera, n, radius=radius,
                                      revolutions=rev)
    want = janimation.orbit_camera_path(jbase.camera, n, radius=radius,
                                        revolutions=rev)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        for f in ("pos", "forward", "left", "up"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.fov == w.fov


def test_loop_events_are_animation_s():
    cfg, fov = bench.TABLE["loop"], scenes.example_scene().camera.fov
    assert (list(animation.orbit_events(cfg.width, 120, fov=fov))
            == list(janimation.orbit_events(cfg.width, 120, fov=fov)))


@pytest.mark.parametrize("cells,rt,tb", [
    ((1234, 567), 512, 128), ((np.int32(74_557), np.int32(131_000)), 256, 128),
    ((3.5, 7.25), 1024, 64)])
def test_pairs_scheduled_is_jax_framework_s(cells, rt, tb):
    from distributed_raytracer_tpu_torch.utils import profiling

    work = profiling.FrameWork(primary_cells=cells[0], shadow_cells=cells[1],
                               rays=640 * 480, ray_tile=rt, tri_block=tb,
                               seconds=0.02)
    extras = {}
    bench._culled_extras(extras, "config5", work)
    want = jprofiling.FrameWork(
        primary_cells=cells[0].item() if hasattr(cells[0], "item") else
        cells[0], shadow_cells=cells[1].item() if hasattr(cells[1], "item")
        else cells[1], rays=640 * 480, ray_tile=rt, tri_block=tb,
        seconds=0.02)
    assert extras["config5_pairs_scheduled"] == int(want.pairs)
    assert set(extras) == {"config5_gpairs_per_s", "config5_sol_fraction",
                           "config5_pairs_scheduled"}
    # Past 2^31 (config 5's 6.3 G pairs) nothing wraps.
    if rt == 256:
        assert extras["config5_pairs_scheduled"] > 2 ** 31


# -- each config at 64x48 on the CPU ------------------------------------

@pytest.fixture
def ico_cache(tmp_path, monkeypatch):
    """A 320-triangle icosphere bundle under load_icosphere(9)'s name, and
    the cold re-bake's synthesis made as small."""
    monkeypatch.setenv("DRT_SCENE_CACHE", str(tmp_path))
    sphere = scenes.icosphere_scene(2)
    bake_cache.save_bundle("icosphere9_bs128", *sphere.bake_bvh(
        block_size=128), sphere.camera)
    real = scenes.icosphere_scene
    monkeypatch.setattr(scenes, "icosphere_scene", lambda sub: real(2))
    return tmp_path


@pytest.mark.parametrize("name", list(bench.CONFIGS))
def test_config_runs_and_emits_bench_py_keys(name, ico_cache):
    extras = bench.CONFIGS[name]({}, "cpu", SMALL)
    assert set(extras) == jax_keys(name)
    assert all(v >= 0 for v in extras.values())
    for k, v in extras.items():
        if k.endswith(("_frame_ms", "_pairs_scheduled", "_mrays")):
            assert v > 0, k
    if name == "loop":
        assert extras["loop_frames"] == extras["loop_frames_budgeted"] == 2
        assert extras["loop_drop_pct"] == 0


def test_config1_paths_share_one_scene():
    """Config 1's four entries at 64x48: each path renders the example
    scene; the batched path's work is its own frames' counts."""
    culled = bench.run(SMALL["1"], "cpu")
    batched = bench.run(SMALL["1_batched"], "cpu", renderer=culled.renderer)
    dense = bench.run(SMALL["1_dense"], "cpu")
    assert culled.n_tris == dense.n_tris == 20 and culled.n_lights == 1
    assert batched.renderer is culled.renderer
    assert culled.work.pairs > 0 and batched.work.pairs > 0
    assert dense.work is None and dense.seconds > 0


# -- the command ---------------------------------------------------------

# A bench at test size: every table entry at 64x48 and 1-2 frames, config
# 5 on the small bundle of DRT_SCENE_CACHE; children run this same file.
SMALL_BENCH = textwrap.dedent("""
    import dataclasses, sys
    from distributed_raytracer_tpu_torch import bench
    from distributed_raytracer_tpu_torch.utils import scenes
    for k, c in list(bench.TABLE.items()):
        bench.TABLE[k] = dataclasses.replace(c, width=64, height=48,
                                             frames=min(c.frames, 2))
    # The card's group timeouts do not fit a loaded CPU at this size.
    bench.GROUP_TIMEOUT_S = dict.fromkeys(bench.GROUP_TIMEOUT_S, 900)
    _real = scenes.icosphere_scene
    scenes.icosphere_scene = lambda sub: _real(2)
    bench.child_command = lambda spec, device: [
        sys.executable, __file__, "--config", spec, "--device", device]
    sys.exit(bench.cli(sys.argv[1:]))
""")


def run_command(argv, env=None, timeout=300):
    env = dict(os.environ if env is None else env, PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=timeout, cwd=REPO, env=env)


def test_main_on_cpu_prints_one_line(ico_cache, tmp_path):
    script = tmp_path / "small_bench.py"
    script.write_text(SMALL_BENCH)
    res = run_command([str(script), "--device", "cpu"])
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert len(lines) == 1, res.stdout
    line = json.loads(lines[0])
    assert list(line)[:len(HEADLINE)] == HEADLINE
    assert list(line)[-1] == "bench_wall_s"
    assert line["metric"] == "primary_mrays_per_sec_per_chip"
    assert line["value"] > 0 and line["fps"] > 0
    assert line["resolution"] == "64x48" and line["n_tris"] == 20
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert line["total_rays_per_frame_incl_shadow"] == 64 * 48 * 2
    fastest = min(line[k] for k in ("frame_ms_culled", "frame_ms_batched",
                                    "frame_ms_batched_bs64",
                                    "frame_ms_dense"))
    assert line["fps"] == pytest.approx(1e3 / fastest, rel=1e-3)
    want = jax_keys("1") | {f"config{n}_wall_s" for n in bench.CONFIGS}
    for name in bench.CONFIGS:
        want |= jax_keys(name)
    assert set(line) - set(HEADLINE) == want
    assert not [k for k in line if k.endswith("_error")]
    # One launch line per process on stderr, the parent's last; on the CPU
    # the wrappers run their plain versions and launch nothing.
    counts = [l for l in res.stderr.splitlines()
              if l.startswith("bench launches: ")]
    assert len(counts) == 1
    assert set(json.loads(counts[0].split(": ", 1)[1]).values()) == {0}
    assert sum("] bench launches: " in l
               for l in res.stderr.splitlines()) == len(bench.CHILD_GROUPS)


def test_main_keeps_its_line_when_a_child_fails(monkeypatch):
    monkeypatch.setattr(bench, "child_command", lambda spec, device: [
        sys.executable, "-c", "import sys; print('boom', file=sys.stderr); "
        "sys.exit(3)"])
    out = io.StringIO()
    line = bench._Line(out)
    bench.main("cpu", line, table=SMALL, groups=(("2", "4"),))
    line.emit()
    got = json.loads(out.getvalue())
    assert got["metric"] == "primary_mrays_per_sec_per_chip"
    assert got["value"] > 0
    assert got["config2_error"] == got["config4_error"] == "rc=3: boom"
    assert "bench_wall_s" in got


@pytest.mark.parametrize("child,want", [
    # The child prints config 4's extras and no key of config 2.
    ("import json; print(json.dumps({'config4_x': 1, 'config4_wall_s': 1}))",
     {"config4_x": 1, "config4_wall_s": 1, "config2_error": "the child printed no result for it"}),
    # The child raises before printing anything.
    ("raise SystemExit('no card')",
     {"config2_error": "rc=1: no card", "config4_error": "rc=1: no card"})])
def test_failed_child_marks_its_configs(monkeypatch, child, want):
    monkeypatch.setattr(bench, "child_command",
                        lambda spec, device: [sys.executable, "-c", child])
    extras, counts = {}, {}
    bench._run_child(("2", "4"), extras, 60, "cpu", counts)
    assert extras == want and counts == {}


TIMED_OUT_CHILD = textwrap.dedent("""
    import sys, time
    from distributed_raytracer_tpu_torch import bench
    def fast(extras, device, table):
        extras["loop_frames"] = 7
    def stuck(extras, device, table):
        extras["config3_62k_frame_ms"] = 1.5
        time.sleep(120)
    bench.CONFIGS.update(loop=fast, **{"3": stuck})
    sys.exit(bench.cli(["--config", "loop,3", "--device", "cpu"]))
""")


def test_timed_out_child_hands_over_its_partial_extras(monkeypatch):
    monkeypatch.setattr(bench, "child_command", lambda spec, device: [
        sys.executable, "-c", TIMED_OUT_CHILD])
    monkeypatch.setenv("PYTHONPATH", REPO)
    extras, counts = {}, {}
    bench._run_child(("loop", "3"), extras, 20, "cpu", counts)
    assert extras["loop_frames"] == 7 and "configloop_wall_s" in extras
    assert extras["config3_62k_frame_ms"] == 1.5
    assert extras["config3_error"] == "timeout after 20s"
    assert "configloop_error" not in extras
    assert set(counts.values()) == {0}     # its SIGTERM launch line


@pytest.mark.parametrize("argv", [[], ["--config", "3"]])
def test_cuda_without_a_card_fails_loudly(argv):
    if torch.cuda.is_available():
        pytest.skip("checks the run on a machine without a card")
    res = run_command(["-m", "distributed_raytracer_tpu_torch.bench",
                       "--device", "cuda", *argv],
                      env={k: v for k, v in os.environ.items()
                           if k != "PYTHONPATH"}, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "Mrays" not in res.stdout
    if not argv:
        line = json.loads(res.stdout)
        assert line["metric"] == "error" and line["value"] == 0
        assert "CUDA is not available" in line["error"]
    else:
        assert res.stdout == ""
