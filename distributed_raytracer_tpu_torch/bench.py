"""The port's benchmark harness: the JAX bench's configurations on one card,
reported as one JSON line.

    python -m distributed_raytracer_tpu_torch.bench [--config NAMES] \\
        [--device cuda]

The counterpart of the repository's root bench.py (the JAX package's
bench), in its shape: exactly one JSON line on stdout,
  {"metric": "primary_mrays_per_sec_per_chip", "value": N, "unit":
   "Mrays/s", "vs_baseline": N, "fps", "resolution", "n_tris", "n_lights",
   "total_rays_per_frame_incl_shadow", "device", "power_limit",
   ...extras, "bench_wall_s"},
and everything else on stderr. The headline is config 1's primary Mrays/s
(the example scene at 640x480, primary and shadow rays, one card) on the
fastest of its four paths (culled, batched, batched with the block-size
policy, dense); `vs_baseline` divides it by the Go reference's published
1.93 M primary rays/s over 96 vCPUs (BASELINE.md), not by a TPU's figure.
That figure comes from 320x240 frames of the reference's own scene, so
on the fallback scene below (other triangles, another resolution) the
ratio is the JAX bench's key, not a like-for-like comparison.

Configurations (TABLE, each entry with the root bench.py's lines):
  1: utils/scenes.example_scene() at 640x480: render_fast, render_many
     of 32 host cameras (best of 3 calls), the same with
     block_size="auto", and the dense ops/render.render_frame;
  2: the example scene at 1920x1080 through freeze_bounced(depth=2);
  3: its 8x8 instanced grid at 640x480, block_size="auto";
  4: its 12x12 grid at 3840x2160, ray_tile 1024, block_size 64;
  5: the 5,242,880-triangle icosphere (tools/bake_cache.load_icosphere(9),
     built and cached when missing) at 640x480 with 16x16 ray tiles, and
     the cold re-bake of its meshes;
  loop: runtime/loop.run_loop over orbit_events on the frozen renderer,
     each frame converted to uint8 on the card.
Without the reference's assets the example scene is a 20-triangle
icosahedron, so configs 1-4 draw 20, 20, 1,280 and 2,880 triangles;
`n_tris` says so, while the key names ("62k", "139k") stay the JAX
bench's.

Config 1 runs in this process. The others run in CHILD_GROUPS, each group
in a child process started with `subprocess` (a fresh interpreter, never a
fork of a process that touched CUDA: a CUDA error leaves the process's
context unusable, and only a new process recovers), under a fixed timeout
(GROUP_TIMEOUT_S). This process builds the kernels first; each child loads
them under ops/_build.py's lock. A child prints one JSON object of extras
on its last stdout line, also on SIGTERM, which is how a timed-out child
hands over what it measured; a config that fails or does not finish gets a
`configN_error` key. On SIGTERM or SIGINT this process prints the line it
has so far.

Each process also prints `bench launches: {...}` on stderr: the
traversal kernels' and stage B2's launch counts (their utils/tracing.COUNTS
keys); this process's line sums its children's. A
frozen frame is a CUDA graph, whose kernels count when it is captured,
not when it is replayed.

With --device cuda (the default) and no card, the line is the error line
and the exit code 1: nothing falls back to the CPU. --device cpu runs the
plain versions (the tests run the configs that way at 64x48).

Left out of the JAX bench: the tunnel-link probe and the icosphere-8
fallback of config 5, and the wall-clock budget with its `_skipped`
markers (each group has a fixed timeout instead).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import traceback
from typing import Optional

BASELINE_MRAYS = 1.93   # the Go reference's primary Mrays/s (96 vCPUs)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Loop frames: about LOOP_SECONDS of them at the probed frame time, at
# least LOOP_MIN_FRAMES, at most the table's count (bench.py:326).
LOOP_SECONDS, LOOP_MIN_FRAMES = 30.0, 60


@dataclasses.dataclass(frozen=True)
class Config:
    """One timed frame of the bench: a scene (SCENE keys: "example",
    "grid:N" = instanced_grid(example, N), "icosphere:S" = the cached
    bundle of load_icosphere(S)), the frame size, CulledRenderer kwargs,
    the path ("fast" render_fast, "many" render_many, "dense"
    render_frame, "bounced" freeze_bounced, "loop" run_loop), the orbit
    (n poses, radius, revolutions of orbit_camera_path) and the frames
    timed (per render_many call for "many"; the loop's most)."""

    scene: str
    width: int
    height: int
    renderer: dict
    orbit: Optional[tuple]
    frames: int
    path: str = "fast"
    depth: int = 0


TABLE = {
    "1": Config("example", 640, 480, {}, (8, 6.0, 0.05), 20),  # :422-461
    "1_batched": Config("example", 640, 480, {}, (32, 6.0, 0.05), 32,
                        "many"),                                # :463-498
    "1_bs64": Config("example", 640, 480, {"block_size": "auto"},
                     (32, 6.0, 0.05), 32, "many"),              # :505-518
    "1_dense": Config("example", 640, 480, {}, (8, 6.0, 0.05), 20,
                      "dense"),                                 # :539-546
    "2": Config("example", 1920, 1080, {}, (4, 6.0, 0.02), 8, "bounced",
                depth=2),                                       # :247-264
    "3": Config("grid:8", 640, 480, {"block_size": "auto"},
                (4, 20.0, 0.02), 8),                            # :222-244
    "4": Config("grid:12", 3840, 2160, {"ray_tile": 1024, "block_size": 64},
                (3, 30.0, 0.015), 4),                           # :267-297
    "5": Config("icosphere:9", 640, 480, {"ray_tile": 256, "tile_w": 16},
                (3, 3.0, 0.01), 4),                             # :138-219
    "loop": Config("example", 640, 480, {"block_size": "auto"}, None, 300,
                   "loop"),                                     # :300-347
}
# The line's keys (the JAX bench's names): config 1's frame time per
# path, the other configs' key prefixes, every frame-time key, and the
# pairs each culled config reports.
CONFIG1_KEYS = {"1": "frame_ms_culled", "1_batched": "frame_ms_batched",
                "1_bs64": "frame_ms_batched_bs64", "1_dense": "frame_ms_dense"}
PREFIX = {"2": "config2_1080p_bounce2", "3": "config3_62k",
          "4": "config4_139k_4k", "5": "config5_5.2m"}
FRAME_KEYS = (*CONFIG1_KEYS.values(),
              *(f"{p}_frame_ms" for p in PREFIX.values()))
PAIRS_KEYS = tuple(f"config{k}_pairs_scheduled"
                   for k in ("1", "1_bs64", "3", "4", "5"))


@dataclasses.dataclass
class Measured:
    """One entry's run: seconds per frame, the scheduled work of the timed
    frames (culled paths), the scene's triangles and lights, the renderer
    (culled paths) with the frozen render it timed, and, for the loop, its
    extras."""

    seconds: float
    work: object
    n_tris: int
    n_lights: int
    renderer: object = None
    render: object = None
    loop: Optional[dict] = None


def load_scene(key: str):
    """(scene, prebaked, camera) of a table scene: a Scene to bake, or an
    (arrays, tree) bundle with scene None."""
    from distributed_raytracer_tpu_torch.utils import scenes

    kind, _, arg = key.partition(":")
    if kind == "icosphere":
        from distributed_raytracer_tpu_torch.tools import bake_cache

        arrays, tree, cam = bake_cache.load_icosphere(int(arg))
        return None, (arrays, tree), cam
    scene = scenes.example_scene()
    if kind == "grid":
        scene = scenes.instanced_grid(scene, int(arg))
    elif kind != "example":
        raise ValueError(f"unknown scene {key}")
    return scene, None, scene.camera


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _bench_frames(render, cams, n_frames: int, device) -> float:
    """Seconds per frame of n_frames renders over cams in turn, on the
    host clock between two synchronizes (jax.block_until_ready in the JAX
    bench). The warm-up is a burst of the same length, where the JAX bench
    warms with one frame: frozen frames in flight each hold a block of the
    caching allocators, and a burst past their cache pays the allocation
    once (cudaHostAlloc, 16.7 ms on the card's host, PERF.md section 7)."""
    for k in range(n_frames):
        render(cams[k % len(cams)])
    sync(device)
    t0 = time.perf_counter()
    for k in range(n_frames):
        render(cams[k % len(cams)])
    sync(device)
    return (time.perf_counter() - t0) / n_frames


def _culled_extras(extras: dict, key: str, work) -> None:
    """Per-config work accounting: scheduled pairs, Gpairs/s and the share
    of the H100's pair-throughput roofline (utils/profiling.FrameWork).

    Where the JAX bench reads the renderer's last sync render
    (`_last_counts`), `work` holds the timed frames' own frozen counts
    (profiling.orbit_work, which refuses an overflowed frame's): an
    overflowed frame's counts undercount, and config 5's cells move 76%
    from pose to pose. The counts are Python ints before they multiply
    (config 5 schedules more than 2^31 pairs)."""
    extras[f"{key}_gpairs_per_s"] = round(work.gpairs_per_sec, 4)
    extras[f"{key}_sol_fraction"] = round(work.sol_fraction, 6)
    extras[f"{key}_pairs_scheduled"] = int(work.pairs)


def real_tris(arrays) -> int:
    """Triangles of a bake (padding slots have a zero normal)."""
    import numpy as np

    return int((np.abs(arrays.geo_n).sum(axis=1) > 0).sum())


def settle(r, poses, camera=None) -> None:
    """Renders every pose with verify=True, so no later frozen frame of
    those poses overflows r's buckets; with a camera, first sizes the work
    lists on it with a sync render and freezes them."""
    if camera is not None:
        r.render(camera, block=True)
        r.freeze(camera)
    for p in poses:
        r.render_fast(p, verify=True)


def run(cfg: Config, device, renderer=None) -> Measured:
    """Renders one TABLE entry on `device` and times it. The culled paths
    size and freeze the renderer (or take `renderer`, already frozen) and
    render every orbit pose with verify=True before timing, so no timed
    frame overflows its buckets; render_fast's cameras are staged on the
    device first, as the JAX bench's."""
    from distributed_raytracer_tpu_torch.ops import raygen
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.runtime import animation
    from distributed_raytracer_tpu_torch.utils import profiling

    scene, prebaked, cam = load_scene(cfg.scene)
    arrays = prebaked[0] if scene is None else None
    n_tris = real_tris(arrays) if scene is None else int(scene.num_tris)
    n_lights = int((arrays if scene is None else scene).light_pos.shape[0])
    w, h = cfg.width, cfg.height
    if cfg.path == "loop":
        return Measured(0.0, None, n_tris, n_lights,
                        loop=_run_loop(cfg, scene, device))
    poses = animation.orbit_camera_path(cam, cfg.orbit[0],
                                        radius=cfg.orbit[1],
                                        revolutions=cfg.orbit[2])
    staged = [raygen.camera_arrays(p, device) for p in poses]
    if cfg.path == "dense":
        from distributed_raytracer_tpu_torch.ops.render import (render_frame,
                                                                scene_on)

        dev_arrays = scene_on(scene.bake(), device)
        s = _bench_frames(lambda c: render_frame(dev_arrays, c, w, h),
                          staged, cfg.frames, device)
        return Measured(s, None, n_tris, n_lights)
    r = renderer or CulledRenderer(scene, w, h, prebaked=prebaked,
                                   device=device, **cfg.renderer)
    if cfg.path == "bounced":
        render = r.freeze_bounced(cam, depth=cfg.depth)
        for c in staged:
            render(c, verify=True)
        s = _bench_frames(render, staged, cfg.frames, device)
        return Measured(s, None, n_tris, n_lights, r, render)
    settle(r, staged, cam if renderer is None else None)
    if cfg.path == "many":
        host = [p.to_arrays() for p in poses][:cfg.frames]
        r.render_many(host)
        sync(device)
        best = None
        for _ in range(3):
            # Best of 3 whole-batch calls; the host cameras' one copy per
            # batch is inside the window.
            t0 = time.perf_counter()
            r.render_many(host)
            sync(device)
            s = (time.perf_counter() - t0) / len(host)
            best = s if best is None else min(best, s)
        return Measured(best, profiling.orbit_work(r, host, best), n_tris,
                        n_lights, r, r.render_fast)
    timed = [poses[k % len(poses)] for k in range(cfg.frames)]
    s = _bench_frames(r.render_fast, staged, cfg.frames, device)
    return Measured(s, profiling.orbit_work(r, timed, s), n_tris, n_lights,
                    r, r.render_fast)


def _run_loop(cfg: Config, scene, device) -> dict:
    """The interactive loop on the frozen renderer, end to end: scripted
    orbit input, the camera controller, frames dispatched without a host
    sync (verify every 8th, as the command line does), converted to uint8
    on the card and shown in order; the reference's FPS statistics and
    drop rate (master/main.go:240-325)."""
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.run import _periodic_verify
    from distributed_raytracer_tpu_torch.runtime import animation, framebuffer
    from distributed_raytracer_tpu_torch.runtime.loop import run_loop

    w, h = cfg.width, cfg.height
    r = CulledRenderer(scene, w, h, device=device, **cfg.renderer)
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    # Size the run from one displayed frame's time (after a warm one).
    cam0 = scene.camera.to_arrays()
    framebuffer.to_u8_device(r.render_fast(cam0)).cpu()
    t0 = time.monotonic()
    framebuffer.to_u8_device(r.render_fast(cam0)).cpu()
    probe_s = max(time.monotonic() - t0, 1e-4)
    n_frames = int(min(cfg.frames, max(LOOP_MIN_FRAMES, LOOP_SECONDS /
                                       probe_s)))
    events = list(animation.orbit_events(w, n_frames,
                                         fov=scene.camera.fov))
    render = _periodic_verify(lambda c, v: r.render_fast(c, verify=v))
    _, stats, dropped = run_loop(
        None, scene.camera,
        lambda s, c: framebuffer.to_u8_device(render(c)), w, h,
        events=events, display=lambda idx, img: None)
    return {"loop_frames_budgeted": n_frames,
            "loop_frames": int(stats.frames_total),
            "loop_mean_fps": round(stats.mean_fps, 4),
            "loop_median_fps": round(stats.median_fps, 4),
            "loop_drop_pct": round(100.0 * dropped
                                   / max(stats.frames_total, 1), 4)}


def _frame_keys(extras: dict, prefix: str, m: Measured, cfg: Config) -> None:
    extras[f"{prefix}_frame_ms"] = round(m.seconds * 1e3, 4)
    extras[f"{prefix}_mrays"] = round(cfg.width * cfg.height / m.seconds
                                      / 1e6, 4)


# -- the configs (each runs in a child process via --config <name>) ------

def config5(extras: dict, device, table=TABLE) -> dict:
    """The 5.24 M-triangle icosphere through the block-sparse path with
    16x16 ray tiles (the JAX bench's form: they halve the scheduled
    pairs, PERF.md section 5), then the cold-bake cost: the meshes
    synthesized and baked again on this host, with the synthesis timed
    apart (it is scene generation, not loading)."""
    from distributed_raytracer_tpu_torch.models import native
    from distributed_raytracer_tpu_torch.utils import scenes

    cfg = table["5"]
    m = run(cfg, device)
    _frame_keys(extras, PREFIX["5"], m, cfg)
    _culled_extras(extras, "config5", m.work)
    m.renderer.release_graphs()
    # The native (OpenMP) bake's library is built on its first use in a
    # checkout; without it the bake runs the NumPy chain. Loading it is
    # set-up, not the bake, and stderr says which bake ran.
    t0 = time.monotonic()
    lib = native.load()
    print(f"native library: {'loaded' if lib else 'unavailable'} in "
          f"{time.monotonic() - t0:.2f} s", file=sys.stderr, flush=True)
    t0 = time.monotonic()
    sc = scenes.icosphere_scene(int(cfg.scene.partition(":")[2]))
    t_syn = time.monotonic() - t0
    t0 = time.monotonic()
    sc.bake_bvh(block_size=128)
    extras["config5_cold_bake_s"] = round(time.monotonic() - t0, 2)
    extras["config5_bake_synthesis_s"] = round(t_syn, 2)
    return extras


def config3(extras: dict, device, table=TABLE) -> dict:
    """The example scene's 8x8 instanced grid, block-sparse, with the
    block-size policy (64-triangle leaves below a million triangles)."""
    m = run(table["3"], device)
    _frame_keys(extras, PREFIX["3"], m, table["3"])
    _culled_extras(extras, "config3", m.work)
    return extras


def config2(extras: dict, device, table=TABLE) -> dict:
    """The example scene at 1920x1080 with specular bounces (depth 2:
    primary + 2 reflection bounces)."""
    m = run(table["2"], device)
    _frame_keys(extras, PREFIX["2"], m, table["2"])
    return extras


def config4(extras: dict, device, table=TABLE) -> dict:
    """The example scene's 12x12 grid at 3840x2160 with 32x32 ray tiles
    and 64-triangle leaves (the JAX bench's adopted form)."""
    m = run(table["4"], device)
    _frame_keys(extras, PREFIX["4"], m, table["4"])
    _culled_extras(extras, "config4", m.work)
    return extras


def config_loop(extras: dict, device, table=TABLE) -> dict:
    """The interactive frame loop: FPS statistics and drop rate."""
    extras.update(run(table["loop"], device).loop)
    return extras


CONFIGS = {"5": config5, "3": config3, "loop": config_loop, "2": config2,
           "4": config4}

# Child groups, as the JAX bench's: config 5 alone and last, the cheap
# configs in two children. Inside a group each config runs under its own
# try/except, so one failure costs one data point.
CHILD_GROUPS = (("loop", "3"), ("2", "4"), ("5",))
# Seconds each group's child may take: about 3x the most it took on an
# NVIDIA H100 80GB HBM3 at 700.00 W in four runs (13.7, 16.0 and 70.3 s,
# config 5 building its bundle; PERF.md section 5).
GROUP_TIMEOUT_S = {("loop", "3"): 45, ("2", "4"): 50, ("5",): 210}


def launches() -> dict:
    from distributed_raytracer_tpu_torch.utils.tracing import COUNTS

    return {k: n for k, n in COUNTS.items()
            if k.startswith(("bsr_", "shade_prep"))}


def _print_launches(counts: dict) -> None:
    print(f"bench launches: {json.dumps(counts)}", file=sys.stderr,
          flush=True)


def child_command(spec: str, device: str) -> list:
    """The command of a child running the configs of `spec`."""
    return [sys.executable, "-m", "distributed_raytracer_tpu_torch.bench",
            "--config", spec, "--device", device]


def _run_child(group, extras: dict, timeout: float, device: str,
               counts: dict, line=None) -> None:
    """Runs one group in a child process and merges its last stdout line
    into extras, its launch counts into counts. On timeout the child gets
    SIGTERM (it prints what it measured) and 15 s before SIGKILL. Every
    config of the group that the child did not finish gets configN_error
    (one that raised keeps its own). line.child (a _Line) holds the child
    while it runs."""
    t0 = time.monotonic()
    spec = ",".join(group)
    proc = subprocess.Popen(child_command(spec, device), cwd=_REPO_ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    if line is not None:
        line.child = proc
    timed_out = False
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        timed_out = True
        proc.terminate()
        try:
            stdout, stderr = proc.communicate(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
    if line is not None:
        line.child = None
    for err in stderr.splitlines():
        print(f"[child {spec}] {err}", file=sys.stderr)
        if err.startswith("bench launches: "):
            for k, n in json.loads(err.split(": ", 1)[1]).items():
                counts[k] = counts.get(k, 0) + n
    secs = time.monotonic() - t0
    print(f"group {spec}: {secs:.1f} s (timeout {timeout:.0f} s)",
          file=sys.stderr, flush=True)
    lines = [l for l in stdout.splitlines() if l.strip()]
    got = {}
    if lines:
        try:
            got = json.loads(lines[-1])
        except ValueError:
            pass
    extras.update(got)
    why = (f"timeout after {timeout:.0f}s" if timed_out else
           f"rc={proc.returncode}: {stderr.strip()[-300:]}"
           if proc.returncode else "the child printed no result for it")
    for name in group:      # child_main times each config it finishes
        if f"config{name}_wall_s" not in got:
            extras.setdefault(f"config{name}_error", why)
    if len(group) == 1:
        extras[f"config{spec}_wall_s"] = round(secs, 2)


class _Line:
    """The one stdout line: the best result so far, printed once (at the
    end, or on SIGTERM / SIGINT with what has been measured), and the
    child process running, if any."""

    def __init__(self, out):
        self.out, self.result, self.printed = out, None, False
        self.child = None

    def emit(self, result=None) -> None:
        if not self.printed:
            self.printed = True
            print(json.dumps(result or self.result or {
                "metric": "error", "value": 0, "unit": "none",
                "vs_baseline": 0,
                "error": "terminated before the headline config finished"}),
                file=self.out, flush=True)


def main(device, line: _Line, table=TABLE, groups=CHILD_GROUPS) -> None:
    """Config 1 in this process, then the child groups; line.result holds
    the headline and the extras so far after each step."""
    import torch

    t_start = time.monotonic()
    device = torch.device(device)
    power_limit = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        from distributed_raytracer_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load_library("bsr_trace")    # children load it under a lock
        print(f"build: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        from distributed_raytracer_tpu_torch.tools.schedule_frames import (
            gpu_query)

        name = torch.cuda.get_device_name(device)
        # nvidia-smi prints one "name, power limit" line per card.
        card = gpu_query().splitlines()[device.index or 0]
        power_limit = card.rsplit(",", 1)[1].strip()
        print(f"gpu: {name}, {power_limit}", file=sys.stderr, flush=True)
    else:
        name = str(device)
    extras = {}
    c1 = table["1"]
    width, height = c1.width, c1.height

    def headline(best_s, m):
        mrays = width * height / best_s / 1e6
        return {
            "metric": "primary_mrays_per_sec_per_chip",
            "value": round(mrays, 4), "unit": "Mrays/s",
            "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
            "fps": round(1.0 / best_s, 4),
            "resolution": f"{width}x{height}", "n_tris": m.n_tris,
            "n_lights": m.n_lights,
            "total_rays_per_frame_incl_shadow":
                width * height * (1 + m.n_lights),
            "device": name, "power_limit": power_limit, **extras}

    # Config 1: the culled path first (the production path and the usual
    # winner), with block_size 128, which its SOL fraction has tracked
    # since the JAX bench's round 3; the batched paths; the dense one.
    culled = run(c1, device)
    extras[CONFIG1_KEYS["1"]] = round(culled.seconds * 1e3, 4)
    _culled_extras(extras, "config1", culled.work)
    best = culled.seconds
    try:
        batched = run(table["1_batched"], device, renderer=culled.renderer)
        extras[CONFIG1_KEYS["1_batched"]] = round(batched.seconds * 1e3, 4)
        if batched.seconds < culled.seconds:
            _culled_extras(extras, "config1", batched.work)
        best = min(best, batched.seconds)
    except Exception as e:
        traceback.print_exc()
        extras["config1_batched_error"] = repr(e)[:200]
    culled.renderer.release_graphs()
    try:
        bs64 = run(table["1_bs64"], device)
        extras[CONFIG1_KEYS["1_bs64"]] = round(bs64.seconds * 1e3, 4)
        _culled_extras(extras, "config1_bs64", bs64.work)
        best = min(best, bs64.seconds)
        bs64.renderer.release_graphs()
    except Exception as e:
        traceback.print_exc()
        extras["config1_bs64_error"] = repr(e)[:200]
    line.result = headline(best, culled)
    dense = run(table["1_dense"], device)
    extras[CONFIG1_KEYS["1_dense"]] = round(dense.seconds * 1e3, 4)
    best = min(best, dense.seconds)
    line.result = headline(best, culled)
    counts = launches()
    for group in groups:
        _run_child(group, extras, GROUP_TIMEOUT_S[group], str(device),
                   counts, line)
        line.result = headline(best, culled)
    extras["bench_wall_s"] = round(time.monotonic() - t_start, 2)
    line.result = headline(best, culled)
    _print_launches(counts)


def child_main(spec: str, device, out, table=TABLE) -> None:
    """--config entry: runs the comma-separated configs, each under its
    own try/except, and prints ONE JSON line of their extras on `out`; on
    SIGTERM, the extras so far."""
    extras = {}

    def emit_partial(signum, frame):
        print(json.dumps(extras), file=out, flush=True)
        _print_launches(launches())
        os._exit(0)

    signal.signal(signal.SIGTERM, emit_partial)
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    for name in spec.split(","):
        t0 = time.monotonic()
        try:
            CONFIGS[name](extras, device, table)
        except Exception as e:
            traceback.print_exc()
            extras[f"config{name}_error"] = repr(e)[:200]
        extras[f"config{name}_wall_s"] = round(time.monotonic() - t0, 2)
    print(json.dumps(extras), file=out, flush=True)
    _print_launches(launches())


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", help="comma-separated CONFIGS keys: run "
                    "them and print their extras (a child's mode)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    # The one line goes to the real stdout; anything else printed (a
    # bundle's build times, say) goes to stderr.
    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        if a.config:
            bad = [n for n in a.config.split(",") if n not in CONFIGS]
            if bad:
                ap.error(f"unknown configs {bad} (choose from "
                         f"{list(CONFIGS)})")
            child_main(a.config, a.device, out)
            return 0
        line = _Line(out)

        def on_term(signum, frame):
            if line.child is not None:
                line.child.kill()
            line.emit()
            os._exit(0)

        signal.signal(signal.SIGTERM, on_term)
        signal.signal(signal.SIGINT, on_term)
        try:
            main(a.device, line)
        except Exception as e:
            traceback.print_exc()
            if line.result is None:
                line.emit({"metric": "error", "value": 0, "unit": "none",
                           "vs_baseline": 0, "error": repr(e)[:500]})
                return 1
            line.result["error"] = repr(e)[:200]
        line.emit()
    return 0


if __name__ == "__main__":
    sys.exit(cli())
