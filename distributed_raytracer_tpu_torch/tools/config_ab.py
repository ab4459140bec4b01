"""Per-config A/B of the culled renderer's construction parameters on one
card.

The counterpart of the JAX package's tools/config_ab.py, with its
tools/config5_ab.py folded in as config 5. Variants are constructor
arguments of CulledRenderer (VARIANTS).

    python -m distributed_raytracer_tpu_torch.tools.config_ab CONFIG \\
        [VARIANT ...] [--device cuda]

  CONFIG (scene and size from the bench's table, bench.TABLE):
         1: the example scene (utils/scenes.example_scene) at 640x480;
         3: its 8x8 instanced grid at 640x480;
         4: its 12x12 instanced grid at 3840x2160;
         5: the 5.24 M-triangle icosphere (tools/bake_cache, built and
            cached when missing) at 640x480.
  VARIANT: keys of VARIANTS (default base bs64 rt256sq rt256sq_bs64);
         config 5 takes CONFIG5_VARIANTS (default base rt256sq exit16
         mxu): its bake fixes blocks of 128. rt256sq, 16x16 ray tiles, is
         the JAX bench's production form of config 5.

Each variant prints one line: the frame's ms (synchronized median over
the orbit poses), the scheduled pairs per frame (the mean over the timed
frames, from their frozen counts), Gpairs/s, the share of the H100
roofline of the kernel form it ran (utils/profiling.FrameWork),
exit_every, the cull levels, the setup seconds (bake, upload, sizing
render, freeze) and the scene's triangles.
Config 1 also times render_many() of the orbit poses as host CameraArrays:
its window holds the cameras' one host-to-device copy per batch. `base` on
config 5 also prints the sync render's stage split (CUDA events around the
renderer's stages, each stage's host syncs included).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from typing import Optional

VARIANTS = {
    "base": {},
    "bs64": dict(block_size=64),
    "rt256": dict(ray_tile=256),
    "rt256sq": dict(ray_tile=256, tile_w=16),
    "rt256sq_bs64": dict(ray_tile=256, tile_w=16, block_size=64),
    "cl3": dict(cull_levels=3),
    "rt256sq_cl3": dict(ray_tile=256, tile_w=16, cull_levels=3),
    "exit16": dict(exit_every=16),
    "rt1024": dict(ray_tile=1024),
    "rt1024_bs64": dict(ray_tile=1024, block_size=64),
    "bs64_cl3": dict(block_size=64, cull_levels=3),
    # config5_ab's own.
    "rt128": dict(ray_tile=128, tile_w=16),
    "exit8": dict(exit_every=8),
    "mxu": dict(use_mxu=True),
}
CONFIG5_VARIANTS = ("base", "rt256", "rt256sq", "rt128", "exit16", "exit8",
                    "mxu")
# The variants run when none are named, by config.
DEFAULTS = {**dict.fromkeys("134", ("base", "bs64", "rt256sq",
                                     "rt256sq_bs64")),
            "5": ("base", "rt256sq", "exit16", "mxu")}


@dataclasses.dataclass
class Config:
    """One configuration: a scene (or a prebaked (arrays, tree) pair), its
    sizing camera, the frame size, the orbit poses timed and how many
    frames are timed."""

    name: str
    scene: object
    prebaked: Optional[tuple]
    camera: object
    width: int
    height: int
    poses: list
    frames: int
    tris: int


# This tool's orbit (poses, revolutions) and frames timed per config; the
# scene, the frame size and the orbit's radius are the bench's (bench.TABLE).
ORBITS = {"1": (4, 0.02, 10), "3": (4, 0.02, 10), "4": (4, 0.02, 4),
          "5": (3, 0.01, 6)}


def build_config(config: str) -> Config:
    from distributed_raytracer_tpu_torch import bench
    from distributed_raytracer_tpu_torch.runtime import animation

    if config not in ORBITS:
        raise SystemExit(f"unknown config {config}")
    entry = bench.TABLE[config]
    scene, prebaked, cam = bench.load_scene(entry.scene)
    n, revolutions, frames = ORBITS[config]
    poses = animation.orbit_camera_path(cam, n, radius=entry.orbit[1],
                                        revolutions=revolutions)
    tris = scene.num_tris if scene else bench.real_tris(prebaked[0])
    return Config(config, scene, prebaked, cam, entry.width, entry.height,
                  poses, frames, tris)


def _mean_ms(fn, device, reps: int = 4) -> float:
    """Mean ms of fn() over reps calls after one warm-up: CUDA events on
    the current stream on a card (what the calls' host syncs wait for
    included), the host's clock elsewhere."""
    import torch

    from distributed_raytracer_tpu_torch import bench

    fn()
    bench.sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def breakdown(r, camera, reps: int = 4) -> dict:
    """{stage: mean ms} of one sync render's stages on its own inputs
    (render() must have run, so exit_every is settled)."""
    from distributed_raytracer_tpu_torch.ops import raygen
    from distributed_raytracer_tpu_torch.ops.frozen_graph import tile_bucket

    sc, cam = r.dev_scene, raygen.camera_arrays(camera, r.device)
    rays, ti, m, e, c1 = r._stage_a(sc, cam)
    p_pads, _ = r._size_pads(sc, ti, m, e, c1)
    hits, hcount, _ = r._stage_b1(sc, p_pads, rays, ti, m, e, c1)
    ht_pad = tile_bucket(int(hcount), r.n_tiles)
    sh = r._stage_b2(sc, ht_pad, rays, hits, cam.pos)
    s_pads, _ = r._size_pads(sc, sh.sti, sh.smasks, sh.sentries, sh.sc1)
    stages = {
        "A raygen + top mask": lambda: r._stage_a(sc, cam),
        "primary sizing (host syncs)": lambda: r._size_pads(
            sc, ti, m, e, c1),
        "B1 work list + K1": lambda: r._stage_b1(sc, p_pads, rays, ti, m, e,
                                                 c1),
        "B2 compaction + prep + shadow masks": lambda: r._stage_b2(
            sc, ht_pad, rays, hits, cam.pos),
        "shadow sizing (host syncs)": lambda: r._size_pads(
            sc, sh.sti, sh.smasks, sh.sentries, sh.sc1),
        "C shadow work list + K2 + shade": lambda: r._stage_c(sc, s_pads,
                                                              sh),
    }
    return {k: _mean_ms(fn, r.device, reps) for k, fn in stages.items()}


def run_variant(cfg: Config, variant: str, device: str = "cuda") -> dict:
    """Builds the variant's renderer, sizes and freezes it on the sizing
    camera, settles its buckets on every orbit pose (verify=True) and
    times render_fast over the poses in turn. Returns {"line", "ms",
    "pairs" (scheduled per frame, the mean over the timed frames),
    "gpairs", "sol", "exit_every", "levels", "setup_s", "timed" (the
    cameras timed), "rt", "tb", "renderer"} (and "batched_ms" on config
    1)."""
    from distributed_raytracer_tpu_torch import bench
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.utils import profiling

    kw = dict(VARIANTS[variant])
    if cfg.prebaked is not None and "block_size" in kw:
        raise ValueError(f"{variant}: config {cfg.name}'s bake fixes its "
                         "blocks")
    t0 = time.perf_counter()
    r = CulledRenderer(cfg.scene, cfg.width, cfg.height,
                       prebaked=cfg.prebaked, device=device, **kw)
    bench.settle(r, cfg.poses, cfg.camera)
    bench.sync(device)
    setup_s = time.perf_counter() - t0
    timed = [cfg.poses[k % len(cfg.poses)] for k in range(cfg.frames)]
    times = []
    for cam in timed:
        t0 = time.perf_counter()
        r.render_fast(cam)
        bench.sync(device)
        times.append(time.perf_counter() - t0)
    s = statistics.median(times)
    work = profiling.orbit_work(r, timed, s)
    out = {"ms": s * 1e3, "pairs": work.pairs, "gpairs": work.gpairs_per_sec,
           "sol": work.sol_fraction, "exit_every": r.exit_every,
           "levels": r.n_levels, "setup_s": setup_s, "timed": timed,
           "rt": r.rt, "tb": r.tb, "renderer": r}
    out["line"] = (f"config{cfg.name} {variant}: frame {out['ms']:.3f} ms "
                   f"(median of {cfg.frames}) | pairs "
                   f"{work.pairs / 1e9:.4f} G | "
                   f"{work.gpairs_per_sec:.1f} Gpairs/s | SOL "
                   f"{work.sol_fraction:.4f} of {work.sol_gpairs:.0f} | exit="
                   f"{r.exit_every} | levels={r.n_levels} | setup "
                   f"{setup_s:.1f}s | {cfg.tris} triangles")
    if cfg.name == "1":
        # Host CameraArrays: render_many stacks them and sends them in one
        # copy, inside the timed window.
        cams = [p.to_arrays() for p in cfg.poses]
        r.render_many(cams)
        bench.sync(device)
        reps, t0 = 3, time.perf_counter()
        for _ in range(reps):
            _, counts = r.render_many(cams)
            bench.sync(device)
        bs = (time.perf_counter() - t0) / (reps * len(cams))
        c = counts.cpu().numpy()
        bwork = profiling.FrameWork(
            primary_cells=float(c[:, r.n_levels - 1].mean()),
            shadow_cells=float(c[:, -1].mean()), rays=cfg.width * cfg.height,
            ray_tile=r.rt, tri_block=r.tb, seconds=bs,
            sol_gpairs=work.sol_gpairs)
        out["batched_ms"] = bs * 1e3
        out["line"] += (f" | batched {bs * 1e3:.3f} ms per frame (K="
                        f"{len(cams)}, host cameras: the window holds their "
                        f"upload) SOL {bwork.sol_fraction:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", choices=("1", "3", "4", "5"))
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    names = a.variants or list(DEFAULTS[a.config])
    allowed = CONFIG5_VARIANTS if a.config == "5" else tuple(VARIANTS)
    bad = [v for v in names if v not in allowed]
    if bad:
        ap.error(f"unknown variants for config {a.config}: {bad} (choose "
                 f"from {list(allowed)})")
    if a.device.startswith("cuda"):
        from distributed_raytracer_tpu_torch.tools.schedule_frames import (
            gpu_query)
        print(f"gpu: {gpu_query()}", flush=True)
    t0 = time.perf_counter()
    cfg = build_config(a.config)
    print(f"config{a.config}: {cfg.tris} triangles at {cfg.width}x"
          f"{cfg.height}, scene ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for v in names:
        res = run_variant(cfg, v, a.device)
        print(res["line"], flush=True)
        if a.config == "5" and v == "base":
            for stage, ms in breakdown(res["renderer"], cfg.camera).items():
                print(f"  {stage:40s} {ms:8.3f} ms", flush=True)
        res["renderer"].release_graphs()
        del res
    return 0


if __name__ == "__main__":
    sys.exit(main())
