"""Time the culled multi-rank schedules' frames on CUDA ranks.

    python3 -m distributed_raytracer_tpu_torch.tools.schedule_frames \\
        [--cards N] [--procs P]

Three frames, RANKS ranks each:
  - bands (parallel/render_sharded_bvh.py): instanced_grid(
    icosphere_scene(3), 12), 144 spheres and 184,320 triangles, at
    3840x2160, equal and cost-balanced bands, over BAND_POSES orbit poses;
    every frame against the single-rank CulledRenderer.render_fast frame of
    the same bake (atol 2e-5), and the balanced frame against the equal one
    bit for bit;
  - the culled geometry ring (parallel/ring_bvh.py) and the culled
    geometry halo (parallel/halo_bvh.py): icosphere_scene(8), 1,310,720
    triangles, at 640x480, each against the single-rank CulledRenderer
    frame built from its own bake (atol 2e-5); the halo also with its
    exchange's bytes per frame (`halo_bytes`).
For each frame and for its single-rank reference: the synchronized frame
time (median of FRAMES), and from one torch.profiler window of
PROFILE_FRAMES frames the device's busy share (the union of kernel and
copy time on any card over the window), kernel launches per frame by
class (utils/profiling.kernel_class: K1, K2, K3n, ...) and the host's CUDA
launch calls per frame; the peak device memory of one frame (summed over
the cards).

With --cards 1 (the default) the ranks share cuda:0. With --cards N the
frames are built twice, the ranks all on cuda:0 and one rank per card
(rank i on cuda:(i % N)), and timed in turns: one card, N cards, N cards,
one card. With --procs P the ranks also run in P processes
(parallel/multihost.py, through tools/multihost_worker.py: RANKS / P
ranks each, process i on card i % N, so NCCL when P <= N): one turn in
the middle of each frame's turns (one card, N cards, P processes, N
cards, one card), each process reporting its frame times (every frame
begun at a barrier), its busy share and host launch calls per frame from
its own torch.profiler window, and the bytes it sent to the others; each
frame is checked equal to the in-process frame. Prints one line per
measurement and, last, one JSON line of everything with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

RANKS = 4
BAND_W, BAND_H = 3840, 2160
BAND_GRID = (3, 12)          # instanced_grid(icosphere_scene(3), 12)
BAND_POSES = 4
RING_W, RING_H = 640, 480
RING_SUBDIV = 8              # icosphere_scene(8): 1,310,720 triangles
FRAMES = 5
PROFILE_FRAMES = 2


def gpu_query() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sync_all() -> None:
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def frame_ms(fn, frames: int = FRAMES) -> float:
    """Median wall time of fn() in ms, every card synchronized around each
    call, after one warm-up call."""
    fn()
    sync_all()
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        fn()
        sync_all()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(fn, n: int = PROFILE_FRAMES) -> dict:
    """One torch.profiler window of n calls of fn (profiling.anatomy): the
    busy share of the window (kernels and copies on any card), kernel
    launches and device ms per call by kernel class, and the host's CUDA
    launch calls per call."""
    from distributed_raytracer_tpu_torch.utils import profiling

    a = profiling.anatomy(profiling.profile_events(fn, n), n)
    return {"busy": a["busy"],
            "launches": {k: round(v, 2)
                         for k, v in sorted(a["launches"].items())},
            "device_ms": {k: round(v, 4)
                          for k, v in sorted(a["device_ms"].items())},
            "host_launch_calls": a["host_launch_calls"]}


def peak_mb(fn) -> float:
    """Peak device memory of one call of fn, summed over the cards, MiB."""
    import torch

    sync_all()
    cards = range(torch.cuda.device_count())
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    fn()
    sync_all()
    return sum(torch.cuda.max_memory_allocated(d) for d in cards) / 2**20


def stats(fn) -> dict:
    out = {"ms": frame_ms(fn), **profile(fn), "peak_mb": peak_mb(fn)}
    return out


def stats_line(s: dict) -> str:
    return (f"{s['ms']:.3f} ms per frame (median of {FRAMES}, synchronized); "
            f"busy {s['busy']:.3f} of a {PROFILE_FRAMES}-frame profiler "
            f"window; kernel launches per frame {s['launches']}, device ms "
            f"per frame {s['device_ms']}; {s['host_launch_calls']:.0f} host "
            f"launch calls per frame; peak {s['peak_mb']:.0f} MiB")


def orbit(scene, n: int):
    """n orbit poses about the scene's centre, a tenth of a revolution."""
    import numpy as np

    from distributed_raytracer_tpu_torch.runtime import animation

    radius = float(np.linalg.norm(scene.camera.pos))
    return animation.orbit_camera_path(scene.camera, n, radius=radius,
                                       revolutions=0.1)


def band_scene():
    from distributed_raytracer_tpu_torch.utils import scenes

    sub, k = BAND_GRID
    return scenes.instanced_grid(scenes.icosphere_scene(sub), k)


def build_bands(scene, bake, mesh, poses):
    """(equal, balanced) band renderers over `mesh`, sized on poses[0]."""
    from distributed_raytracer_tpu_torch.parallel import render_sharded_bvh

    make = lambda balance: render_sharded_bvh.make_sharded_culled_renderer(
        None, BAND_W, BAND_H, mesh=mesh, sizing_camera=poses[0],
        prebaked=bake, balance=balance)
    return make(False), make(True)


def check_bands(equal, balanced, refs, poses) -> float:
    """Every pose's equal-band frame within 2e-5 of the single-rank frame,
    the balanced frame equal to it bit for bit; returns the largest
    |diff|."""
    import torch

    worst = 0.0
    for cam, ref in zip(poses, refs):
        e = equal(cam, verify=True)
        b = balanced(cam, verify=True)
        diff = float((e.to(ref.device) - ref).abs().max())
        worst = max(worst, diff)
        check(tuple(e.shape) == (BAND_H, BAND_W, 3) and diff <= 2e-5,
              f"band frame differs from the single-rank frame by {diff}")
        check(bool(torch.equal(b, e)), "balanced frame != equal frame")
    return worst


def single_band_refs(scene, bake, poses, device="cuda:0"):
    """The single-rank CulledRenderer of the bake (render_fast, verified)
    and its frames of the poses."""
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer

    single = CulledRenderer(None, BAND_W, BAND_H, prebaked=bake,
                            device=device)
    single.render(poses[0], block=True)
    single.freeze(poses[0])
    return single, [single.render_fast(c, verify=True) for c in poses]


def ring_scene():
    from distributed_raytracer_tpu_torch.utils import scenes

    return scenes.icosphere_scene(RING_SUBDIV)


def check_ring(ring, ref, cam) -> float:
    """The ring's (or the halo's) verified frame within 2e-5 of `ref`;
    returns the largest |diff|."""
    img = ring.render(cam, verify=True)
    diff = float((img.to(ref.device) - ref).abs().max())
    check(tuple(img.shape) == (RING_H, RING_W, 3) and diff <= 2e-5,
          f"{type(ring).__name__} frame differs from the single-rank frame "
          f"by {diff}")
    return diff


def halo_bytes(halo) -> int:
    """Bytes the halo's collectives move per frame between ranks, counting
    every (source, destination) pair of distinct ranks as a transfer,
    whether the ranks share a card or not: per bounce one all_to_all of
    (t, gid, 32-word row) per ray, per light one all_gather of the 8-word
    queries, the liveness and one all_to_all of a 4-byte bit; one
    all_gather of the exclusion ids; per further bounce one all_gather of
    the reflection rays and their liveness."""
    n, r_loc = halo.n, halo.r_loc
    a2a = lambda words: n * (n - 1) * r_loc * words * 4
    gather = lambda nbytes: n * (n - 1) * r_loc * nbytes
    per_bounce = (a2a(34) + gather(4)
                  + halo.n_lights * (gather(32 + 1) + a2a(1)))
    return ((halo.bounces + 1) * per_bounce
            + halo.bounces * gather(32 + 1))


def procs_turn(spec: str, size, mode: str, procs: int, cards: int,
               ref, extra=()) -> dict:
    """One multi-process turn: `procs` workers (RANKS / procs ranks each,
    process i on card i % cards) render `mode` of `spec`, checked equal to
    the in-process frame `ref` (numpy); per process the median frame ms,
    busy share and host launch calls per frame, and the bytes it sent."""
    import numpy as np

    from distributed_raytracer_tpu_torch.tools import multihost_worker as mw

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "frame")
        reports = mw.launch(
            procs, spec, out, mode, cards=[i % cards for i in range(procs)],
            extra=["--device", "cuda", "--size", f"{size[0]}x{size[1]}",
                   "--ranks-per-process", str(RANKS // procs), "--frames",
                   str(FRAMES), "--profile", *extra], timeout_s=900)
        got = np.load(f"{out}-{mode}.npy")
    diff = float(np.abs(got - ref).max())
    check(bool(np.array_equal(got, ref)),
          f"{procs}-process {mode} frame differs from the in-process frame "
          f"by {diff}")
    runs = [r["modes"][mode] for r in reports]
    return {"backend": reports[0]["backend"],
            "ms": statistics.median(runs[0]["ms"]),
            "ms_per_process": [statistics.median(r["ms"]) for r in runs],
            "busy": [r["busy"] for r in runs],
            "host_launch_calls": [r["host_launch_calls"] for r in runs],
            "bytes_per_frame": [r["bytes_per_frame"] for r in runs],
            "launches": [r["launches"] for r in runs]}


def procs_line(s: dict) -> str:
    return (f"{s['ms']:.3f} ms per frame (median of {FRAMES}, process 0; "
            f"per process {[round(v, 3) for v in s['ms_per_process']]}); "
            f"transport {s['backend']}; busy per process "
            f"{[round(v, 3) for v in s['busy']]}; host launch calls per "
            f"frame per process {[round(v) for v in s['host_launch_calls']]}"
            f"; bytes sent per frame per process {s['bytes_per_frame']}; "
            f"frame launches per process {s['launches']}; equal to the "
            "in-process frame bit for bit")


def _turns(order: list, n_layouts: int, procs):
    """The turn order with the multi-process turn (`procs`, a name or
    None) in the middle."""
    if procs is None:
        return list(order)
    return order[:n_layouts] + [procs] + order[n_layouts:]


def time_bands(layouts: dict, order: list, procs=None) -> dict:
    """The band frames of every layout (name -> mesh), checked, then
    timed in `order`; procs = (P, cards) adds the P-process turn."""
    scene = band_scene()
    t0 = time.perf_counter()
    bake = scene.bake_bvh(block_size=128)
    poses = orbit(scene, BAND_POSES)
    single, refs = single_band_refs(scene, bake, poses)
    print(f"[bands] {scene.num_tris} triangles, {bake[1].num_blocks} "
          f"blocks at {BAND_W}x{BAND_H}: bake and single-rank frames "
          f"{time.perf_counter() - t0:.1f} s")
    built = {}
    for name, mesh in layouts.items():
        t0 = time.perf_counter()
        built[name] = build_bands(scene, bake, mesh, poses)
        worst = check_bands(*built[name], refs, poses)
        print(f"[bands] {name}: built and sized in "
              f"{time.perf_counter() - t0:.1f} s; {BAND_POSES} poses within "
              f"{worst} of the single-rank frame, balanced == equal bit for "
              f"bit; layout {built[name][1].layout()}")
    res = {"single": stats(lambda: single.render_fast(poses[1]))}
    print(f"[bands] single rank: {stats_line(res['single'])}")
    name0, i = next(iter(built)), 0
    for name in _turns(order, len(layouts),
                       procs and f"{procs[0]} processes"):
        if name not in built:
            ref = built[name0][0](poses[1]).cpu().numpy()
            s = procs_turn(f"grid:{BAND_GRID[0]}:{BAND_GRID[1]}",
                           (BAND_W, BAND_H), "sharded-bvh", *procs, ref,
                           extra=["--orbit", str(BAND_POSES)])
            res[f"{name} equal"] = s
            print(f"[bands] {name}, equal: {procs_line(s)}")
            continue
        for kind, r in zip(("equal", "balanced"), built[name]):
            s = stats(lambda: r(poses[1]))
            res[f"{name} {kind} turn {i // len(layouts)}"] = s
            print(f"[bands] {name}, {kind}: {stats_line(s)}")
        i += 1
    return res


def time_geometry(kind: str, layouts: dict, order: list,
                  procs=None) -> dict:
    """The culled `kind` ("ring" or "halo") frames of every layout,
    checked, then timed in `order`; procs = (P, cards) adds the P-process
    turn."""
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.parallel import halo_bvh, ring_bvh

    cls = (halo_bvh.HaloCulledRenderer if kind == "halo"
           else ring_bvh.RingCulledRenderer)
    scene = ring_scene()
    built = {}
    for name, mesh in layouts.items():
        t0 = time.perf_counter()
        built[name] = cls(scene, RING_W, RING_H, mesh=mesh)
        print(f"[{kind}] {name}: {scene.num_tris} triangles, "
              f"{built[name].nb_ext} blocks ({built[name].nb_loc} per rank), "
              f"local levels {built[name].n_levels}: bake, upload and "
              f"sizing {time.perf_counter() - t0:.1f} s")
    single = CulledRenderer(None, RING_W, RING_H,
                            prebaked=next(iter(built.values())).bake,
                            device="cuda:0")
    ref = single.render(scene.camera, block=True)
    single.freeze(scene.camera)
    res = {}
    for name, r in built.items():
        diff = check_ring(r, ref, scene.camera)
        extra = (f"; exchange {halo_bytes(r)} bytes per frame"
                 if kind == "halo" else "")
        print(f"[{kind}] {name}: frame within {diff} of the single-rank "
              f"frame; scheduled pairs {r.scheduled_pairs()}{extra}")
        if kind == "halo":
            res["halo_bytes"] = halo_bytes(r)
    res["single"] = stats(lambda: single.render_fast(scene.camera))
    print(f"[{kind}] single rank: {stats_line(res['single'])}")
    i = 0
    for name in _turns(order, len(layouts),
                       procs and f"{procs[0]} processes"):
        if name not in built:
            ref = next(iter(built.values())).render(
                scene.camera, verify=True).cpu().numpy()
            s = procs_turn(f"icosphere:{RING_SUBDIV}", (RING_W, RING_H),
                           kind, *procs, ref)
            res[name] = s
            print(f"[{kind}] {name}: {procs_line(s)}")
            continue
        r = built[name]
        s = stats(lambda: r.render(scene.camera))
        res[f"{name} turn {i // len(layouts)}"] = s
        print(f"[{kind}] {name}: {stats_line(s)}")
        i += 1
    return res


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1)
    p.add_argument("--procs", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("schedule_frames: CUDA is not available")
    check(torch.cuda.device_count() >= args.cards,
          f"--cards {args.cards}: only {torch.cuda.device_count()} cards")
    from distributed_raytracer_tpu_torch.ops import _build

    card = gpu_query()
    print(f"gpu: {card}; torch {torch.__version__}, "
          f"{torch.cuda.device_count()} cards")
    _build.build_all()
    layouts = {"1 card": ["cuda:0"] * RANKS}
    if args.cards > 1:
        layouts[f"{args.cards} cards"] = [f"cuda:{i % args.cards}"
                                         for i in range(RANKS)]
    check(args.procs >= 1 and RANKS % args.procs == 0,
          f"--procs {args.procs} does not divide {RANKS} ranks")
    order = list(layouts) + list(layouts)[::-1]
    procs = (args.procs, args.cards) if args.procs > 1 else None
    out = {"gpu": card, "ranks": RANKS, "procs": args.procs,
           "bands": time_bands(layouts, order, procs),
           "ring": time_geometry("ring", layouts, order, procs),
           "halo": time_geometry("halo", layouts, order, procs),
           "gpu_after": gpu_query()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
