#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the traversal kernels from csrc/ and runs on cuda:0:

  1. Kernels against their plain PyTorch versions on the paths' real
     inputs, each with exit_every 0 and 32, on the same CUDA tensors: every
     output bit for bit, unvisited tiles included (t compared as int32; the
     kernels are built with -fmad=false and round as the plain versions
     do). Each launch's line gives its live items, pairs, items per
     tile (mean, p99, max over tiles with items), its bound (the pair
     math's FP32 operations over 67 TFLOP/s, or its bytes over 3.35 TB/s,
     whichever is larger) and the kernel's share of it. Kernel times are
     device times: CUDA events around 20 calls queued behind a sleep
     kernel (every launch of a call counted); the synchronized call's
     median of 20 is printed beside them.
     - K1 and K2 (shared origin) on the launches of one 640x480 render() of
       icosphere_scene(6) (81,920 triangles, 3 lights).
     - K1 and K2 (shared origin), K3n and K3a (per-ray origins) on
       utils/trace_cases.edge_case_launch in both origin forms (rays at
       shared vertices and edges, grazing and dead rays, zero rows, ties,
       t = -0.0, exclusion, finite seeds, a tile seeded as hit, t_max at
       the hit, tiles of 0, 1 and more than 4 chunks of items, slots past
       count; per ray, origins on the spheres' surfaces excluding their own
       triangle) at rt 256 and 1024, tb 64 and 128.
     - K3n (per-ray origins) on each of the three nearest launches (bounces
       0, 1, 2) of one depth-2 render_bounced() of the 1920x1080 sphere
       grid (instanced_grid(icosphere_scene(3), 4): 16 mirrored spheres,
       20,480 triangles), K3a (its any-hit twin, which no renderer path
       calls) on the bounce-1 rays with t_max set to K3n's finite hit t,
       and K2 on that frame's largest shadow launch. The plain versions
       take seconds at this size, so their times are medians of 3 (of 1
       for bounces 0 and 2); the JSON line carries bounce 1's K3n.
  2. The 640x480 frame end to end: render(), freeze(), a 16-pose orbit
     through render_fast(verify=True), one render_fast under CUDA's
     sync-debug "error" mode (it must not wait on the device), and the
     first pose on a device="cpu" renderer built from the same bake (the
     plain versions), held to the repository's culled-vs-dense bound:
     max-channel diff > 2/255 on < 0.5% of pixels and mean |diff| < 1e-4.
     The launch counters are reset before this phase; K1 and K2 must be
     > 0 after it.
  2b. The bounced 1920x1080 depth-2 frame of the sphere grid end to end:
     render_bounced() with its per-bounce counts, freeze_bounced(), an
     6-pose orbit through the frozen renderer with verify=True, the frozen
     renderer timed without verify, and one frozen call under sync-debug
     "error". The counters are reset before this phase; per-ray-origin
     nearest (K3n) and K2 launches must be > 0 after it. The frame must
     equal the same frame rendered with the wrappers swapped for their
     plain versions on the card (max |diff| <= 2e-5), and bounces must add
     light: some pixel exceeds the depth-0 frame by > 0.01, none falls
     below it by > 1e-5.
  1c. K4 and K5 (the tensor-core form, use_mxu=True: 3xTF32, not bit-equal)
     against their plain versions on the launches of one 640x480 render()
     of icosphere_scene(6) with use_mxu=True, exit_every 0 and 32, every
     mismatch counted and printed: on rays of visited tiles hit/miss equal
     on all but <= 1 in 1e4 rays; ids equal on all but <= 1 in 1e4 hit rays,
     not counting edge ties (the kernel's and the plain version's triangles
     hit at t within 1e-5 relative: two triangles meeting at an edge, both
     inside the BARY_EPS band, whose order rests on the last bit of t), and
     edge ties on <= 1 in 1e3 hit rays; |t_k - t_p| <= 1e-5 * t_p on every
     hit ray; any-hit flags equal on all but <= 1 in 1e4 rays; unvisited
     tiles left at init. K4 is timed against K1 and K5 against K2 on the
     same work (the launch in the (T, 16) form), medians of 20 calls in the
     order old, new, new, old, and by device time; each line gives the
     tensor-core bound (54 tensor operations per pair at the TF32 peak or
     the 6-operation FP32 epilogue, the larger), the tensor work as issued
     (144 per pair) and the 21-operation FP32 bound, with shares. Then the
     same bounds on utils/trace_cases.edge_case_launch in the tuple form
     (one origin; two origins' scalars stacked over one A, as the all-lights
     shadow launch indexes them) at rt 256 and 512, on the visited rays
     that trace_cases.ambiguous_rays does not set aside (the share set
     aside printed and <= 40%); and K5 on the three shadow launches of one
     use_mxu=True depth-2 render_bounced() of the 1080p sphere grid, each
     timed against K2 on the same work.
  1d. Stage B2's kernel (csrc/shade_prep.cu, shade_prep.prep_tiles)
     against its plain version (prep_tiles_ref) on the 640x480 frame's B2,
     on the bounced 1080p frame's bounce 1 (per-ray viewer, compacted rays
     kept) and on the 3840x2160 frame of instanced_grid(icosphere_scene(3),
     12) (184,320 triangles) at the bucket the 4K cells' frozen frames
     hold, every ray tile (ht_pad = n_tiles, C = 8,294,400): every output
     bit for bit, NaN and inf; device times of both, the byte bound
     (shade_prep.bytes_moved at 3.35 TB/s) and the kernel's share of it.
     The 4K case is the `shade_prep` entry of the kernels line. Every
     main-path phase below counts stage B2's launches beside K1-K5's
     (`shade_prep` in its launches) and requires some.
  2c. The 640x480 frame with use_mxu=True: render(), freeze(), a 16-pose
     orbit through render_fast(verify=True), one render_fast under
     sync-debug "error"; counters reset first, then bsr_nearest_mxu and
     bsr_any_mxu must be > 0 and bsr_nearest, bsr_any 0. Pose 0 within the
     culled-vs-dense bound of the use_mxu=False CUDA frame and of the
     plain-version (CPU) frame; render_fast timed for both forms. Then one
     depth-2 render_bounced of the 1080p sphere grid with use_mxu=True
     (bsr_any_mxu > 0) within the same bound of the use_mxu=False frame.
  2d. The dynamic renderer (DynamicCulledRenderer) on the sphere grid at
     1920x1080, for use_mxu False and True: object 0 orbits through 12
     diffs of orbit_object_diffs with verify on every 8th frame; each frame
     within tests/test_dynamic.py's bound (max-channel diff > 2/255 on
     < 0.5% of pixels, mean |diff| < 1e-3) of render() on a fresh bake of
     the moved scene; a zero diff equals render_fast exactly; one call
     under sync-debug "error"; the counters show the kernel form asked for;
     median frame time per form.
  2e. The frozen frames as CUDA graph replays (ops/frozen_graph.py), each
     with use_mxu False and True: render_fast of the 640x480 frame, the
     bounced 1080p depth-2 frame (freeze_bounced's render) and
     render_dynamic of the 1080p sphere grid (a zero diff, then 8 orbit
     diffs). Each renderer is sized on a pose that sees nothing, so the
     first verify render overflows, recaptures and must equal the sizing
     render (max |diff| <= 2e-5); then every pose's replay equals the same
     stages run eagerly with the same buckets bit for bit (two eager runs
     are compared first: were they to differ, the replay would be held to
     atol 2e-5 and the line says so); a frame held by the caller is
     unchanged after later replays; replays run under sync-debug "error";
     a torch.profiler trace of one replay (no capture, no eager launch:
     the launch counts stay 0) shows K1/K2 (K3n/K2 bounced; K4/K5,
     K3n/K5 with use_mxu) by kernel name. Each line gives the graph and
     eager frame times (synchronized medians), the host's enqueue time of
     each, the graph's memory pool and its capture time. render_many at K = 32
     equals render_fast per pose bit for bit, timed per frame.
  4. The dense, ray-sharded and ring renderers on the sphere grid
     (instanced_grid(icosphere_scene(3), 4): 20,480 triangles, 3 lights) at
     640x480, the ranks all on cuda:0 (n ranks share the card, each with
     its own compute and copy streams).
     4a. K6 and K7 (the ring step kernels) against ring_nearest_ref and
     ring_any_ref on the frame's own primary and shadow rays (recorded from
     one use_rdma=True frame), for n = 1, 2 and 4 ranks: bit for bit on
     every rank (t compared as int32), with the blocks per step launch,
     the tiles whose rays share an origin (K6 folds it into the staged
     rows) and the share of K7's rays with t_max = 0 (the shadow rays of
     primary misses). K6 also on the primary rays with one ray per tile
     nudged off the camera by one ulp (no tile shares an origin: the
     per-ray branch). At n = 4: the kernel transport per query against the
     plain version (median of 10 synchronized calls; the plain version's
     compared call), K6's share of its bound (21 operations per pair on
     tiles that share an origin, 39 elsewhere) and of the 39-operation
     bound, the frame rays against the nudged ones in turns, and from a
     torch.profiler trace of one query the kernel time of one step, the
     copy time of one step and the share of copy time that ran under a
     kernel. Then K6 and K7 on utils/trace_cases.ring_edge_case over 2
     ranks, per-ray origins and all rays from one origin (ties between two
     ids at one t, hits at t = +-0.0, exclusion, misses): bit for bit.
     4b. render_frame (dense, one device), then make_ring_renderer over 4
     ranks with use_rdma=True and use_rdma=False, each held to the ring
     tests' bound against the dense frame (max-channel diff > 2/255 on
     < 0.2% of pixels, mean |diff| < 1e-4); 8 RDMA frames, each
     bit-identical to the first (a missing event wait shows up as a frame
     that changes from run to run); ms per frame of each. The ring launch
     counters are reset before the RDMA frames; K6 and K7 must be > 0.
     4c. make_sharded_renderer over 4 ranks equals render_frame to atol
     2e-5.
  5. The culled multi-rank schedules, RING_N = 4 ranks sharing cuda:0
     (frames and measurements from tools/schedule_frames.py: synchronized
     frame ms, median of 5; from one torch.profiler window of 2 frames
     the busy share, kernel launches per frame by class and host launch
     calls per frame; the peak device memory of one frame).
     5a. Equal and balanced bands (parallel/render_sharded_bvh.py) of
     instanced_grid(icosphere_scene(3), 12) (144 spheres, 184,320
     triangles) at 3840x2160 over 4 orbit poses, each frame within 2e-5
     of the single-rank render_fast frame of the same bake, balanced ==
     equal bit for bit; the launch counters are reset before the bands
     are built and K1, K2 must be > 0 after their first frames (later
     frames are graph replays). Then bounced bands of the 1080p sphere
     grid at depth 2 against the single-rank freeze_bounced frame (atol
     2e-5; K3n and K2 > 0).
     5b. The culled ring (parallel/ring_bvh.py) of icosphere_scene(8)
     (1,310,720 triangles) at 640x480 against the single-rank frame built
     from the ring's own bake (atol 2e-5), launches per frame (K1, K2 >
     0); the 640x480 sphere grid with bounces 2 against the single-rank
     render_bounced (atol 2e-5), one K1, K2 and K3n call recorded on it
     (gid_base != 0, a carried init, the most live items) held bit for
     bit against its plain version and timed; dynamic=True over 2 orbit
     diffs against fresh bakes of the moved scenes (phase 2d's bound).
     5c. The culled halo (parallel/halo_bvh.py) of icosphere_scene(8) at
     640x480: against the single-rank frame built from the halo's own bake
     (atol 2e-5), 8 frames bit-identical to the first (a missing event
     wait in mesh.all_to_all shows as a frame that changes from run to
     run), launches per frame (K1, K2 > 0) and the frame's stats; the
     640x480 sphere grid with bounces 2 against the single-rank
     render_bounced (atol 2e-5), one K3n call recorded on it (gid_base !=
     0, the most live items) held bit for bit against its plain version;
     dynamic=True over 2 orbit diffs against fresh bakes of the moved
     scenes (phase 2d's bound); the dense make_halo_renderer
     (parallel/halo.py) of the sphere grid at 320x240 against render_frame
     (phase 4b's bound).
  2f. One CUDA culled frame of icosphere_scene(3) at 160x120 against the
     float64 oracle (utils/oracle.render_oracle, the port's copy of the
     JAX package's) under the repository's golden tolerance
     (oracle.assert_images_close); the oracle's time is printed.
  6. Multihost (parallel/multihost.py) through
     tools/multihost_worker.py, after the kernels are built: 2 processes
     of 2 ranks each on cuda:0 (over gloo, the only transport two
     processes on one card have; every child bounded by a timeout, killed
     with its stderr printed on a failure): the culled halo of
     icosphere_scene(8) at 640x480 and the equal bands of the 4K sphere
     grid at 3840x2160 at full size, then the culled ring, the balanced
     bands and the bounced bands (depth 2) on the 640x480 sphere grid.
     Each frame equals the single-process 4-rank frame of the same bake on
     the same card bit for bit, with the same buckets, counts and bake
     checksum; every process launched K1 and K2 (K3n and K2 on the
     bounced bands, which trace bounce 0 with K3n too); each frame's time
     beside the single process's, and the bytes that crossed processes. With two or more cards the halo also runs
     with one process per card over NCCL; with one, a line says NCCL was
     not exercised. The children's K1, K2 and K3n launches count in the
     JSON line.
  6b. The command line with --multihost (after phase 3): 2 processes of
     2 ranks on cuda:0, 3 frames of the sphere grid at 320x240 with
     --mode halo and with --mode sharded-bvh --balance: process 0 prints
     the FPS report and writes every frame, process 1 neither.
  3. The command line: the 640x480 sphere written as OBJ + scene.json, 30
     frames through distributed_raytracer_tpu_torch.run.main on cuda; then
     the sphere grid, 8 frames at 1920x1080 with --bounces 2, and 8 with
     --animate-objects; 3 frames at 320x240 with --mode sequential, with
     --mode sharded --devices 4, with --mode sharded-bvh --devices 4
     (with and without --balance), with --mode ring --devices 4 and with
     --mode halo --devices 4 (also with --bounces 2).
  3b. runtime/loop.run_loop at 640x480 over 120 ticks of orbit_events on
     the frozen renderer (verify every 8th frame): no drops, frames shown
     in order, the last equal to render_fast of the final camera, FPS and
     ms per frame; then `python -m distributed_raytracer_tpu_torch ...
     --serve 127.0.0.1:0` as a subprocess: an HTTP client posts key and
     mouse events, waits for 5 frames, fetches /frame.png (a lit 640x480
     PNG) and /stats, posts Esc, and the run must exit 0 with no frame
     dropped.
  7. Config 5 of the JAX bench: icosphere_scene(9) (5,242,880 triangles,
     blocks of 128, a three-level cull) at 640x480, its bake built once
     and cached by tools/bake_cache.py (synthesis, bake and write times
     printed). For 16x16 ray tiles (ray_tile 256, tile_w 16, the bench's
     form) and then the default 32x16 (ray_tile 512): render(), freeze(),
     a 3-pose orbit through render_fast(verify=True), the counters reset
     before and K1, K2 > 0 after; the frame's K1 and K2 launches bit for
     bit against their plain versions (compare_kernel); pose 0 within 2e-5
     of the frame rendered with the plain versions swapped in on the card;
     the counts per level, the sizing pose's scheduled pairs, the stage
     split of render() (tools/config_ab.breakdown), the peak device memory
     the renderer and its frames add, and cull_levels. Then both shapes
     timed in turns (16x16, 32x16, 16x16, 32x16; each turn the
     synchronized median of 10 frames over the poses), with Gpairs/s and
     the share of the H100 roofline (utils/profiling.orbit_work over the
     timed frames' exact counts), and the ratio of their scheduled pairs.
  7b. tools/config_ab.py's per-variant function on config 1 (base,
     rt256sq); a utils/profiling.trace of 3 replays of config 5's 16x16
     frame, read by tools/xprof.py: its top kernels must name K1 and K2,
     and its busy share must be within 0.05 of
     tools/schedule_frames.profile on the same frames (both parse with
     profiling.anatomy, so this shows only that two windows agree). Then,
     in a fresh process (one that holds CUDA graphs can lose kernel
     records from a later profiler window), anatomy against clocks it
     does not read: 3 matmul chains between CUDA events, each followed by
     a 10 ms host sleep; its device ms within 4% of the events', its busy
     share within 0.03 of the events' device time over the host's wall
     time, and its two longest idle gaps each holding a sleep.
  7c. tools/loop_recovery_smoke.run_smoke with its children on cuda:0: a
     healthy pass, then the child SIGKILLed mid-stream and a fresh child
     started by the loop's recover hook: exactly one recovery, two child
     processes in the faulted pass, every later frame equal to the healthy
     pass's bit for bit (each child bounded by a timeout, its stderr
     printed on a failure).
  8a. Configs 4 and 2 of the port's bench at its table's values
     (bench.TABLE: the 12x12 grid at 3840x2160 with rt 1024 and tb 64,
     the example scene at 1920x1080 with depth 2), each run by bench.run
     in this process, then, on its last orbit pose, a sync frame of the
     bench's renderer with its launches recorded: each (K1 and K2, or
     K3n and K2 per bounce) against its plain version on the card, bit
     for bit at exit_every 0 and 32, and the bench's frozen frame against
     the plain-version frame (max |diff| <= 2e-5); its launches count.
  8. The port's bench (python -m distributed_raytracer_tpu_torch.bench,
     all configs, --device cuda) as a child process leading a process
     group of its own (killed with its children at its groups' timeouts
     plus 300 s), after phase 7 so
     config 5 finds the bundle cache warm: exit code 0, exactly one stdout
     line, printed with the bench's stderr lines of its groups and the
     phase's seconds. The line must name the headline metric
     primary_mrays_per_sec_per_chip with a value > 0, hold every config's
     frame time (> 0) and the loop's frames and FPS, no `_error` key,
     every `_pairs_scheduled` > 0, and the card's name and power limit;
     its launch line (all its processes) must show K1, K2 and K3n, and
     its counts join the JSON line's. The expected keys are the bench's
     own (bench.FRAME_KEYS, bench.PAIRS_KEYS).

Prints the versions, the card's name and power limit, the build time and
each kernel's registers and spills, each phase's numbers and seconds, one
JSON line of per-kernel results (launches on the paths, max_abs_err, ms,
plain_ms, bound_ms, bound_by, share_of_bound, library_ms: null, no single
PyTorch call computes any of them) and, last, one JSON line {"ok": true,
"device": {...}}.
Exits non-zero without that line on any failure, when CUDA is not
available, or when run outside the repository; on a failure it first
prints the card's name and power limit and the ECC, retired-page,
remapped-row and Xid lines of `nvidia-smi -q`.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

W, H = 640, 480
SUBDIV = 6          # icosphere_scene(6): 81,920 triangles
ORBIT = 16
REPEATS = 20
PLAIN_REPEATS_BIG = 3
# The bounced path: instanced_grid(icosphere_scene(3), 4) at 1080p, depth 2.
BW, BH, DEPTH = 1920, 1080, 2
GRID_SUBDIV, GRID_N = 3, 4
BOUNCE_ORBIT = 6
DYN_FRAMES = 12
# Phase 4: the ring's rank counts (all on cuda:0) and the RDMA frames.
RING_RANKS = (1, 2, 4)
RING_N = 4
RING_FRAMES = 8
SOURCE = "distributed_raytracer_tpu_torch/csrc/bsr_trace.cu"
RING_SOURCE = "distributed_raytracer_tpu_torch/csrc/ring_trace.cu"
SHADE_SOURCE = "distributed_raytracer_tpu_torch/csrc/shade_prep.cu"
_PALLAS = "distributed_raytracer_tpu/ops/pallas/bsr_trace.py"
_PALLAS_RING = "distributed_raytracer_tpu/ops/pallas/ring_trace.py"
WRAPPERS = ("bsr_nearest", "bsr_any")
RING_WRAPPERS = ("ring_nearest", "ring_any")
# Per kernel (its launch key in utils/tracing.COUNTS): (its id in
# PERF.md's kernel table, its source, the TPU kernel it replaces: none for
# stage B2's, whose JAX version is jnp that XLA fuses).
KERNELS = {
    "bsr_nearest": ("K1", SOURCE, f"{_PALLAS}:356"),
    "bsr_any": ("K2", SOURCE, f"{_PALLAS}:411"),
    "bsr_nearest_rays": ("K3n", SOURCE, f"{_PALLAS}:356"),
    "bsr_any_rays": ("K3a", SOURCE, f"{_PALLAS}:411"),
    "bsr_nearest_mxu": ("K4", SOURCE, f"{_PALLAS}:287"),
    "bsr_any_mxu": ("K5", SOURCE, f"{_PALLAS}:324"),
    "ring_nearest": ("K6", RING_SOURCE, f"{_PALLAS_RING}:57"),
    "ring_any": ("K7", RING_SOURCE, f"{_PALLAS_RING}:57"),
    "shade_prep": ("B2", SHADE_SOURCE, None),
}
# The traversal kernels' launch keys (K1-K5), and with stage B2's.
BSR_KEYS = tuple(k for k in KERNELS if k.startswith("bsr_"))
LAUNCH_KEYS = (*BSR_KEYS, "shade_prep")


def tensor_bytes(x) -> int:
    """Bytes of every tensor in x (a tensor, or a tuple/list of them)."""
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(a) for a in x)
    return x.numel() * x.element_size() if hasattr(x, "numel") else 0


def worklist_stats(args, kwargs, nearest: bool) -> dict:
    """A traversal launch's live items, pairs, items per tile over the
    tiles that have items (torch.bincount of the live tile ids: mean, p99,
    max) and its bound (inputs read once, the outputs written once)."""
    import torch

    from distributed_raytracer_tpu_torch.utils import profiling

    rays, tile_ids, count = args[0], args[3], args[6]
    n = min(int(count.item()), tile_ids.shape[0])
    per = torch.bincount(tile_ids[:n].long())
    per = per[per > 0].double()
    pairs = n * kwargs["rt"] * kwargs["tb"]
    out_bytes = rays.shape[1] * (8 if nearest else 4)
    ms, by = profiling.bound_ms(pairs, kwargs["shared_origin"],
                                tensor_bytes(args) + out_bytes)
    return {"items": n, "pairs": pairs, "tiles": int(per.numel()),
            "mean": float(per.mean()) if n else 0.0,
            "p99": float(torch.quantile(per, 0.99)) if n else 0.0,
            "max": int(per.max()) if n else 0, "bound_ms": ms,
            "bound_by": by}


def stats_line(s: dict) -> str:
    return (f"live items {s['items']} ({s['pairs'] / 1e9:.4f} G pairs) in "
            f"{s['tiles']} tiles; items per tile mean {s['mean']:.2f}, p99 "
            f"{s['p99']:.0f}, max {s['max']}; bound {s['bound_ms']:.4f} ms "
            f"({s['bound_by']})")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_query() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, repeats: int = REPEATS, warmup: int = 2) -> float:
    """Median wall time of `fn()` in ms, synchronized around each call,
    after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, calls: int = REPEATS) -> float:
    """Device time of one `fn()` in ms: CUDA events around `calls` calls
    queued back to back behind a sleep kernel, so the host's enqueue time
    stays out of it (every launch of the call is counted)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def print_ptxas(log: str) -> None:
    """One line per kernel instantiation from nvcc's -Xptxas -v output."""
    name, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            b = lambda x: "true" if x == "1" else "false"
            k = re.search(r"(nearest|any)_chunk_kernelILi(\d+)ELb([01])E",
                          m.group(1))
            x = re.search(r"(nearest|any)_mxu_chunk_kernelILi(\d+)ELi(\d+)E"
                          r"(?:Li(\d+)E)?Li(\d+)E", m.group(1))
            g = re.search(r"ring_(nearest|any)_chunksILi(\d+)E", m.group(1))
            rk = re.search(r"ring_(seed|unpack)_keys", m.group(1))
            sp = re.search(r"shade_prep_tilesILi(\d+)E", m.group(1))
            e = re.search(r"\d(seed_keys|unpack_keys)ILb([01])ELb([01])E",
                          m.group(1))
            name = (f"{k.group(1)}_chunk_kernel<RPT={k.group(2)}, shared="
                    f"{b(k.group(3))}>" if k
                    else f"{x.group(1)}_mxu_chunk_kernel<NT={x.group(2)}, "
                         f"WARPS={x.group(3)}" + (f", PASSES={x.group(4)}"
                                                  if x.group(4) else "")
                         + f", MINB={x.group(5)}>" if x
                    else f"ring_{g.group(1)}_chunks<RPT={g.group(2)}>" if g
                    else rk.group(0) if rk
                    else f"shade_prep_tiles<{sp.group(1)}>" if sp
                    else f"{e.group(1)}<shared={b(e.group(2))}, "
                         f"mxu={b(e.group(3))}>" if e
                    else m.group(1))
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            print(f"  ptxas: {name}: {line.split(':', 1)[-1].strip()}; "
                  f"{spill}")
            name = None


@contextlib.contextmanager
def wrappers_replaced(module, make, names=WRAPPERS):
    """Within the block, module.<name> is make(name, original) for each
    wrapper name; the originals come back afterwards."""
    originals = {name: getattr(module, name) for name in names}
    for name, fn in originals.items():
        setattr(module, name, make(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def recording(bsr_trace, seen: dict):
    """A make() for wrappers_replaced that appends every call's arguments
    to seen[its launch key] and then calls the wrapper."""
    def make(name, fn):
        def call(*args, **kwargs):
            key = bsr_trace.launch_key(name, kwargs["shared_origin"],
                                       mxu=isinstance(args[2], tuple))
            seen.setdefault(key, []).append((args, dict(kwargs)))
            return fn(*args, **kwargs)
        return call
    return make


def plain_versions(bsr_trace):
    """A make() for wrappers_replaced: each wrapper's plain version."""
    return lambda name, fn: getattr(bsr_trace, name + "_ref")


def reset_launches(keys=LAUNCH_KEYS) -> None:
    """Sets the launch counts of `keys` (utils/tracing.COUNTS; default the
    traversal kernels' and stage B2's) to 0."""
    from distributed_raytracer_tpu_torch.utils.tracing import COUNTS

    for key in keys:
        COUNTS[key] = 0


def launch_counts(keys=LAUNCH_KEYS) -> dict:
    """The launches of `keys` since reset_launches (default the traversal
    kernels' (K1-K5) and stage B2's (`shade_prep`))."""
    from distributed_raytracer_tpu_torch.utils.tracing import COUNTS

    return {key: COUNTS[key] for key in keys}


def visited_rays(args, kwargs):
    """(R,) bool: rays of the tiles named by the live work-list slots."""
    import torch

    rays, tile_ids, count = args[0], args[3], args[6]
    rt = kwargs["rt"]
    n = min(int(count.item()), tile_ids.shape[0])
    v = torch.zeros(rays.shape[1] // rt, dtype=torch.bool, device=rays.device)
    v[tile_ids[:n].long()] = True
    return v[:, None].expand(-1, rt).reshape(-1)


def bits_equal(got, want) -> bool:
    """Outputs (a tensor or a tuple) torch.equal, float32 compared as int32
    (so -0.0 and +0.0 differ)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               if g.dtype == torch.float32 else torch.equal(g, w)
               for g, w in zip(got, want))


def compare_kernel(bsr_trace, key, args, kwargs, plain_repeats=REPEATS,
                   tag=None, phase="1"):
    """One kernel against its plain version on (args, kwargs), with
    exit_every 0 and 32: every output bit for bit. Returns {"max_abs_err",
    "ms" (device time of one call, every launch in it), "call_ms" (the
    synchronized call, median of REPEATS), "plain_ms", "bound_ms",
    "bound_by", "share_of_bound", "library_ms" (None: no PyTorch call
    computes it)}."""
    import torch

    name = key.removesuffix("_rays")
    kernel = getattr(bsr_trace, name)
    plain = getattr(bsr_trace, name + "_ref")
    err = 0.0
    for exit_every in (0, 32):
        kw = dict(kwargs, exit_every=exit_every)
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        if name == "bsr_nearest":
            (gt, gi), (wt, wi) = got, want
            bad = int((gi != wi).sum())
            both = torch.isfinite(wt) & (gi == wi)
            diff = (gt - wt).abs()[both]
            e = float(diff.max()) if diff.numel() else 0.0
        else:
            bad = int((got != want).sum())
            e = float((got - want).abs().max())
        check(bad == 0 and bits_equal(got, want),
              f"{tag or key} exit_every={exit_every}: {bad} ids or flags "
              f"differ, t by up to {e}")
        err = max(err, e)
    ms = device_ms(lambda: kernel(*args, **kwargs))
    call_ms = time_ms(lambda: kernel(*args, **kwargs))
    plain_ms = time_ms(lambda: plain(*args, **kwargs),
                       repeats=plain_repeats,
                       warmup=1 if plain_repeats < REPEATS else 2)
    st = worklist_stats(args, kwargs, name == "bsr_nearest")
    share = st["bound_ms"] / ms
    print(f"[phase {phase}] {tag or KERNELS[key][0] + ' ' + key}: "
          f"R={args[0].shape[1]} T={args[2].shape[0]} W={args[3].shape[0]} "
          f"rt={kwargs['rt']} tb={kwargs['tb']} exit_every(path)="
          f"{kwargs.get('exit_every', 0)}; {stats_line(st)}; bit-equal to the "
          f"plain version at exit_every 0 and 32; kernel {ms:.4f} ms "
          f"(device, mean of {REPEATS} calls) = {share:.2%} of its bound, "
          f"{call_ms:.4f} ms synchronized (median of {REPEATS}); plain "
          f"{plain_ms:.4f} ms (median of {plain_repeats})")
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "share_of_bound": share,
            "library_ms": None}


def phase_kernels(renderer, scene, bsr_trace):
    """Phase 1, K1 and K2: the shared-origin kernels against their plain
    versions on the 640x480 frame's real inputs."""
    seen = {}
    with wrappers_replaced(bsr_trace, recording(bsr_trace, seen)):
        renderer.render(scene.camera, block=True)
    check(set(seen) == {"bsr_nearest", "bsr_any"},
          f"recorded launches: {sorted(seen)}")
    return {key: compare_kernel(bsr_trace, key, *seen[key][-1])
            for key in ("bsr_nearest", "bsr_any")}


def phase_edge_cases(bsr_trace) -> None:
    """Phase 1, K1 and K2 (shared origin), K3n and K3a (per-ray origins) on
    utils/trace_cases.edge_case_launch (shared vertices and edges, grazing
    and dead rays, zero rows, ties, t = -0.0, exclusion, finite seeds, a
    tile seeded as hit, t_max at the hit, a tile of more than 4 chunks,
    slots past count; per ray, surface origins excluding their triangle) at
    rt 256 and 1024, tb 64 and 128, exit_every 0 and 32: bit for bit."""
    import torch

    from distributed_raytracer_tpu_torch.utils import trace_cases

    for shared in (True, False):
        ids = ("K1", "K2") if shared else ("K3n", "K3a")
        for rt in (256, 1024):
            for tb in (64, 128):
                L = trace_cases.edge_case_launch(
                    rt, tb, shared_origin=shared).to("cuda")
                for exit_every in (0, 32):
                    kw = dict(L.kwargs, exit_every=exit_every)
                    for k, name, args in (
                            (ids[0], "bsr_nearest", L.nearest_args()),
                            (ids[1], "bsr_any", L.any_args())):
                        got = getattr(bsr_trace, name)(*args, **kw)
                        want = getattr(bsr_trace, name + "_ref")(*args, **kw)
                        check(bits_equal(got, want),
                              f"{k} on the edge cases (rt={rt}, tb={tb}, "
                              f"exit_every={exit_every}) differs")
                n = int(L.count.item())
                print(f"[phase 1] edge cases, {ids[0]} and {ids[1]}, rt={rt} "
                      f"tb={tb}: R={L.rays.shape[1]} T={L.tris.shape[0]} "
                      f"W={L.tile_ids.shape[0]} live items={n}, items per "
                      f"tile {torch.bincount(L.tile_ids[:n].long()).tolist()}"
                      "; bit-equal to the plain versions at exit_every 0 and "
                      "32")


def phase_kernels_rays(renderer, scene, bsr_trace):
    """Phase 1, K3n on the three nearest launches of the bounced 1080p
    frame, K3a on the bounce-1 rays, and K2 on the frame's largest shadow
    launch."""
    import torch

    seen = {}
    with wrappers_replaced(bsr_trace, recording(bsr_trace, seen)):
        renderer.render_bounced(scene.camera, DEPTH, block=True)
    calls = seen.get("bsr_nearest_rays", [])
    check(len(calls) == DEPTH + 1, f"{len(calls)} per-ray-origin nearest "
                                   f"launches for depth {DEPTH}")
    check(renderer._last_bounce_counts[1][renderer.n_levels] > 0,
          "bounce 1 has no hit tiles")
    results = {}
    for bounce, (args, kwargs) in enumerate(calls):
        r = compare_kernel(bsr_trace, "bsr_nearest_rays", args, kwargs,
                           PLAIN_REPEATS_BIG if bounce == 1 else 1,
                           tag=f"K3n bsr_nearest_rays, bounced 1080p frame, "
                               f"bounce {bounce}")
        if bounce == 1:
            results["bsr_nearest_rays"] = r
    args, kwargs = calls[1]
    # K3a: the same rays and exclude ids, t_max = K3n's finite hit t.
    best_t, _ = bsr_trace.bsr_nearest(*args, **kwargs)
    rays = args[0].clone()
    rays[6] = torch.where(torch.isfinite(best_t), best_t, bsr_trace.BIG_TMAX)
    any_args = (rays,) + tuple(args[1:])
    any_kwargs = {k: kwargs[k] for k in ("rt", "tb", "shared_origin",
                                         "exit_every")}
    results["bsr_any_rays"] = compare_kernel(
        bsr_trace, "bsr_any_rays", any_args, any_kwargs, PLAIN_REPEATS_BIG)
    shadows = seen["bsr_any"]
    big = max(range(len(shadows)),
              key=lambda i: int(shadows[i][0][6].item()))
    compare_kernel(bsr_trace, "bsr_any", *shadows[big], PLAIN_REPEATS_BIG,
                   tag=f"K2 bsr_any, bounced 1080p frame, bounce {big}")
    return results


def b2_args(r, camera, bounce: bool, ht_pad=None):
    """shade_prep.prep_tiles' arguments at one frame's stage B2, sized by
    the sync render's host syncs: the primary rays', or with `bounce`
    bounce 1's (reflection rays, each with its own viewer). `ht_pad`, if
    given, replaces the hit count's bucket."""
    from distributed_raytracer_tpu_torch.ops import raygen
    from distributed_raytracer_tpu_torch.ops.frozen_graph import tile_bucket

    sc = r.dev_scene
    cam = raygen.camera_arrays(camera, r.device)
    rays, ti, m, e, c1 = r._stage_a(sc, cam)
    pads, _ = r._size_pads(sc, ti, m, e, c1)
    hits, hcount, _ = r._stage_b1(sc, pads, rays, ti, m, e, c1)
    view = cam.pos
    if bounce:
        sh = r._stage_b2(sc, tile_bucket(int(hcount), r.n_tiles), rays,
                         hits, view, keep_rays=True)
        rays, ti, m, e, c1, excl, view, _ = r._bounce(
            sc, sh, hits, rays.new_ones((3, r.n_pad)))
        pads, _ = r._size_pads(sc, ti, m, e, c1)
        hits, hcount, _ = r._nearest(sc, pads, sc.tris_packed, rays, excl,
                                     ti, m, e, c1)
    ht_pad = ht_pad or tile_bucket(int(hcount), r.n_tiles)
    _, tidx, ht_count, _ = r._tile_order(ht_pad, hits)
    return ((rays, hits, tidx, ht_count, sc.arrays, sc.shade_tbl, view,
             r.cfg), dict(rt=r.rt, keep_rays=bounce))


def tree_bits_equal(got, want) -> bool:
    """Nested NamedTuples of tensors (or None) bits_equal field by field."""
    if isinstance(want, tuple):
        return all(tree_bits_equal(g, w) for g, w in zip(got, want))
    if want is None:
        return got is None
    return (got.shape == want.shape and got.dtype == want.dtype
            and bits_equal(got.contiguous(), want.contiguous()))


def phase_shade_prep(renderer, scene, bounced, grid):
    """Phase 1d: stage B2's kernel (csrc/shade_prep.cu) against its plain
    version on the 640x480 frame's B2, the bounced 1080p frame's bounce 1
    (a per-ray viewer) and the 4K sphere grid's B2 at every ray tile,
    every output bit for bit; device times of both, the kernel's byte
    bound at 3.35 TB/s and its share of it. Returns the kernels line's
    entry: the 4K case's numbers, every case's under "cases"."""
    from distributed_raytracer_tpu_torch.ops import shade_prep
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.utils import scenes

    # The 4K sphere grid of the bench's config 4 (184,320 triangles).
    grid4k = scenes.instanced_grid(scenes.icosphere_scene(GRID_SUBDIV), 12)
    r4k = CulledRenderer(grid4k, 3840, 2160, device="cuda")
    big = "3840x2160 12x12 sphere grid, every ray tile"
    out = {}
    for tag, r, camera, bounce, ht_pad in (
            ("640x480 frame", renderer, scene.camera, False, None),
            (f"bounced {BW}x{BH} frame, bounce 1", bounced, grid.camera,
             True, None),
            (big, r4k, grid4k.camera, False, r4k.n_tiles)):
        args, kw = b2_args(r, camera, bounce, ht_pad)
        got = shade_prep.prep_tiles(*args, **kw)
        want = shade_prep.prep_tiles_ref(*args, **kw)
        check(tree_bits_equal(got, want),
              f"shade_prep_tiles on the {tag} differs from the plain version")
        ms = device_ms(lambda: shade_prep.prep_tiles(*args, **kw))
        plain_ms = device_ms(lambda: shade_prep.prep_tiles_ref(*args, **kw),
                             calls=5)
        ht_pad, n_lights = args[2].shape[0], args[4].light_pos.shape[0]
        nbytes = shade_prep.bytes_moved(n_lights, ht_pad, r.rt, bounce,
                                        bounce)
        bound_ms = nbytes / 3.35e12 * 1e3
        print(f"[phase 1d] B2 shade_prep_tiles, {tag}: ht_pad={ht_pad} "
              f"(hit tiles {int(args[3])}) C={ht_pad * r.rt} L={n_lights} "
              f"rt={r.rt}, bit-equal to the plain version; {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; bound "
              f"{nbytes / (ht_pad * r.rt):.0f} B a ray, {bound_ms:.4f} ms, "
              f"share {bound_ms / ms:.2%}")
        out[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "share_of_bound": bound_ms / ms}
    return {"max_abs_err": 0.0, **out[big], "bound_by": "bytes",
            "library_ms": None, "cases": out}


def phase_frame(renderer, scene, bsr_trace):
    """Phase 2: the frame end to end on the card, against the plain
    versions on the CPU."""
    import numpy as np
    import torch

    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.runtime import animation

    reset_launches()
    render_ms = time_ms(lambda: renderer.render(scene.camera, block=True),
                        repeats=5)
    sync_img = renderer.render(scene.camera, block=True).cpu().numpy()
    counts = renderer._last_counts
    renderer.freeze(scene.camera)
    poses = animation.orbit_camera_path(scene.camera, ORBIT, radius=3.0)
    imgs, fast_ms = [], []
    for cam in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs.append(renderer.render_fast(cam, verify=True))
        torch.cuda.synchronize()
        fast_ms.append((time.perf_counter() - t0) * 1e3)
    nosync_ms = time_ms(lambda: renderer.render_fast(poses[1]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        renderer.render_fast(poses[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[phase 2] render() {render_ms:.3f} ms; render_fast(verify=True) "
          f"median {statistics.median(fast_ms):.3f} ms over {ORBIT} poses; "
          f"render_fast() {nosync_ms:.3f} ms; counts {counts}; pads "
          f"{renderer.buckets()}; exit_every {renderer.exit_every}; "
          f"launches {launches}; block layout {renderer.block_layout}")
    for name in ("bsr_nearest", "bsr_any", "shade_prep"):
        check(launches[name] > 0, f"{name} was not launched on the path")
    for img in imgs:
        check(tuple(img.shape) == (H, W, 3) and bool(img.isfinite().all()),
              "orbit frame shape / finiteness")

    fast0 = renderer.render_fast(scene.camera, verify=True).cpu().numpy()
    check(np.abs(fast0 - sync_img).max() <= 2e-5,
          "render_fast != render on the sizing pose")
    hit = float((sync_img.sum(-1) > 0).mean())
    check(hit > 0.05, f"hit fraction {hit}")

    t0 = time.perf_counter()
    cpu = CulledRenderer(None, W, H, prebaked=(renderer.arrays_host,
                                               renderer.tree), device="cpu")
    want = cpu.render(poses[0]).numpy()
    cpu_s = time.perf_counter() - t0
    got = imgs[0].cpu().numpy()
    diff = np.abs(got - want)
    frac = float((diff.max(-1) > 2 / 255).mean())
    mean = float(diff.mean())
    print(f"[phase 2] pose 0 cuda vs cpu plain versions: max {diff.max()}, "
          f"{frac:.6%} of pixels > 2/255, mean {mean:.3e}; hit fraction "
          f"{hit:.4f}; cpu render {cpu_s:.1f} s")
    check(frac < 0.005 and mean < 1e-4, "cuda frame differs from cpu frame")
    return launches, want


def grid_poses(scene, n: int):
    """An n-pose orbit about the grid's centre (the camera looks at it
    from its distance), a tenth of a revolution: the spheres stay in
    view."""
    import numpy as np

    from distributed_raytracer_tpu_torch.runtime import animation

    radius = float(np.linalg.norm(scene.camera.pos))
    return animation.orbit_camera_path(scene.camera, n, radius=radius,
                                       revolutions=0.1)


def phase_bounced(renderer, scene, bsr_trace):
    """Phase 2b: the bounced 1080p depth-2 frame end to end."""
    import numpy as np
    import torch

    reset_launches()
    bounced_ms = time_ms(
        lambda: renderer.render_bounced(scene.camera, DEPTH, block=True),
        repeats=3, warmup=1)
    sync = renderer.render_bounced(scene.camera, DEPTH, block=True)
    counts = renderer._last_bounce_counts
    t0 = time.perf_counter()
    fast = renderer.freeze_bounced(scene.camera, DEPTH)
    torch.cuda.synchronize()
    freeze_s = time.perf_counter() - t0
    poses = grid_poses(scene, BOUNCE_ORBIT)
    imgs, verify_ms = [], []
    for cam in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs.append(fast(cam, verify=True))
        torch.cuda.synchronize()
        verify_ms.append((time.perf_counter() - t0) * 1e3)
    nosync_ms = time_ms(lambda: fast(poses[1]), repeats=10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fast(poses[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[phase 2b] render_bounced(depth={DEPTH}) {bounced_ms:.3f} ms "
          f"(median of 3); per-bounce counts {counts}; freeze_bounced "
          f"{freeze_s:.2f} s; frozen(verify=True) per frame "
          f"{[round(t, 3) for t in verify_ms]} ms, median "
          f"{statistics.median(verify_ms):.3f}; frozen() "
          f"{nosync_ms:.3f} ms (median of 10); pads {fast.pads()}; "
          f"exit_every {renderer.exit_every}; launches {launches}; "
          f"block layout {renderer.block_layout}")
    for name in ("bsr_nearest_rays", "bsr_any", "shade_prep"):
        check(launches[name] > 0, f"{name} was not launched on the bounced "
                                  "path")
    for img in imgs:
        check(tuple(img.shape) == (BH, BW, 3) and bool(img.isfinite().all())
              and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
              "bounced orbit frame shape / range")

    fast0 = fast(scene.camera, verify=True)
    check(float((fast0 - sync).abs().max()) <= 2e-5,
          "frozen bounced frame != render_bounced on the sizing pose")
    t0 = time.perf_counter()
    with wrappers_replaced(bsr_trace, plain_versions(bsr_trace)):
        plain = renderer.render_bounced(scene.camera, DEPTH, block=True)
    plain_s = time.perf_counter() - t0
    check(renderer._last_bounce_counts == counts,
          "plain-version frame sized different work lists")
    diff = float((sync - plain).abs().max())
    d0 = renderer.render_bounced(scene.camera, 0, block=True)
    gain = (sync - d0).cpu().numpy()
    hit = float(((sync.sum(-1) > 0).float().mean()))
    print(f"[phase 2b] cuda vs plain versions on the card: max |diff| "
          f"{diff} (plain frame {plain_s:.1f} s); bounces vs depth 0: max "
          f"gain {gain.max():.4f}, {int((gain.max(-1) > 0.01).sum())} pixels "
          f"gain > 0.01, min {gain.min():.3e}; hit fraction {hit:.4f}")
    check(diff <= 2e-5, "bounced cuda frame differs from its plain-version "
                        "frame")
    check(gain.max() > 0.01 and gain.min() >= -1e-5,
          "bounces do not add light")
    check(hit > 0.05, f"hit fraction {hit}")
    return launches, sync


def close_frames(what: str, got, want, mean_bound: float = 1e-4,
                 frac_bound: float = 0.005):
    """Checks the culled-vs-dense bound between two (H, W, 3) frames:
    max-channel diff > 2/255 on < `frac_bound` of pixels (0.5%) and mean
    |diff| below `mean_bound`; prints both numbers."""
    import numpy as np

    got = got.cpu().numpy() if hasattr(got, "cpu") else got
    want = want.cpu().numpy() if hasattr(want, "cpu") else want
    diff = np.abs(got - want)
    frac = float((diff.max(-1) > 2 / 255).mean())
    mean = float(diff.mean())
    print(f"  {what}: max {diff.max():.3e}, {frac:.6%} of pixels > 2/255, "
          f"mean {mean:.3e}")
    check(frac < frac_bound and mean < mean_bound, f"{what}: frames differ")
    return frac, mean


def mxu_mismatches(got, want, vis, nearest: bool, keep=None) -> dict:
    """Counts of a tensor-core output against its plain version on the
    visited rays (restricted to `keep` where given): hit/miss, ids (edge
    ties apart: t within 1e-5 relative), the largest relative t gap on hit
    rays, or any-hit flags; and whether unvisited tiles kept init."""
    import torch

    keep = vis if keep is None else vis & keep
    if not nearest:
        return {"rays": int(keep.sum()),
                "flags": int((got != want)[keep].sum()),
                "hits": int(want[keep].sum()),
                "init": bool(torch.equal(got[~vis], want[~vis]))}
    (gt, gi), (pt, pi) = got, want
    hit_p, hit_g = torch.isfinite(pt) & keep, torch.isfinite(gt) & keep
    both = hit_p & hit_g
    rel = torch.where(both, (gt - pt).abs() / pt.abs().clamp_min(1e-30), 0.0)
    idm = both & (gi != pi)
    ties = int((idm & (rel <= 1e-5)).sum())
    return {"rays": int(keep.sum()), "hits": int(hit_p.sum()),
            "hit_miss": int((hit_p != hit_g).sum()), "ties": ties,
            "other": int(idm.sum()) - ties, "rel": float(rel.max()),
            "abs": float((gt - pt).abs()[both].max()) if both.any() else 0.0,
            "init": bool(torch.equal(gi[~vis], pi[~vis])
                         and torch.equal(gt[~vis], pt[~vis]))}


def check_mxu(tag: str, m: dict, nearest: bool) -> None:
    """Phase 1c's bounds (module docstring) on mxu_mismatches' counts."""
    if nearest:
        print(f"{tag}: {m['rays']} rays, {m['hits']} hits; hit/miss differ "
              f"{m['hit_miss']}; ids differ {m['ties'] + m['other']} "
              f"({m['ties']} edge ties, {m['other']} other); max |t_k - t_p| "
              f"/ t_p {m['rel']:.3e}; max |t_k - t_p| {m['abs']}")
        check(m["hit_miss"] * 1e4 <= m["rays"],
              f"{tag}: {m['hit_miss']} hit/miss differences")
        check(m["other"] * 1e4 <= m["hits"], f"{tag}: {m['other']} ids differ")
        check(m["ties"] * 1e3 <= m["hits"], f"{tag}: {m['ties']} edge ties")
        check(m["rel"] <= 1e-5, f"{tag}: t differs by {m['rel']} relative")
    else:
        print(f"{tag}: {m['rays']} rays, {m['hits']} hit in the plain "
              f"version; flags differ {m['flags']}")
        check(m["flags"] * 1e4 <= m["rays"],
              f"{tag}: {m['flags']} any-hit flags differ")
    check(m["init"], f"{tag}: unvisited tiles differ from init")


def compare_mxu(bsr_trace, key, args, kwargs, twin, plain_repeats=REPEATS,
                tag=None):
    """Phase 1c: one tensor-core kernel (K4 or K5) against its plain
    version with exit_every 0 and 32, under the bounds of the module
    docstring; then timed against its CUDA-core twin (K1 or K2) on the same
    work. Returns the kernel's JSON fields and "twin_ms"."""
    import torch

    from distributed_raytracer_tpu_torch.utils import profiling

    name = key.removesuffix("_mxu")
    kernel = getattr(bsr_trace, name)
    plain = getattr(bsr_trace, name + "_ref")
    vis = visited_rays(args, kwargs)
    tag = tag or f"{KERNELS[key][0]} {key}"
    err = 0.0
    for exit_every in (0, 32):
        kw = dict(kwargs, exit_every=exit_every)
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        check_mxu(f"[phase 1c] {tag} exit_every={exit_every}",
                  mxu_mismatches(got, want, vis, name == "bsr_nearest"),
                  name == "bsr_nearest")
        if name == "bsr_nearest":
            both = torch.isfinite(want[0]) & torch.isfinite(got[0])
            e = float((got[0] - want[0]).abs()[both].max()) if both.any() \
                else 0.0
        else:
            e = float((got - want).abs().max())
        err = max(err, e)
    t_args, t_kwargs = twin
    t1 = time_ms(lambda: kernel(*t_args, **t_kwargs))
    m1 = time_ms(lambda: kernel(*args, **kwargs))
    m2 = time_ms(lambda: kernel(*args, **kwargs))
    t2 = time_ms(lambda: kernel(*t_args, **t_kwargs))
    ms = device_ms(lambda: kernel(*args, **kwargs))
    twin_dev = device_ms(lambda: kernel(*t_args, **t_kwargs))
    plain_ms = time_ms(lambda: plain(*args, **kwargs), repeats=plain_repeats,
                       warmup=1 if plain_repeats < REPEATS else 2)
    st = worklist_stats(args, kwargs, name == "bsr_nearest")
    bd = profiling.mxu_bounds(st["pairs"])
    mem_ms = st["bound_ms"] if st["bound_by"] == "bytes" else 0.0
    bound, by = ((bd["tensor"], "operations") if bd["tensor"] >= mem_ms
                 else (mem_ms, "bytes"))
    tw = KERNELS[name][0]
    print(f"[phase 1c] {tag}: R={args[0].shape[1]} W={args[3].shape[0]} "
          f"exit_every(path)={kwargs['exit_every']}; {stats_line(st)}; "
          f"kernel {m1:.4f} / {m2:.4f} ms, {tw} on the same work {t1:.4f} / "
          f"{t2:.4f} ms (order {tw}, {KERNELS[key][0]}, {KERNELS[key][0]}, "
          f"{tw}; synchronized medians of {REPEATS}); device (mean of "
          f"{REPEATS} calls): kernel {ms:.4f} ms, {tw} {twin_dev:.4f} ms; "
          f"bounds: tensor-core {bd['tensor']:.4f} ms ({bd['tensor'] / ms:.2%}"
          f"), as issued {bd['issued']:.4f} ms ({bd['issued'] / ms:.2%}), 21 "
          f"FP32 operations per pair {bd['fp32']:.4f} ms ({bd['fp32'] / ms:.2%}"
          f"); plain {plain_ms:.4f} ms (median of {plain_repeats}); "
          f"max_abs_err {err}")
    return {"max_abs_err": err, "ms": ms, "call_ms": m1,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms, "fp32_bound_ms": bd["fp32"],
            "share_of_fp32_bound": bd["fp32"] / ms, "library_ms": None,
            "twin_ms": twin_dev}


# The tuple-form edge cases: the ulps of their terms to which the tensor
# cores' 3xTF32 direction dots are trusted (utils/trace_cases
# .ambiguous_rays), and the share of visited rays that may be set aside as
# ambiguous (tests/test_torch_bsr_edges.py's bound: the launch aims about
# half its rays at vertices and edges).
MXU_DOT_ULPS = 8
AMBIGUOUS_SHARE = 0.4


def phase_mxu_edge_cases(bsr_trace) -> None:
    """Phase 1c, K4 and K5 on utils/trace_cases.edge_case_launch in the
    tensor-core form (one origin; two origins' scalars stacked over one A)
    at rt 256 and 512, exit_every 0 and 32, against their plain versions
    under the bounds of the 640x480 launches, on the visited rays that
    trace_cases.ambiguous_rays does not set aside: rays whose result rests
    on a BARY_EPS bound, a t tie, t_max or a grazing den to within the
    3xTF32 dots' error (MXU_DOT_ULPS ulps of their terms). The share set
    aside is printed and bounded; every ray of an unvisited tile keeps
    init."""
    import torch

    from distributed_raytracer_tpu_torch.utils import trace_cases

    for rt in (256, 512):
        for origins in (1, 2):
            host = trace_cases.edge_case_launch(rt, 64, mxu_origins=origins)
            amb_near, amb_any = trace_cases.ambiguous_rays(
                host, dot_ulps=MXU_DOT_ULPS)
            L = host.to("cuda")
            vis = L.visited()
            n_vis = int(vis.sum())
            shares = (int((amb_near & vis.cpu()).sum()) / n_vis,
                      int((amb_any & vis.cpu()).sum()) / n_vis)
            what = (f"K4 and K5, tuple-form edge cases, {origins} "
                    f"origin{'s' * (origins > 1)}, rt={rt}")
            print(f"[phase 1c] {what}: R={L.rays.shape[1]} "
                  f"W={L.tile_ids.shape[0]} live items={int(L.count.item())}"
                  f", {n_vis} visited rays; set aside as ambiguous: nearest "
                  f"{shares[0]:.2%}, any hit {shares[1]:.2%}")
            check(max(shares) <= AMBIGUOUS_SHARE, f"{what}: too many rays "
                                                  "set aside")
            for exit_every in (0, 32):
                kw = dict(L.kwargs, exit_every=exit_every)
                for name, args, amb in (
                        ("bsr_nearest", L.nearest_args(), amb_near),
                        ("bsr_any", L.any_args(), amb_any)):
                    got = getattr(bsr_trace, name)(*args, **kw)
                    want = getattr(bsr_trace, name + "_ref")(*args, **kw)
                    torch.cuda.synchronize()
                    check_mxu(f"  {what}, {name} exit_every={exit_every}",
                              mxu_mismatches(got, want, vis,
                                             name == "bsr_nearest",
                                             keep=~amb.to("cuda")),
                              name == "bsr_nearest")


def twin_args(args, kwargs, tris):
    """A tensor-core launch in the (T, 16) form: the same work list on
    `tris` rows, without ablock_ids."""
    return ((args[0], args[1], tris) + tuple(args[3:]),
            {k: v for k, v in kwargs.items() if k != "ablock_ids"})


def phase_kernels_mxu(mxu, renderer, scene, bsr_trace, grid, bounced):
    """Phase 1c: K4 and K5 on the launches of one use_mxu=True 640x480
    render(), their twins the same launches in the (T, 16) form; the
    tuple-form edge cases; K5 on the three shadow launches of one
    use_mxu=True depth-2 render_bounced() of the 1080p sphere grid, against
    K2 on the same work."""
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer

    seen = {}
    with wrappers_replaced(bsr_trace, recording(bsr_trace, seen)):
        mxu.render(scene.camera, block=True)
    check(set(seen) == {"bsr_nearest_mxu", "bsr_any_mxu"},
          f"recorded launches: {sorted(seen)}")
    args, kwargs = seen["bsr_nearest_mxu"][-1]
    folded = bsr_trace.pack_tris_origin(renderer.dev_scene.tris_packed,
                                        args[0][0:3, 0])
    results = {"bsr_nearest_mxu": compare_mxu(
        bsr_trace, "bsr_nearest_mxu", args, kwargs,
        twin_args(args, kwargs, folded))}
    args, kwargs = seen["bsr_any_mxu"][-1]
    results["bsr_any_mxu"] = compare_mxu(
        bsr_trace, "bsr_any_mxu", args, kwargs,
        twin_args(args, kwargs, renderer.dev_scene.lights_scal))
    phase_mxu_edge_cases(bsr_trace)
    gmxu = CulledRenderer(None, BW, BH, prebaked=(bounced.arrays_host,
                                                  bounced.tree),
                          device="cuda", use_mxu=True)
    seen = {}
    with wrappers_replaced(bsr_trace, recording(bsr_trace, seen)):
        gmxu.render_bounced(grid.camera, DEPTH, block=True)
    shadows = seen.get("bsr_any_mxu", [])
    check(len(shadows) == DEPTH + 1, f"{len(shadows)} K5 launches for depth "
                                     f"{DEPTH}")
    for bounce, (args, kwargs) in enumerate(shadows):
        compare_mxu(bsr_trace, "bsr_any_mxu", args, kwargs,
                    twin_args(args, kwargs, bounced.dev_scene.lights_scal),
                    PLAIN_REPEATS_BIG,
                    tag=f"K5 bsr_any_mxu, bounced 1080p frame, bounce "
                        f"{bounce}")
    return results


def phase_frame_mxu(mxu, renderer, scene, bsr_trace, plain0):
    """Phase 2c: the 640x480 frame end to end with use_mxu=True, against
    the use_mxu=False CUDA frame and the plain-version frame of pose 0."""
    import torch

    from distributed_raytracer_tpu_torch.runtime import animation

    reset_launches()
    render_ms = time_ms(lambda: mxu.render(scene.camera, block=True),
                        repeats=5)
    mxu.freeze(scene.camera)
    poses = animation.orbit_camera_path(scene.camera, ORBIT, radius=3.0)
    imgs, fast_ms = [], []
    for cam in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs.append(mxu.render_fast(cam, verify=True))
        torch.cuda.synchronize()
        fast_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mxu.render_fast(poses[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[phase 2c] use_mxu=True: render() {render_ms:.3f} ms; "
          f"render_fast(verify=True) median {statistics.median(fast_ms):.3f} "
          f"ms over {ORBIT} poses; counts {mxu._last_counts}; pads "
          f"{mxu.buckets()}; exit_every {mxu.exit_every}; launches "
          f"{launches}")
    for name in ("bsr_nearest_mxu", "bsr_any_mxu", "shade_prep"):
        check(launches[name] > 0, f"{name} was not launched on the path")
    for name in ("bsr_nearest", "bsr_any"):
        check(launches[name] == 0, f"{name} launched under use_mxu=True")
    for img in imgs:
        check(tuple(img.shape) == (H, W, 3) and bool(img.isfinite().all()),
              "orbit frame shape / finiteness")
    close_frames("pose 0, use_mxu=True vs the plain versions (cpu)",
                 imgs[0], plain0)
    close_frames("pose 0, use_mxu=True vs use_mxu=False on cuda", imgs[0],
                 renderer.render_fast(poses[0], verify=True))
    # render_fast of both forms at one pose, in turns.
    old1 = time_ms(lambda: renderer.render_fast(poses[1]))
    new1 = time_ms(lambda: mxu.render_fast(poses[1]))
    new2 = time_ms(lambda: mxu.render_fast(poses[1]))
    old2 = time_ms(lambda: renderer.render_fast(poses[1]))
    print(f"[phase 2c] render_fast() at pose 1, medians of {REPEATS}: "
          f"use_mxu=False {old1:.3f} / {old2:.3f} ms, use_mxu=True "
          f"{new1:.3f} / {new2:.3f} ms (order False, True, True, False)")
    return launches


def phase_bounced_mxu(grid, bounced, bsr_trace, sync_k2):
    """Phase 2c, bounced: one depth-2 render_bounced of the 1080p sphere
    grid with use_mxu=True against the use_mxu=False frame."""
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer

    mxu = CulledRenderer(None, BW, BH, prebaked=(bounced.arrays_host,
                                                 bounced.tree),
                         device="cuda", use_mxu=True)
    mxu.render_bounced(grid.camera, DEPTH, block=True)   # warm-up
    reset_launches()
    t0 = time.perf_counter()
    img = mxu.render_bounced(grid.camera, DEPTH, block=True)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    print(f"[phase 2c] bounced 1080p depth {DEPTH}, use_mxu=True: "
          f"render_bounced {secs * 1e3:.3f} ms; per-bounce counts "
          f"{mxu._last_bounce_counts}; launches {launches}")
    check(launches["bsr_any_mxu"] > 0 and launches["bsr_nearest_rays"] > 0
          and launches["bsr_any"] == 0, "bounced use_mxu=True launches")
    close_frames("bounced, use_mxu=True vs use_mxu=False", img, sync_k2)
    return launches


def moved_grid(grid, diff):
    """The grid scene with the diff's object positions, for a fresh
    bake."""
    import copy

    import numpy as np

    m = copy.deepcopy(grid)
    for o, pos in zip(m.objects, diff.obj_pos):
        o.pos = np.asarray(pos, np.float64)
    m.light_pos = np.asarray(diff.light_pos, np.float64)
    return m


def phase_dynamic(grid, bsr_trace):
    """Phase 2d: DynamicCulledRenderer on the 1080p sphere grid for both
    kernel forms, against fresh bakes of every moved scene."""
    import numpy as np
    import torch

    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.ops.render_dynamic import (
        DynamicCulledRenderer)
    from distributed_raytracer_tpu_torch.runtime import animation

    diffs = animation.orbit_object_diffs(grid, DYN_FRAMES)
    t0 = time.perf_counter()
    refs = []
    for d in diffs:
        m = moved_grid(grid, d)
        refs.append(CulledRenderer(m, BW, BH, device="cuda").render(
            m.camera, block=True).cpu().numpy())
    print(f"[phase 2d] {DYN_FRAMES} fresh bakes + render() of the moved "
          f"scenes: {time.perf_counter() - t0:.1f} s")
    launches = {}
    for use_mxu in (False, True):
        dyn = DynamicCulledRenderer(grid, BW, BH, device="cuda",
                                    use_mxu=use_mxu)
        dyn.render(grid.camera, block=True)
        dyn.freeze(grid.camera)
        reset_launches()
        imgs, ms = [], []
        for k, d in enumerate(diffs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs.append(dyn.render_dynamic(grid.camera, d,
                                           verify=(k % 8 == 0)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        zero = dyn.render_dynamic(grid.camera, grid.make_diff())
        static = dyn.render_fast(grid.camera)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dyn.render_dynamic(grid.camera, diffs[3])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        got = launch_counts()
        worst = (0.0, 0.0)
        for k, img in enumerate(imgs):
            diff = np.abs(img.cpu().numpy() - refs[k])
            frac = float((diff.max(-1) > 2 / 255).mean())
            mean = float(diff.mean())
            worst = (max(worst[0], frac), max(worst[1], mean))
            check(frac < 0.005 and mean < 1e-3,
                  f"dynamic frame {k} (use_mxu={use_mxu}) differs from its "
                  f"fresh bake: {frac:.6%} of pixels > 2/255, mean {mean}")
        print(f"[phase 2d] use_mxu={use_mxu}: render_dynamic per frame "
              f"{[round(t, 3) for t in ms]} ms, median "
              f"{statistics.median(ms):.3f} ms (verify on frames 0, 8); "
              f"worst frame vs fresh bake: {worst[0]:.6%} of pixels > "
              f"2/255, mean {worst[1]:.3e}; pads {dyn.buckets()}; "
              f"launches {got}; block layout {dyn.block_layout}")
        check(bool(torch.equal(zero, static)),
              "zero diff differs from render_fast")
        want, other = (("bsr_nearest_mxu", "bsr_any_mxu"),
                       ("bsr_nearest", "bsr_any"))[::1 if use_mxu else -1]
        for name in want + ("shade_prep",):
            check(got[name] > 0, f"{name} not launched (use_mxu={use_mxu})")
        for name in other:
            check(got[name] == 0, f"{name} launched (use_mxu={use_mxu})")
        for key, n in got.items():
            launches[key] = launches.get(key, 0) + n
    return launches


# Phase 2e: the frozen frames as CUDA graph replays.
GRAPH_MANY = 32          # render_many's batch
GRAPH_POSES = 8          # orbit poses per frame kind
# The kernel classes (tools/kernel_ab's, by kernel name) a replay of each
# frame kind must show in a profiler trace, per use_mxu.
GRAPH_KERNELS = {("fast", False): ("K1", "K2"), ("fast", True): ("K4", "K5"),
                 ("bounced", False): ("K3n", "K2"),
                 ("bounced", True): ("K3n", "K5"),
                 ("dynamic", False): ("K1", "K2"),
                 ("dynamic", True): ("K4", "K5")}


def traced_kernels(fn) -> dict:
    """{kernel name: launches} with device time in a profiler trace of
    fn()."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_time_total > 0
            and str(getattr(e, "device_type", "CUDA")).endswith("CUDA")}


def enqueue_ms(fn, repeats: int = REPEATS) -> float:
    """Median host time of fn() in ms from an idle card to its return
    (what the host spends enqueueing; the card may still be busy)."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_case(tag, r, kind, use_mxu, items, replay, eager, sync):
    """Phase 2e on one frozen frame kind: renderer r, its buckets sized on
    a pose that sees nothing (frozen_on_nothing), so that items[0]
    overflows them; replay(item, verify) runs the frozen frame
    (a graph replay), eager(item) the same stages with the same buckets
    eagerly, sync(item) the exactly sized render. Returns the times."""
    import torch

    from distributed_raytracer_tpu_torch.ops import bsr_trace, frozen_graph
    from distributed_raytracer_tpu_torch.utils.profiling import kernel_class

    counts = frozen_graph.COUNTS
    # Forced small buckets: the verify loop overflows, recaptures and
    # comes back equal to the sizing render.
    pads0 = str(r.buckets() if kind != "bounced" else replay.pads())
    caps = counts["captures"]
    first = replay(items[0], True)
    pads1 = str(r.buckets() if kind != "bounced" else replay.pads())
    recaptures = counts["captures"] - caps - 1
    check(pads1 != pads0 and recaptures >= 1,
          f"{tag}: small buckets did not overflow and recapture")
    err = float((first - sync(items[0])).abs().max())
    check(err <= 2e-5, f"{tag}: overflowed frame differs from the sizing "
                       f"render by {err}")
    for it in items:                 # settle the buckets on every pose
        replay(it, True)
    graph = r._graphs[kind]
    key, caps = graph.key, counts["captures"]
    # Two eager runs first: replay must equal eager bit for bit where the
    # eager stages are themselves deterministic.
    e1 = [eager(it) for it in items]
    e2 = [eager(it) for it in items]
    deterministic = all(bits_equal(a, b) for a, b in zip(e1, e2))
    got = [replay(it, False) for it in items]
    worst = max(float((g - e).abs().max()) for g, e in zip(got, e1))
    equal = all(bits_equal(g, e) for g, e in zip(got, e1))
    if deterministic:
        check(equal, f"{tag}: a replay differs from the eager frame "
                     f"(max |diff| {worst})")
    else:
        worst_e = max(float((a - b).abs().max()) for a, b in zip(e1, e2))
        print(f"[phase 2e] {tag}: two eager runs differ (max |diff| "
              f"{worst_e}): held to atol 2e-5")
        check(worst <= 2e-5, f"{tag}: replay vs eager max |diff| {worst}")
    check(graph.key == key and counts["captures"] == caps,
          f"{tag}: a replay at settled buckets recaptured")
    held = got[0].clone()
    replay(items[1], False)
    replay(items[2], False)
    torch.cuda.synchronize()
    check(bool(torch.equal(got[0], held)),
          f"{tag}: a held frame changed under later replays")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for it in items[:2]:
            replay(it, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reset_launches()
    replays = counts["replays"]
    traced = traced_kernels(lambda: replay(items[1], False))
    seen = {kernel_class(k) for k in traced}
    want = GRAPH_KERNELS[(kind, use_mxu)]
    check(all(k in seen for k in want),
          f"{tag}: kernels {want} not in the replay's trace {sorted(seen)}")
    check(sum(launch_counts().values()) == 0
          and counts["replays"] == replays + 1
          and counts["captures"] == caps,
          f"{tag}: the profiled frame was not one replay")
    eager_traced = traced_kernels(lambda: eager(items[1]))
    differ = {k: (traced.get(k, 0), eager_traced.get(k, 0))
              for k in set(traced) | set(eager_traced)
              if traced.get(k, 0) != eager_traced.get(k, 0)}
    out = {"graph_ms": time_ms(lambda: replay(items[1], False)),
           "eager_ms": time_ms(lambda: eager(items[1])),
           "graph_enqueue_ms": enqueue_ms(lambda: replay(items[1], False)),
           "eager_enqueue_ms": enqueue_ms(lambda: eager(items[1])),
           "pool_bytes": graph.pool_bytes, "capture_ms": graph.capture_ms}
    print(f"[phase 2e] {tag}: {len(items)} poses, replay == eager bit for "
          f"bit: {equal} (max |diff| {worst}; eager runs deterministic: "
          f"{deterministic}); small buckets {pads0} overflowed, "
          f"{recaptures} recapture(s), frame within {err} of the sizing "
          f"render; held frame unchanged; sync-debug \"error\" replays "
          f"ok; replay trace shows {sorted(seen)}, "
          f"{sum(traced.values())} kernel launches against the eager "
          f"frame's {sum(eager_traced.values())} (names whose counts "
          f"differ, replay / eager: {differ}); synchronized median "
          f"graph {out['graph_ms']:.3f} ms, eager {out['eager_ms']:.3f} "
          f"ms; host enqueue graph {out['graph_enqueue_ms']:.3f} ms, eager "
          f"{out['eager_enqueue_ms']:.3f} ms; graph pool "
          f"{graph.pool_bytes / 2**20:.1f} MiB, capture "
          f"{graph.capture_ms:.1f} ms")
    return out


def phase_graphs(renderer, scene, bounced, grid):
    """Phase 2e: render_fast (640x480), freeze_bounced's render (1080p,
    depth 2) and render_dynamic (1080p) as CUDA graph replays, use_mxu
    False and True, each against its eager stages; render_many at K = 32
    against render_fast."""
    import torch

    from distributed_raytracer_tpu_torch.ops import raygen
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.ops.render_dynamic import (
        DynamicCulledRenderer)
    from distributed_raytracer_tpu_torch.runtime import animation

    dev = torch.device("cuda")
    poses = animation.orbit_camera_path(scene.camera, GRAPH_POSES,
                                        radius=3.0)
    gposes = grid_poses(grid, GRAPH_POSES)
    diffs = animation.orbit_object_diffs(grid, GRAPH_POSES)
    out = {}
    for use_mxu in (False, True):
        r = CulledRenderer(None, W, H, prebaked=(renderer.arrays_host,
                                                 renderer.tree),
                           device=dev, use_mxu=use_mxu)
        frozen_on_nothing(r, scene.camera, lambda away: r.freeze(away))
        fast = lambda cam, v: r.render_fast(cam, verify=v)
        out[("fast", use_mxu)] = graph_case(
            f"render_fast 640x480 use_mxu={use_mxu}", r, "fast", use_mxu,
            [scene.camera] + poses, fast,
            lambda cam: r._full(r.dev_scene, r.buckets(),
                                raygen.camera_arrays(cam, dev))[0],
            lambda cam: r.render(cam, block=True))
        many = animation.orbit_camera_path(scene.camera, GRAPH_MANY,
                                           radius=3.0)
        for cam in many:                 # buckets that hold every pose
            r.render_fast(cam, verify=True)
        imgs, counts = r.render_many(many)
        fits = bool((counts <= torch.tensor(r.buckets(),
                                            device=dev)).all())
        check(fits, f"render_many counts overflow the buckets (use_mxu="
                    f"{use_mxu})")
        for k, cam in enumerate(many):
            check(bits_equal(imgs[k], r.render_fast(cam)),
                  f"render_many frame {k} != render_fast (use_mxu="
                  f"{use_mxu})")
        many_ms = time_ms(lambda: r.render_many(many), repeats=5) / len(many)
        out[("fast", use_mxu)]["many_ms"] = many_ms
        print(f"[phase 2e] render_many K={GRAPH_MANY} 640x480 use_mxu="
              f"{use_mxu}: every frame == render_fast bit for bit; counts "
              f"fit the buckets; {many_ms:.3f} ms per frame "
              f"(synchronized batch, median of 5)")

        b = CulledRenderer(None, BW, BH, prebaked=(bounced.arrays_host,
                                                   bounced.tree),
                           device=dev, use_mxu=use_mxu)
        fb = frozen_on_nothing(b, grid.camera,
                               lambda away: b.freeze_bounced(away, DEPTH))
        out[("bounced", use_mxu)] = graph_case(
            f"bounced 1080p depth {DEPTH} use_mxu={use_mxu}", b, "bounced",
            use_mxu, [grid.camera] + gposes, _with_pads(fb),
            lambda cam: b._full_bounced(fb.pads(),
                                        raygen.camera_arrays(cam, dev))[0],
            lambda cam: b.render_bounced(cam, DEPTH, block=True))

        d = DynamicCulledRenderer(grid, BW, BH, device=dev, use_mxu=use_mxu)
        frozen_on_nothing(d, grid.camera, lambda away: d.freeze(away))
        cam_d = raygen.camera_arrays(grid.camera, dev)
        out[("dynamic", use_mxu)] = graph_case(
            f"render_dynamic 1080p use_mxu={use_mxu}", d, "dynamic",
            use_mxu, [grid.make_diff()] + diffs,
            lambda diff, v: d.render_dynamic(grid.camera, diff, verify=v),
            lambda diff: d._full(d._apply_diff(d._diff_views(
                raygen.to_device(d._diff_packed(diff), dev))),
                d.buckets(), cam_d)[0],
            lambda diff: d.render(grid.camera, block=True))
        for x in (r, b, d):
            x.release_graphs()
    return out


def frozen_on_nothing(r, real, freeze):
    """Settles r's exit_every on the real pose, then returns freeze(away)
    for a pose that sees nothing (the real one turned around): the
    buckets come out at their floor, and the real pose overflows them."""
    r.render(real, block=True)
    r._exit_auto = False
    away = real.yaw(3.14159)
    r.render(away, block=True)
    return freeze(away)


def _with_pads(fb):
    """freeze_bounced's render as replay(cam, verify), with its pads()."""
    replay = lambda cam, v: fb(cam, verify=v)
    replay.pads = fb.pads
    return replay


def ring_renderer(arrays, n: int, use_rdma: bool):
    """make_ring_renderer over n ranks that all share cuda:0."""
    from distributed_raytracer_tpu_torch.parallel import ring

    return ring.make_ring_renderer(ring.pad_for_ring(arrays, n), W, H,
                                   mesh=["cuda:0"] * n, use_rdma=use_rdma)


def record_ring(render, cam, ring_trace) -> dict:
    """{wrapper: (args, kwargs)} of the ring kernels' calls in one frame."""
    seen = {}

    def make(name, fn):
        def call(*args, **kwargs):
            seen[name] = (args, dict(kwargs))
            return fn(*args, **kwargs)
        return call

    with wrappers_replaced(ring_trace, make, RING_WRAPPERS):
        render(cam)
    return seen


def outputs_equal(got, want) -> bool:
    """Per-rank lists (or tuples of lists) of tensors, all torch.equal,
    float32 compared as int32 (so -0.0 and +0.0 differ)."""
    if isinstance(got, tuple):
        return all(outputs_equal(g, w) for g, w in zip(got, want))
    return all(bits_equal(g, w) for g, w in zip(got, want))


def ring_trace_profile(fn):
    """Runs fn() once under torch.profiler; returns (mean kernel ms, mean
    copy ms, share of copy time under a kernel, kernel count, copy count),
    or None when the trace holds no device kernels."""
    import torch

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel"
               and re.search(r"ring_(nearest|any)_chunks", e.get("name", ""))]
    copies = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_memcpy"]
    if not kernels:
        return None
    under = 0.0
    for c0, c1 in copies:
        # Union of the kernel intervals that meet the copy.
        spans = sorted((max(c0, k0), min(c1, k1)) for k0, k1 in kernels
                       if k0 < c1 and k1 > c0)
        end = c0
        for a, b in spans:
            a = max(a, end)
            if b > a:
                under += b - a
                end = b
    copy_total = sum(b - a for a, b in copies)
    k_ms = statistics.mean(b - a for a, b in kernels) / 1e3
    c_ms = statistics.mean(b - a for a, b in copies) / 1e3 if copies else 0.0
    share = under / copy_total if copy_total else 0.0
    return k_ms, c_ms, share, len(kernels), len(copies)


def shared_origin_tiles(rays, rt: int):
    """(tiles,) bool: every ray of the tile has the tile's first ray's
    origin, bit for bit (K6's vote, csrc/ring_trace.cu)."""
    import torch

    o = rays[0:3].view(torch.int32).reshape(3, -1, rt)
    return (o == o[:, :, :1]).all(dim=2).all(dim=0)


def nudged(rays, rt: int):
    """The rays with one ray per tile (a different lane in each) moved off
    the tile's origin by one ulp of x: no tile's vote holds."""
    import torch

    x = rays.clone()
    tiles = x.shape[1] // rt
    idx = (torch.arange(tiles, device=x.device) * rt
           + torch.arange(tiles, device=x.device) % rt)
    x[0, idx] = torch.nextafter(x[0, idx], torch.full_like(x[0, idx],
                                                           float("inf")))
    return x


def ring_step_blocks(rays, tris, rt: int, chunk: int) -> int:
    """Blocks of one rank's step launch: (ray tile, 128-row block) items
    over `chunk` items per block."""
    items = (rays.shape[1] // rt) * (tris.shape[0] // 128)
    return -(-items // chunk)


def ring_bound(name: str, args, kwargs):
    """(bound ms, "operations" or "bytes", the 39-operation bound ms,
    pairs) of one ring query: every resident ray against every shard's
    triangles, 21 operations per pair for K6 tiles whose rays share an
    origin (the fold) and 39 otherwise; inputs read once, outputs written
    once."""
    from distributed_raytracer_tpu_torch.utils import profiling

    rays, tris, rt = args[1], args[2], kwargs["rt"]
    t_all = sum(x.shape[0] for x in tris)
    pairs = sum(x.shape[1] for x in rays) * t_all
    shared = (sum(int(shared_origin_tiles(x, rt).sum()) for x in rays) * rt
              * t_all if name == "ring_nearest" else 0)
    ops_ms = lambda p, form: (p * profiling.OPS_PER_PAIR[form]
                              / profiling.PEAK_FP32 * 1e3)
    out_bytes = sum(x.shape[1] for x in rays) * (
        8 if name == "ring_nearest" else 4)
    mem = (tensor_bytes(args[1:4]) + out_bytes) / profiling.PEAK_BYTES * 1e3
    ops = ops_ms(shared, True) + ops_ms(pairs - shared, False)
    bound, by = (ops, "operations") if ops >= mem else (mem, "bytes")
    return bound, by, ops_ms(pairs, False), pairs


def check_ring(ring_trace, name: str, args, kwargs, what: str):
    """One ring query, kernel against plain version on the same inputs,
    every output bit for bit; returns (the plain outputs, plain ms)."""
    import torch

    got = getattr(ring_trace, name)(*args, **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = getattr(ring_trace, name + "_ref")(*args, **kwargs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(outputs_equal(got, want),
          f"{name} ({what}) differs from its plain version")
    return want, plain_ms


def phase_ring_kernels(grid, ring_trace):
    """Phase 4a: K6 and K7 against their plain versions on the frame's own
    rays for n = 1, 2, 4 ranks on cuda:0, K6 also on the primary rays with
    one ray per tile nudged (the per-ray branch); timed at n = RING_N; then
    the edge cases over 2 ranks."""
    import torch

    arrays = grid.bake()
    results = {}
    for n in RING_RANKS:
        render = ring_renderer(arrays, n, use_rdma=True)
        seen = record_ring(render, grid.camera, ring_trace)
        check(set(seen) == set(RING_WRAPPERS), f"recorded {sorted(seen)}")
        for name in RING_WRAPPERS:
            args, kwargs = seen[name]
            kernel = getattr(ring_trace, name)
            want, plain_ms = check_ring(ring_trace, name, args, kwargs,
                                        f"n={n}")
            rays, rt = args[1], kwargs["rt"]
            hits = (sum(int(torch.isfinite(t).sum()) for t in want[0])
                    if name == "ring_nearest"
                    else sum(int(h.sum()) for h in want))
            shared = sum(int(shared_origin_tiles(x, rt).sum()) for x in rays)
            line = (f"[phase 4a] {KERNELS[name][0]} {name} n={n}: "
                    f"{n} x R_loc={rays[0].shape[1]} rays, T_loc="
                    f"{args[2][0].shape[0]}, rt={rt}; "
                    f"{ring_step_blocks(rays[0], args[2][0], rt, ring_trace.CHUNK)}"
                    f" blocks per step launch (chunk {ring_trace.CHUNK}); "
                    f"{shared} of {n * rays[0].shape[1] // rt} tiles share "
                    f"an origin; bit-equal to the plain version on every "
                    f"rank; {'hits' if name == 'ring_nearest' else 'occluded'}"
                    f" {hits}")
            if name == "ring_any":
                zero = sum(int((x[6] == 0).sum()) for x in rays)
                total = sum(x.shape[1] for x in rays)
                line += (f"; rays with t_max = 0: {zero} of {total} "
                         f"({zero / total:.2%})")
            if n == RING_N:
                ms = time_ms(lambda: kernel(*args, **kwargs), repeats=10)
                prof = ring_trace_profile(lambda: kernel(*args, **kwargs))
                if prof is None:
                    line += ("; profile: no device kernels in the trace "
                             "(step and copy times not measured)")
                else:
                    k_ms, c_ms, share, nk, nc = prof
                    line += (f"; step kernel {k_ms:.4f} ms (mean of {nk}), "
                             f"step copy {c_ms:.4f} ms (mean of {nc}), "
                             f"{share:.1%} of copy time under a kernel")
                b_ms, b_by, b39, pairs = ring_bound(name, args, kwargs)
                line += (f"; transport {ms:.3f} ms per query (median of 10),"
                         f" plain {plain_ms:.3f} ms (the compared call); "
                         f"{pairs / 1e9:.3f} G pairs, bound {b_ms:.4f} ms "
                         f"({b_by}), {b_ms / ms:.2%} of it; 39-operation "
                         f"bound {b39:.4f} ms, {b39 / ms:.2%} of it")
                results[name] = {"max_abs_err": 0.0, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by,
                                 "share_of_bound": b_ms / ms,
                                 "library_ms": None}
            print(line)
        # The per-ray branch: no tile of these rays shares an origin.
        args, kwargs = seen["ring_nearest"]
        moved = [nudged(x, kwargs["rt"]) for x in args[1]]
        check(not any(bool(shared_origin_tiles(x, kwargs["rt"]).any())
                      for x in moved), "a nudged tile still shares an origin")
        moved_args = (args[0], moved) + tuple(args[2:])
        check_ring(ring_trace, "ring_nearest", moved_args, kwargs,
                   f"n={n}, one ray per tile nudged")
        line = (f"[phase 4a] K6 ring_nearest n={n}, one ray per tile "
                f"nudged (no tile shares an origin): bit-equal to the plain "
                f"version on every rank")
        if n == RING_N:
            fold = lambda: ring_trace.ring_nearest(*args, **kwargs)
            rays_form = lambda: ring_trace.ring_nearest(*moved_args, **kwargs)
            f1, p1 = time_ms(fold, repeats=10), time_ms(rays_form, repeats=10)
            p2, f2 = time_ms(rays_form, repeats=10), time_ms(fold, repeats=10)
            line += (f"; per query, medians of 10 in turns: frame rays "
                     f"(folded) {f1:.3f} / {f2:.3f} ms, nudged (per-ray) "
                     f"{p1:.3f} / {p2:.3f} ms")
        print(line)
    phase_ring_edge_cases(ring_trace)
    return results


def phase_ring_edge_cases(ring_trace) -> None:
    """Phase 4a: K6 and K7 on utils/trace_cases.ring_edge_case over 2 ranks
    on cuda:0, per-ray origins and all rays from one origin: ties between
    two ids at one t, hits at t = +-0.0, exclusion, misses, dead rays; bit
    for bit."""
    import torch

    from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
    from distributed_raytracer_tpu_torch.utils import trace_cases

    n, rt = 2, 128
    ranks = mesh_mod.Ranks(["cuda:0"] * n)
    split = lambda x, dim: [p.contiguous().to("cuda:0")
                            for p in torch.chunk(x, n, dim=dim)]
    for shared in (False, True):
        rays, tris, excl = trace_cases.ring_edge_case(n, rt,
                                                      shared_origin=shared)
        args = (ranks, split(rays, 1), split(tris, 0), split(excl, 0))
        what = f"edge cases, {'one origin' if shared else 'per-ray origins'}"
        (wt, wi), _ = check_ring(ring_trace, "ring_nearest", args,
                                 {"rt": rt}, what)
        hit, _ = check_ring(ring_trace, "ring_any", args, {"rt": rt}, what)
        t = torch.cat(wt)
        print(f"[phase 4a] K6 and K7, {what}, n={n}: R={rays.shape[1]} "
              f"T={tris.shape[0]}; {int(torch.isfinite(t).sum())} hits, "
              f"{int((t == 0).sum())} at t = 0, "
              f"{int(sum(int(h.sum()) for h in hit))} occluded; "
              f"{sum(int(shared_origin_tiles(x, rt).sum()) for x in args[1])}"
              f" of {rays.shape[1] // rt} tiles share an origin; bit-equal "
              f"to the plain versions on every rank")


def phase_ring_frames(grid, ring_trace):
    """Phase 4b and 4c: the dense frame, the ring frames of both
    transports over RING_N ranks, the ray-sharded frame."""
    import numpy as np
    import torch

    from distributed_raytracer_tpu_torch.ops.render import (render_frame,
                                                            scene_on)
    from distributed_raytracer_tpu_torch.parallel import render_sharded

    arrays = grid.bake()
    dev_arrays = scene_on(arrays, "cuda:0")
    t0 = time.perf_counter()
    dense = render_frame(dev_arrays, grid.camera, W, H)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    dense_ms = time_ms(lambda: render_frame(dev_arrays, grid.camera, W, H),
                       repeats=1, warmup=0)
    hit = float((dense.sum(-1) > 0).float().mean())
    print(f"[phase 4b] dense render_frame {W}x{H}, {arrays.p0.shape[0]} "
          f"triangles: first call {dense_s * 1e3:.1f} ms, second {dense_ms:.1f} "
          f"ms; hit fraction {hit:.4f}")
    check(hit > 0.05, f"hit fraction {hit}")

    rdma = ring_renderer(arrays, RING_N, use_rdma=True)
    rdma(grid.camera)                                      # warm-up
    torch.cuda.synchronize()
    reset_launches(RING_WRAPPERS)
    frames, ms = [], []
    for _ in range(RING_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames.append(rdma(grid.camera))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts(RING_WRAPPERS)
    print(f"[phase 4b] ring use_rdma=True, {RING_N} ranks on cuda:0: "
          f"{[round(t, 3) for t in ms]} ms per frame, median "
          f"{statistics.median(ms):.3f}; launches {launches} (mesh "
          f"{[str(d) for d in rdma.mesh]})")
    for name in RING_WRAPPERS:
        check(launches[name] > 0, f"{name} was not launched on the path")
    same = sum(bool(torch.equal(f, frames[0])) for f in frames)
    print(f"[phase 4b] {same} of {RING_FRAMES} RDMA frames bit-identical to "
          "the first")
    check(same == RING_FRAMES, "RDMA ring frames differ from run to run")
    close_frames("ring use_rdma=True vs dense", frames[0], dense,
                 frac_bound=0.002)

    scan = ring_renderer(arrays, RING_N, use_rdma=False)
    t0 = time.perf_counter()
    scan_img = scan(grid.camera)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    scan_ms = time_ms(lambda: scan(grid.camera), repeats=1, warmup=0)
    print(f"[phase 4b] ring use_rdma=False (ppermute scan, plain torch), "
          f"{RING_N} ranks on cuda:0: first call {scan_s * 1e3:.1f} ms, "
          f"second {scan_ms:.1f} ms")
    close_frames("ring use_rdma=False vs dense", scan_img, dense,
                 frac_bound=0.002)

    sharded = render_sharded.make_sharded_renderer(W, H,
                                                   mesh=["cuda:0"] * RING_N)
    img = sharded(dev_arrays, grid.camera)
    sharded_ms = time_ms(lambda: sharded(dev_arrays, grid.camera),
                         repeats=1, warmup=0)
    diff = float((img - dense).abs().max())
    print(f"[phase 4c] sharded {RING_N} ranks on cuda:0: {sharded_ms:.1f} ms "
          f"(second call); max |diff| vs render_frame {diff}")
    check(tuple(img.shape) == (H, W, 3) and diff <= 2e-5,
          "sharded frame differs from render_frame")
    check(bool(np.isfinite(dense.cpu().numpy()).all()), "dense frame finite")
    return launches


# Phase 5: the culled multi-rank schedules, RING_N ranks sharing cuda:0
# (the frames and their measurements: tools/schedule_frames.py).
RING_DYN_DIFFS = 2


def phase_bands(bsr_trace, bounced, grid):
    """Phase 5a: equal and balanced bands of the 184,320-triangle sphere
    grid at 3840x2160 against the single-rank frame of the same bake, and
    the bounced bands of the 1080p sphere grid against the single-rank
    freeze_bounced frame."""
    import torch

    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.parallel import render_sharded_bvh
    from distributed_raytracer_tpu_torch.tools import schedule_frames as sf

    mesh = ["cuda:0"] * RING_N
    scene = sf.band_scene()
    t0 = time.perf_counter()
    bake = scene.bake_bvh(block_size=128)
    poses = sf.orbit(scene, sf.BAND_POSES)
    single, refs = sf.single_band_refs(scene, bake, poses)
    print(f"[phase 5a] {scene.num_tris} triangles, {bake[1].num_blocks} "
          f"blocks at {sf.BAND_W}x{sf.BAND_H}: bake, upload and "
          f"{sf.BAND_POSES} single-rank frames {time.perf_counter() - t0:.1f} "
          "s")
    reset_launches()
    t0 = time.perf_counter()
    equal, balanced = sf.build_bands(scene, bake, mesh, poses)
    worst = sf.check_bands(equal, balanced, refs, poses)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[phase 5a] equal and balanced bands, {RING_N} ranks on cuda:0: "
          f"built, sized and {sf.BAND_POSES} poses in "
          f"{time.perf_counter() - t0:.1f} s; every frame within {worst} of "
          f"the single-rank frame (atol 2e-5), balanced == equal bit for "
          f"bit; buckets {equal.buckets()}; balanced layout "
          f"{balanced.layout()}; launches while building and capturing "
          f"{launches}")
    for name in ("bsr_nearest", "bsr_any", "shade_prep"):
        check(launches[name] > 0, f"{name} was not launched on the bands")
    for what, fn in (("single rank", lambda: single.render_fast(poses[1])),
                     ("equal bands", lambda: equal(poses[1])),
                     ("balanced bands", lambda: balanced(poses[1]))):
        print(f"[phase 5a] {what}: {sf.stats_line(sf.stats(fn))}")

    prebaked = (bounced.arrays_host, bounced.tree)
    reset_launches()
    bands = render_sharded_bvh.make_sharded_bounced_renderer(
        None, BW, BH, DEPTH, mesh=mesh, prebaked=prebaked,
        sizing_camera=grid.camera)
    one = CulledRenderer(None, BW, BH, prebaked=prebaked,
                         device="cuda").freeze_bounced(grid.camera, DEPTH)
    diff = 0.0
    for cam in grid_poses(grid, 2):
        got = bands(cam, verify=True)
        diff = max(diff, float((got - one(cam, verify=True)).abs().max()))
    torch.cuda.synchronize()
    got = launch_counts()
    print(f"[phase 5a] bounced bands, {BW}x{BH} depth {DEPTH}, {RING_N} "
          f"ranks: 2 poses within {diff} of the single-rank freeze_bounced "
          f"frame (atol 2e-5); buckets {bands.buckets()}; launches {got}; "
          f"{sf.stats_line(sf.stats(lambda: bands(grid.camera)))}")
    check(diff <= 2e-5, "bounced bands differ from the single-rank frame")
    check(got["bsr_nearest_rays"] > 0 and got["bsr_any"] > 0,
          "the bounced bands launched no K3n or K2")
    for key, n in got.items():
        launches[key] += n
    return launches


def ring_call(seen: dict, key: str):
    """Of the recorded ring calls of `key` on a shard other than rank 0's
    own (gid_base != 0) with a carried state (a finite init t, or an init
    flag set), the one with the most live work items."""
    import torch

    calls = []
    for args, kwargs in seen.get(key, []):
        init = kwargs.get("init_t", kwargs.get("init"))
        carried = (bool(torch.isfinite(init).any()) if "init_t" in kwargs
                   else bool(init.any()))
        if int(kwargs["gid_base"].item()) != 0 and carried:
            calls.append((int(args[6].item()), args, kwargs))
    check(bool(calls) and max(c[0] for c in calls) > 0,
          f"no {key} call with gid_base != 0, a carried init and work on "
          "the ring")
    _, args, kwargs = max(calls, key=lambda c: c[0])
    return args, kwargs


def phase_ring_bvh(bsr_trace, grid):
    """Phase 5b: the culled ring of icosphere_scene(8) at 640x480 against
    the single-rank frame of its own bake; the sphere grid with bounces 2
    (against render_bounced) and dynamic (against fresh bakes); K1, K2 and
    K3n recorded on the ring with gid_base != 0 and carried seeds, each
    bit for bit against its plain version."""
    import torch

    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.parallel import ring_bvh
    from distributed_raytracer_tpu_torch.runtime import animation
    from distributed_raytracer_tpu_torch.tools import schedule_frames as sf

    mesh = ["cuda:0"] * RING_N
    scene = sf.ring_scene()
    reset_launches()
    t0 = time.perf_counter()
    ring = ring_bvh.RingCulledRenderer(scene, sf.RING_W, sf.RING_H,
                                       mesh=mesh)
    build_s = time.perf_counter() - t0
    single = CulledRenderer(None, sf.RING_W, sf.RING_H, prebaked=ring.bake,
                            device="cuda")
    ref = single.render(scene.camera, block=True)
    single.freeze(scene.camera)
    diff = sf.check_ring(ring, ref, scene.camera)
    torch.cuda.synchronize()
    launches = launch_counts(BSR_KEYS)
    reset_launches()
    ring.render(scene.camera)
    torch.cuda.synchronize()
    per_frame = launch_counts(BSR_KEYS)
    print(f"[phase 5b] ring, {scene.num_tris} triangles, {ring.nb_ext} "
          f"blocks ({ring.nb_loc} per rank, local levels {ring.n_levels}), "
          f"{RING_N} ranks on cuda:0, {sf.RING_W}x{sf.RING_H}: bake, upload "
          f"and sizing {build_s:.1f} s; frame within {diff} of the "
          f"single-rank frame (atol 2e-5); buckets {ring.w_pads} / "
          f"{ring.w_pads_sh}; scheduled pairs {ring.scheduled_pairs()}; "
          f"launches per frame {per_frame}")
    for name in ("bsr_nearest", "bsr_any"):
        check(per_frame[name] > 0, f"{name} was not launched on the ring")
    for what, fn in (("single rank", lambda: single.render_fast(
                          scene.camera)),
                     ("ring", lambda: ring.render(scene.camera))):
        print(f"[phase 5b] {what}: {sf.stats_line(sf.stats(fn))}")
    del ring, single

    reset_launches()
    rb = ring_bvh.RingCulledRenderer(grid, W, H, mesh=mesh, bounces=DEPTH)
    seen = {}
    with wrappers_replaced(bsr_trace, recording(bsr_trace, seen)):
        img = rb.render(grid.camera, verify=True)
    one = CulledRenderer(None, W, H, prebaked=rb.bake, device="cuda")
    diff = float((img - one.render_bounced(grid.camera, DEPTH,
                                           block=True)).abs().max())
    torch.cuda.synchronize()
    got = launch_counts(BSR_KEYS)
    reset_launches()
    rb.render(grid.camera)
    torch.cuda.synchronize()
    per_frame = launch_counts(BSR_KEYS)
    print(f"[phase 5b] ring, sphere grid {W}x{H}, bounces {DEPTH}: within "
          f"{diff} of the single-rank render_bounced (atol 2e-5); launches "
          f"per frame {per_frame}; "
          f"{sf.stats_line(sf.stats(lambda: rb.render(grid.camera)))}")
    check(diff <= 2e-5, "bounced ring differs from render_bounced")
    for key in ("bsr_nearest", "bsr_any", "bsr_nearest_rays"):
        check(per_frame[key] > 0, f"{key} was not launched on the ring")
        args, kwargs = ring_call(seen, key)
        compare_kernel(bsr_trace, key, args, kwargs, phase="5b",
                       tag=f"{KERNELS[key][0]} {key} on the ring, gid_base "
                           f"{int(kwargs['gid_base'].item())}, carried init")
    for key, n in got.items():
        launches[key] += n
    del rb, seen

    reset_launches()
    rd = ring_bvh.RingCulledRenderer(grid, W, H, mesh=mesh, dynamic=True)
    diffs = animation.orbit_object_diffs(grid, 4)[1:1 + RING_DYN_DIFFS]
    worst = (0.0, 0.0)
    for d in diffs:
        img = rd.render_dynamic(grid.camera, d, verify=True)
        m = moved_grid(grid, d)
        want = CulledRenderer(m, W, H, device="cuda").render(m.camera,
                                                             block=True)
        worst = tuple(map(max, worst, close_frames(
            "ring render_dynamic vs a fresh bake", img, want,
            mean_bound=1e-3)))
    torch.cuda.synchronize()
    for key, n in launch_counts(BSR_KEYS).items():
        launches[key] += n
    print(f"[phase 5b] ring dynamic, sphere grid {W}x{H}: "
          f"{RING_DYN_DIFFS} orbit diffs, worst {worst[0]:.6%} of pixels > "
          f"2/255, mean {worst[1]:.3e} against fresh bakes; "
          f"{sf.stats_line(sf.stats(lambda: rd.render_dynamic(grid.camera, diffs[0])))}")
    return launches


def halo_call(seen: dict, key: str):
    """Of the recorded halo calls of `key` on a shard other than rank 0's
    (gid_base != 0), the one with the most live work items."""
    calls = [(int(args[6].item()), args, kwargs)
             for args, kwargs in seen.get(key, [])
             if int(kwargs["gid_base"].item()) != 0]
    check(bool(calls) and max(c[0] for c in calls) > 0,
          f"no {key} call with gid_base != 0 and work on the halo")
    _, args, kwargs = max(calls, key=lambda c: c[0])
    return args, kwargs


HALO_FRAMES = 8


def phase_halo(bsr_trace, grid):
    """Phase 5c: the culled halo of icosphere_scene(8) at 640x480 against
    the single-rank frame of its own bake, 8 frames bit-identical; the
    sphere grid with bounces 2 (against render_bounced, K3n recorded and
    held to its plain version) and dynamic (against fresh bakes); the
    dense halo at 320x240 against render_frame."""
    import torch

    from distributed_raytracer_tpu_torch.ops.render import (render_frame,
                                                            scene_on)
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.parallel import halo, halo_bvh
    from distributed_raytracer_tpu_torch.runtime import animation
    from distributed_raytracer_tpu_torch.tools import schedule_frames as sf

    mesh = ["cuda:0"] * RING_N
    scene = sf.ring_scene()
    reset_launches()
    t0 = time.perf_counter()
    hb = halo_bvh.HaloCulledRenderer(scene, sf.RING_W, sf.RING_H, mesh=mesh)
    build_s = time.perf_counter() - t0
    single = CulledRenderer(None, sf.RING_W, sf.RING_H, prebaked=hb.bake,
                            device="cuda")
    ref = single.render(scene.camera, block=True)
    single.freeze(scene.camera)
    diff = sf.check_ring(hb, ref, scene.camera)
    frames = [hb.render(scene.camera) for _ in range(HALO_FRAMES)]
    torch.cuda.synchronize()
    same = sum(bool(torch.equal(f, frames[0])) for f in frames)
    launches = launch_counts(BSR_KEYS)
    reset_launches()
    hb.render(scene.camera)
    torch.cuda.synchronize()
    per_frame = launch_counts(BSR_KEYS)
    print(f"[phase 5c] halo, {scene.num_tris} triangles, {hb.nb_ext} "
          f"blocks ({hb.nb_loc} per rank, local levels {hb.n_levels}), "
          f"{RING_N} ranks on cuda:0, {sf.RING_W}x{sf.RING_H}: bake, upload "
          f"and sizing {build_s:.1f} s; frame within {diff} of the "
          f"single-rank frame (atol 2e-5); {same} of {HALO_FRAMES} frames "
          f"bit-identical to the first; buckets {hb.w_pads} / "
          f"{hb.w_pads_sh}; scheduled pairs {hb.scheduled_pairs()}; "
          f"exchange {sf.halo_bytes(hb)} bytes per frame; launches per "
          f"frame {per_frame}")
    check(same == HALO_FRAMES, "halo frames differ from run to run")
    for name in ("bsr_nearest", "bsr_any"):
        check(per_frame[name] > 0, f"{name} was not launched on the halo")
    st = sf.stats(lambda: hb.render(scene.camera))
    print(f"[phase 5c] halo: {sf.stats_line(st)}")
    del hb, single, frames

    reset_launches()
    rb = halo_bvh.HaloCulledRenderer(grid, W, H, mesh=mesh, bounces=DEPTH)
    seen = {}
    with wrappers_replaced(bsr_trace, recording(bsr_trace, seen)):
        img = rb.render(grid.camera, verify=True)
    one = CulledRenderer(None, W, H, prebaked=rb.bake, device="cuda")
    diff = float((img - one.render_bounced(grid.camera, DEPTH,
                                           block=True)).abs().max())
    torch.cuda.synchronize()
    for key, n in launch_counts(BSR_KEYS).items():
        launches[key] += n
    reset_launches()
    rb.render(grid.camera)
    torch.cuda.synchronize()
    per_frame = launch_counts(BSR_KEYS)
    print(f"[phase 5c] halo, sphere grid {W}x{H}, bounces {DEPTH}: within "
          f"{diff} of the single-rank render_bounced (atol 2e-5); launches "
          f"per frame {per_frame}; "
          f"{sf.stats_line(sf.stats(lambda: rb.render(grid.camera)))}")
    check(diff <= 2e-5, "bounced halo differs from render_bounced")
    for key in ("bsr_nearest", "bsr_any", "bsr_nearest_rays"):
        check(per_frame[key] > 0, f"{key} was not launched on the halo")
    args, kwargs = halo_call(seen, "bsr_nearest_rays")
    compare_kernel(bsr_trace, "bsr_nearest_rays", args, kwargs, phase="5c",
                   tag=f"K3n bsr_nearest_rays on the halo, gid_base "
                       f"{int(kwargs['gid_base'].item())}")
    for key, n in per_frame.items():
        launches[key] += n
    del rb, seen

    reset_launches()
    rd = halo_bvh.HaloCulledRenderer(grid, W, H, mesh=mesh, dynamic=True)
    diffs = animation.orbit_object_diffs(grid, 4)[1:1 + RING_DYN_DIFFS]
    worst = (0.0, 0.0)
    for d in diffs:
        img = rd.render_dynamic(grid.camera, d, verify=True)
        m = moved_grid(grid, d)
        want = CulledRenderer(m, W, H, device="cuda").render(m.camera,
                                                             block=True)
        worst = tuple(map(max, worst, close_frames(
            "halo render_dynamic vs a fresh bake", img, want,
            mean_bound=1e-3)))
    torch.cuda.synchronize()
    for key, n in launch_counts(BSR_KEYS).items():
        launches[key] += n
    st = sf.stats(lambda: rd.render_dynamic(grid.camera, diffs[0]))
    print(f"[phase 5c] halo dynamic, sphere grid {W}x{H}: "
          f"{RING_DYN_DIFFS} orbit diffs, worst {worst[0]:.6%} of pixels > "
          f"2/255, mean {worst[1]:.3e} against fresh bakes; "
          f"{sf.stats_line(st)}")
    del rd

    dw, dh = 320, 240
    arrays = grid.bake()
    dense = render_frame(scene_on(arrays, "cuda:0"), grid.camera, dw, dh)
    dh_render = halo.make_halo_renderer(halo.pad_for_ring(arrays, RING_N),
                                        dw, dh, mesh=mesh)
    t0 = time.perf_counter()
    img = dh_render(grid.camera)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    dense_ms = time_ms(lambda: dh_render(grid.camera), repeats=1, warmup=0)
    print(f"[phase 5c] dense halo, sphere grid {dw}x{dh}, {RING_N} ranks on "
          f"cuda:0: first call {first_s * 1e3:.1f} ms, second "
          f"{dense_ms:.1f} ms; halo density "
          f"{dh_render.halo_density(grid.camera):.4f}")
    close_frames("dense halo vs render_frame", img, dense, frac_bound=0.002)
    return launches


ORACLE_SUBDIV, ORACLE_W, ORACLE_H = 3, 160, 120


def phase_oracle() -> None:
    """Phase 2f: one CUDA frame of icosphere_scene(3) at 160x120 held to
    the float64 oracle (utils/oracle.py, the JAX package's copied) with the
    repository's golden tolerance, assert_images_close."""
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.utils import oracle, scenes

    scene = scenes.icosphere_scene(ORACLE_SUBDIV)
    got = CulledRenderer(scene, ORACLE_W, ORACLE_H, device="cuda").render(
        scene.camera, block=True).cpu().numpy()
    t0 = time.perf_counter()
    want, aux = oracle.render_oracle(scene, ORACLE_W, ORACLE_H,
                                     return_aux=True)
    oracle_s = time.perf_counter() - t0
    oracle.assert_images_close(got, want, aux)
    print(f"[phase 2f] icosphere_scene({ORACLE_SUBDIV}) {ORACLE_W}x"
          f"{ORACLE_H}, CUDA culled frame vs the float64 oracle: "
          f"assert_images_close holds (max |diff| "
          f"{float(abs(got - want).max()):.3e}, continuity pixels "
          f"{float((~oracle.discontinuity_mask(aux)).mean()):.3f}); oracle "
          f"{oracle_s:.1f} s")


# Phase 6: multihost on the one card. MH_PROCS worker processes of 2 ranks
# each share cuda:0 (over gloo), against the single-process 4-rank frames.
MH_PROCS = 2
MH_FRAMES = 3
MH_TIMEOUT_S = 420


def mh_cases():
    """(scene spec, size, modes, depth) of phase 6: the culled halo of the
    1.31 M-triangle sphere and the equal 4K bands at full size, the ring,
    the balanced and the bounced bands on the 640x480 sphere grid."""
    from distributed_raytracer_tpu_torch.tools import schedule_frames as sf

    return [(f"icosphere:{sf.RING_SUBDIV}", (sf.RING_W, sf.RING_H), "halo",
             1),
            (f"grid:{sf.BAND_GRID[0]}:{sf.BAND_GRID[1]}",
             (sf.BAND_W, sf.BAND_H), "sharded-bvh", 1),
            (f"grid:{GRID_SUBDIV}:{GRID_N}", (W, H),
             "ring,sharded-bvh-balanced,sharded-bvh-bounced", DEPTH)]


def mh_check(tag, reports, mode, scene, size, depth, refs) -> dict:
    """One mode of a phase-6 run held to the single-process 4-rank frame
    of the same bake on cuda:0 (refs caches it by (mode, size)): bit for
    bit, the same buckets and counts, the same bake; every process
    launched K1 and K2 (K3n and K2 on the bounced bands). Prints the frame
    times and the bytes that crossed processes; returns the summed
    launches."""
    import numpy as np
    import torch

    from distributed_raytracer_tpu_torch.tools import multihost_worker as mw

    w, h = size
    key = (mode, size)
    if key not in refs:
        case = mw.render_case(mode, scene, w, h, ["cuda:0"] * RING_N, depth)
        torch.cuda.synchronize()
        ms = mw.timed(case.pop("render"), scene.camera, MH_FRAMES,
                      torch.device("cuda:0"), lambda: None)
        refs[key] = case, statistics.median(ms)
    case, single_ms = refs[key]
    want = case["frame"]
    runs = [r["modes"][mode] for r in reports]
    got = np.load(f"{reports[0]['out']}-{mode}.npy")
    check(got.shape == want.shape and bool(np.array_equal(got, want)),
          f"{tag} {mode}: the multi-process frame differs from the "
          f"single-process frame (max |diff| "
          f"{float(np.abs(got - want).max())})")
    for run in runs:
        check(case["checksum"].startswith(run["checksum"]),
              f"{tag} {mode}: bakes differ")
        for k in ("buckets", "counts", "layout"):
            check(run[k] == case[k],
                  f"{tag} {mode}: {k} differ from the single process's")
        # The bounced bands trace every bounce, bounce 0 included, with
        # the per-ray-origin K3n (as the JAX package does): K1 stays 0.
        need = ("K3n", "K2") if mode.endswith("bounced") else ("K1", "K2")
        for k in need:
            check(run["launches"][k] > 0,
                  f"{tag} {mode}: a process launched no {k}")
    print(f"[phase 6] {tag} {mode} {w}x{h}: frame == the single-process "
          f"{RING_N}-rank frame bit for bit; buckets {runs[0]['buckets']}; "
          f"launches per process "
          f"{[r['modes'][mode]['launches'] for r in reports]}; frame "
          f"{statistics.median(runs[0]['ms']):.3f} ms (median of "
          f"{MH_FRAMES}, process 0) against the single process's "
          f"{single_ms:.3f} ms; {sum(r['bytes_per_frame'] for r in runs):.0f}"
          f" bytes per frame crossed processes in "
          f"{runs[0]['exchanges_per_frame']:.0f} exchanges")
    return {name: sum(r["launches"][k] for r in runs)
            for k, name in mw.KERNEL_KEYS.items()}


def phase_multihost() -> dict:
    """Phase 6: parallel/multihost.py on the card, through
    tools/multihost_worker.py: MH_PROCS processes of 2 ranks each on
    cuda:0 over gloo for every case of mh_cases(); with 2 or more cards
    the halo again with one process per card over NCCL."""
    import torch

    from distributed_raytracer_tpu_torch.tools import multihost_worker as mw

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = {name: 0 for name in mw.KERNEL_KEYS.values()}
    refs = {}
    with tempfile.TemporaryDirectory() as d:
        runs = [(f"{MH_PROCS} processes on cuda:0", [0] * MH_PROCS, "gloo",
                 case) for case in mh_cases()]
        if torch.cuda.device_count() >= 2:
            runs.append(("2 processes, one card each", [0, 1], "nccl",
                         mh_cases()[0]))
        for i, (tag, cards, backend, (spec, size, modes, depth)) in \
                enumerate(runs):
            out = os.path.join(d, f"frame{i}")
            t0 = time.perf_counter()
            reports = mw.launch(
                len(cards), spec, out, modes, cards=cards,
                extra=["--device", "cuda", "--size", f"{size[0]}x{size[1]}",
                       "--depth", str(depth), "--frames", str(MH_FRAMES)],
                timeout_s=MH_TIMEOUT_S)
            for r in reports:
                r["out"] = out
            check({r["backend"] for r in reports} == {backend},
                  f"{tag}: transport {[r['backend'] for r in reports]}, "
                  f"not {backend}")
            print(f"[phase 6] {tag}, {spec} at {size[0]}x{size[1]}: "
                  f"{len(cards)} processes (transport {backend}) ran "
                  f"{modes} in {time.perf_counter() - t0:.1f} s")
            scene = mw.load(spec)
            for mode in modes.split(","):
                got = mh_check(tag, reports, mode, scene, size, depth, refs)
                for name, n in got.items():
                    launches[name] += n
        if torch.cuda.device_count() < 2:
            print("[phase 6] NCCL was not exercised: this machine has one "
                  "card (information, not a pass)")
    refs.clear()
    torch.cuda.empty_cache()
    return launches


def write_scene(d: str, scene, mesh) -> str:
    """The scene as OBJ + MTL + scene.json (the reference's schema): one
    mesh, one `objs` entry per object of the scene."""
    m = mesh.materials[0]
    with open(os.path.join(d, "mesh.mtl"), "w") as f:
        f.write("newmtl mat\n"
                f"Ka {m.ka[0]!r} {m.ka[1]!r} {m.ka[2]!r}\n"
                f"Kd {m.kd[0]!r} {m.kd[1]!r} {m.kd[2]!r}\n"
                f"Ks {m.ks[0]!r} {m.ks[1]!r} {m.ks[2]!r}\n"
                f"Ns {m.ns!r}\n")
    lines = ["mtllib mesh.mtl"]
    lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in mesh.vertices.tolist()]
    lines += [f"vn {x!r} {y!r} {z!r}" for x, y, z in mesh.normals.tolist()]
    lines.append("usemtl mat")
    lines += ["f " + " ".join(f"{v + 1}//{n + 1}" for v, n in zip(fv, fn))
              for fv, fn in zip(mesh.faces_v.tolist(), mesh.faces_n.tolist())]
    with open(os.path.join(d, "mesh.obj"), "w") as f:
        f.write("\n".join(lines) + "\n")
    cam = scene.camera
    xyz = lambda v: {"x": float(v[0]), "y": float(v[1]), "z": float(v[2])}
    doc = {"objs": [{"model": "mesh.obj", "pos": xyz(o.pos)}
                    for o in scene.objects],
           "lights": [{"pos": xyz(p), "col": {"r": int(round(c[0] * 255)),
                                              "g": int(round(c[1] * 255)),
                                              "b": int(round(c[2] * 255))}}
                      for p, c in zip(scene.light_pos, scene.light_col)],
           "cam": {"pos": xyz(cam.pos), "dir": xyz(cam.forward),
                   "fov": cam.fov}}
    path = os.path.join(d, "scene.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def run_cli(scene, mesh, size, frames: int, flags) -> None:
    """Phase 3: `frames` frames of the scene through run.main on cuda."""
    import numpy as np

    from distributed_raytracer_tpu_torch import run

    radius = float(np.linalg.norm(np.asarray(scene.camera.pos)))
    with tempfile.TemporaryDirectory() as d:
        path = write_scene(d, scene, mesh)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run.main([path, str(size[0]), str(size[1]), "--frames",
                           str(frames), "--fps-target", "0", "--radius",
                           repr(radius), "--device", "cuda", *flags])
        secs = time.perf_counter() - t0
    check(rc == 0, f"run.main returned {rc}")
    report = [l for l in out.getvalue().splitlines()
              if l.startswith(("Mean FPS", "Median FPS", "Throughput"))]
    check(len(report) == 3, f"no FPS report in: {out.getvalue()!r}")
    what = f"{size[0]}x{size[1]} {' '.join(flags) or 'no bounces'}"
    for line in report:
        print(f"[phase 3] {what}: {line}")
    print(f"[phase 3] {what}: CLI total {secs:.1f} s (scene load, bake, "
          f"sizing, {frames} frames)")


def mh_cli(scene, mesh, flags) -> None:
    """Phase 6b: the command line with --multihost, 2 processes of 2 ranks
    sharing cuda:0 (--device cuda, the default), 3 frames of the sphere
    grid at 320x240: process 0 prints the report and writes every frame,
    process 1 neither; both print their transport (gloo)."""
    import numpy as np

    from distributed_raytracer_tpu_torch.tools import multihost_worker as mw

    radius = float(np.linalg.norm(np.asarray(scene.camera.pos)))
    port = mw.free_port()
    with tempfile.TemporaryDirectory() as d:
        path = write_scene(d, scene, mesh)
        out = os.path.join(d, "frames")
        cmds = [[sys.executable, "-m", "distributed_raytracer_tpu_torch",
                 path, "320", "240", "--frames", "3", "--fps-target", "0",
                 "--radius", repr(radius), "--revolutions", "0.1", "--out",
                 out, "--multihost", "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(i),
                 "--devices", str(RING_N), *flags] for i in range(2)]
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
        t0 = time.perf_counter()
        outs = mw.run_all(cmds, [env, env], MH_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.perf_counter() - t0
        frames = sorted(os.listdir(out))
    what = " ".join(flags)
    check("Mean FPS" in outs[0] and "Mean FPS" not in outs[1],
          f"--multihost {what}: the report is not process 0's alone")
    check(all("transport gloo" in o for o in outs),
          f"--multihost {what}: transport lines {outs}")
    check(len(frames) == 3, f"--multihost {what}: frames {frames}")
    fps = [l for l in outs[0].splitlines() if l.startswith("Mean FPS")]
    print(f"[phase 6b] CLI --multihost {what}, 2 processes on cuda:0: "
          f"{fps[0]}; process 0 wrote {len(frames)} frames, process 1 no "
          f"report; {secs:.1f} s")


LOOP_TICKS = 120        # phase 3b: orbit_events ticks of the loop


def phase_loop(renderer, scene, mesh) -> None:
    """Phase 3b: runtime/loop.run_loop at 640x480 over orbit_events on the
    frozen renderer (verify on every 8th frame, as the CLI does), then the
    CLI with --serve as a subprocess driven over HTTP until Esc."""
    import queue
    import threading
    import urllib.request

    import numpy as np
    import torch

    from distributed_raytracer_tpu_torch.runtime import animation, framebuffer
    from distributed_raytracer_tpu_torch.runtime.loop import run_loop

    events = list(animation.orbit_events(W, LOOP_TICKS,
                                         fov=scene.camera.fov,
                                         revolutions=0.25))
    issued = [0]

    def render(_, cam):
        verify = issued[0] % 8 == 0
        issued[0] += 1
        return renderer.render_fast(cam, verify=verify)

    shown, last = [], {}

    def display(i, img):
        shown.append(i)
        last["img"] = img

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cam, stats, dropped = run_loop(None, scene.camera, render, W, H,
                                   events=events, display=display)
    secs = time.perf_counter() - t0
    check(dropped == 0 and shown == list(range(LOOP_TICKS))
          and stats.frames_drawn == LOOP_TICKS,
          f"run_loop: {dropped} dropped, {len(shown)} shown in order "
          f"{shown == sorted(shown)}")
    want = renderer.render_fast(cam).cpu().numpy()
    check(np.array_equal(last["img"], want),
          "the loop's last frame differs from render_fast of its camera")
    print(f"[phase 3b] run_loop {W}x{H}, {LOOP_TICKS} orbit_events ticks, "
          f"realtime=False, no display work: {stats.frames_drawn} frames "
          f"drawn, {dropped} dropped, mean FPS {stats.mean_fps:.1f}, median "
          f"{stats.median_fps:.1f}; {secs * 1e3 / LOOP_TICKS:.3f} ms per "
          f"frame over the whole loop ({secs:.2f} s); last frame == "
          f"render_fast of the final camera")

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        path = write_scene(d, scene, mesh)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "distributed_raytracer_tpu_torch",
             path, str(W), str(H), "--device", "cuda", "--serve",
             "127.0.0.1:0"], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines = queue.Queue()
        reader = threading.Thread(
            target=lambda: [lines.put(l) for l in proc.stdout], daemon=True)
        reader.start()
        try:
            url, out = None, []
            while url is None:
                line = lines.get(timeout=300)
                out.append(line)
                if line.startswith("viewer at "):
                    url = line.split()[-1]
            ready_s = time.perf_counter() - t0

            def post(ev):
                urllib.request.urlopen(urllib.request.Request(
                    url + "input", method="POST",
                    data=json.dumps(ev).encode()), timeout=60).read()

            def get(what):
                with urllib.request.urlopen(url + what, timeout=60) as r:
                    return r.read()

            post({"kind": "key_down", "key": "a"})
            post({"kind": "mouse", "dx": 20, "dy": 0})
            deadline = time.monotonic() + 120
            while (json.loads(get("stats"))["frames"] < 5
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            png = os.path.join(d, "frame.png")
            with open(png, "wb") as f:
                f.write(get("frame.png"))
            img = framebuffer.read_png(png)
            served = json.loads(get("stats"))
            post({"kind": "key_up", "key": "a"})
            post({"kind": "key_down", "key": "esc"})
            rc = proc.wait(timeout=120)
            reader.join(timeout=30)
            while not lines.empty():
                out.append(lines.get())
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        text = "".join(out)
        check(rc == 0, f"--serve exited {rc}:\n{text[-3000:]}")
        check(img.shape == (H, W, 3) and img.max() > 0,
              f"served frame {img.shape}, max {img.max()}")
        check(served["frames"] >= 5 and "Frames dropped: 0." in text,
              f"--serve: stats {served}; output {text[-2000:]!r}")
        for line in out:
            if line.startswith(("Total frames", "Mean FPS", "Frames dropped")):
                print(f"[phase 3b] --serve: {line.strip()}")
        print(f"[phase 3b] --serve 127.0.0.1:0 subprocess: viewer up after "
              f"{ready_s:.1f} s (start, scene load, bake, sizing); frame.png "
              f"{img.shape} with {int((img.max(-1) > 0).sum())} lit pixels; "
              f"stats {served}; exit {rc} after Esc, "
              f"{time.perf_counter() - t0:.1f} s in all")


# Phase 7: the JAX bench's config 5, icosphere_scene(9) at 640x480, with
# the bench's 16x16 ray tiles and with the default 32x16 ones.
C5_SUB = 9
C5_TILES = (("16x16", 256, 16), ("32x16", 512, 32))
C5_ORBIT = 3
C5_FRAMES = 10


def config5_pass(tag, arrays, tree, cam, poses, bsr_trace):
    """Phase 7 on one tile shape: the frame on the card against its plain
    versions. Returns (renderer, its launches on the path, results)."""
    import torch

    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.tools import config_ab
    from distributed_raytracer_tpu_torch.utils import profiling

    rt, tw = dict((t, (r, w)) for t, r, w in C5_TILES)[tag]
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    r = CulledRenderer(None, W, H, prebaked=(arrays, tree), ray_tile=rt,
                       tile_w=tw, device="cuda:0")
    build_s = time.perf_counter() - t0
    seen = {}
    t0 = time.perf_counter()
    with wrappers_replaced(bsr_trace, recording(bsr_trace, seen)):
        sync_img = r.render(cam, block=True)
    render_s = time.perf_counter() - t0
    counts = r._last_counts
    sizing_pairs = profiling.frame_work(r, 1.0).pairs
    r.freeze(cam)
    imgs = [r.render_fast(p, verify=True) for p in poses]
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    for name in ("bsr_nearest", "bsr_any", "shade_prep"):
        check(launches[name] > 0, f"config 5 {tag}: {name} was not launched")
    for img in imgs:
        check(tuple(img.shape) == (H, W, 3) and bool(img.isfinite().all()),
              f"config 5 {tag}: orbit frame shape / finiteness")
    hit = float((sync_img.sum(-1) > 0).float().mean())
    check(hit > 0.05, f"config 5 {tag}: hit fraction {hit}")
    fast0 = r.render_fast(cam, verify=True)
    check(float((fast0 - sync_img).abs().max()) <= 2e-5,
          f"config 5 {tag}: render_fast != render on the sizing pose")
    print(f"[phase 7] {tag} tiles (rt {rt}, tile_w {tw}): {r.n_tiles} ray "
          f"tiles, cull_levels {r.n_levels} (groups {r.groups}), exit_every "
          f"{r.exit_every}; renderer built in {build_s:.1f} s, render() "
          f"{render_s:.2f} s; the sizing pose's counts per level {counts}, "
          f"scheduled pairs {sizing_pairs} ({sizing_pairs / 1e9:.3f} G); "
          f"pads after the orbit {r.buckets()}; launches {launches}; peak "
          f"device memory above the run's earlier allocations {peak:.2f} "
          "GiB")
    kernels = {key: compare_kernel(
        bsr_trace, key, *seen[key][-1], plain_repeats=1, phase="7",
        tag=f"{KERNELS[key][0]} {key}, config 5 {tag}")
        for key in ("bsr_nearest", "bsr_any")}
    t0 = time.perf_counter()
    with wrappers_replaced(bsr_trace, plain_versions(bsr_trace)):
        plain = r.render(poses[0], block=True)
    plain_s = time.perf_counter() - t0
    diff = float((imgs[0] - plain).abs().max())
    print(f"[phase 7] {tag}: pose 0 render_fast vs the plain versions on the "
          f"card: max |diff| {diff} (plain frame {plain_s:.1f} s)")
    check(diff <= 2e-5, f"config 5 {tag}: frame differs from its "
                        "plain-version frame")
    split = config_ab.breakdown(r, cam)
    print(f"[phase 7] {tag}: render() stages (CUDA events, mean of 4): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    return r, launches, {"sizing_pairs": sizing_pairs, "kernels": kernels,
                         "peak": peak}


def phase_config5(bsr_trace):
    """Phase 7: config 5 at full size, both tile shapes, timed in turns.
    Returns (the 16x16 renderer, its poses, launches)."""
    import torch

    from distributed_raytracer_tpu_torch.runtime import animation
    from distributed_raytracer_tpu_torch.tools import bake_cache
    from distributed_raytracer_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    arrays, tree, cam = bake_cache.load_icosphere(C5_SUB)
    real = int((abs(arrays.geo_n).sum(axis=1) > 0).sum())
    print(f"[phase 7] icosphere_scene({C5_SUB}): {real} triangles in "
          f"{arrays.p0.shape[0]} slots, {tree.num_blocks} blocks of "
          f"{tree.block_size}; bundle ready in {time.perf_counter() - t0:.1f}"
          " s")
    check(real == 20 * 4 ** C5_SUB, f"config 5 has {real} triangles")
    poses = animation.orbit_camera_path(cam, C5_ORBIT, radius=3.0,
                                        revolutions=0.01)
    runs, launches = {}, {}
    for tag, _, _ in C5_TILES:
        r, got, res = config5_pass(tag, arrays, tree, cam, poses, bsr_trace)
        runs[tag] = (r, res)
        for key, n in got.items():
            launches[key] = launches.get(key, 0) + n
    # In turns, each turn C5_FRAMES synchronized frames over the poses in
    # order; the work is the timed frames' mean scheduled pairs.
    turns = [tag for _ in range(2) for tag, _, _ in C5_TILES]
    timed = [poses[k % C5_ORBIT] for k in range(C5_FRAMES)]
    times = {tag: [] for tag, _, _ in C5_TILES}
    for tag in turns:
        r = runs[tag][0]
        r.render_fast(timed[0])
        frame = []
        for p in timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_fast(p)
            torch.cuda.synchronize()
            frame.append((time.perf_counter() - t0) * 1e3)
        times[tag].append(statistics.median(frame))
    pairs = {}
    for tag, (r, res) in runs.items():
        ms = statistics.median(times[tag])
        work = profiling.orbit_work(r, timed, ms / 1e3)
        pairs[tag] = (work.pairs, res["sizing_pairs"])
        print(f"[phase 7] {tag}: render_fast {times[tag]} ms (synchronized "
              f"medians of {C5_FRAMES} over {C5_ORBIT} poses, turns "
              f"{turns}); {work.report()}; Mrays/s {W * H / ms / 1e3:.1f}; "
              f"peak device memory {res['peak']:.2f} GiB; cull_levels "
              f"{r.n_levels}")
    (a, sa), (b, sb) = (pairs[t] for t, _, _ in C5_TILES)
    print(f"[phase 7] scheduled pairs per frame, 16x16 / 32x16 tiles: the "
          f"timed frames' mean {a:.0f} / {b:.0f} = {a / b:.4f}; the sizing "
          f"pose {sa} / {sb} = {sa / sb:.4f}")
    for tag, (r, _) in runs.items():
        if tag != "16x16":
            r.release_graphs()
    torch.cuda.synchronize()
    return runs["16x16"][0], poses, launches


def phase_tools(r5, poses5) -> None:
    """Phase 7b: config_ab's per-variant function on config 1 (base,
    rt256sq); a profiling.trace of 3 replays of config 5's 16x16 frame read
    by xprof, whose top list must name K1 and K2 and whose busy share must
    be within 0.05 of schedule_frames.profile on the same frames (both
    parse with profiling.anatomy: this shows only that two windows agree);
    then busy_calibration, in a fresh process, holds anatomy to CUDA
    events and the host clock."""
    import torch

    from distributed_raytracer_tpu_torch.tools import config_ab, xprof
    from distributed_raytracer_tpu_torch.tools import schedule_frames as sf
    from distributed_raytracer_tpu_torch.utils import profiling

    cfg = config_ab.build_config("1")
    for v in ("base", "rt256sq"):
        res = config_ab.run_variant(cfg, v, "cuda:0")
        print(f"[phase 7b] {res['line']}")
        check(res["pairs"] > 0 and res["ms"] > 0, f"config_ab 1 {v}")
        res["renderer"].release_graphs()
    frame = lambda: r5.render_fast(poses5[1])
    # As many frames in flight as the window holds, first: each holds a
    # pinned block for its camera's copy until the card reaches it, and a
    # new block (cudaHostAlloc, ~17 ms on the card's host) would open the
    # window with an idle gap that the next window does not have.
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            for _ in range(3):
                frame()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            xprof.main([d, "3", "8"])
    lines = buf.getvalue().splitlines()[1:]
    for line in lines:
        print(f"[phase 7b] xprof: {line}")
    top = lines[lines.index("== kernels by device ms/frame (launches in "
                            "the window)") + 1:
                lines.index("== idle gaps of the card, longest first")]
    check(any("[K1]" in l for l in top) and any("[K2]" in l for l in top),
          "xprof's top kernels do not name K1 and K2")
    busy = float(re.search(r"busy ([0-9.]+);", lines[0]).group(1))
    prof = sf.profile(frame, 3)
    print(f"[phase 7b] schedule_frames.profile on the same frames: busy "
          f"{prof['busy']:.4f}, device ms {prof['device_ms']}, launches "
          f"{prof['launches']}, host launch calls "
          f"{prof['host_launch_calls']:.1f}; xprof busy {busy:.4f}")
    check(abs(busy - prof["busy"]) <= 0.05,
          f"busy shares differ: xprof {busy}, profile {prof['busy']}")
    # In a fresh process: in this one, which holds CUDA graphs, a later
    # profiler window can lose kernel records (PERF.md section 7).
    out = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.busy_calibration()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    print(out.stdout, end="")
    if out.returncode:
        print(out.stderr[-4000:], file=sys.stderr)
    check(out.returncode == 0, f"busy_calibration exited {out.returncode}")


def busy_calibration(rounds: int = 3, sleep_s: float = 0.01) -> None:
    """profiling.anatomy against clocks it does not read: `rounds` chains
    of 8 4096^3 matmuls (~21 ms), each between two CUDA events and
    followed by a host sleep with nothing queued. The parser's device ms
    must match the events' within 4%, its busy share the events' device
    time over the host's wall time of the window within 0.03, and each of
    its rounds - 1 longest idle gaps must hold a sleep (at least the
    sleep, less 0.2 ms of clock skew, and at most 1.5 ms more). The
    events also time the ~0.3 ms from their start to the first matmul's
    launch on an idle card (1.5% of a chain; the gaps exceed the sleeps
    by ~0.5 ms; NVIDIA H100 80GB HBM3, 700.00 W)."""
    import torch

    from distributed_raytracer_tpu_torch.utils import profiling

    a = torch.randn(4096, 4096, device="cuda:0") / 64
    c = torch.empty_like(a)

    def chain():
        for _ in range(8):
            torch.mm(a, a, out=c)

    chain()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(rounds)]
    sleeps = []
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as t:
            t0 = time.perf_counter()
            for i, (e0, e1) in enumerate(marks):
                if i:
                    s0 = time.perf_counter()
                    time.sleep(sleep_s)
                    sleeps.append((time.perf_counter() - s0) * 1e3)
                e0.record()
                chain()
                e1.record()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        got = profiling.anatomy(profiling.load_events(t.path), rounds)
    dev = sum(e0.elapsed_time(e1) for e0, e1 in marks)
    parsed = sum(got["device_ms"].values()) * rounds
    gaps = [g["ms"] for g in got["gaps"][:rounds - 1]]
    print(f"[phase 7b] anatomy against CUDA events and the host clock: "
          f"device {parsed:.4f} ms (events {dev:.4f}), busy "
          f"{got['busy']:.4f} (events over the host's wall "
          f"{dev / wall:.4f}), window {got['window_ms'] * rounds:.4f} ms "
          f"(host {wall:.4f}), longest gaps {gaps} ms (host sleeps "
          f"{sleeps} ms)")
    check(abs(parsed - dev) <= 0.04 * dev,
          f"anatomy's device ms {parsed} against the events' {dev}")
    check(abs(got["busy"] - dev / wall) <= 0.03,
          f"anatomy's busy {got['busy']} against the events' {dev / wall}")
    for g in gaps:
        check(min(sleeps) - 0.2 <= g <= max(sleeps) + 1.5,
              f"anatomy's idle gap of {g} ms holds no host sleep {sleeps}")


def phase_recovery() -> None:
    """Phase 7c: tools/loop_recovery_smoke with its children on cuda:0."""
    from distributed_raytracer_tpu_torch.tools import loop_recovery_smoke

    t0 = time.perf_counter()
    ok, detail = loop_recovery_smoke.run_smoke(
        device="cuda:0", log=lambda s: print(f"[phase 7c]{s}"))
    print(f"[phase 7c] loop_recovery_smoke on cuda:0: {detail} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(ok, detail)


BENCH_SHAPES = ("4", "2")     # phase 8a: the bench's configs held here


def phase_bench_shapes(bsr_trace) -> dict:
    """Phase 8a: configs 4 and 2 of the port's bench at its table's values
    (bench.TABLE), run by bench.run in this process. On the last orbit
    pose, every kernel launch of a sync frame of the bench's renderer
    against its plain version on the card (bit for bit), and the bench's
    frozen frame against the plain-version frame. Returns the launches of
    the bench's runs and those sync frames."""
    import torch

    from distributed_raytracer_tpu_torch import bench
    from distributed_raytracer_tpu_torch.runtime import animation

    launches = {}
    for name in BENCH_SHAPES:
        cfg = bench.TABLE[name]
        bounced = cfg.path == "bounced"
        keys = ("bsr_nearest_rays" if bounced else "bsr_nearest", "bsr_any")
        reset_launches()
        t0 = time.perf_counter()
        m = bench.run(cfg, "cuda:0")
        run_s = time.perf_counter() - t0
        r = m.renderer
        _, _, cam = bench.load_scene(cfg.scene)
        n, radius, revolutions = cfg.orbit
        pose = animation.orbit_camera_path(cam, n, radius=radius,
                                           revolutions=revolutions)[-1]

        def sync_frame():
            if bounced:
                return r.render_bounced(pose, cfg.depth, block=True)
            return r.render(pose, block=True)

        seen = {}
        with wrappers_replaced(bsr_trace, recording(bsr_trace, seen)):
            sync_frame()
        got = launch_counts()
        for key, k in got.items():
            launches[key] = launches.get(key, 0) + k
        print(f"[phase 8a] bench config {name}: {cfg.width}x{cfg.height}, "
              f"{m.n_tris} triangles, rt {r.rt}, tb {r.tb}, exit_every "
              f"{r.exit_every}, {cfg.path} frame {m.seconds * 1e3:.4f} ms "
              f"(bench.run, {run_s:.1f} s); launches {got}; block layout "
              f"{r.block_layout}; the sync "
              f"frame's calls {({k: len(v) for k, v in seen.items()})}")
        check(set(seen) == set(keys), f"bench config {name} launched "
                                      f"{sorted(seen)}, not {keys}")
        for key in keys:
            check(got[key] > 0, f"bench config {name}: {key} was not "
                                "launched")
            for i, (args, kwargs) in enumerate(seen[key]):
                compare_kernel(bsr_trace, key, args, kwargs, plain_repeats=1,
                               phase="8a", tag=f"{KERNELS[key][0]} {key}, "
                               f"bench config {name}, call {i}")
        frozen = m.render(pose, verify=True)
        t0 = time.perf_counter()
        with wrappers_replaced(bsr_trace, plain_versions(bsr_trace)):
            plain = sync_frame()
        plain_s = time.perf_counter() - t0
        diff = float((frozen - plain).abs().max())
        print(f"[phase 8a] bench config {name}: frozen frame vs the plain "
              f"versions on the card: max |diff| {diff} (plain frame "
              f"{plain_s:.1f} s)")
        check(tuple(frozen.shape) == (cfg.height, cfg.width, 3)
              and bool(frozen.isfinite().all()),
              f"bench config {name}: frame shape / finiteness")
        check(diff <= 2e-5, f"bench config {name}: frame differs from its "
                            "plain-version frame")
        r.release_graphs()
        del m, r, frozen, plain, seen
        torch.cuda.empty_cache()
    return launches


def check_bench_line(line: dict, card: str) -> None:
    """The bench's JSON line on the card: the headline, every config's
    frame time, the loop, the pairs, no error, the card named."""
    from distributed_raytracer_tpu_torch import bench

    check(line.get("metric") == "primary_mrays_per_sec_per_chip"
          and line.get("value", 0) > 0, f"bench headline {line.get('metric')}"
          f" = {line.get('value')}")
    for key in bench.FRAME_KEYS:
        check(line.get(key, 0) > 0, f"bench: {key} = {line.get(key)}")
    check(line.get("loop_frames", 0) > 0 and line.get("loop_mean_fps", 0) > 0,
          "bench: the loop drew no frames")
    errors = {k: v for k, v in line.items() if k.endswith("_error")}
    check(not errors, f"bench errors: {errors}")
    pairs = {k: v for k, v in line.items() if k.endswith("_pairs_scheduled")}
    check(set(pairs) == set(bench.PAIRS_KEYS)
          and all(v > 0 for v in pairs.values()), f"bench pairs {pairs}")
    name, limit = (p.strip() for p in card.rsplit(",", 1))
    check(line.get("device") == name and line.get("power_limit") == limit,
          f"bench device {line.get('device')}, {line.get('power_limit')}; "
          f"the card {card}")


def phase_bench(card: str) -> dict:
    """Phase 8: the port's bench, all configs, as a child process; returns
    its launches (all its processes)."""
    from distributed_raytracer_tpu_torch import bench

    timeout = sum(bench.GROUP_TIMEOUT_S.values()) + 300
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_raytracer_tpu_torch.bench",
         "--device", "cuda"], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)         # the bench and its children
        stdout, stderr = proc.communicate()
    secs = time.perf_counter() - t0
    lines = stdout.splitlines()
    for err in stderr.splitlines():
        if err.startswith(("group ", "build:", "gpu:", "bench launches:",
                           "[child 5] native library:")):
            print(f"[phase 8] {err}")
    print(f"[phase 8] bench line: {stdout.strip()}")
    print(f"[phase 8] bench: exit {proc.returncode}, {secs:.1f} s (timeout "
          f"{timeout} s)")
    if proc.returncode or len(lines) != 1:
        print(stderr[-8000:], file=sys.stderr)
    check(proc.returncode == 0, f"bench exited {proc.returncode}")
    check(len(lines) == 1, f"bench printed {len(lines)} stdout lines")
    check_bench_line(json.loads(lines[0]), card)
    counts = [l for l in stderr.splitlines()
              if l.startswith("bench launches: ")]
    check(len(counts) == 1, "bench printed no launch line")
    launches = json.loads(counts[0].split(": ", 1)[1])
    for key in ("bsr_nearest", "bsr_any", "bsr_nearest_rays", "shade_prep"):
        check(launches.get(key, 0) > 0, f"bench: {key} was not launched")
    return launches


def timed(tag: str, fn, *args):
    """fn(*args), printing the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase {tag}] {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributed_raytracer_tpu_torch.ops import _build, bsr_trace
    from distributed_raytracer_tpu_torch.ops import ring_trace
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.utils import scenes

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    card = gpu_query()
    print(f"gpu: {card}")
    t0 = time.perf_counter()
    _build.build_all()          # one nvcc per source, side by side
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name in ("bsr_trace", "ring_trace", "shade_prep"):
        print_ptxas(_build.build_logs.get(name, ""))

    scene = scenes.icosphere_scene(SUBDIV)
    t0 = time.perf_counter()
    renderer = CulledRenderer(scene, W, H, block_size="auto", device="cuda")
    print(f"scene: {scene.num_tris} triangles, tb={renderer.tb}, "
          f"{renderer.tree.num_blocks} blocks, groups {renderer.groups}, "
          f"{renderer.n_tiles} ray tiles; bake + upload "
          f"{time.perf_counter() - t0:.1f} s")
    grid = scenes.instanced_grid(scenes.icosphere_scene(GRID_SUBDIV), GRID_N)
    t0 = time.perf_counter()
    bounced = CulledRenderer(grid, BW, BH, block_size="auto", device="cuda")
    print(f"grid scene: {grid.num_tris} triangles, tb={bounced.tb}, "
          f"{bounced.tree.num_blocks} blocks, groups {bounced.groups}, "
          f"{bounced.n_tiles} ray tiles at {BW}x{BH}; bake + upload "
          f"{time.perf_counter() - t0:.1f} s")

    # The same bake in the tensor-core form (use_mxu=True).
    mxu = CulledRenderer(None, W, H, prebaked=(renderer.arrays_host,
                                               renderer.tree),
                         device="cuda", use_mxu=True)

    kernels = timed("1", phase_kernels, renderer, scene, bsr_trace)
    timed("1 edge cases", phase_edge_cases, bsr_trace)
    kernels.update(timed("1 bounced", phase_kernels_rays, bounced, grid,
                         bsr_trace))
    kernels.update(timed("1c", phase_kernels_mxu, mxu, renderer, scene,
                         bsr_trace, grid, bounced))
    kernels["shade_prep"] = timed("1d", phase_shade_prep, renderer, scene,
                                  bounced, grid)
    launches, plain0 = timed("2", phase_frame, renderer, scene, bsr_trace)
    got, sync_k2 = timed("2b", phase_bounced, bounced, grid, bsr_trace)
    runs = [got,
            timed("2c", phase_frame_mxu, mxu, renderer, scene, bsr_trace,
                  plain0),
            timed("2c bounced", phase_bounced_mxu, grid, bounced, bsr_trace,
                  sync_k2),
            timed("2d", phase_dynamic, grid, bsr_trace)]
    timed("2e", phase_graphs, renderer, scene, bounced, grid)
    kernels.update(timed("4a", phase_ring_kernels, grid, ring_trace))
    runs.append(timed("4b/4c", phase_ring_frames, grid, ring_trace))
    runs.append(timed("5a", phase_bands, bsr_trace, bounced, grid))
    runs.append(timed("5b", phase_ring_bvh, bsr_trace, grid))
    runs.append(timed("5c", phase_halo, bsr_trace, grid))
    timed("2f", phase_oracle)
    runs.append(timed("6", phase_multihost))
    mesh = scenes.icosphere_mesh(SUBDIV)
    grid_mesh = scenes.icosphere_mesh(GRID_SUBDIV)
    t0 = time.perf_counter()
    run_cli(scene, mesh, (W, H), 30, [])
    run_cli(grid, grid_mesh, (BW, BH), 8,
            ["--bounces", str(DEPTH), "--revolutions", "0.1"])
    run_cli(grid, grid_mesh, (BW, BH), 8,
            ["--animate-objects", "--revolutions", "0.1"])
    for flags in (["--mode", "sequential"],
                  ["--mode", "sharded", "--devices", str(RING_N)],
                  ["--mode", "sharded-bvh", "--devices", str(RING_N)],
                  ["--mode", "sharded-bvh", "--devices", str(RING_N),
                   "--balance"],
                  ["--mode", "ring", "--devices", str(RING_N)],
                  ["--mode", "halo", "--devices", str(RING_N)],
                  ["--mode", "halo", "--devices", str(RING_N), "--bounces",
                   str(DEPTH)]):
        run_cli(grid, grid_mesh, (320, 240), 3,
                flags + ["--revolutions", "0.1"])
    print(f"[phase 3] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for flags in (["--mode", "halo"], ["--mode", "sharded-bvh", "--balance"]):
        mh_cli(grid, grid_mesh, flags)
    print(f"[phase 6b] {time.perf_counter() - t0:.1f} s")
    timed("3b", phase_loop, renderer, scene, mesh)
    r5, poses5, got = timed("7", phase_config5, bsr_trace)
    runs.append(got)
    timed("7b", phase_tools, r5, poses5)
    r5.release_graphs()
    del r5
    timed("7c", phase_recovery)
    runs.append(timed("8a", phase_bench_shapes, bsr_trace))
    runs.append(timed("8", phase_bench, card))
    for got in runs:
        for key, n in got.items():
            launches[key] = launches.get(key, 0) + n

    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(f"gpu: {gpu_query()}")
    print(json.dumps({"kernels": [
        {"name": key, "route": "cuda", "source": KERNELS[key][1],
         "replaces": KERNELS[key][2], "kernel": KERNELS[key][0],
         "launches": launches[key], **kernels[key]} for key in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


ERROR_SECTIONS = ("ECC Mode", "ECC Errors", "Retired Pages",
                  "Remapped Rows")


def error_counters() -> None:
    """After a failure: the card's name and power limit, and the ECC,
    retired-page, remapped-row and Xid lines of `nvidia-smi -q` (each
    section's header with its indented lines)."""
    try:
        print(f"gpu: {gpu_query()}")
        report = subprocess.run(["nvidia-smi", "-q"], capture_output=True,
                                text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: no error counters: {e}")
        return
    depth = None
    for line in report.splitlines():
        indent = len(line) - len(line.lstrip())
        if depth is not None and indent <= depth:
            depth = None
        if line.strip().startswith(ERROR_SECTIONS):
            depth = indent
        if depth is not None or "xid" in line.lower():
            print(f"nvidia-smi: {line.rstrip()}")


def run() -> int:
    """main(); on a failure, a traceback and the card's error counters,
    and a non-zero exit."""
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    if rc:
        sys.stdout.flush()
        error_counters()
    return rc


if __name__ == "__main__":
    sys.exit(run())
