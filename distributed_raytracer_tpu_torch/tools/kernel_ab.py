"""Time the traversal kernels and the frames of this tree against another
tree's, in turns, on one CUDA card (the ring: one card, or one per rank).

    python -m distributed_raytracer_tpu_torch.tools.kernel_ab \\
        [--other DIR] [--cut] [--chunks 1,2,4] [--out FILE]
    python -m distributed_raytracer_tpu_torch.tools.kernel_ab --ring \\
        [--other DIR] [--cards N] [--chunks 1,2,4,8] [--out FILE]
    python -m distributed_raytracer_tpu_torch.tools.kernel_ab --mxu \\
        [--other DIR] [--chunks 1,2,4,8] [--out FILE]

The launches are recorded once, in this tree: K1 and K2 of one 640x480
render() of icosphere_scene(6); the three K2 launches and the three K3n
launches (bounces 0, 1, 2) of one depth-2 render_bounced() of the
1920x1080 sphere grid (instanced_grid(icosphere_scene(3), 4)); and K3a on
the bounce-1 rays with t_max set to K3n's finite hit t (as chip_smoke.py
builds it). Each tree then times its own
wrappers (ops/bsr_trace.bsr_nearest, bsr_any) on those inputs in a worker
process of its own: the traversal kernels' device time per call from
torch.profiler (the mean of 10 calls), and the call's device time from CUDA
events (the mean of 20 calls queued behind a sleep). With --other DIR (a
copy of another commit's distributed_raytracer_tpu_torch package, e.g.
`git archive <commit> distributed_raytracer_tpu_torch | tar -x -C DIR`)
the workers run in turns: other, this, this, other; each checks that its
outputs equal the recorded plain-version outputs bit for bit. The frame
workers, in the same turns, time render_fast() at an orbit pose of the
640x480 frame (median of 30 synchronized calls), the frozen bounced frame
and render_dynamic() of the 1080p sphere grid (medians of 10), each also
by the host's enqueue time, and profile each: the device's busy share of
the profiled window, kernels and host launch calls per frame, and the
device ms per frame of K1, K2, K3n, K3a and the rest (kernels are classed
by name: the origin form is a template argument, and seed_keys /
unpack_keys are instantiated per form, so K3n's key launches are booked
to K3n). They also time render_many() of 32 poses per frame (a tree
without it: 32 render_fast() calls) and run runtime/loop.run_loop over
120 ticks of orbit_events at 640x480 (FPS; a tree without the loop says
so).

--cut also times, in every tree, the 640x480 K1 and K2 launches with
every tile's run of items cut to its first cap items (how much the longest
runs cost); --chunks times K1, K2 (640x480), K3n (bounce 1) and K3a at
other chunk lengths (ops/bsr_trace.CHUNK, both origin forms) in this tree
only.

--ring times the geometry ring instead: the K6 and K7 queries of one
use_rdma=True 640x480 frame of the sphere grid over 4 ranks, recorded
once in this tree with their plain-version outputs; each tree's worker (in
turns, as above) checks its ring_nearest / ring_any outputs bit for bit
against them, times each query (median of 10 synchronized calls, and the
K6 or K7 kernel time per query summed over the ranks' streams from
torch.profiler, the mean of 3 queries), times the RDMA ring frame
(median of 10 synchronized frames) and profiles 3 frames (busy share,
kernels per frame, device ms per kernel class). The 4 ranks share cuda:0,
or with
--cards N sit one per card on cuda:0..N-1 (rank i on cuda:(i % N));
--chunks sweeps ops/ring_trace.CHUNK for K6 and K7 in this tree only.

--mxu times the tensor-core form instead (use_mxu=True: K4, K5): the K4
and K5 launches of one 640x480 render() of icosphere_scene(6) and the
three K5 launches (bounces 0, 1, 2) of one depth-2 render_bounced() of the
1080p sphere grid, recorded once in this tree, each with its twin: the
same work in the (T, 16) form (K1 on pack_tris_origin rows, K2 on the
use_mxu=False renderer's stacked per-light rows). Each tree's worker (in
turns, as above) runs its K4/K5 wrappers on them and saves their outputs;
every turn's outputs must equal the first turn's (the other tree's, with
--other) bit for bit, t compared as values (a winning t of -0.0 comes back
as +0.0 through a key merge). Each worker times the kernels (profiler,
mean of 10 calls; CUDA events, mean of 20) and the twins on the same work,
and render_fast() of the 640x480 use_mxu=True frame (median of 30
synchronized calls); --chunks sweeps ops/bsr_trace.CHUNK for K4 and K5 in
the second turn (this tree).

Prints one line per measurement, and writes them to --out FILE if given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile


def _load_profiling():
    """This tree's utils/profiling.py, loaded by its path: a worker puts
    another tree's package first on the import path, and that tree may
    predate the module."""
    name = "_kernel_ab_profiling"
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "utils", "profiling.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


profiling = _load_profiling()
kernel_class = profiling.kernel_class

# --cut: the longest runs of items per tile allowed.
CUT_CAPS = (64, 42, 32, 21, 16, 8, 4, 2, 1)
# --chunks: the launches swept.
CHUNK_SWEEP = ("K1 640x480 primary", "K2 640x480 shadows",
               "K3n bounced 1080p bounce 1", "K3a bounced 1080p bounce 1")


def _profile(fn, n: int):
    """(busy share of the window, {class: device ms per call}, kernels per
    call, host launch calls per call) over n calls of fn under
    torch.profiler (profiling.anatomy; copies and sets count as "other");
    the host calls are the CUDA runtime's kernel, graph and copy
    launches."""
    a = profiling.anatomy(profiling.profile_events(fn, n), n)
    per = dict(a["device_ms"])
    if a["copy_ms"]:
        per["other"] = per.get("other", 0.0) + a["copy_ms"]
    return a["busy"], per, a["kernels"], a["host_launch_calls"]


def _events_ms(fn, calls: int = 20) -> float:
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


def _traversal_ms(fn, n: int = 10) -> float:
    """Device ms per call of the traversal kernels (profiler)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if profiling.TRAVERSAL.search(e.key)) / 1e3 / n


def _bits(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _equal(got, want) -> bool:
    import torch

    got = got if isinstance(got, tuple) else (got,)
    return all(torch.equal(_bits(g), _bits(w.to(g.device)))
               for g, w in zip(got, want))


# -- the worker, run inside a tree ------------------------------------------

def _worker_kernels(path: str, cut: bool) -> list:
    import torch

    from distributed_raytracer_tpu_torch.ops import _build, bsr_trace

    _build.load_library()
    rows = []
    for i, rec in enumerate(torch.load(path)):
        args = tuple(a.cuda() if isinstance(a, torch.Tensor) else a
                     for a in rec["args"])
        fn = getattr(bsr_trace, rec["wrapper"])
        call = lambda: fn(*args, **rec["kwargs"])
        same = _equal(call(), rec["want"])
        row = {"tag": rec["tag"], "equal": same,
               "kernel_ms": _traversal_ms(call), "call_ms": _events_ms(call)}
        if cut and i < 2:                   # the 640x480 K1 and K2 launches
            row["cut"] = []
            for cap in CUT_CAPS:
                short = _recut(args, cap)
                row["cut"].append((cap, int(short[6].item()), _traversal_ms(
                    lambda: fn(*short, **rec["kwargs"]))))
        rows.append(row)
    return rows


def _worker_frames() -> dict:
    """The frames of the tree on the import path: per frame kind the
    synchronized median ms, the host's enqueue ms (from an idle card to
    the call's return) and a profile (busy share, device ms per kernel
    class, kernels and host launch calls per frame). A tree without
    render_many times 32 render_fast calls in its place; a tree without
    runtime/loop.py has no loop FPS."""
    import statistics
    import time

    import numpy as np
    import torch

    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.ops.render_dynamic import (
        DynamicCulledRenderer)
    from distributed_raytracer_tpu_torch.runtime import animation
    from distributed_raytracer_tpu_torch.utils import scenes

    def sync_ms(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def enqueue_ms(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    out = {}

    def frame(key, fn, n, profiled):
        out[key + "_ms"] = sync_ms(fn, n)
        out[key + "_enqueue_ms"] = enqueue_ms(fn, n)
        out[key] = _profile(fn, profiled)

    scene = scenes.icosphere_scene(6)
    r = CulledRenderer(scene, 640, 480, block_size="auto", device="cuda")
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    poses = animation.orbit_camera_path(scene.camera, 16, radius=3.0)
    for cam in poses:
        r.render_fast(cam)
    frame("render_fast", lambda: r.render_fast(poses[1]), 30, 10)
    many = animation.orbit_camera_path(scene.camera, MANY, radius=3.0)
    if hasattr(r, "render_many"):
        batch = lambda: r.render_many(many)
    else:
        batch = lambda: [r.render_fast(cam) for cam in many]
    out["many_native"] = hasattr(r, "render_many")
    batch()
    out["many_ms"] = sync_ms(batch, 5) / MANY
    out["many_enqueue_ms"] = enqueue_ms(batch, 5) / MANY
    try:
        from distributed_raytracer_tpu_torch.runtime.loop import run_loop
    except ImportError:
        out["loop"] = None
    else:
        events = list(animation.orbit_events(640, LOOP_TICKS,
                                             fov=scene.camera.fov,
                                             revolutions=0.25))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, stats, dropped = run_loop(None, scene.camera,
                                     lambda s, c: r.render_fast(c), 640,
                                     480, events=events)
        out["loop"] = {"mean_fps": stats.mean_fps,
                       "median_fps": stats.median_fps, "dropped": dropped,
                       "frames": stats.frames_drawn,
                       "ms_per_frame": (time.perf_counter() - t0) * 1e3
                       / LOOP_TICKS}
    grid = scenes.instanced_grid(scenes.icosphere_scene(3), 4)
    b = CulledRenderer(grid, 1920, 1080, block_size="auto", device="cuda")
    fast = b.freeze_bounced(grid.camera, 2)
    radius = float(np.linalg.norm(grid.camera.pos))
    gp = animation.orbit_camera_path(grid.camera, 8, radius=radius,
                                     revolutions=0.1)
    for cam in gp:
        fast(cam)
    frame("bounced", lambda: fast(gp[1]), 10, 3)
    d = DynamicCulledRenderer(grid, 1920, 1080, device="cuda")
    d.render(grid.camera, block=True)
    d.freeze(grid.camera)
    diffs = animation.orbit_object_diffs(grid, 16)
    for k, diff in enumerate(diffs):
        d.render_dynamic(grid.camera, diff, verify=(k % 8 == 0))
    frame("dynamic", lambda: d.render_dynamic(grid.camera, diffs[3]), 10, 3)
    return out


# Frames of render_many's batch, and run_loop's orbit_events ticks.
MANY, LOOP_TICKS = 32, 120


def _values_equal(got, want) -> bool:
    """Outputs equal, float32 compared as values (-0.0 == +0.0)."""
    import torch

    return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


def _worker_mxu(path: str, out_path: str, chunks: str) -> list:
    import statistics
    import time

    import torch

    from distributed_raytracer_tpu_torch.ops import _build, bsr_trace
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.runtime import animation
    from distributed_raytracer_tpu_torch.utils import scenes

    _build.load_library()
    cuda = lambda a: (tuple(cuda(x) for x in a) if isinstance(a, tuple)
                      else a.cuda() if isinstance(a, torch.Tensor) else a)
    rows, outs = [], []
    for rec in torch.load(path):
        fn = getattr(bsr_trace, rec["wrapper"])
        args = cuda(rec["args"])
        kw = {k: cuda(v) for k, v in rec["kwargs"].items()}
        targs, tkw = cuda(rec["twin_args"]), rec["twin_kwargs"]
        call = lambda: fn(*args, **kw)
        twin = lambda: fn(*targs, **tkw)
        got = call()
        got = got if isinstance(got, tuple) else (got,)
        outs.append(tuple(g.cpu() for g in got))
        row = {"tag": rec["tag"], "kernel_ms": _traversal_ms(call),
               "call_ms": _events_ms(call), "twin_ms": _traversal_ms(twin)}
        if chunks:
            chosen = bsr_trace.CHUNK
            row["chunks"] = []
            for chunk in (int(c) for c in chunks.split(",") if c):
                bsr_trace.CHUNK = chunk
                row["chunks"].append((chunk, _traversal_ms(call)))
            bsr_trace.CHUNK = chosen
        rows.append(row)
    torch.save(outs, out_path)
    scene = scenes.icosphere_scene(6)
    r = CulledRenderer(scene, 640, 480, block_size="auto", device="cuda",
                       use_mxu=True)
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    poses = animation.orbit_camera_path(scene.camera, 16, radius=3.0)
    for cam in poses:
        r.render_fast(cam)
    times = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_fast(poses[1])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rows.append({"tag": "render_fast", "ms": statistics.median(times)})
    return rows


def _record_mxu(path: str) -> list:
    """Records the tensor-core launches with their (T, 16) twins into
    path; returns [(tag, pairs)]."""
    import torch

    from distributed_raytracer_tpu_torch.ops import bsr_trace
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.utils import scenes

    seen = {}
    originals = {n: getattr(bsr_trace, n) for n in ("bsr_nearest",
                                                    "bsr_any")}

    def recorder(name):
        def call(*args, **kwargs):
            if isinstance(args[2], tuple):
                seen.setdefault(name, []).append((args, dict(kwargs)))
            return originals[name](*args, **kwargs)
        return call

    scene = scenes.icosphere_scene(6)
    plain = CulledRenderer(scene, 640, 480, block_size="auto", device="cuda")
    mxu = CulledRenderer(None, 640, 480, prebaked=(plain.arrays_host,
                                                   plain.tree),
                         device="cuda", use_mxu=True)
    grid = scenes.instanced_grid(scenes.icosphere_scene(3), 4)
    g_plain = CulledRenderer(grid, 1920, 1080, block_size="auto",
                             device="cuda")
    g_mxu = CulledRenderer(None, 1920, 1080, prebaked=(g_plain.arrays_host,
                                                       g_plain.tree),
                           device="cuda", use_mxu=True)
    try:
        for n in originals:
            setattr(bsr_trace, n, recorder(n))
        mxu.render(scene.camera, block=True)
        main = dict(seen)
        seen.clear()
        g_mxu.render_bounced(grid.camera, 2, block=True)
    finally:
        for n, fn in originals.items():
            setattr(bsr_trace, n, fn)

    def twin(args, kwargs, tris):
        return ((args[0], args[1], tris) + tuple(args[3:]),
                {k: v for k, v in kwargs.items() if k != "ablock_ids"})

    args, kwargs = main["bsr_nearest"][-1]
    launches = [("K4 640x480 primary", "bsr_nearest", args, kwargs,
                 twin(args, kwargs, bsr_trace.pack_tris_origin(
                     plain.dev_scene.tris_packed, args[0][0:3, 0])))]
    args, kwargs = main["bsr_any"][-1]
    launches.append(("K5 640x480 shadows", "bsr_any", args, kwargs,
                     twin(args, kwargs, plain.dev_scene.lights_scal)))
    for i, (args, kwargs) in enumerate(seen["bsr_any"]):
        launches.append((f"K5 bounced 1080p bounce {i}", "bsr_any", args,
                         kwargs, twin(args, kwargs,
                                      g_plain.dev_scene.lights_scal)))
    cpu = lambda a: (tuple(cpu(x) for x in a) if isinstance(a, tuple)
                     else a.cpu() if isinstance(a, torch.Tensor) else a)
    torch.save([{"tag": tag, "wrapper": wrapper, "args": cpu(args),
                 "kwargs": {k: cpu(v) for k, v in kwargs.items()},
                 "twin_args": cpu(t[0]),
                 "twin_kwargs": t[1]}
                for tag, wrapper, args, kwargs, t in launches], path)
    return [(tag, min(int(args[6].reshape(-1)[0].item()), args[3].shape[0])
             * kwargs["rt"] * kwargs["tb"])
            for tag, _, args, kwargs, _ in launches]


def _main_mxu(a, here: str, say) -> None:
    """--mxu: K4 and K5 in turns against --other, outputs held equal."""
    import torch

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mxu.pt")
        sizes = _record_mxu(path)
        turns = ([("other", a.other), ("this", here), ("this", here),
                  ("other", a.other)] if a.other else [("this", here)])
        runs, outs = [], []
        for i, (who, tree) in enumerate(turns):
            out = os.path.join(d, f"out{i}.pt")
            runs.append((who, _run_worker(
                tree, "mxu", path, chunks=a.chunks if i == min(
                    1, len(turns) - 1) else "", out=out)))
            outs.append(torch.load(out))
    for i, (tag, pairs) in enumerate(sizes):
        # The tensor-core bound: 54 tensor operations per pair at the TF32
        # peak, or the 6-operation epilogue at the FP32 peak; as issued (K
        # padded to 8, 144 per pair); the 21-operation FP32 bound.
        tc = max(pairs * 54 / 495e12, pairs * 6 / 67e12) * 1e3
        issued = pairs * 144 / 495e12 * 1e3
        fp32 = pairs * 21 / 67e12 * 1e3
        say(f"[mxu] {tag}: {pairs / 1e9:.4f} G pairs; bound {tc:.4f} ms "
            f"(tensor-core), {issued:.4f} ms as issued, {fp32:.4f} ms at 21 "
            f"FP32 operations per pair")
        for (who, rows), out in zip(runs, outs):
            r = rows[i]
            say(f"    {who}: kernels {r['kernel_ms']:.4f} ms "
                f"({tc / r['kernel_ms']:.2%} of the tensor-core bound, {fp32 / r['kernel_ms']:.2%} of "
                f"the 21-operation one), call {r['call_ms']:.4f} ms; twin "
                f"(K1/K2 on the same work) {r['twin_ms']:.4f} ms; outputs "
                f"equal to the first turn's: "
                f"{_values_equal(out[i], outs[0][i])}")
            for chunk, ms in r.get("chunks", ()):
                say(f"        {chunk} items per block: kernels {ms:.4f} ms")
    for who, rows in runs:
        say(f"[mxu] {who} render_fast 640x480 use_mxu=True: "
            f"{rows[-1]['ms']:.3f} ms synchronized (median of 30)")


# Phase ring: the 640x480 sphere-grid frame over RING_N ranks.
RING_N = 4
RING_W, RING_H = 640, 480


def _ring_scene():
    from distributed_raytracer_tpu_torch.utils import scenes

    grid = scenes.instanced_grid(scenes.icosphere_scene(3), 4)
    return grid, grid.bake()


def _ring_renderer(arrays, mesh):
    from distributed_raytracer_tpu_torch.parallel import ring

    return ring.make_ring_renderer(ring.pad_for_ring(arrays, len(mesh)),
                                   RING_W, RING_H, mesh=mesh, use_rdma=True)


def _sync_all(cards: int) -> None:
    import torch

    for d in range(cards):
        torch.cuda.synchronize(d)


def _median_ms(fn, n: int, cards: int) -> float:
    import statistics
    import time

    fn()
    times = []
    for _ in range(n):
        _sync_all(cards)
        t0 = time.perf_counter()
        fn()
        _sync_all(cards)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _class_ms(fn, cls: str, n: int, cards: int) -> float:
    """Device ms per call of the kernels of class `cls` (profiler), summed
    over every stream and card."""
    import torch

    fn()
    _sync_all(cards)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        _sync_all(cards)
    return sum(e.device_time_total for e in prof.key_averages()
               if kernel_class(e.key) == cls) / 1e3 / n


def _ring_mesh(cards: int) -> list:
    return [f"cuda:{i % cards}" for i in range(RING_N)]


def _worker_ring(path: str, cards: int, chunks: str) -> dict:
    import torch

    from distributed_raytracer_tpu_torch.ops import _build, ring_trace
    from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod

    _build.load_library("ring_trace")
    mesh = _ring_mesh(cards)
    ranks = mesh_mod.Ranks(mesh)
    rec = torch.load(path)
    out = {}
    for name, cls in (("ring_nearest", "K6"), ("ring_any", "K7")):
        args = [[x.to(d) for x, d in zip(part, mesh)]
                for part in rec[name]["args"]]
        fn = getattr(ring_trace, name)
        call = lambda: fn(ranks, *args, rt=rec["rt"])
        got = call()
        _sync_all(cards)
        got = got if isinstance(got, tuple) else (got,)
        same = all(_equal(tuple(g), tuple(w))
                   for g, w in zip(got, rec[name]["want"]))
        out[cls] = {"equal": same, "query_ms": _median_ms(call, 10, cards),
                    "kernel_ms": _class_ms(call, cls, 3, cards)}
        if chunks:
            chosen = ring_trace.CHUNK
            out[cls]["chunks"] = []
            for chunk in (int(c) for c in chunks.split(",") if c):
                ring_trace.CHUNK = chunk
                out[cls]["chunks"].append(
                    (chunk, _median_ms(call, 10, cards),
                     _class_ms(call, cls, 3, cards)))
            ring_trace.CHUNK = chosen
    grid, arrays = _ring_scene()
    render = _ring_renderer(arrays, mesh)
    out["frame_ms"] = _median_ms(lambda: render(grid.camera), 10, cards)
    out["frame_profile"] = _profile(lambda: render(grid.camera), 3)
    return out


def _record_ring(path: str, cards: int) -> dict:
    """Records one frame's K6 and K7 queries and their plain-version
    outputs into path; returns {wrapper: (pairs, rays)}."""
    import torch

    from distributed_raytracer_tpu_torch.ops import ring_trace

    grid, arrays = _ring_scene()
    render = _ring_renderer(arrays, _ring_mesh(cards))
    seen = {}
    originals = {n: getattr(ring_trace, n) for n in ("ring_nearest",
                                                      "ring_any")}

    def recorder(name):
        def call(*args, **kwargs):
            seen[name] = (args, dict(kwargs))
            return originals[name](*args, **kwargs)
        return call

    try:
        for n in originals:
            setattr(ring_trace, n, recorder(n))
        render(grid.camera)
    finally:
        for n, fn in originals.items():
            setattr(ring_trace, n, fn)
    rec, sizes = {}, {}
    for name, (args, kwargs) in seen.items():
        want = getattr(ring_trace, name + "_ref")(*args, **kwargs)
        _sync_all(cards)
        want = want if isinstance(want, tuple) else (want,)
        rec[name] = {"args": [[x.cpu() for x in part] for part in args[1:]],
                     "want": [[x.cpu() for x in part] for part in want]}
        rays, tris = args[1], args[2]
        sizes[name] = (sum(x.shape[1] for x in rays)
                       * sum(x.shape[0] for x in tris),
                       sum(x.shape[1] for x in rays))
        rec["rt"] = kwargs["rt"]
    torch.save(rec, path)
    return sizes


def _main_ring(a, here: str, say) -> None:
    """--ring: K6, K7 and the RDMA frame in turns against --other."""
    import torch

    if torch.cuda.device_count() < a.cards:
        raise RuntimeError(f"--cards {a.cards}: {torch.cuda.device_count()} "
                           "cards visible")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ring.pt")
        sizes = _record_ring(path, a.cards)
        turns = ([("other", a.other), ("this", here), ("this", here),
                  ("other", a.other)] if a.other else [("this", here)])
        runs = [(who, _run_worker(tree, "ring", path, cards=a.cards,
                                  chunks=a.chunks if who == "this" and i == 1
                                  else ""))
                for i, (who, tree) in enumerate(turns)]
    mesh = ", ".join(_ring_mesh(a.cards))
    for name, cls in (("ring_nearest", "K6"), ("ring_any", "K7")):
        pairs, rays = sizes[name]
        say(f"[ring] {cls} {name}: {RING_N} ranks on {mesh}; {rays} rays, "
            f"{pairs / 1e9:.4f} G pairs")
        for who, res in runs:
            r = res[cls]
            say(f"    {who}: query {r['query_ms']:.4f} ms synchronized "
                f"(median of 10), {cls} kernels {r['kernel_ms']:.4f} ms per "
                f"query summed over the streams (profiler); equal to the "
                f"plain version: {r['equal']}")
            for chunk, ms, k_ms in r.get("chunks", ()):
                say(f"        {chunk} items per block: query {ms:.4f} ms, "
                    f"kernels {k_ms:.4f} ms")
    for who, res in runs:
        busy, per, nk, _ = res["frame_profile"]
        say(f"[ring] {who} RDMA frame {RING_W}x{RING_H}, {RING_N} ranks on "
            f"{mesh}: {res['frame_ms']:.3f} ms synchronized (median of 10); "
            f"profiled (3 frames): busy {busy:.3f} (any card), {nk:.0f} "
            f"kernels per frame, device ms per frame summed over the "
            f"streams " + ", ".join(f"{k} {v:.4f}"
                                    for k, v in sorted(per.items())))


# -- the parent process -------------------------------------------------------

def _record(path: str) -> list:
    """Records the launches and their plain-version outputs into path."""
    import torch

    from distributed_raytracer_tpu_torch.ops import bsr_trace
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.utils import scenes

    seen = {}
    originals = {n: getattr(bsr_trace, n) for n in ("bsr_nearest",
                                                    "bsr_any")}

    def recorder(name):
        def call(*args, **kwargs):
            seen.setdefault((name, kwargs["shared_origin"]), []).append(
                (args, dict(kwargs)))
            return originals[name](*args, **kwargs)
        return call

    try:
        for n in originals:
            setattr(bsr_trace, n, recorder(n))
        scene = scenes.icosphere_scene(6)
        CulledRenderer(scene, 640, 480, block_size="auto",
                       device="cuda").render(scene.camera, block=True)
        main = dict(seen)
        seen.clear()
        grid = scenes.instanced_grid(scenes.icosphere_scene(3), 4)
        CulledRenderer(grid, 1920, 1080, block_size="auto",
                       device="cuda").render_bounced(grid.camera, 2,
                                                     block=True)
    finally:
        for n, fn in originals.items():
            setattr(bsr_trace, n, fn)
    launches = [("K1 640x480 primary", "bsr_nearest",
                 main[("bsr_nearest", True)][-1]),
                ("K2 640x480 shadows", "bsr_any", main[("bsr_any", True)][-1])]
    launches += [(f"K2 bounced 1080p bounce {i}", "bsr_any", c)
                 for i, c in enumerate(seen[("bsr_any", True)])]
    launches += [(f"K3n bounced 1080p bounce {i}", "bsr_nearest", c)
                 for i, c in enumerate(seen[("bsr_nearest", False)])]
    # K3a: the bounce-1 rays and exclude ids, t_max = K3n's finite hit t.
    args, kwargs = seen[("bsr_nearest", False)][1]
    best_t, _ = bsr_trace.bsr_nearest_ref(*args, **kwargs)
    rays = args[0].clone()
    rays[6] = torch.where(torch.isfinite(best_t), best_t, bsr_trace.BIG_TMAX)
    launches.append(("K3a bounced 1080p bounce 1", "bsr_any", (
        (rays,) + tuple(args[1:]),
        {k: kwargs[k] for k in ("rt", "tb", "shared_origin", "exit_every")})))
    recs = []
    for tag, wrapper, (args, kwargs) in launches:
        want = getattr(bsr_trace, wrapper + "_ref")(*args, **kwargs)
        want = want if isinstance(want, tuple) else (want,)
        recs.append({"tag": tag, "wrapper": wrapper, "kwargs": kwargs,
                     "args": tuple(a.cpu() if isinstance(a, torch.Tensor)
                                   else a for a in args),
                     "want": tuple(w.cpu() for w in want)})
    torch.save(recs, path)
    return launches


def _run_worker(tree: str, mode: str, path: str = "",
                cut: bool = False, cards: int = 1,
                chunks: str = "", out: str = "") -> object:
    """Runs this file's worker with `tree` first on the import path."""
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", mode,
         "--tree", tree, "--launches", path, "--cards", str(cards),
         "--chunks", chunks, "--out", out] + ["--cut"] * cut,
        capture_output=True, text=True, timeout=1200)
    for line in res.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[7:])
    raise RuntimeError(f"{mode} worker in {tree} failed:\n"
                       f"{res.stderr[-3000:]}")


def _recut(args, cap: int):
    """The launch with every tile's run cut to its first cap items."""
    import numpy as np
    import torch

    tile_ids = args[3]
    n = int(args[6].reshape(-1)[0].item())
    t = tile_ids[:n].cpu().numpy()
    keep = np.nonzero(np.arange(n) - np.searchsorted(t, t) < cap)[0]
    idx = np.concatenate([keep, np.full(len(tile_ids) - len(keep),
                                        keep[-1])])
    idx = torch.from_numpy(idx).to(tile_ids.device)
    new = list(args)
    for k in (3, 4, 5):
        new[k] = args[k][idx].contiguous()
    new[6] = torch.full((1,), len(keep), dtype=torch.int32,
                        device=tile_ids.device)
    return tuple(new)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another tree's package root")
    ap.add_argument("--cut", action="store_true")
    ap.add_argument("--chunks", default="")
    ap.add_argument("--out")
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--mxu", action="store_true")
    ap.add_argument("--cards", type=int, default=1)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--launches", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        sys.path.insert(0, os.path.abspath(a.tree))
        result = (_worker_kernels(a.launches, a.cut)
                  if a.worker == "kernels"
                  else _worker_ring(a.launches, a.cards, a.chunks)
                  if a.worker == "ring"
                  else _worker_mxu(a.launches, a.out, a.chunks)
                  if a.worker == "mxu" else _worker_frames())
        print("RESULT " + json.dumps(result))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from distributed_raytracer_tpu_torch.ops import bsr_trace

    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    say(f"gpu: {card}; torch {torch.__version__}")
    if a.ring:
        _main_ring(a, here, say)
    elif a.mxu:
        _main_mxu(a, here, say)
    else:
        _main_traversal(a, here, say, bsr_trace)
    say(f"gpu: {card}")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def _main_traversal(a, here: str, say, bsr_trace) -> None:
    """K1-K3a and the culled frames in turns against --other."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "launches.pt")
        launches = _record(path)
        turns = ([("other", a.other), ("this", here), ("this", here),
                  ("other", a.other)] if a.other else [("this", here)])
        runs = [(who, _run_worker(tree, "kernels", path, a.cut))
                for who, tree in turns]
        for i, (tag, wrapper, (args, kwargs)) in enumerate(launches):
            n = int(args[6].reshape(-1)[0].item())
            pairs = n * kwargs["rt"] * kwargs["tb"]
            ops = 21 if kwargs["shared_origin"] else 39
            bound = pairs * ops / 67e12 * 1e3
            say(f"[kernels] {tag}: {n} live items, {pairs / 1e9:.4f} G "
                f"pairs, bound {bound:.4f} ms (FP32 operations)")
            for who, rows in runs:
                r = rows[i]
                say(f"    {who}: kernels {r['kernel_ms']:.4f} ms, call "
                    f"{r['call_ms']:.4f} ms, {bound / r['kernel_ms']:.2%} "
                    f"of the bound; equal to the plain version: "
                    f"{r['equal']}")
                for cap, items, ms in r.get("cut", ()):
                    say(f"        runs cut to {cap} items per tile: {items} "
                        f"items, kernels {ms:.4f} ms")
        for who, tree in turns:
            f = _run_worker(tree, "frames")
            for key in ("render_fast", "bounced", "dynamic"):
                busy, per, nk, nl = f[key]
                say(f"[frames] {who} {key}: {f[key + '_ms']:.3f} ms "
                    f"synchronized (median), host enqueue "
                    f"{f[key + '_enqueue_ms']:.3f} ms; profiled: busy "
                    f"{busy:.3f}, {nk:.0f} kernels and {nl:.0f} host launch "
                    f"calls per frame, device ms per frame "
                    + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                        per.items())))
            say(f"[frames] {who} render_many K={MANY}"
                + ("" if f["many_native"] else " (no render_many: "
                   f"{MANY} render_fast calls)")
                + f": {f['many_ms']:.3f} ms per frame synchronized (median "
                  f"of 5 batches), host enqueue {f['many_enqueue_ms']:.3f} "
                  "ms per frame")
            loop = f["loop"]
            say(f"[frames] {who} run_loop 640x480, {LOOP_TICKS} ticks: "
                + ("no runtime/loop.py in this tree" if loop is None else
                   f"mean FPS {loop['mean_fps']:.1f}, median "
                   f"{loop['median_fps']:.1f}, {loop['frames']} frames, "
                   f"{loop['dropped']} dropped, {loop['ms_per_frame']:.3f} "
                   "ms per frame over the loop"))
    for tag, wrapper, (args, kwargs) in launches:
        if tag not in CHUNK_SWEEP:
            continue
        fn = getattr(bsr_trace, wrapper)
        chosen = bsr_trace.CHUNK
        for chunk in (int(c) for c in a.chunks.split(",") if c):
            bsr_trace.CHUNK = chunk
            ms = _traversal_ms(lambda: fn(*args, **kwargs))
            bsr_trace.CHUNK = chosen
            say(f"[chunks] {tag}, {chunk} items per block: kernels "
                f"{ms:.4f} ms")


if __name__ == "__main__":
    sys.exit(main())
