"""One process of a multi-process render (parallel/multihost.py).

    python -m distributed_raytracer_tpu_torch.tools.multihost_worker \\
        PID NPROC PORT SCENE OUT [MODES] [--device cpu|cuda|cuda:K]
        [--ranks-per-process 2] [--size 48x36] [--depth 1] [--frames 0]
        [--pitch A] [--sizing-yaw A] [--orbit N] [--profile]

The counterpart of the JAX package's tests/multihost_worker.py: NPROC such
processes (PID 0..NPROC-1) join one job through the coordinator
127.0.0.1:PORT, each running --ranks-per-process ranks on its own device,
and render SCENE (a scene.json, or "icosphere:S" / "grid:S:K" for
utils/scenes.icosphere_scene(S) / instanced_grid(icosphere_scene(S), K))
at --size. Each process loads and bakes the scene itself; an all-gathered
checksum of the baked arrays raises if the bakes differ. MODES is a
comma-separated list (default "dense") of:
  dense                row-sharded dense sweep (parallel/render_sharded.py)
  sharded-bvh          culled bands, geometry replicated
  sharded-bvh-balanced cost-balanced band heights
  sharded-bvh-bounced  the bands with --depth reflection bounces
  halo                 culled geometry halo: rays exchanged (all_to_all and
                       all_gather across the process boundary)
  ring                 culled geometry ring: shards rotated across it
Each mode is sized on the scene camera (yawed by --sizing-yaw; with
--orbit N, on pose 0 of tools/schedule_frames.orbit's N poses), renders
the scene camera (pitched by --pitch; with --orbit, pose 1) once with the
verify loop, then --frames more frames without it, timed (every process
starts each frame at a barrier and ends it synchronized). Process 0 saves each mode's first frame to OUT-MODE.npy. Every process
prints one JSON line: its backend and device, and per mode the launch
counts of K1, K2 and K3n over the first frame, the frame times, the bytes
it sent to other processes per frame, the buckets before and after the
first frame (every process must show the same) and the per-rank counts
of that frame's first pass; with --profile, the busy share and host
launch calls per frame from one torch.profiler window of 2 frames.

`render_case` is the same path for a single-process mesh: the tests and
chip_smoke.py compute their references with it. `launch` starts NPROC
workers from another program (chip_smoke.py, tools/schedule_frames.py)
under a timeout and returns their reports.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

MODES = ("dense", "sharded-bvh", "sharded-bvh-balanced",
         "sharded-bvh-bounced", "halo", "ring")
# The launch counters of the kernels on these paths.
KERNEL_KEYS = {"K1": "bsr_nearest", "K2": "bsr_any",
               "K3n": "bsr_nearest_rays"}


def load(spec: str):
    """A scene from a scene.json path or a procedural spec."""
    from distributed_raytracer_tpu_torch.models.scene import load_scene
    from distributed_raytracer_tpu_torch.utils import scenes

    kind, *args = spec.split(":")
    if kind == "icosphere":
        return scenes.icosphere_scene(int(args[0]))
    if kind == "grid":
        return scenes.instanced_grid(scenes.icosphere_scene(int(args[0])),
                                     int(args[1]))
    return load_scene(spec)


def checksum(bake) -> str:
    """sha256 of every array of a bake (a SceneArrays, or one with its
    BlockBVH), in order."""
    import numpy as np

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, tuple):         # the NamedTuples and their pair
            for v in x:
                feed(v)
        else:
            a = np.ascontiguousarray(np.asarray(x))
            h.update(str((a.dtype, a.shape)).encode())
            h.update(a.tobytes())

    feed(bake)
    return h.hexdigest()


def build(mode: str, scene, w: int, h: int, mesh, depth: int,
          sizing_camera):
    """(render(cam, verify) -> the (H, W, 3) frame on process 0 / None
    elsewhere, buckets() -> the renderer's buckets, counts() -> its last
    per-rank counts, layout() -> the balanced bands' (starts, rows) or
    None, the bake the renderer was built from)."""
    from distributed_raytracer_tpu_torch.ops.render import scene_on
    from distributed_raytracer_tpu_torch.parallel import (
        halo_bvh, mesh as mesh_mod, render_sharded, render_sharded_bvh,
        ring_bvh)

    if mode == "dense":
        arrays = scene.bake()
        dev = mesh_mod.Ranks(mesh).device
        on_dev = scene_on(arrays, dev)
        r = render_sharded.make_sharded_renderer(w, h, mesh=mesh)
        return (lambda cam, verify: r(on_dev, cam), lambda: None,
                lambda: None, lambda: None, arrays)
    if mode.startswith("sharded-bvh"):
        bake = scene.bake_bvh(block_size=128)
        if mode == "sharded-bvh-bounced":
            r = render_sharded_bvh.make_sharded_bounced_renderer(
                None, w, h, depth, mesh=mesh, sizing_camera=sizing_camera,
                prebaked=bake)
        else:
            r = render_sharded_bvh.make_sharded_culled_renderer(
                None, w, h, mesh=mesh, sizing_camera=sizing_camera,
                prebaked=bake, balance=mode.endswith("balanced"))
        layout = getattr(r, "layout", lambda: None)
        return (lambda cam, verify: r(cam, verify=verify), r.buckets,
                lambda: r.last_counts, layout, bake)
    if mode in ("halo", "ring"):
        cls = (halo_bvh.HaloCulledRenderer if mode == "halo"
               else ring_bvh.RingCulledRenderer)
        r = cls(scene, w, h, mesh=mesh, sizing_camera=sizing_camera)
        return (lambda cam, verify: r.render(cam, verify=verify),
                lambda: (r.w_pads, r.w_pads_sh), lambda: r.last_counts,
                lambda: None, r.bake)
    raise SystemExit(f"unknown mode {mode}")


def _nested(x):
    """A host value (tensors and arrays too) as JSON carries it: nested
    lists of numbers."""
    return json.loads(json.dumps(x, default=lambda v: v.tolist()))


def render_case(mode: str, scene, w: int, h: int, mesh, depth: int = 1,
                camera=None, sizing_camera=None):
    """One mode's first frame over `mesh` (a plain or a process mesh), as
    the worker renders it, with the verify loop: {"frame": numpy on
    process 0 / None elsewhere, "buckets": {"before", "after"}, "counts":
    the frame's per-rank counts, "layout": the balanced bands' (starts,
    rows) or None, "checksum": the bake's, "render": render(cam,
    verify)}, host values as JSON carries them. The kernel launch
    counters are zeroed after the build: they count the frame alone."""
    from distributed_raytracer_tpu_torch.ops import bsr_trace
    from distributed_raytracer_tpu_torch.parallel import multihost

    camera = scene.camera if camera is None else camera
    sizing_camera = scene.camera if sizing_camera is None else sizing_camera
    render, buckets, counts, layout, bake = build(
        mode, scene, w, h, mesh, depth, sizing_camera)
    before = _nested(buckets())
    for key in bsr_trace.LAUNCHES:
        bsr_trace.LAUNCHES[key] = 0
    frame = multihost.gather_frame(render(camera, True))
    return {"frame": frame,
            "buckets": {"before": before, "after": _nested(buckets())},
            "counts": _nested(counts()), "layout": _nested(layout()),
            "checksum": checksum(bake), "render": render}


def timed(render, camera, frames: int, ranks_device, barrier) -> list:
    """Wall ms of `frames` frames, each begun at a barrier of every process
    and ended with this process's device synchronized."""
    import torch

    out = []
    for _ in range(frames):
        barrier()
        t0 = time.perf_counter()
        render(camera, False)
        if ranks_device.type == "cuda":
            torch.cuda.synchronize(ranks_device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_all(cmds, envs=None, timeout_s: float = 600.0, cwd=None) -> list:
    """Runs the commands as processes at once; returns their stdouts. When
    one fails or the time runs out, every process still running is killed
    (a peer blocked in a collective would otherwise wait for its own
    timeout) and RuntimeError carries each one's exit code and stderr."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        files = [(open(os.path.join(d, f"{i}.out"), "w+"),
                  open(os.path.join(d, f"{i}.err"), "w+"))
                 for i in range(len(cmds))]
        procs = [subprocess.Popen(c, cwd=cwd, stdout=o, stderr=e,
                                  env=None if envs is None else envs[i],
                                  text=True)
                 for i, (c, (o, e)) in enumerate(zip(cmds, files))]
        deadline = time.monotonic() + timeout_s
        while True:
            rcs = [p.poll() for p in procs]
            failed = any(rc for rc in rcs if rc is not None)
            late = time.monotonic() > deadline
            if all(rc is not None for rc in rcs) or failed or late:
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for o, e in files:
            o.seek(0)
            e.seek(0)
            texts.append((o.read(), e.read()))
            o.close()
            e.close()
    rcs = [p.returncode for p in procs]
    if late or any(rcs):
        why = f"timed out after {timeout_s} s" if late else "failed"
        raise RuntimeError(f"processes {why}, exit codes {rcs}; stderr of "
                           f"each: {[e[-3000:] for _, e in texts]}")
    return [o for o, _ in texts]


def launch(nproc: int, scene: str, out: str, modes: str, cards=None,
           extra=(), timeout_s: float = 600.0) -> list:
    """Runs nproc workers at once (`python -m` this module, run_all) and
    returns every process's JSON report. cards[i] is the one card worker i
    sees (CUDA_VISIBLE_DEVICES): processes given one card share it (over
    gloo), processes given a card each own it (NCCL)."""
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cmds, envs = [], []
    for pid in range(nproc):
        env = dict(os.environ)
        if cards is not None:
            env["CUDA_VISIBLE_DEVICES"] = str(cards[pid])
        envs.append(env)
        cmds.append([sys.executable, "-m",
                     "distributed_raytracer_tpu_torch.tools.multihost_worker",
                     str(pid), str(nproc), str(port), scene, out, modes,
                     *extra])
    outs = run_all(cmds, envs, timeout_s, cwd=root)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("pid", type=int)
    p.add_argument("nproc", type=int)
    p.add_argument("port", type=int)
    p.add_argument("scene")
    p.add_argument("out")
    p.add_argument("modes", nargs="?", default="dense")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks-per-process", type=int, default=2)
    p.add_argument("--size", default="48x36")
    p.add_argument("--depth", type=int, default=1)
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--sizing-yaw", type=float, default=0.0)
    p.add_argument("--orbit", type=int, default=0)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    modes = args.modes.split(",")
    for m in modes:
        if m not in MODES:
            raise SystemExit(f"unknown mode {m}; modes: {', '.join(MODES)}")

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from distributed_raytracer_tpu_torch.ops import bsr_trace
    from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
    from distributed_raytracer_tpu_torch.parallel import multihost

    tr = multihost.initialize(f"127.0.0.1:{args.port}", args.nproc,
                              args.pid, device=args.device)
    try:
        mesh = multihost.global_mesh(args.nproc * args.ranks_per_process,
                                     args.device)
        ranks = mesh_mod.Ranks(mesh)
        w, h = (int(v) for v in args.size.split("x"))
        scene = load(args.scene)
        cam = scene.camera.pitch(args.pitch)
        sizing = scene.camera.yaw(args.sizing_yaw)
        if args.orbit:
            from distributed_raytracer_tpu_torch.tools import schedule_frames

            sizing, cam = schedule_frames.orbit(scene, args.orbit)[:2]
        barrier = lambda: torch.distributed.barrier(group=tr.host_group)
        report = {"process": args.pid, "processes": args.nproc,
                  "backend": tr.backend, "device": str(ranks.device),
                  "ranks": list(ranks.local), "modes": {}}
        for mode in modes:
            case = render_case(mode, scene, w, h, mesh, args.depth, cam,
                               sizing)
            frame, digest = case["frame"], case["checksum"]
            if ranks.cuda:
                torch.cuda.synchronize(ranks.device)
            launches = {k: bsr_trace.LAUNCHES[v]
                        for k, v in KERNEL_KEYS.items()}
            digests = [None] * args.nproc
            torch.distributed.all_gather_object(digests, digest,
                                                group=tr.host_group)
            if len(set(digests)) != 1:
                raise RuntimeError(f"the processes' bakes differ: {digests}")
            if args.pid == 0:
                np.save(f"{args.out}-{mode}.npy", frame)
            elif frame is not None:
                raise RuntimeError("a process other than 0 got the frame")
            mesh_mod.CROSSED.update(bytes=0, calls=0)
            render = case["render"]
            ms = timed(render, cam, args.frames, ranks.device, barrier)
            res = {"launches": launches, "ms": ms,
                   "buckets": case["buckets"], "counts": case["counts"],
                   "layout": case["layout"], "checksum": digest[:16],
                   "bytes_per_frame": (mesh_mod.CROSSED["bytes"]
                                       / max(args.frames, 1)),
                   "exchanges_per_frame": (mesh_mod.CROSSED["calls"]
                                           / max(args.frames, 1))}
            if args.profile:
                from distributed_raytracer_tpu_torch.tools import (
                    schedule_frames)

                barrier()
                prof = schedule_frames.profile(lambda: render(cam, False))
                res.update(busy=prof["busy"],
                           host_launch_calls=prof["host_launch_calls"],
                           device_ms=prof["device_ms"])
            report["modes"][mode] = res
            barrier()
        print(json.dumps(report), flush=True)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
