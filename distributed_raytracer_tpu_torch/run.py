"""Command-line renderer: the analog of the reference's binaries.

  python -m distributed_raytracer_tpu_torch SCENE.json WIDTH HEIGHT [options]

The counterpart of distributed_raytracer_tpu/run.py, on an explicit
device (`--device`, default cuda). Modes:
  sequential - the single-device dense sweep (ops/render.render_frame)
  culled     - the single-device block-BVH renderer, with `--bounces N`
               Whitted reflection bounces, or `--animate-objects`: object 0
               orbits through per-frame scene diffs
  sharded    - the dense sweep with the rays row-partitioned over
               `--devices N` ranks (parallel/render_sharded.py); the ranks
               are a device list, rank i on cuda:(i % cards), so N ranks
               may share one card, or all on the CPU with --device cpu
  sharded-bvh - the culled renderer on one band of rows per rank
               (parallel/render_sharded_bvh.py), `--balance` for
               cost-balanced band heights, `--bounces N` on equal bands
  halo       - the culled geometry halo (parallel/halo_bvh.py): triangle
               shards stay put and the rays are exchanged, `--bounces N`,
               and `--animate-objects` through per-frame scene diffs
  ring       - the culled geometry ring (parallel/ring_bvh.py): triangle
               shards rotate past resident rays, `--bounces N`, and
               `--animate-objects` through per-frame scene diffs
With no display, the interactive loop becomes a scripted camera
animation (default: orbit, the reference's benchmark motion); frames can
be written as PNGs, and the exit report reproduces the master's FPS
statistics (master/main.go:285-325) plus Mrays/s. `--serve HOST:PORT`
runs the interactive loop (runtime/loop.py) behind the browser viewer
(runtime/viewer.py) instead, in every ported mode, until a client sends
Esc; with `--animate-objects` each viewer tick carries the next diff as
the loop's scene state (`served_dynamic`), so the object moves one diff a
tick.

`--multihost --coordinator HOST:PORT --num-processes P --process-id I`
runs one of P processes of one job (parallel/multihost.py), each on its
own device (`--device cuda`: card I % cards; several processes may share a
card). `--devices N` then counts the ranks of the whole job and must split
evenly over the processes (default: one rank per process). The sharded,
sharded-bvh, halo and ring modes run one program over every process's
ranks; sequential and culled modes render the whole frame in every
process, as the JAX CLI does. Process 0 alone writes the frames and prints
the report. The transport (NCCL when every process owns a card, else
gloo) is printed by every process before the first frame.

`--trace-out PATH` turns the tracer on (utils/tracing.py) before the
renderer is built and writes its spans, device stage stamps and counters
as a chrome trace to PATH at exit (PATH.I for process I > 0 of a
multi-process job); a browser's trace viewer (chrome://tracing, Perfetto)
opens it.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

_MODES = ["sequential", "culled", "sharded", "sharded-bvh", "halo", "ring"]


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_raytracer_tpu_torch",
        description="Raytracer on PyTorch with CUDA kernels",
    )
    p.add_argument("scene", help="JSON scene file (reference schema)")
    p.add_argument("width", type=int)
    p.add_argument("height", type=int)
    p.add_argument("--mode", choices=_MODES, default="culled")
    p.add_argument("--bounces", type=int, default=0,
                   help="Whitted reflection bounces (culled, sharded-bvh, "
                        "halo and ring modes)")
    p.add_argument("--devices", type=int, default=None,
                   help="rank count for the sharded, sharded-bvh, halo "
                        "and ring modes (default: one per card)")
    p.add_argument("--balance", action="store_true",
                   help="cost-balanced band heights for --mode sharded-bvh "
                        "(the least-loaded-scheduler analog)")
    p.add_argument("--animate-objects", action="store_true",
                   help="orbit object 0 via per-frame SceneDiffs (the "
                        "reference's per-WorkOrder EnvMutables, "
                        "master/main.go:260-266; culled, halo and ring "
                        "modes)")
    p.add_argument("--object-radius", type=float, default=1.0,
                   help="orbit radius for --animate-objects")
    p.add_argument("--serve", metavar="HOST:PORT", default=None,
                   help="serve an interactive browser viewer instead of the "
                        "scripted animation (the SDL window analog)")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-process job (the master/worker "
                        "topology analog); process 0 assembles + reports")
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="coordinator address for --multihost (process 0 "
                        "binds it, the registrar analog)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--frames", type=int, default=60,
                   help="animation frames to render")
    p.add_argument("--animation", choices=["orbit", "strafe", "none"],
                   default="orbit")
    p.add_argument("--radius", type=float, default=6.0,
                   help="orbit radius (distance to look-at point)")
    p.add_argument("--revolutions", type=float, default=1.0)
    p.add_argument("--out", default=None,
                   help="directory to write frame PNGs (omit to skip IO)")
    p.add_argument("--fps-target", type=int, default=30,
                   help="pace frames like the reference's 30 Hz loop; "
                        "0 = flat out")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:N or cpu)")
    p.add_argument("--trace-out", metavar="PATH", default=None,
                   help="record the program's spans and device stage "
                        "stamps and write them as a chrome trace to PATH "
                        "at exit")
    return p


def _periodic_verify(render_v, period: int = 8):
    """Check the frozen work-list buckets every `period` frames only (a
    host sync in the call, or, inside runtime/loop.run_loop, a read when
    the loop drains the frame), so a silent overflow lasts at most
    period - 1 frames."""
    k = [0]

    def render(cam):
        v = (k[0] % period) == 0
        k[0] += 1
        return render_v(cam, v)

    return render


def served_dynamic(dyn, diffs):
    """--serve --animate-objects: (the scene states, render_fn(state,
    camera_arrays)) for runtime/loop.run_loop. The states are (k, diff k
    of `diffs`, cycled), one for each viewer tick (runtime/viewer.serve's
    `scenes`): the scene moves one diff a tick, so every tick makes a
    frame, and a frame issued again is drawn with its own diff. The frame
    of every 8th diff verifies its buckets."""
    states = ((k, diffs[k % len(diffs)]) for k in itertools.count())

    def render(state, cam):
        k, diff = state
        return dyn.render_dynamic(cam, diff, verify=(k % 8 == 0))

    return states, render


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    multi = args.multihost or args.coordinator is not None
    if multi:
        if (args.coordinator is None or args.num_processes is None
                or args.process_id is None):
            raise SystemExit("--multihost needs --coordinator HOST:PORT, "
                             "--num-processes and --process-id")
        if args.devices is not None and (
                args.devices < 1 or args.devices % args.num_processes):
            raise SystemExit(f"--devices {args.devices} must split evenly "
                             f"over --num-processes {args.num_processes}")
        if args.serve:
            raise SystemExit("--serve runs in one process; it does not "
                             "combine with --multihost")
    if args.bounces < 0:
        raise SystemExit(f"--bounces {args.bounces}: must be >= 0")
    if args.animate_objects:
        # The JAX package's guards and messages.
        if args.mode not in ("culled", "halo", "ring") or (
                args.bounces and args.mode == "culled"):
            raise SystemExit("--animate-objects supports --mode "
                             "culled/halo/ring (--bounces on halo/ring)")
        if multi or (args.serve and args.mode != "culled"):
            raise SystemExit("--animate-objects + --serve needs --mode "
                             "culled; --multihost is unsupported")

    from distributed_raytracer_tpu_torch.parallel import multihost
    from distributed_raytracer_tpu_torch.utils import tracing

    device = args.device
    if multi:
        tr = multihost.initialize(args.coordinator, args.num_processes,
                                  args.process_id, device=args.device)
        device = multihost.process_device(args.process_id, args.device)
        print(f"multihost: process {tr.process} of {tr.n_procs} on "
              f"{device}, transport {tr.backend}", flush=True)
    if args.trace_out:
        tracing.enable()
    try:
        return _run(args, device)
    finally:
        if args.trace_out:
            tracing.disable()
            path = args.trace_out
            if multi and args.process_id:
                path = f"{path}.{args.process_id}"
            tracing.write_chrome_trace(path)
        multihost.shutdown()


def _run(args, device) -> int:
    """Builds the mode's renderer on `device` (this process's) and runs the
    animation or the viewer."""
    from distributed_raytracer_tpu_torch.models.scene import load_scene
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.parallel import multihost
    from distributed_raytracer_tpu_torch.runtime import animation, framebuffer
    from distributed_raytracer_tpu_torch.runtime.stats import FrameTimer
    from distributed_raytracer_tpu_torch.utils import tracing

    scene = load_scene(args.scene)
    w, h = args.width, args.height
    # --serve: the scene states its ticks carry (None: the scene as
    # loaded, never moved).
    scene_states = None
    diffs = (animation.orbit_object_diffs(scene, args.frames,
                                          radius=args.object_radius,
                                          revolutions=args.revolutions)
             if args.animate_objects else None)

    if args.mode in ("sequential", "sharded"):
        # The dense sweep; --bounces applies to culled mode only, as in the
        # JAX CLI.
        from distributed_raytracer_tpu_torch.ops.render import (render_frame,
                                                                scene_on)
        from distributed_raytracer_tpu_torch.parallel import render_sharded

        if args.mode == "sequential":
            arrays = scene_on(scene.bake(), device)
            render = lambda cam: render_frame(arrays, cam, w, h)
        else:
            mesh = multihost.global_mesh(args.devices, device)
            arrays = scene_on(scene.bake(), device)
            sharded = render_sharded.make_sharded_renderer(w, h, mesh=mesh)
            render = lambda cam: sharded(arrays, cam)
        render_k = lambda k, cam: render(cam)
        render_arrays = render
    elif args.mode in ("sharded-bvh", "halo", "ring"):
        from distributed_raytracer_tpu_torch.parallel import (
            halo_bvh, render_sharded_bvh, ring_bvh)

        mesh = multihost.global_mesh(args.devices, device)
        if args.mode in ("halo", "ring"):
            # Halo bounces gather the reflection rays and fold the
            # candidates home again; ring bounces move no rays (they stay
            # resident and the next rotation streams the geometry past).
            cls = (halo_bvh.HaloCulledRenderer if args.mode == "halo"
                   else ring_bvh.RingCulledRenderer)
            r = cls(scene, w, h, mesh=mesh, bounces=args.bounces,
                    dynamic=args.animate_objects)
            render_v = r.render
        elif args.bounces:
            r = render_sharded_bvh.make_sharded_bounced_renderer(
                scene, w, h, args.bounces, mesh=mesh)
            render_v = r
        else:
            r = render_sharded_bvh.make_sharded_culled_renderer(
                scene, w, h, mesh=mesh, balance=args.balance)
            render_v = r
        if args.animate_objects:
            render_k = lambda k, cam: r.render_dynamic(
                cam, diffs[k], verify=(k % 8 == 0))
        else:
            render = _periodic_verify(render_v)
            render_k = lambda k, cam: render(cam)
        render_arrays = render_v
    elif args.animate_objects:
        # Per-frame object/light diffs through the frozen pipeline
        # (ops/render_dynamic.py), block size 128 as in the JAX CLI.
        from distributed_raytracer_tpu_torch.ops.render_dynamic import (
            DynamicCulledRenderer)

        dyn = DynamicCulledRenderer(scene, w, h, device=device)
        dyn.render(scene.camera, block=True)
        dyn.freeze(scene.camera)
        render_k = lambda k, cam: dyn.render_dynamic(
            cam, diffs[k], verify=(k % 8 == 0))
        scene_states, render_state = served_dynamic(dyn, diffs)
    else:
        # block_size="auto": the per-scene leaf policy
        # (utils/config.default_block_size).
        culled = CulledRenderer(scene, w, h, block_size="auto",
                                device=device)
        if args.bounces:
            bounced = culled.freeze_bounced(scene.camera, args.bounces)
            render = _periodic_verify(bounced)
            render_arrays = bounced
        else:
            culled.render(scene.camera, block=True)
            culled.freeze(scene.camera)
            render = _periodic_verify(
                lambda cam, v: culled.render_fast(cam, verify=v))
            render_arrays = lambda c: culled.render_fast(c)
        render_k = lambda k, cam: render(cam)

    if args.serve:
        from distributed_raytracer_tpu_torch.runtime import viewer

        host, _, port = args.serve.rpartition(":")
        if scene_states is None:
            render_state = lambda s, c: render_arrays(c)
        cam, stats, dropped = viewer.serve(
            None, scene.camera, render_state, w, h,
            host=host or "127.0.0.1", port=int(port),
            on_ready=lambda v: print(f"viewer at {v.url}", flush=True),
            scenes=scene_states)
        if stats is not None:
            print(stats.report())
        print(f"Frames dropped: {dropped}.")
        return 0

    if args.animation == "none":
        poses = [scene.camera] * args.frames
    elif args.animation == "strafe":
        poses = []
        cam = scene.camera
        for _ in range(args.frames):
            cam = cam.move(0.1, leftward=True)
            poses.append(cam)
    else:
        poses = animation.orbit_camera_path(scene.camera, args.frames,
                                            radius=args.radius,
                                            revolutions=args.revolutions)

    # Warm up outside the timed loop (the reference never counts startup
    # either — its first frame just runs slow).
    multihost.gather_frame(render_k(0, poses[0]))

    master = multihost.is_master()
    if args.out and master:
        os.makedirs(args.out, exist_ok=True)

    timer = FrameTimer()
    ms_per_frame = 1000.0 / args.fps_target if args.fps_target else 0.0
    for k, cam in enumerate(poses):
        tick = time.monotonic()
        tracing.set_frame(k)
        timer.frame_issued()
        img = render_k(k, cam)
        if args.out and img is not None:
            # u8 on the device before the host copy: 1 byte per channel
            # crosses instead of a float32.
            img = framebuffer.to_u8_device(img)
        # Frame assembly: process 0 holds the frame (the coordinator
        # painting worker tiles, master/main.go:163-177); None elsewhere.
        img_np = multihost.gather_frame(img)
        timer.frame_drawn()
        if args.out and img_np is not None:
            framebuffer.write_png(os.path.join(args.out, f"frame_{k:05d}.png"),
                                  img_np)
        if ms_per_frame:
            elapsed = (time.monotonic() - tick) * 1000.0
            if elapsed < ms_per_frame:
                time.sleep((ms_per_frame - elapsed) / 1000.0)

    stats = timer.stats()
    if stats is not None and master:
        print(stats.report())
        rays = w * h * (1 + scene.light_pos.shape[0])
        print(f"Throughput: {stats.mean_fps * w * h / 1e6:.2f} M primary "
              f"rays/s ({stats.mean_fps * rays / 1e6:.2f} M total rays/s "
              "incl. shadows).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
