#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the traversal kernels from csrc/ and runs three phases on cuda:0:

  1. Kernels against their plain PyTorch versions. One 640x480 frame of
     icosphere_scene(6) (81,920 triangles, 3 lights) is rendered on the
     card, recording the real inputs of the nearest-hit launch (primary
     rays) and of the any-hit launch (all lights). Each kernel runs on them
     with exit_every 0 and 32 and must agree with its plain version on the
     same CUDA tensors: nearest ids equal on every ray, t equal where the
     ids agree (both round identically: the kernels are built with
     -fmad=false), any-hit flags equal. Times are medians of 20 calls after
     warm-up, with a device synchronize around each call.
  2. The frame end to end: render(), freeze(), a 16-pose orbit through
     render_fast(verify=True), one render_fast under CUDA's sync-debug
     "error" mode (it must not wait on the device), and the first pose on a
     device="cpu" renderer built from the same bake (the plain versions),
     held to the repository's culled-vs-dense bound: max-channel diff >
     2/255 on < 0.5% of pixels and mean |diff| < 1e-4. The launch counters
     are reset before this phase and must both be > 0 after it.
  3. The command line: the same sphere written as OBJ + scene.json, 30
     frames through distributed_raytracer_tpu_torch.run.main on cuda.

Prints the versions, the card's name and power limit, the build time, each
phase's numbers, one JSON line of per-kernel results and, last, one JSON
line {"ok": true, "device": {...}}. Exits non-zero without that line on any
failure, when CUDA is not available, or when run outside the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

W, H = 640, 480
SUBDIV = 6          # icosphere_scene(6): 81,920 triangles
ORBIT = 16
REPEATS = 20
SOURCE = "distributed_raytracer_tpu_torch/csrc/bsr_trace.cu"
REPLACES = {
    "bsr_nearest": "distributed_raytracer_tpu/ops/pallas/bsr_trace.py:356",
    "bsr_any": "distributed_raytracer_tpu/ops/pallas/bsr_trace.py:411",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_query() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median wall time of `fn()` in ms, synchronized around each call,
    after two warm-up calls."""
    import torch

    for _ in range(2):
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


def record_launches(bsr_trace):
    """Replace the wrappers with recorders of their arguments; returns the
    record and a function that restores the wrappers."""
    seen = {}
    originals = {name: getattr(bsr_trace, name) for name in REPLACES}

    def recorder(name):
        def call(*args, **kwargs):
            seen[name] = (args, dict(kwargs))
            return originals[name](*args, **kwargs)
        return call

    for name in REPLACES:
        setattr(bsr_trace, name, recorder(name))

    def restore():
        for name, fn in originals.items():
            setattr(bsr_trace, name, fn)

    return seen, restore


def visited_rays(args, kwargs):
    """(R,) bool: rays of the tiles named by the live work-list slots."""
    import torch

    rays, tile_ids, count = args[0], args[3], args[6]
    rt = kwargs["rt"]
    n = min(int(count.item()), tile_ids.shape[0])
    v = torch.zeros(rays.shape[1] // rt, dtype=torch.bool, device=rays.device)
    v[tile_ids[:n].long()] = True
    return v[:, None].expand(-1, rt).reshape(-1)


def phase_kernels(renderer, scene, bsr_trace):
    """Phase 1: each kernel against its plain version on the main path's
    real inputs."""
    import torch

    seen, restore = record_launches(bsr_trace)
    try:
        renderer.render(scene.camera, block=True)
    finally:
        restore()
    check(set(seen) == set(REPLACES), f"recorded launches: {sorted(seen)}")
    results = {}
    for name in REPLACES:
        args, kwargs = seen[name]
        kernel = getattr(bsr_trace, name)
        plain = getattr(bsr_trace, name + "_ref")
        vis = visited_rays(args, kwargs)
        err = 0.0
        for exit_every in (0, 32):
            kw = dict(kwargs, exit_every=exit_every)
            got = kernel(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            if name == "bsr_nearest":
                (gt, gi), (wt, wi) = got, want
                bad = int((gi != wi)[vis].sum())
                check(bad == 0, f"{name} exit_every={exit_every}: {bad} ids "
                                "differ on visited tiles")
                both = vis & torch.isfinite(wt)
                diff = (gt - wt).abs()[both]
                e = float(diff.max()) if diff.numel() else 0.0
                check(e == 0.0, f"{name} exit_every={exit_every}: t differs "
                                f"by {e} where the ids agree")
                check(bool(torch.equal(gi, wi) and torch.equal(gt[~vis],
                                                               wt[~vis])),
                      f"{name}: unvisited tiles differ from init")
            else:
                bad = int((got != want).sum())
                check(bad == 0, f"{name} exit_every={exit_every}: {bad} "
                                "any-hit flags differ")
                e = float((got - want).abs().max())
            err = max(err, e)
        ms = time_ms(lambda: kernel(*args, **kwargs))
        plain_ms = time_ms(lambda: plain(*args, **kwargs))
        w = args[3].shape[0]
        n = int(args[6].item())
        print(f"[phase 1] {name}: R={args[0].shape[1]} T={args[2].shape[0]} "
              f"W={w} live items={n} exit_every(main path)="
              f"{kwargs['exit_every']} max_abs_err={err} kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return results


def phase_frame(renderer, scene, bsr_trace):
    """Phase 2: the frame end to end on the card, against the plain
    versions on the CPU."""
    import numpy as np
    import torch

    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.runtime import animation

    for name in bsr_trace.LAUNCHES:
        bsr_trace.LAUNCHES[name] = 0
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
    launches = dict(bsr_trace.LAUNCHES)
    print(f"[phase 2] render() {render_ms:.3f} ms; render_fast(verify=True) "
          f"median {statistics.median(fast_ms):.3f} ms over {ORBIT} poses; "
          f"render_fast() {nosync_ms:.3f} ms; counts {counts}; pads "
          f"{renderer._frozen_pads}; exit_every {renderer.exit_every}; "
          f"launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
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
    return launches


def write_scene(d: str, scene, mesh) -> str:
    """The scene as OBJ + MTL + scene.json (the reference's schema)."""
    m = mesh.materials[0]
    with open(os.path.join(d, "sphere.mtl"), "w") as f:
        f.write("newmtl mat\n"
                f"Ka {m.ka[0]!r} {m.ka[1]!r} {m.ka[2]!r}\n"
                f"Kd {m.kd[0]!r} {m.kd[1]!r} {m.kd[2]!r}\n"
                f"Ks {m.ks[0]!r} {m.ks[1]!r} {m.ks[2]!r}\n"
                f"Ns {m.ns!r}\n")
    lines = ["mtllib sphere.mtl"]
    lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in mesh.vertices.tolist()]
    lines += [f"vn {x!r} {y!r} {z!r}" for x, y, z in mesh.normals.tolist()]
    lines.append("usemtl mat")
    lines += ["f " + " ".join(f"{v + 1}//{n + 1}" for v, n in zip(fv, fn))
              for fv, fn in zip(mesh.faces_v.tolist(), mesh.faces_n.tolist())]
    with open(os.path.join(d, "sphere.obj"), "w") as f:
        f.write("\n".join(lines) + "\n")
    cam = scene.camera
    xyz = lambda v: {"x": float(v[0]), "y": float(v[1]), "z": float(v[2])}
    doc = {"objs": [{"model": "sphere.obj", "pos": xyz([0, 0, 0])}],
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


def phase_cli(scene, mesh):
    """Phase 3: the command line on the card."""
    from distributed_raytracer_tpu_torch import run

    with tempfile.TemporaryDirectory() as d:
        path = write_scene(d, scene, mesh)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run.main([path, str(W), str(H), "--frames", "30",
                           "--fps-target", "0", "--radius", "3",
                           "--device", "cuda"])
        secs = time.perf_counter() - t0
    check(rc == 0, f"run.main returned {rc}")
    report = [l for l in out.getvalue().splitlines()
              if l.startswith(("Mean FPS", "Median FPS", "Throughput"))]
    check(len(report) == 3, f"no FPS report in: {out.getvalue()!r}")
    for line in report:
        print(f"[phase 3] {line}")
    print(f"[phase 3] CLI total {secs:.1f} s (scene load, bake, sizing, "
          "30 frames)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distributed_raytracer_tpu_torch.ops import _build, bsr_trace
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.utils import scenes

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    card = gpu_query()
    print(f"gpu: {card}")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _build.build_logs.get("bsr_trace", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    scene = scenes.icosphere_scene(SUBDIV)
    t0 = time.perf_counter()
    renderer = CulledRenderer(scene, W, H, block_size="auto", device="cuda")
    print(f"scene: {scene.num_tris} triangles, tb={renderer.tb}, "
          f"{renderer.tree.num_blocks} blocks, groups {renderer.groups}, "
          f"{renderer.n_tiles} ray tiles; bake + upload "
          f"{time.perf_counter() - t0:.1f} s")

    kernels = phase_kernels(renderer, scene, bsr_trace)
    launches = phase_frame(renderer, scene, bsr_trace)
    phase_cli(scene, scenes.icosphere_mesh(SUBDIV))

    print(f"gpu: {gpu_query()}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         **kernels[name]} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
