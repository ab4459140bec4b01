"""Recovery against a really dead render client: a killed process.

The counterpart of the JAX package's tools/loop_recovery_smoke.py. A
sticky CUDA error (an illegal address, a device-side assert) poisons the
process's CUDA context, and no rebuild inside that process heals it
(runtime/loop.py); only a new process does. This harness proves that path,
the reference's worker re-registration (pool.go:224-260,
worker/distributed/main.go:160-185):

  - a CHILD process owns the device (its own CUDA context) and serves
    frozen CulledRenderer frames of utils/scenes.example_scene() over a
    pipe: 13 float64 camera values in (pos, forward, left, up, fov),
    length-prefixed uint8 RGB out (the JAX tool's wire protocol);
  - the parent's render_fn proxies to it;
  - at a scripted frame the parent SIGKILLs the child;
  - dead-pipe renders raise, drops accumulate, and the loop's recover hook
    starts a FRESH child: a new interpreter, a new CUDA context, the scene
    loaded again;
  - every frame shown after recovery must equal the healthy pass's frame
    for the same pose, bit for bit.

Children are started with subprocess (a fresh interpreter, never a fork of
a process that has touched CUDA), each bounded by a timeout; a child that
fails has its stderr reported. On a card the parent builds the kernels
before the first child starts, so every child only loads them.

    python -m distributed_raytracer_tpu_torch.tools.loop_recovery_smoke \\
        [--device cuda:0]

The CPU variant runs in the tests (tests/test_torch_recovery_child.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_FRAME_FLOATS = 13   # pos(3) forward(3) left(3) up(3) fov(1)


def child_main(w: int, h: int, device: str) -> int:
    """Serve frozen culled frames over stdin/stdout (length-prefixed u8
    RGB) until the parent closes the pipe. A CUDA device without a card
    raises (CulledRenderer refuses it): nothing falls back to the CPU."""
    from distributed_raytracer_tpu_torch.models.camera import CameraArrays
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.runtime import framebuffer
    from distributed_raytracer_tpu_torch.utils import scenes

    scene = scenes.example_scene()
    r = CulledRenderer(scene, w, h, device=device)
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    out = sys.stdout.buffer
    out.write(b"READY\n")
    out.flush()
    inp = sys.stdin.buffer
    while True:
        raw = inp.read(8 * _FRAME_FLOATS)
        if len(raw) < 8 * _FRAME_FLOATS:
            return 0                       # the parent closed the pipe
        v = np.frombuffer(raw, np.float64).astype(np.float32)
        cam = CameraArrays(pos=v[0:3], forward=v[3:6], left=v[6:9],
                           up=v[9:12], fov=v[12])
        data = framebuffer.to_u8_device(r.render_fast(cam)).cpu().numpy()
        out.write(struct.pack("<I", data.nbytes))
        out.write(data.tobytes())
        out.flush()


class ChildRenderer:
    """The master-side proxy: one render client living in a child process.

    render() raises on a dead or closed child (the loop counts that as a
    dropped frame, as the reference counts a failed BulkTrace,
    pool.go:169-175). Each wait on the child is bounded: past its timeout
    the child is killed and the wait fails."""

    def __init__(self, w: int, h: int, device: str,
                 ready_timeout: float = 300.0, frame_timeout: float = 60.0):
        self.w, self.h, self.frame_timeout = w, h, frame_timeout
        self.stderr = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m",
             "distributed_raytracer_tpu_torch.tools.loop_recovery_smoke",
             "--child", str(w), str(h), "--device", device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.stderr, cwd=_REPO)
        line = self._bounded(ready_timeout, self.proc.stdout.readline)
        if line.strip() != b"READY":
            self.kill()
            raise RuntimeError(f"child did not become ready ({line!r}); "
                               f"stderr:\n{self.stderr_text()}")

    def _bounded(self, timeout: float, fn):
        """fn() with the child killed if it takes longer than timeout."""
        timer = threading.Timer(timeout, self.proc.kill)
        timer.start()
        try:
            return fn()
        finally:
            timer.cancel()

    def stderr_text(self, tail: int = 4000) -> str:
        self.stderr.seek(0)
        return self.stderr.read().decode(errors="replace")[-tail:]

    def _exchange(self, v: np.ndarray) -> bytes:
        self.proc.stdin.write(v.tobytes())
        self.proc.stdin.flush()
        hdr = self.proc.stdout.read(4)
        if len(hdr) < 4:
            raise IOError("child pipe closed")
        (n,) = struct.unpack("<I", hdr)
        data = self.proc.stdout.read(n)
        if len(data) < n:
            raise IOError("short frame from child")
        return data

    def render(self, cam) -> np.ndarray:
        v = np.concatenate([np.asarray(cam.pos, np.float64),
                            np.asarray(cam.forward, np.float64),
                            np.asarray(cam.left, np.float64),
                            np.asarray(cam.up, np.float64),
                            [float(cam.fov)]])
        try:
            data = self._bounded(self.frame_timeout,
                                 lambda: self._exchange(v))
        except (OSError, ValueError) as e:
            raise RuntimeError(f"render client dead: {e}") from e
        return np.frombuffer(data, np.uint8).reshape(self.h, self.w, 3)

    def kill(self):
        self.proc.kill()
        self.proc.wait(timeout=30)

    def close(self) -> str:
        """Ends the child (closing its input, killing it if it does not
        exit) and returns the tail of its stderr."""
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            self.kill()
        self.proc.stdout.close()
        text = self.stderr_text()
        self.stderr.close()
        return text


def run_smoke(w: int = 160, h: int = 120, n_ticks: int = 24,
              kill_at: int = 6, device: str = "cuda:0", log=print):
    """A golden pass (a healthy child), then a faulted pass (the child
    SIGKILLed after frame `kill_at` is shown; recovery starts a fresh
    child). Returns (ok, detail); a child that fails to start raises with
    its stderr."""
    from distributed_raytracer_tpu_torch.runtime import animation
    from distributed_raytracer_tpu_torch.runtime.loop import run_loop
    from distributed_raytracer_tpu_torch.utils import scenes
    from distributed_raytracer_tpu_torch.utils.config import DEFAULT_CONFIG

    if device.startswith("cuda"):
        from distributed_raytracer_tpu_torch.ops import _build

        _build.build_all()
    scene = scenes.example_scene()
    events = lambda: list(animation.orbit_events(w, n_ticks,
                                                 fov=scene.camera.fov))
    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=3,
                              frames_in_flight=1)

    # Pass 1: a healthy run -> golden frames per index.
    child = ChildRenderer(w, h, device)
    golden = {}
    _, stats_ok, dropped_ok = run_loop(
        None, scene.camera, lambda s, c: child.render(c), w, h,
        events=events(),
        display=lambda idx, img: golden.__setitem__(idx, np.array(img)),
        cfg=cfg)
    err = child.close()
    if dropped_ok:
        return False, (f"healthy pass dropped {dropped_ok} frames; child "
                       f"stderr:\n{err}")
    log(f"  healthy pass: {stats_ok.frames_total} frames")

    # Pass 2: kill the client mid-stream; the recover hook re-registers.
    state = {"child": ChildRenderer(w, h, device), "spawned": 1}
    shown = {}

    def display(idx, img):
        shown[idx] = np.array(img)
        if idx == kill_at:
            log(f"  killing render client at frame {idx}")
            state["child"].kill()

    def recover(attempt):
        log(f"  recover attempt {attempt}: starting a fresh client")
        state["child"].kill()
        state["child"] = ChildRenderer(w, h, device)
        state["spawned"] += 1
        return lambda s, c: state["child"].render(c)

    _, stats, dropped = run_loop(
        None, scene.camera, lambda s, c: state["child"].render(c), w, h,
        events=events(), display=display, cfg=cfg, recover=recover)
    err = state["child"].close()

    if stats.recoveries != 1:
        return False, (f"expected 1 recovery, got {stats.recoveries}; last "
                       f"child's stderr:\n{err}")
    if state["spawned"] != 2:
        return False, f"expected 2 client processes, got {state['spawned']}"
    resumed = [i for i in shown if i > kill_at]
    if not resumed:
        return False, "no frames displayed after the kill"
    for i in resumed:
        if i in golden and not np.array_equal(shown[i], golden[i]):
            return False, f"post-recovery frame {i} != healthy frame"
    checked = len([i for i in resumed if i in golden])
    if not checked:
        return False, "no post-recovery frame had a healthy twin"
    return True, (f"{stats.frames_total} issued, {dropped} dropped, 1 "
                  f"recovery, {checked} post-recovery frames equal to the "
                  f"healthy run's")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", nargs=2, type=int, metavar=("W", "H"))
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    if a.child:
        return child_main(*a.child, a.device)
    t0 = time.monotonic()
    ok, detail = run_smoke(device=a.device)
    print(f"loop_recovery_smoke: {'PASSED' if ok else 'FAILED'} in "
          f"{time.monotonic() - t0:.0f}s on {a.device}: {detail}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
