"""Interactive frame loop with pipelined dispatch.

The counterpart of the JAX package's runtime/loop.py, and of the reference
master's 30 Hz input loop + per-frame coordinator goroutines
(master/main.go:240-280, :94-187). The reference pipelines frames by
spawning one coordinator per frame and forcing in-order display with a
channel chain; here the device queue is the pipeline: each frame is
enqueued without blocking (a frozen render is one CUDA graph replay), its
device-to-host copy starts at once on a copy stream, a bounded deque of
in-flight frames (cfg.frames_in_flight) provides backpressure, and FIFO
completion guarantees in-order display. Input events come from a pluggable
source (scripted animation when headless, or runtime/viewer.py); the
display sink is a callback.

Fault handling, as in the JAX package: a failed frame (the render raises
when it is dispatched, or its copy fails when it is drained) is a dropped
frame and the stream continues, with drop accounting preserved. After
cfg.max_consecutive_drops drops in a row the loop calls the pluggable
`recover` hook to rebuild the render path (the reference worker's
re-registration, worker/distributed/main.go:160-185) and resumes; it aborts
when recovery is unavailable, fails or is used up (cfg.max_recoveries).
`make_culled_recoverer` is the stock hook for the block-sparse path.

The bucket check of a verify frame (ops/frozen_graph.py) runs at the
frame's drain, not at its issue: the loop opens a deferral around each
render call, keeps the checks the call made (and the frame's camera) with
the frame in flight, and settles them once the frame's host copy has
landed, before it is displayed; the render call itself waits for nothing.
A verify frame is never displayed before its counts are known to fit. On
an overflow the check has grown the buckets; the loop then issues the
frame again with its own camera, and every frame still in flight behind
it, in order, abandoning their old copies, so no frame issued after it is
shown with the outgrown buckets, and drains and displays the new frame
under the same index (`COUNTS["verify_reissued"]` counts the frames
issued again). A check that raises is a dropped frame. Outside this loop
a verify check runs before the render call returns.

Spans (utils/tracing.py): `loop.run` (the whole loop, no frame id),
`loop.tick` (one input tick), `loop.issue` (the render call), `loop.drain`
(the wait for a frame's host copy), `frozen.verify` (a verify frame's
check, after its drain) and `loop.display` (the display callback). Each
tick sets the tracer's frame id to the index of the frame it would issue;
a drain, its check and its display carry the drained frame's, and so does
the `loop.issue` of a frame issued again.

A sticky CUDA error (an illegal address, say) poisons the process's CUDA
context: every later launch fails, and a rebuilt renderer in the same
process fails with it. The hook cannot heal that; only a new process can.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import SceneArrays
from distributed_raytracer_tpu_torch.ops import frozen_graph
from distributed_raytracer_tpu_torch.runtime.controller import CameraController
from distributed_raytracer_tpu_torch.runtime.stats import FrameTimer
from distributed_raytracer_tpu_torch.utils import tracing
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

_log = logging.getLogger(__name__)


class _HostCopy:
    """A frame's device-to-host copy in flight: a pinned host tensor
    filled by a non-blocking copy on a copy stream, and the CUDA event
    recorded after it."""

    def __init__(self, img: torch.Tensor, streams: dict):
        dev = img.device
        copy = streams.get(dev)
        if copy is None:
            copy = streams[dev] = torch.cuda.Stream(dev)
        # The copy waits for the frame, and the frame's memory is kept
        # until the copy has read it.
        copy.wait_stream(torch.cuda.current_stream(dev))
        img.record_stream(copy)
        self.host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
        with torch.cuda.stream(copy):
            self.host.copy_(img, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(copy)

    def __array__(self, dtype=None, copy=None):
        self.done.synchronize()    # raises if the device failed
        return np.asarray(self.host.numpy(), dtype=dtype)


def _start_copy(out, streams: dict):
    """A CUDA tensor's host copy starts now; anything else (a host tensor,
    any object with __array__) is converted when it is drained."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        return _HostCopy(out, streams)
    return out


def run_loop(
    scene_arrays: SceneArrays,
    camera: Camera,
    render_fn: Callable,            # (scene, cam_arrays) -> image (H, W, 3)
    width: int,
    height: int,
    events: Iterable,               # iterable of per-tick event lists
    display: Optional[Callable] = None,   # (frame_index, np image) -> None
    cfg: RenderConfig = DEFAULT_CONFIG,
    realtime: bool = False,         # pace ticks at cfg.target_fps (main.go:271-275)
    max_frames: Optional[int] = None,
    recover: Optional[Callable] = None,   # (attempt) -> new render_fn
):
    """Drive the interactive loop until events are exhausted or Esc.

    Each element of `events` is a list of (kind, *args) tuples with kinds
    "key_down"/"key_up"/"mouse" — the HandleInputs analog. `render_fn`
    returns a tensor (on the card or the host) or any object with
    __array__. Returns (final_camera, FrameStats, frames_dropped).

    `recover`, when given, is called with the 1-based attempt number after
    cfg.max_consecutive_drops consecutive dropped frames; it should tear
    down and rebuild the render path and return the replacement render_fn.
    Returning None or raising means recovery failed; the loop aborts after
    cfg.max_recoveries failed-or-exhausted attempts. Successful recoveries
    are counted in FrameStats.recoveries.
    """
    controller = CameraController(width=width, height=height, cfg=cfg)
    timer = FrameTimer()
    # (frame_index, pending image, its deferred checks, its camera arrays)
    in_flight = collections.deque()
    copy_streams = {}
    frames_dropped = 0
    consecutive_drops = 0
    recoveries = 0
    ms_per_frame = 1000.0 / cfg.target_fps

    def try_recover():
        """Rebuild the render path via the `recover` hook. Returns True if
        the stream should continue (with render_fn replaced)."""
        nonlocal render_fn, consecutive_drops, recoveries, frames_dropped
        if recover is None or recoveries >= cfg.max_recoveries:
            return False
        # In-flight results belong to the torn-down path. Abandon them as
        # drops without waiting on them: a path that hangs (rather than
        # raises) would turn the heal path into a deadlock. Display order
        # is preserved (nothing later has been shown).
        while in_flight:
            idx = in_flight.popleft()[0]
            frames_dropped += 1
            _log.warning("frame %d abandoned (recovery)", idx)
        attempt = recoveries + 1
        try:
            new_fn = recover(attempt)
        except Exception:
            _log.exception("recovery attempt %d failed", attempt)
            return False
        if new_fn is None:
            return False
        _log.warning("recovered render path (attempt %d); resuming stream",
                     attempt)
        render_fn = new_fn
        recoveries = attempt
        consecutive_drops = 0
        return True

    def issue(cam_arrays):
        """Enqueues one frame: (its pending image, the checks its render
        call deferred)."""
        with frozen_graph.deferred() as checks:
            out = render_fn(scene_arrays, cam_arrays)
        return _start_copy(out, copy_streams), checks

    def reissue(idx, cam_arrays):
        """After frame idx's check grew the buckets: issues idx again, then
        every frame in flight behind it, in order, with its own camera."""
        nonlocal frames_dropped, consecutive_drops
        frames = [(idx, cam_arrays)] + [(f[0], f[3]) for f in in_flight]
        in_flight.clear()
        for i, cam in frames:
            try:
                with tracing.span("loop.issue", frame=i):
                    pending, checks = issue(cam)
            except Exception:
                frames_dropped += 1
                consecutive_drops += 1
                _log.warning("frame %d dropped (dispatch failure)", i)
                continue
            tracing.COUNTS["verify_reissued"] += 1
            in_flight.append((i, pending, checks, cam))

    def drain_one():
        """Drains, checks and displays the oldest frame in flight (issuing
        it and those behind it again first if its check grew the
        buckets)."""
        nonlocal frames_dropped, consecutive_drops
        while in_flight:
            idx, pending, checks, cam_arrays = in_flight.popleft()
            try:
                with tracing.span("loop.drain", frame=idx):
                    img = np.asarray(pending)  # waits for the host copy
                fit = frozen_graph.settle(checks, idx)
            except Exception:          # device failure -> dropped frame
                frames_dropped += 1
                consecutive_drops += 1
                _log.warning("frame %d dropped (device failure)", idx)
                return
            if fit:
                consecutive_drops = 0
                timer.frame_drawn()
                if display is not None:
                    with tracing.span("loop.display", frame=idx):
                        display(idx, img)
                return
            reissue(idx, cam_arrays)

    tracing.set_frame(None)
    with tracing.span("loop.run"):
        for tick_events in events:
            tracing.set_frame(timer.frames_total)
            with tracing.span("loop.tick"):
                tick_start = time.monotonic()
                for ev in tick_events:
                    kind = ev[0]
                    if kind == "key_down":
                        controller.key_down(ev[1])
                    elif kind == "key_up":
                        controller.key_up(ev[1])
                    elif kind == "mouse":
                        controller.mouse_motion(ev[1], ev[2])
                if not controller.running:
                    break

                # Frames only on input change (main.go:246).
                if controller.dirty:
                    camera = controller.apply(camera)
                    frame_index = timer.frames_total
                    timer.frame_issued()
                    cam_arrays = camera.to_arrays()
                    try:
                        # Dispatch-time protection: render_fn may raise
                        # before any device work is enqueued (bad buckets,
                        # host-side sizing, a failed capture) — contain it
                        # like a failed tile (main.go:119-125), do not let
                        # it escape the loop.
                        with tracing.span("loop.issue"):
                            pending, checks = issue(cam_arrays)
                    except Exception:
                        frames_dropped += 1
                        consecutive_drops += 1
                        _log.warning("frame %d dropped (dispatch failure)",
                                     frame_index)
                    else:
                        in_flight.append((frame_index, pending, checks,
                                          cam_arrays))
                        while len(in_flight) > cfg.frames_in_flight:
                            drain_one()
                    if consecutive_drops >= cfg.max_consecutive_drops:
                        # The render path looks wedged: heal it if we can;
                        # abort only when recovery is unavailable,
                        # exhausted, or itself failing — otherwise the loop
                        # would spin at target FPS with every frame a drop.
                        if not try_recover():
                            _log.error("aborting after %d consecutive "
                                       "dropped frames", consecutive_drops)
                            break
                    if (max_frames is not None
                            and timer.frames_total >= max_frames):
                        break

                if realtime:
                    elapsed_ms = (time.monotonic() - tick_start) * 1000.0
                    if elapsed_ms < ms_per_frame:
                        time.sleep((ms_per_frame - elapsed_ms) / 1000.0)

        while in_flight:
            drain_one()
    tracing.set_frame(None)
    stats = timer.stats()
    if stats is not None:
        stats.recoveries = recoveries
    return camera, stats, frames_dropped


def make_culled_recoverer(scene, width: int, height: int, renderer=None,
                          **renderer_kwargs):
    """Stock `recover` hook for the block-sparse path: each attempt frees
    the current renderer's CUDA graphs (`renderer` at first, the last
    rebuilt one after), builds a FRESH CulledRenderer on the same device
    (new bake upload, new buckets, new graphs: everything the old path
    owned), freezes it and returns a render_fn over it — the counterpart of
    the JAX hook's jax.clear_caches() and rebuild. `device` defaults to
    `renderer`'s. The reference analog: a worker that idled out rebuilds
    its server and re-registers from scratch, receiving the full scene
    again (worker/distributed/main.go:101-129,:160-171)."""
    if renderer is not None:
        renderer_kwargs.setdefault("device", renderer.device)
    current = [renderer]

    def recover(attempt: int):
        from distributed_raytracer_tpu_torch.ops.render_bvh import (
            CulledRenderer)

        if current[0] is not None:
            current[0].release_graphs()
            current[0] = None
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        r = CulledRenderer(scene, width, height, **renderer_kwargs)
        r.render(scene.camera, block=True)
        r.freeze(scene.camera)
        current[0] = r
        return lambda scene_arrays, cam_arrays: r.render_fast(cam_arrays)
    return recover
