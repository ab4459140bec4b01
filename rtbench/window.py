"""The measured window: the program's interactive loop
(runtime/loop.run_loop) driven by scripted input, stamped from outside.

The render function is the CLI's culled mode's (run.py `_periodic_verify`
over the renderer, uint8 conversion on the card with
runtime/framebuffer.to_u8_device): every `verify_period`-th frame checks
its buckets (a host sync). Each call hands the layout the scene state of
the frame it stands for (None where the traffic moves nothing). Around
each call the harness reads the host clock (the enqueue time) and, on
CUDA, records an event on each card's frame streams before and after it.
The display callback stamps each frame's display and keeps a sample of
the displayed frames, drawn from the seed, for the comparison with the
reference.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from rtbench import port
from rtbench.traffic import Events, Traffic


@dataclasses.dataclass
class Call:
    verify: bool
    enqueue_s: float
    events: Optional[list]     # per card (start, end) CUDA events


class Renderer:
    """render_fn(scene_arrays, camera_arrays) for run_loop over the run of
    `traffic` starting at cycle position `start`.

    Each call hands the layout the scene state of the frame it stands
    for: a new frame (a camera object not seen yet) is the next frame; a
    frame issued again is run_loop passing back the very camera object of
    a frame in flight, found by `is` among the cameras of the last
    frames_in_flight + 1 new frames (the frames run_loop may issue
    again)."""

    def __init__(self, layout, traffic: Traffic, start: int, first: int = 0,
                 wrap: Optional[Callable] = None):
        from distributed_raytracer_tpu_torch.runtime import framebuffer

        self.layout, self.period, self.k = layout, traffic.verify_period, first
        self.to_u8 = framebuffer.to_u8_device
        self.render = layout.render if wrap is None else wrap(layout.render)
        self.cuda = layout.cards[0].type == "cuda"
        self.streams = layout.frame_streams() if self.cuda else None
        self.calls: List[Call] = []
        self.traffic, self.start, self.frame = traffic, start, first
        self.held = collections.deque(maxlen=traffic.frames_in_flight + 1)

    def frame_of(self, cam) -> int:
        """The frame index of a call with camera object `cam`."""
        for seen, k in self.held:
            if seen is cam:
                return k
        k, self.frame = self.frame, self.frame + 1
        self.held.append((cam, k))
        return k

    def __call__(self, scene_arrays, cam):
        verify = self.k % self.period == 0
        self.k += 1
        state = self.traffic.frame_state(self.start, self.frame_of(cam))
        evs = None
        if self.cuda:
            evs = [(torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
                   for _ in self.streams]
            for (a, _), (s, _) in zip(evs, self.streams):
                a.record(s)
        t0 = time.perf_counter()
        img = self.to_u8(self.render(cam, verify, state))
        t1 = time.perf_counter()
        if self.cuda:
            for (_, b), (_, s) in zip(evs, self.streams):
                b.record(s)
        self.calls.append(Call(verify, t1 - t0, evs))
        return img


class Display:
    """Stamps each displayed frame and keeps a uniform sample of `keep`
    of them (reservoir sampling from `rng`)."""

    def __init__(self, keep: int, rng: np.random.Generator):
        self.keep, self.rng = keep, rng
        self.shown: Dict[int, float] = {}
        self.sample: Dict[int, np.ndarray] = {}

    def __call__(self, idx: int, img) -> None:
        self.shown[idx] = time.perf_counter()
        seen = len(self.shown)
        if seen <= self.keep:
            self.sample[idx] = np.array(img, copy=True)
            return
        j = int(self.rng.integers(seen))
        if j < self.keep:
            del self.sample[sorted(self.sample)[j]]
            self.sample[idx] = np.array(img, copy=True)


def sync(layout) -> None:
    if layout.cards[0].type == "cuda":
        for d in layout.cards:
            torch.cuda.synchronize(d)


def loop(layout, traffic: Traffic, start: int, *, seconds: float = None,
         ticks: int = None, first: int = 0, display: Display = None,
         wrap: Callable = None):
    """One run_loop over ticks first, first + 1, ... of the run starting
    at cycle position `start`. Returns (events, renderer, frames dropped,
    device window marks (per card (start, end) events) or None)."""
    from distributed_raytracer_tpu_torch.runtime.loop import run_loop
    from distributed_raytracer_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(move_step=traffic.move_step,
                       frames_in_flight=traffic.frames_in_flight)
    render = Renderer(layout, traffic, start, first, wrap)
    events = Events(traffic, start, seconds=seconds, ticks=ticks,
                    first=first)
    n = len(traffic.cycle)
    camera = port.camera(traffic.poses[(start + first) % n])
    marks = None
    if render.cuda:
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in render.streams]
        for (a, _), (_, s) in zip(marks, render.streams):
            a.record(s)
    _, _, dropped = run_loop(None, camera, render, layout.width,
                             layout.height, events=events, display=display,
                             cfg=cfg, realtime=traffic.paced)
    if marks is not None:
        for (_, b), (_, s) in zip(marks, render.streams):
            b.record(s)
    return events, render, dropped, marks


def card_intervals(render: Renderer, marks) -> list:
    """Per card: (the window's device length in ms, the frames' (start,
    end) intervals in ms from the window's start). Synchronizes."""
    sync(render.layout)
    out = []
    for c, (w0, w1) in enumerate(marks):
        spans = [(w0.elapsed_time(call.events[c][0]),
                  w0.elapsed_time(call.events[c][1]))
                 for call in render.calls]
        out.append((w0.elapsed_time(w1), spans))
    return out
