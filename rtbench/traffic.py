"""The one traffic generator: scripted orbit input, read from a mix's file.

A mix (`traffic/<name>.json`) sets:
  - "move_step": the strafe per tick (the reference's move_step, 0.1,
    master/main.go:254);
  - "share_of_revolution": the arc the camera covers in one pass about
    the scene's centre (the origin) at the camera's distance d;
  - "back_and_forth": false repeats the pass in one direction; true runs
    it forward, then back over the same poses, then again;
  - "frames_in_flight", "verify_period" and "paced": the loop's settings
    (closed loop when not paced);
  - "why": a line on what the mix is for;
  - "scene_motion" (optional): the scene's objects and lights moving on
    every frame, as the upstream master's per-frame diff moves them
    (EnvMutables, shared/state/environment.go:65-69). Every object
    moves; its keys: "object_radius" (world units: object j of k circles
    in the XZ plane through its position in the scene, offset
    r (cos a - 1, 0, sin a), the form of
    runtime/animation.orbit_object_diffs, starting at a = 2 pi j / k),
    "object_revolutions" (whole turns per traffic cycle) and
    "light_revolutions" (whole turns per cycle of each light about the
    world y axis through the origin; 0 keeps the lights still).
Each tick strafes left (the "a" key) and yaws by a mouse move, the orbit
input pattern of tools/schedule_frames.py's sector and of
runtime/animation.orbit_camera_path, driven through the input path. The
ticks per pass follow from the configuration: P = round(share * 2 pi d /
move_step), and the yaw per tick is share * 2 pi / P, so a pass closes
exactly. Going back, one tick of yaw alone turns the camera, P ticks
strafe right and yaw back, and a last tick of yaw alone turns it again:
each pose of the way back is a pose of the way forth, one yaw step
turned, and the cycle returns to its start.

The seed sets where in the cycle a run starts (every seed has the same
poses, in another order). Every tick moves the camera, so every tick
makes a frame. The scene of the frame at cycle position c is
`state(c)`, a function of c alone (None for a mix that moves nothing):
the turns are whole, so `state(len(cycle))` is `state(0)`, bit for bit,
and a frame's scene lies at the same cycle position as its pose.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

import numpy as np

from rtbench.reference import Pose, State

KEYS = {1: "a", -1: "d"}
MOTION_KEYS = ("object_radius", "object_revolutions", "light_revolutions")


def _motion(mix: dict) -> Optional[dict]:
    """A mix's "scene_motion", its keys checked, or None."""
    m = mix.get("scene_motion")
    if m is None:
        return None
    if set(m) != set(MOTION_KEYS):
        raise ValueError(f"scene_motion takes the keys {MOTION_KEYS}; "
                         f"got {sorted(m)}")
    for key in ("object_revolutions", "light_revolutions"):
        if type(m[key]) is not int:
            raise ValueError(f"scene_motion {key} is a whole number of "
                             f"turns; got {m[key]!r}")
    return m


def moves(mix: dict) -> bool:
    """Whether the mix moves any object or light."""
    m = _motion(mix)
    if m is None:
        return False
    return ((m["object_radius"] != 0 and m["object_revolutions"] != 0)
            or m["light_revolutions"] != 0)


class Traffic:
    def __init__(self, mix: dict, scene, width: int):
        self.move_step = float(mix["move_step"])
        self.frames_in_flight = int(mix["frames_in_flight"])
        self.verify_period = int(mix["verify_period"])
        self.paced = bool(mix["paced"])
        self.width = width
        self.start = Pose.create(scene.cam_pos, scene.cam_dir, scene.fov)
        share = float(mix["share_of_revolution"])
        d = float(np.linalg.norm(scene.cam_pos))
        self.ticks_per_pass = round(share * 2 * math.pi * d / self.move_step)
        theta = share * 2 * math.pi / self.ticks_per_pass
        # The mouse move whose yaw is theta (input.go:98-102, main.go:255).
        self.dx = theta / (scene.fov / 2.0) * (width / 2)
        p = self.ticks_per_pass
        self.cycle: List[Tuple[int, float]] = [(1, self.dx)] * p
        if mix["back_and_forth"]:
            self.cycle += ([(0, -self.dx)] + [(-1, -self.dx)] * p
                           + [(0, self.dx)])
        # poses[c]: the camera before tick c of the cycle (c = len: after).
        self.poses = [self.start]
        for strafe, dx in self.cycle:
            self.poses.append(self.next(self.poses[-1], (strafe, dx)))
        self.moves = moves(mix)
        self._states = None
        if self.moves:
            self._states = self._scene_states(_motion(mix), scene)

    def _scene_states(self, m: dict, scene) -> List[State]:
        """state(c) for c = 0 .. len(cycle)."""
        n = len(self.cycle)
        n_obj = len(scene.instances)
        r = float(m["object_radius"])
        phase = 2 * math.pi * np.arange(n_obj) / n_obj
        lights = np.asarray(scene.light_pos, np.float64)
        out = []
        for c in range(n + 1):
            # Angles from whole turns taken modulo the cycle: c = n is c = 0.
            a = 2 * math.pi * ((m["object_revolutions"] * c) % n) / n + phase
            offsets = np.zeros((n_obj, 3))
            offsets[:, 0] = r * (np.cos(a) - 1.0)
            offsets[:, 2] = r * np.sin(a)
            b = 2 * math.pi * ((m["light_revolutions"] * c) % n) / n
            moved = lights.copy()
            if b:
                cb, sb = math.cos(b), math.sin(b)
                moved[:, 0] = lights[:, 0] * cb + lights[:, 2] * sb
                moved[:, 2] = -lights[:, 0] * sb + lights[:, 2] * cb
            out.append(State(offsets, moved))
        return out

    def state(self, c: int) -> Optional[State]:
        """The scene at cycle position c (0 .. len(cycle)), or None when
        the mix moves nothing."""
        return None if self._states is None else self._states[c]

    def next(self, pose: Pose, tick) -> Pose:
        return pose.tick(tick[0], tick[1], self.width, self.move_step)

    def offset(self, seed: int) -> int:
        """The cycle position a run of `seed` starts at."""
        return int(np.random.default_rng(seed).integers(len(self.cycle)))

    def tick(self, k: int, start: int):
        return self.cycle[(start + k) % len(self.cycle)]

    def settle_poses(self) -> List[Pose]:
        """Every frame pose of one cycle, in the cycle's order."""
        return self.poses[1:]

    def settle_states(self) -> List[Optional[State]]:
        """The scene of each pose of settle_poses()."""
        return [self.state(c) for c in range(1, len(self.poses))]

    def frame_state(self, start: int, k: int) -> Optional[State]:
        """The scene of frame k of the run starting at `start`."""
        return self.state((start + k) % len(self.cycle) + 1)

    def frame_poses(self, start: int, ticks: int) -> List[Pose]:
        """The poses of the first `ticks` frames from `start`, accumulated
        tick by tick as the input path does."""
        out, pose = [], self.poses[start]
        for k in range(ticks):
            pose = self.next(pose, self.tick(k, start))
            out.append(pose)
        return out


class Events:
    """The input of ticks start, start + 1, ... as run_loop's per-tick
    event lists, until `seconds` have passed since the first tick (or
    `ticks` ticks, when given). Stamps each tick's time
    (time.perf_counter) as it is handed over."""

    def __init__(self, traffic: Traffic, start: int, seconds: float = None,
                 ticks: int = None, first: int = 0):
        self.traffic, self.start = traffic, start
        self.seconds, self.ticks, self.first = seconds, ticks, first
        self.stamps: List[float] = []

    def __iter__(self):
        held = 0
        t0 = None
        k = self.first
        while True:
            now = time.perf_counter()
            if t0 is None:
                t0 = now
            elif self.seconds is not None and now - t0 >= self.seconds:
                return
            if self.ticks is not None and k - self.first >= self.ticks:
                return
            strafe, dx = self.traffic.tick(k, self.start)
            events = []
            if strafe != held:
                if held:
                    events.append(("key_up", KEYS[held]))
                if strafe:
                    events.append(("key_down", KEYS[strafe]))
                held = strafe
            events.append(("mouse", dx, 0.0))
            self.stamps.append(now)
            k += 1
            yield events
