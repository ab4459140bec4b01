"""Scripted camera animation (headless input source).

The reference was benchmarked with a human orbiting the camera around the
mesh at ~1 unit distance (final_report.pdf §3.1); with no SDL here, this
module generates equivalent input-event streams for runtime.loop, the
equivalent camera path and per-frame object motion — a deterministic,
reproducible replacement for interactive input.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Tuple

import numpy as np

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import SceneDiff

Event = Tuple


def constant_motion(keys: List[str], n_ticks: int) -> Iterator[List[Event]]:
    """Hold a set of keys for n_ticks ticks, then release."""
    yield [("key_down", k) for k in keys]
    for _ in range(n_ticks - 1):
        yield []
    yield [("key_up", k) for k in keys]


def mouse_pan(dx_per_tick: float, n_ticks: int, width: int) -> Iterator[List[Event]]:
    """Steady horizontal mouse motion (yaw sweep)."""
    for _ in range(n_ticks):
        yield [("mouse", dx_per_tick, 0.0)]


def orbit_events(width: int, n_ticks: int, fov: float,
                 revolutions: float = 1.0) -> Iterator[List[Event]]:
    """Strafe left while yawing to sweep a full orbit's worth of turn — the
    motion class used for the reference's benchmarks. Yaw per tick is
    d_theta; the controller maps mouse dx -> yaw = dx/(width/2) * fov/2, so
    dx = d_theta * width / fov."""
    d_theta = 2.0 * math.pi * revolutions / n_ticks
    dx = d_theta * width / fov
    yield [("key_down", "a"), ("mouse", dx, 0.0)]
    for _ in range(n_ticks - 1):
        yield [("mouse", dx, 0.0)]
    yield [("key_up", "a")]


def orbit_object_diffs(scene, n_frames: int, obj_index: int = 0,
                       radius: float = 1.0, revolutions: float = 1.0):
    """Per-frame SceneDiffs orbiting one object about its baked position in
    the XZ plane — the scripted analog of the reference mutating object
    state between frames (every WorkOrder carries the full EnvMutables,
    master/main.go:260-266). Frame 0 is the baked pose; lights pass
    through unchanged (they ride the same diff and may be animated the
    same way)."""
    base = scene.make_diff()
    diffs = []
    for k in range(n_frames):
        theta = 2.0 * math.pi * revolutions * k / max(n_frames, 1)
        delta = np.array([radius * (math.cos(theta) - 1.0), 0.0,
                          radius * math.sin(theta)], np.float32)
        obj_pos = base.obj_pos.copy()
        obj_pos[obj_index] = obj_pos[obj_index] + delta
        diffs.append(SceneDiff(obj_pos=obj_pos, light_pos=base.light_pos,
                               light_col=base.light_col))
    return diffs


def orbit_camera_path(camera: Camera, n_frames: int, radius: float = None,
                      revolutions: float = 1.0) -> List[Camera]:
    """Direct camera-pose orbit (bypasses the event system): rotate the
    camera position about the vertical axis through its look-at point at
    distance `radius`, always facing the center. Deterministic ground truth
    for benchmarks."""
    center = camera.pos + camera.forward * (radius if radius is not None else 1.0)
    r = camera.pos - center
    poses = []
    for k in range(n_frames):
        theta = 2.0 * math.pi * revolutions * k / n_frames
        c, s = math.cos(theta), math.sin(theta)
        # rotate r about global +y
        rx = c * r[0] + s * r[2]
        rz = -s * r[0] + c * r[2]
        pos = center + [rx, r[1], rz]
        direction = center - pos
        poses.append(Camera.create(pos, direction, camera.fov))
    return poses
