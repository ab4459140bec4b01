"""Scripted camera animation (headless input source).

The reference was benchmarked with a human orbiting the camera around the
mesh at ~1 unit distance (final_report.pdf §3.1); with no SDL here, this
module generates the equivalent camera path and per-frame object motion — a
deterministic, reproducible replacement for interactive input. (The event
streams of the JAX package's runtime/animation.py are not part of this
package yet.)
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import SceneDiff


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
