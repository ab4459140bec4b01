"""Scripted camera animation (headless input source).

The reference was benchmarked with a human orbiting the camera around the
mesh at ~1 unit distance (final_report.pdf §3.1); with no SDL here, this
module generates the equivalent camera path — a deterministic, reproducible
replacement for interactive input. (The event streams of the JAX package's
runtime/animation.py are not part of this package yet.)
"""

from __future__ import annotations

import math
from typing import List

from distributed_raytracer_tpu_torch.models.camera import Camera


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
