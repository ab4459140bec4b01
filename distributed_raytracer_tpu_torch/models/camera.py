"""FPS-style camera.

Semantics mirror the reference camera (shared/state/camera.go):
  - construction: forward = norm(dir), left = norm(dir × GlobalUp),
    up = left × forward; rejects dir parallel to GlobalUp (camera.go:35-44)
  - Move: sum of local frame axes selected by six booleans with opposing-key
    cancellation, normalized, scaled by distance (camera.go:62-92)
  - Yaw: Rodrigues rotation of forward about up, then left/up re-derived from
    GlobalUp to stop drift (camera.go:130-146)
  - Pitch: rotation of forward about left; up recomputed (camera.go:149-154)
  - gimbal guard: if forward becomes parallel to GlobalUp during yaw, forward
    is nudged. The reference nudges in a *random* direction
    (camera.go:96-127, seeded from wall clock); we use a deterministic nudge
    of +nudge on every axis — a documented divergence for reproducibility.

Host camera state is float64 (the reference is float64 throughout); the
device-side pytree (`CameraArrays`) is float32 for device compute.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np

GLOBAL_UP = np.array([0.0, 1.0, 0.0])  # shared/state/environment.go:22


def _norm(v: np.ndarray) -> np.ndarray:
    return v / math.sqrt(float(v @ v))


def _rotate(a: np.ndarray, b: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation of a about unit axis b (shared/geom/vector.go:39-42)."""
    c, s = math.cos(theta), math.sin(theta)
    return a * c + np.cross(b, a) * s + b * (float(b @ a) * (1.0 - c))


class CameraArrays(NamedTuple):
    """Device-side camera pytree (float32 arrays) consumed by ops.raygen."""

    pos: np.ndarray      # (3,)
    forward: np.ndarray  # (3,)
    left: np.ndarray     # (3,)
    up: np.ndarray       # (3,)
    fov: np.ndarray      # () horizontal field of view, radians


@dataclasses.dataclass
class Camera:
    pos: np.ndarray
    forward: np.ndarray
    left: np.ndarray
    up: np.ndarray
    fov: float

    @staticmethod
    def create(pos, direction, fov: float) -> "Camera":
        """Build a camera from position/direction/fov (camera.go:35-44)."""
        pos = np.asarray(pos, dtype=np.float64)
        direction = np.asarray(direction, dtype=np.float64)
        if np.all(np.cross(direction, GLOBAL_UP) == 0.0):
            raise ValueError(f"Camera dir {direction} is parallel to global up {GLOBAL_UP}")
        forward = _norm(direction)
        left = _norm(np.cross(direction, GLOBAL_UP))
        up = np.cross(left, forward)
        return Camera(pos=pos, forward=forward, left=left, up=up, fov=float(fov))

    def move(self, distance: float, forward=False, backward=False,
             leftward=False, rightward=False, upward=False, downward=False) -> "Camera":
        """Move along the local frame (camera.go:62-92). Opposing keys cancel."""
        d = np.zeros(3)
        if forward != backward:
            d = d + self.forward if forward else d - self.forward
        if leftward != rightward:
            d = d + self.left if leftward else d - self.left
        if upward != downward:
            d = d + self.up if upward else d - self.up
        if np.any(d != 0.0):
            return dataclasses.replace(self, pos=self.pos + _norm(d) * distance)
        return self

    def yaw(self, theta: float, nudge: float = 1e-4) -> "Camera":
        """Rotate about local up; re-orthonormalize vs GlobalUp (camera.go:130-146)."""
        if math.fmod(theta, 2.0 * math.pi) == 0.0:
            return self
        fwd = _norm(_rotate(self.forward, self.up, theta))
        if np.all(np.cross(fwd, GLOBAL_UP) == 0.0):
            # Deterministic gimbal nudge (divergence from camera.go:96-127's
            # seeded-random nudge; magnitude preserved).
            fwd = fwd + np.array([nudge, nudge, nudge])
        left = _norm(np.cross(fwd, GLOBAL_UP))
        up = _norm(np.cross(left, fwd))
        return dataclasses.replace(self, forward=fwd, left=left, up=up)

    def pitch(self, theta: float) -> "Camera":
        """Rotate about local left (camera.go:149-154). No gimbal guard, as in
        the reference — pitching to ±90° is representable; the guard fires on
        the next yaw."""
        if math.fmod(theta, 2.0 * math.pi) == 0.0:
            return self
        fwd = _norm(_rotate(self.forward, self.left, theta))
        up = _norm(np.cross(self.left, fwd))
        return dataclasses.replace(self, forward=fwd, up=up)

    def to_arrays(self, dtype=np.float32) -> CameraArrays:
        return CameraArrays(
            pos=self.pos.astype(dtype),
            forward=self.forward.astype(dtype),
            left=self.left.astype(dtype),
            up=self.up.astype(dtype),
            fov=np.asarray(self.fov, dtype=dtype),
        )
