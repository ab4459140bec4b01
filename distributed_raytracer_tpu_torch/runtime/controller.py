"""Camera controller: the input-semantics layer (the JAX package's
runtime/controller.py, over the port's Camera).

Reproduces shared/input/input.go + the master's application of inputs
(master/main.go:246-258) without SDL:
  - six movement directions as a bitmask with opposing-key cancellation
    (pressing S while W is held clears both, input.go:38-74)
  - mouse deltas accumulate into yaw/pitch in units of half the screen:
    yaw += dx / (width/2), pitch -= dy / (height/2) (input.go:98-102)
  - per frame the camera moves by `move_step` (0.1, main.go:254) and rotates
    by yaw * fov/2 and pitch * (H/W) * fov/2 (main.go:255-257)
  - a frame is produced only when some input changed (main.go:246)
"""

from __future__ import annotations

import dataclasses

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)

# Movement bitmask (input.go:7-14).
MOVE_FORWARD = 1 << 0
MOVE_LEFTWARD = 1 << 1
MOVE_BACKWARD = 1 << 2
MOVE_RIGHTWARD = 1 << 3
MOVE_UPWARD = 1 << 4
MOVE_DOWNWARD = 1 << 5

_KEY_BITS = {
    "w": (MOVE_FORWARD, MOVE_BACKWARD),
    "a": (MOVE_LEFTWARD, MOVE_RIGHTWARD),
    "s": (MOVE_BACKWARD, MOVE_FORWARD),
    "d": (MOVE_RIGHTWARD, MOVE_LEFTWARD),
    "space": (MOVE_UPWARD, MOVE_DOWNWARD),
    "lshift": (MOVE_DOWNWARD, MOVE_UPWARD),
}


@dataclasses.dataclass
class CameraController:
    width: int
    height: int
    cfg: RenderConfig = DEFAULT_CONFIG
    move_dirs: int = 0
    _yaw: float = 0.0
    _pitch: float = 0.0
    running: bool = True

    def key_down(self, key: str) -> None:
        if key == "esc":
            self.running = False
            return
        if key in _KEY_BITS:
            bit, opposite = _KEY_BITS[key]
            if self.move_dirs & opposite:
                self.move_dirs &= ~(bit | opposite)  # opposing keys cancel
            else:
                self.move_dirs |= bit

    def key_up(self, key: str) -> None:
        if key in _KEY_BITS:
            self.move_dirs &= ~_KEY_BITS[key][0]

    def mouse_motion(self, dx: float, dy: float) -> None:
        self._yaw += dx / (self.width / 2)
        self._pitch -= dy / (self.height / 2)

    @property
    def dirty(self) -> bool:
        """Whether the next apply() would change the camera (main.go:246)."""
        return self.move_dirs != 0 or self._yaw != 0.0 or self._pitch != 0.0

    def apply(self, camera: Camera) -> Camera:
        """Apply one frame's worth of input to the camera; resets deltas."""
        camera = camera.move(
            self.cfg.move_step,
            forward=bool(self.move_dirs & MOVE_FORWARD),
            backward=bool(self.move_dirs & MOVE_BACKWARD),
            leftward=bool(self.move_dirs & MOVE_LEFTWARD),
            rightward=bool(self.move_dirs & MOVE_RIGHTWARD),
            upward=bool(self.move_dirs & MOVE_UPWARD),
            downward=bool(self.move_dirs & MOVE_DOWNWARD),
        )
        camera = camera.yaw(self._yaw * camera.fov / 2.0,
                            nudge=self.cfg.gimbal_nudge)
        camera = camera.pitch(
            self._pitch * (self.height / self.width) * camera.fov / 2.0)
        self._yaw = 0.0
        self._pitch = 0.0
        return camera
