"""Primary-ray generation (pinhole projection).

The torch counterpart of distributed_raytracer_tpu/ops/raygen.py
(`ray_directions`, `ray_directions_flat`, `ray_rows_flat`), operation for
operation, plus `camera_arrays`, which puts a camera on a device, and
`camera_packed` / `camera_views`, the one (13,) tensor it travels in.
Reproduces tracer.go:15-22 `pixelToPoint` exactly, including its integer
half-width/height division and 0.5 pixel-center offset:

  halfW, halfH = W // 2, H // 2            (integer division)
  projHalfWidth  = tan(fov / 2)
  projHalfHeight = projHalfWidth * H / W
  iOffset = left * projHalfWidth  * ((halfW - i) - 0.5) / halfW
  jOffset = up   * projHalfHeight * ((halfH - j) - 0.5) / halfH
  point   = pos + forward + iOffset + jOffset   (plane at distance 1)

and the primary ray direction is norm(point - pos) (tracer.go:83-86).

`cam` is a CameraArrays of float32 tensors on the rays' device.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.camera import Camera, CameraArrays


def camera_packed(camera) -> torch.Tensor:
    """Camera or CameraArrays -> one (13,) float32 tensor (pos, forward,
    left, up, fov): on the host for a Camera or host CameraArrays, on
    their device for CameraArrays of tensors."""
    if isinstance(camera, Camera):
        camera = camera.to_arrays()
    if isinstance(camera.pos, torch.Tensor):
        return torch.cat([camera.pos.reshape(3), camera.forward.reshape(3),
                          camera.left.reshape(3), camera.up.reshape(3),
                          camera.fov.reshape(1)]).to(torch.float32)
    return torch.from_numpy(np.concatenate(
        [np.asarray(camera.pos, np.float32).reshape(3),
         np.asarray(camera.forward, np.float32).reshape(3),
         np.asarray(camera.left, np.float32).reshape(3),
         np.asarray(camera.up, np.float32).reshape(3),
         np.asarray(camera.fov, np.float32).reshape(1)]))


def camera_views(packed: torch.Tensor) -> CameraArrays:
    """CameraArrays viewing a (13,) camera_packed tensor."""
    return CameraArrays(pos=packed[0:3], forward=packed[3:6],
                        left=packed[6:9], up=packed[9:12], fov=packed[12])


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """x on `device` in one copy: from pinned memory and non-blocking when
    a host tensor goes to CUDA, so it does not wait for earlier frames."""
    device = torch.device(device)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def camera_arrays(camera, device) -> CameraArrays:
    """Camera or host CameraArrays -> CameraArrays of float32 tensors on
    `device`, in ONE host-to-device copy (CameraArrays of tensors pass
    through). On CUDA the copy is from pinned memory and non-blocking, so
    it does not wait for earlier frames."""
    if isinstance(camera, Camera):
        camera = camera.to_arrays()
    if isinstance(camera.pos, torch.Tensor):
        return camera
    return camera_views(to_device(camera_packed(camera), device))


def _offsets(cam, width: int, height: int, idx: torch.Tensor):
    idx = torch.clamp(idx, max=width * height - 1)
    i = (idx % width).to(torch.float32)
    j = torch.div(idx, width, rounding_mode="floor").to(torch.float32)

    half_w, half_h = width // 2, height // 2
    phw = torch.tan(cam.fov / 2.0)
    phh = phw * (height / width)
    a = phw * ((half_w - i) - 0.5) / half_w
    b = phh * ((half_h - j) - 0.5) / half_h
    return a, b


def _norm_rows(d: torch.Tensor, axis: int) -> torch.Tensor:
    """sqrt of the three squares summed in order (x, y, z) — the order
    jnp.linalg.norm reduces in, written out so every backend agrees."""
    x, y, z = d.unbind(axis)
    return torch.sqrt(x * x + y * y + z * z).unsqueeze(axis)


def ray_directions(cam, width: int, height: int) -> torch.Tensor:
    """Normalized primary ray directions, shape (height, width, 3).

    Goes through ray_directions_flat, so the dense and block-sparse paths
    see bit-identical directions (different evaluation orders flip
    edge-pixel hit decisions)."""
    idx = torch.arange(width * height, dtype=torch.int32,
                       device=cam.pos.device)
    return ray_directions_flat(cam, width, height, idx).reshape(
        height, width, 3)


def ray_directions_flat(cam, width: int, height: int,
                        idx: torch.Tensor) -> torch.Tensor:
    """Directions (R, 3) for flat pixel indices idx (row-major j*width + i).
    Indices past the last pixel are clamped — padding rays are traced and
    discarded by the caller."""
    a, b = _offsets(cam, width, height, idx)
    d = (cam.forward[None, :] + a[:, None] * cam.left[None, :]
         + b[:, None] * cam.up[None, :])
    return d / _norm_rows(d, 1)


def ray_rows_flat(cam, width: int, height: int,
                  idx: torch.Tensor) -> torch.Tensor:
    """Directions as (3, R) rows — the block-sparse path's native layout.
    Values are bit-identical to ray_directions_flat (same multiplies, same
    add order, elementwise-commuted broadcasts only)."""
    a, b = _offsets(cam, width, height, idx)
    d = (cam.forward[:, None] + a[None, :] * cam.left[:, None]
         + b[None, :] * cam.up[:, None])
    return d / _norm_rows(d, 0)
