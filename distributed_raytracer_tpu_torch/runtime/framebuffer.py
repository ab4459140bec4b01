"""Framebuffer output: uint8 conversion and a PNG writer.

The reference displays via an SDL2 window (shared/screen/screen.go); headless
hosts get image-file output instead. PNG encoding is hand-rolled over stdlib
zlib to avoid imaging dependencies. `to_u8`, `png_bytes` and `write_png` are
the JAX package's runtime/framebuffer.py unchanged; `to_u8_device` is its
torch counterpart.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def to_u8(img) -> np.ndarray:
    """Float [0,1] (H, W, 3) -> uint8, truncating like colour.go:59-61."""
    arr = np.asarray(img)
    return (255.0 * np.clip(arr, 0.0, 1.0)).astype(np.uint8)


def to_u8_device(img: torch.Tensor) -> torch.Tensor:
    """to_u8 on the tensor's own device, so a frame crosses to the host as
    1 byte per channel instead of a float32 (same truncating conversion)."""
    return (255.0 * img.clamp(0.0, 1.0)).to(torch.uint8)


def png_bytes(img, level: int = 6) -> bytes:
    """Minimal RGB8 PNG encoder (stdlib zlib only)."""
    u8 = to_u8(img) if np.asarray(img).dtype != np.uint8 else np.asarray(img)
    h, w, _ = u8.shape
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + u8[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))
