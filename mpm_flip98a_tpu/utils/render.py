"""Headless frame rendering: particle circles -> PNG frames -> GIF.

Replaces the reference's native rasterizer + window stack — `Canvas`
circle/rect drawing (taichi.h:16581-16920), the X11/Win32/Cocoa `GUI`
(taichi.h:16923-17600) and the bundled stb_image_write (taichi.h:24860+) —
with a small NumPy rasterizer and a standard-library PNG encoder.  The
reference itself runs headless (`show_gui=False`, exec.py:14), so only the
frame files matter.  GIF assembly (the reference's golden artifact,
README.md:29-31) is the one part that needs Pillow.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np


BG_COLOR = 0x112F41      # exec.py:14 / mls-mpm88-explained.cpp:218
FLUID_COLOR = 0x2986CC   # mls-mpm88-explained.cpp:194
BOUNDARY_COLOR = 0x52BFBF  # mls-mpm88-explained.cpp:219


def _hex_rgb(c: int) -> np.ndarray:
    return np.array([(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF], np.uint8)


def rasterize(
    x: np.ndarray,
    res: int = 512,
    extent: float = 1.0,
    radius: int = 1,
    colors: Optional[np.ndarray] = None,
    bg: int = BG_COLOR,
) -> np.ndarray:
    """Draw particles as filled squares/circles into an (res, res, 3) image.

    `x` is (N, 2) in [0, extent]^2; image y-axis points up (like the
    reference GUI).  Equivalent of gui.circles / canvas.circle
    (exec.py:29 via post_process; mls-mpm88-explained.cpp:221).
    """
    img = np.empty((res, res, 3), np.uint8)
    img[:] = _hex_rgb(bg)
    if len(x) == 0:
        return img
    px = np.clip((x[:, 0] / extent) * res, 0, res - 1).astype(np.int64)
    py = np.clip((1.0 - x[:, 1] / extent) * res, 0, res - 1).astype(np.int64)
    col = (
        np.broadcast_to(_hex_rgb(FLUID_COLOR), (len(x), 3))
        if colors is None
        else colors
    )
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy > radius * radius:
                continue
            ix = np.clip(px + dx, 0, res - 1)
            iy = np.clip(py + dy, 0, res - 1)
            img[iy, ix] = col
    return img


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(img: np.ndarray, path: str) -> None:
    """stb_image_write / Array2D::write_as_image equivalent
    (taichi.h:30346-30390): 8-bit RGB, no filtering, zlib-deflated."""
    h, w, _ = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img, np.uint8).reshape(h, w * 3)],
        axis=1,
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_gif(
    frames: Sequence[np.ndarray], path: str, fps: int = 30
) -> None:
    """Assemble frames into a GIF — the reference's golden visual artifact
    (output.gif, README.md:29-31; ffmpeg assembly mls-mpm88:235).  Needs
    Pillow, and raises ImportError where it is missing."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(
        path,
        save_all=True,
        append_images=ims[1:],
        duration=int(1000 / fps),
        loop=0,
    )
