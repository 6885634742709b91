"""Image artifacts: sample grids, uint8 conversion and PNG files.

Port of ``myconvnet_tpu/utils/images.py`` (``make_grid:17``,
``to_uint8:36``, ``voc_palette:44``, ``colorize_mask:60``, ``save_png:84``,
``flow_to_color:94``).  ``to_uint8`` takes a tensor and keeps
it on its device, with the JAX function's float32 steps.  ``save_png``
writes the PNG itself with ``zlib`` and ``struct`` (8-bit grayscale or
RGB, no filter), so no image library is needed.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch


def make_grid(images: np.ndarray, pad: int = 2,
              pad_value: int = 0) -> np.ndarray:
    """[N,H,W,C] uint8 -> one [GH,GW,C] uint8 grid (row-major, square-ish).
    """
    images = np.asarray(images)
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError("make_grid wants [N,H,W,C] uint8")
    n, h, w, c = images.shape
    side = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / side))
    grid = np.full((rows * (h + pad) - pad, side * (w + pad) - pad, c),
                   pad_value, np.uint8)
    for i, img in enumerate(images):
        r, col = divmod(i, side)
        y, x = r * (h + pad), col * (w + pad)
        grid[y:y + h, x:x + w] = img
    return grid


def to_uint8(images: torch.Tensor,
             value_range: tuple[float, float] = (-1.0, 1.0)
             ) -> torch.Tensor:
    """Float images in ``value_range`` -> uint8: clip((x - lo) / (hi -
    lo), 0, 1) * 255 + 0.5, truncated."""
    lo, hi = value_range
    x = ((images.float() - lo) / max(hi - lo, 1e-12)).clamp(0.0, 1.0)
    return (x * 255.0 + 0.5).to(torch.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(image: np.ndarray) -> bytes:
    """[H, W], [H, W, 1] or [H, W, 3] uint8 as the bytes of a PNG."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (
            arr.ndim == 3 and arr.shape[-1] == 3)):
        raise ValueError(f"save_png writes uint8 gray or RGB, not "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    color = 0 if arr.ndim == 2 else 2
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = b"".join(b"\x00" + row.tobytes() for row in rows)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    return png


def voc_palette(num_classes: int = 256) -> np.ndarray:
    """The VOC label palette ([num_classes, 3] uint8): the class index's
    bits spread over the RGB bit-planes."""
    pal = np.zeros((num_classes, 3), np.uint8)
    for i in range(num_classes):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


def colorize_mask(mask: np.ndarray, ignore_label: int | None = 255
                  ) -> np.ndarray:
    """Int mask [H, W] or [N, H, W] -> RGB uint8 through the VOC palette;
    ``ignore_label`` pixels white."""
    mask = np.asarray(mask)
    rgb = voc_palette(256)[np.where((mask >= 0) & (mask < 256), mask, 0)]
    if ignore_label is not None:
        rgb = np.where((mask == ignore_label)[..., None], np.uint8(255), rgb)
    return rgb


def save_png(path: str, image: np.ndarray) -> str:
    """Write [H, W], [H, W, 1] or [H, W, 3] uint8 as a PNG."""
    png = png_bytes(image)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
    return path


def flow_to_color(flow: np.ndarray, max_mag: float | None = None
                  ) -> np.ndarray:
    """``[H, W, 2]`` flow -> ``[H, W, 3]`` uint8, Middlebury-style: hue =
    direction, saturation = magnitude (white = static), normalized by
    ``max_mag`` or this map's 99th-percentile magnitude; NaN pixels
    black."""
    f = np.asarray(flow, np.float64)
    u, v = f[..., 0], f[..., 1]
    bad = ~np.isfinite(u) | ~np.isfinite(v)
    u = np.where(bad, 0.0, u)
    v = np.where(bad, 0.0, v)
    mag = np.sqrt(u * u + v * v)
    if max_mag is None:
        max_mag = max(float(np.percentile(mag, 99)), 1e-6)
    s = np.clip(mag / max_mag, 0.0, 1.0)
    h6 = (np.arctan2(-v, -u) / np.pi + 1.0) * 3.0   # [0, 6) hue sector
    i = np.floor(h6).astype(int) % 6
    frac = h6 - np.floor(h6)
    # around the RGB hue hexagon at full value
    wheel = np.array([[1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 1, 1], [0, 0, 1], [1, 0, 1]], np.float64)
    chroma = wheel[i] * (1.0 - frac[..., None]) \
        + wheel[(i + 1) % 6] * frac[..., None]
    rgb = 1.0 - s[..., None] * (1.0 - chroma)       # desaturate to white
    rgb = np.where(bad[..., None], 0.0, rgb)
    return (rgb * 255.0 + 0.5).astype(np.uint8)
