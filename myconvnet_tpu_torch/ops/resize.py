"""Bilinear / nearest resize of NHWC tensors.

Port of ``myconvnet_tpu/ops/resize.py``: bilinear resize along one axis is
a sparse linear map, realised as a dense float32 matmul with a precomputed
interpolation matrix (numpy, cached), one per axis.  The matrices equal the
JAX package's entry for entry, so the flow models' upsampled flows do too.
cuBLAS runs the two products in true float32 (PyTorch leaves
``torch.backends.cuda.matmul.allow_tf32`` off), the counterpart of JAX's
``precision="highest"``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool,
                   half_pixel: bool) -> np.ndarray:
    """[out_size, in_size] bilinear interpolation weights (numpy, cached)."""
    w = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        if align_corners or in_size == 1:
            w[0, 0] = 1.0
        else:
            src = (0.5 * in_size / out_size) - 0.5 if half_pixel else 0.0
            src = min(max(src, 0.0), in_size - 1)
            lo = int(np.floor(src))
            hi = min(lo + 1, in_size - 1)
            frac = src - lo
            w[0, lo] += 1.0 - frac
            w[0, hi] += frac
        return w
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1)
        elif half_pixel:
            src = (i + 0.5) * in_size / out_size - 0.5
        else:
            src = i * in_size / out_size
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


@lru_cache(maxsize=64)
def _cached_matrix(in_size: int, out_size: int, align_corners: bool,
                   half_pixel: bool, device: torch.device) -> torch.Tensor:
    # made outside inference mode whoever asks first: an inference tensor
    # in the cache would break a later forward that autograd records
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(
            in_size, out_size, align_corners, half_pixel)).to(device)


def _matrix_on(in_size: int, out_size: int, align_corners: bool,
               half_pixel: bool, device: torch.device) -> torch.Tensor:
    """The interpolation matrix on ``device``, copied there once.  While
    ``torch.export`` traces, a new one: the tracer's tensors must not stay
    in the cache for the eager calls after it (the export keeps the matrix
    as a constant of the program)."""
    if torch.compiler.is_exporting():
        return torch.from_numpy(_interp_matrix(
            in_size, out_size, align_corners, half_pixel)).to(device)
    return _cached_matrix(in_size, out_size, align_corners, half_pixel,
                          device)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], *,
                    align_corners: bool = False,
                    half_pixel: bool = True) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) tensors by two float32 matmuls;
    the result keeps ``x``'s dtype."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x[0] if squeeze else x
    mh = _matrix_on(h, oh, align_corners, half_pixel, x.device)
    mw = _matrix_on(w, ow, align_corners, half_pixel, x.device)
    y = torch.einsum("oh,nhwc->nowc", mh, x.float())
    y = torch.einsum("pw,nowc->nopc", mw, y).to(x.dtype)
    return y[0] if squeeze else y


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]
                   ) -> torch.Tensor:
    """Nearest-neighbour resize by static row and column indices."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = out_hw
    rows = np.minimum((np.arange(oh) * h / oh).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(ow) * w / ow).astype(np.int64), w - 1)
    y = x.index_select(1, torch.from_numpy(rows).to(x.device))
    y = y.index_select(2, torch.from_numpy(cols).to(x.device))
    return y[0] if squeeze else y


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample by broadcast and reshape (no gather)."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)
