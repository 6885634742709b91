"""Pooling on NHWC activations.

Port of the parts of ``myconvnet_tpu/ops/pool.py`` the classifiers use:
SAME max-pool pads with -inf (``pool.py:25-36``); average pool
(``pool.py:38-57``) sums in float32 and divides by the window, or under
SAME by the count of the window's elements inside the frame (TF's
``count_include_pad=False``), and casts back; global average pool sums in
float32 and casts back (``pool.py:60-62``); the adaptive average pool
(``pool.py:65-94``, PSPNet's pyramid) is two float32 products with
per-axis bin matrices and casts back.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from myconvnet_tpu_torch.ops.conv import Padding, _IntOrPair, _pair, \
    pad_nhwc, resolve_padding


def max_pool2d(x: torch.Tensor, window: _IntOrPair = 2,
               stride: _IntOrPair = 2, padding: Padding = "SAME"
               ) -> torch.Tensor:
    """x: [N,H,W,C].  ``padding`` is "SAME", "VALID" or ((t, b), (l, r))."""
    k, s = _pair(window), _pair(stride)
    pads = resolve_padding(padding, tuple(x.shape[1:3]), k, s)
    if any(pads[0]) or any(pads[1]):
        x = pad_nhwc(x, pads, value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s)
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window: _IntOrPair = 2,
               stride: _IntOrPair = 2, padding: Padding = "SAME",
               count_include_pad: bool = False) -> torch.Tensor:
    """x: [N,H,W,C] -> the window means in x's dtype, summed in float32.
    VALID (or ``count_include_pad``) divides by the window's size, SAME
    by the number of its elements inside the frame."""
    k, s = _pair(window), _pair(stride)
    pads = resolve_padding(padding, tuple(x.shape[1:3]), k, s)
    xf = x.float()
    if any(pads[0]) or any(pads[1]):
        xf = pad_nhwc(xf, pads)
    summed = F.avg_pool2d(xf.permute(0, 3, 1, 2), k, s,
                          divisor_override=1)
    if padding == "VALID" or count_include_pad or not (any(pads[0])
                                                       or any(pads[1])):
        out = summed / float(k[0] * k[1])
    else:
        ones = pad_nhwc(torch.ones((1, *x.shape[1:3], 1),
                                   device=x.device), pads)
        counts = F.avg_pool2d(ones.permute(0, 3, 1, 2), k, s,
                              divisor_override=1)
        out = summed / counts
    return out.permute(0, 2, 3, 1).to(x.dtype)


def global_avg_pool(x: torch.Tensor, keepdims: bool = False
                    ) -> torch.Tensor:
    """[N,H,W,C] -> [N,C] ([N,1,1,C] with ``keepdims``), mean taken in
    float32, in x's dtype."""
    return x.float().mean(dim=(1, 2), keepdim=keepdims).to(x.dtype)


@lru_cache(maxsize=64)
def _bin_matrix(size: int, bins: int) -> np.ndarray:
    """[bins, size]: row i averages [floor(i S / B), ceil((i + 1) S / B))."""
    m = np.zeros((bins, size), np.float32)
    for i in range(bins):
        lo = (i * size) // bins
        hi = -(-(i + 1) * size // bins)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def adaptive_avg_pool2d(x: torch.Tensor, output_hw: _IntOrPair
                        ) -> torch.Tensor:
    """[N,H,W,C] -> [N,bh,bw,C], torch ``AdaptiveAvgPool2d``'s bins, the
    means taken in float32, in x's dtype."""
    bh, bw = _pair(output_hw)
    _, h, w, _ = x.shape
    mh = torch.from_numpy(_bin_matrix(h, bh)).to(x.device)
    mw = torch.from_numpy(_bin_matrix(w, bw)).to(x.device)
    y = torch.einsum("bh,nhwc->nbwc", mh, x.float())
    return torch.einsum("vw,nbwc->nbvc", mw, y).to(x.dtype)
