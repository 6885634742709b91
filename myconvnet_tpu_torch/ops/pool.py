"""Pooling on NHWC activations.

Port of the parts of ``myconvnet_tpu/ops/pool.py`` the classifiers use:
SAME max-pool pads with -inf (``pool.py:25-36``); average pool
(``pool.py:38-57``) sums in float32 and divides by the window, or under
SAME by the count of the window's elements inside the frame (TF's
``count_include_pad=False``), and casts back; global average pool sums in
float32 and casts back (``pool.py:60-62``).
"""

from __future__ import annotations

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


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,C], mean taken in float32."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)
