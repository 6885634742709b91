"""Pooling on NHWC activations.

Port of the parts of ``myconvnet_tpu/ops/pool.py`` the ResNet path uses:
SAME max-pool pads with -inf (``pool.py:25-36``), and global average pool
sums in float32 and casts back (``pool.py:60-62``).
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


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,C], mean taken in float32."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)
