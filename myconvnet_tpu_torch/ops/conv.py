"""2-D convolution on NHWC activations with HWIO weights.

Port of ``myconvnet_tpu/ops/conv.py``.  The public layout is the JAX
package's (NHWC input, HWIO weight), so tests compare like with like.
Inside, the NHWC tensor is viewed as a channels_last NCHW tensor and the
weight as OIHW, and cuDNN runs the convolution; no transpose is copied
when the weight is stored OIHW channels_last, as ``nn.Conv`` keeps it.

TF "SAME" padding is asymmetric when the total is odd (a 7x7/2 at 224 pads
(2, 3); a 3x3/2 at 56 pads (0, 1)).  ``F.conv2d``'s ``padding=`` is
symmetric, so such pads go through an explicit ``F.pad``.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

_IntOrPair = Union[int, Sequence[int]]
Padding = Union[str, Sequence[Sequence[int]]]


def _pair(v: _IntOrPair) -> tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(lo, hi) padding of TF/XLA "SAME" along one axis; ``k`` is the
    effective kernel size, (k - 1) * dilation + 1 for a dilated conv."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def resolve_padding(padding: Padding, hw: tuple[int, int],
                    k: tuple[int, int], stride: tuple[int, int]
                    ) -> tuple[tuple[int, int], tuple[int, int]]:
    """((top, bottom), (left, right)) for "SAME", "VALID" or explicit
    pairs, as ``lax.conv_general_dilated`` reads them."""
    if padding == "SAME":
        return tuple(same_pads(hw[i], k[i], stride[i]) for i in range(2))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    (t, b), (l, r) = padding
    return ((int(t), int(b)), (int(l), int(r)))


def pad_nhwc(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (t, b), (l, r) = pads
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           bias: torch.Tensor | None = None, *,
           stride: _IntOrPair = 1, padding: Padding = "SAME",
           dilation: _IntOrPair = 1) -> torch.Tensor:
    """NHWC conv. x: [N,H,W,Cin], w: [kh,kw,Cin,Cout] -> NHWC,
    in x's dtype (bf16 inputs accumulate in float32 inside cuDNN).
    ``dilation`` is the atrous rate; "SAME" pads for the effective kernel
    (k - 1) * rate + 1."""
    s, rate = _pair(stride), _pair(dilation)
    k_eff = tuple((w.shape[i] - 1) * rate[i] + 1 for i in range(2))
    (t, b), (l, r) = resolve_padding(padding, tuple(x.shape[1:3]), k_eff, s)
    if t == b and l == r:
        sym = (t, l)
    else:
        x = pad_nhwc(x, ((t, b), (l, r)))
        sym = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias,
                 stride=s, padding=sym, dilation=rate)
    return y.permute(0, 2, 3, 1)
