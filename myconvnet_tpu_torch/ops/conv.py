"""2-D convolution on NHWC activations with HWIO weights.

Port of ``myconvnet_tpu/ops/conv.py``.  The public layout is the JAX
package's (NHWC input, HWIO weight), so tests compare like with like.
Inside, the NHWC tensor is viewed as a channels_last NCHW tensor and the
weight as OIHW, and cuDNN runs the convolution; no transpose is copied
when the weight is stored OIHW channels_last, as ``nn.Conv`` keeps it.

TF "SAME" padding is asymmetric when the total is odd (a 7x7/2 at 224 pads
(2, 3); a 3x3/2 at 56 pads (0, 1)).  ``F.conv2d``'s ``padding=`` is
symmetric, so such pads go through an explicit ``F.pad``; so do the
stride-2 depthwise convs of MobileNet and EfficientNet at even sizes.

``groups`` is ``feature_group_count`` (``conv.py:41-58``): the weight is
[kh, kw, Cin / groups, Cout] and cuDNN's grouped conv takes it as
[Cout, Cin / groups, kh, kw].  :func:`depthwise_conv2d` (``:76-83``)
reshapes its [kh, kw, C, m] weight to [kh, kw, 1, C * m] and runs the
grouped conv with groups = C, so output channel c * m + k reads input
channel c through ``w[..., c, k]``, as in JAX.

:func:`conv2d_transpose` is ``conv2d_transpose`` (``:61``), which calls
``lax.conv_transpose`` with ``transpose_kernel=False``: a correlation of
the stride-dilated input with the HWIO kernel as it is, over the padding
of ``_conv_transpose_padding`` (:func:`transpose_pads`).
``F.conv_transpose2d`` is the gradient of a convolution, a correlation
with the kernel flipped in space and read [Cin, Cout, kh, kw], so the
kernel goes in flipped and permuted.  Its ``padding=p`` pads the dilated
input by k - 1 - p on both sides (plus ``output_padding`` at the end);
JAX's pads are (k - 1 - p, k - 1 - p) for a 4x4/2 under SAME (p = 1), and
an asymmetric pair with the shorter end cut off the output (a 3x3/2 under
SAME pads (2, 1)).
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
           dilation: _IntOrPair = 1, groups: int = 1) -> torch.Tensor:
    """NHWC conv. x: [N,H,W,Cin], w: [kh,kw,Cin/groups,Cout] -> NHWC,
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
                 stride=s, padding=sym, dilation=rate, groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None, *,
                     stride: _IntOrPair = 1, padding: Padding = "SAME",
                     dilation: _IntOrPair = 1) -> torch.Tensor:
    """Depthwise conv. x: [N,H,W,C], w: [kh,kw,C,multiplier] -> NHWC
    with C * multiplier channels."""
    kh, kw, c, m = w.shape
    return conv2d(x, w.reshape(kh, kw, 1, c * m), bias, stride=stride,
                  padding=padding, dilation=dilation, groups=c)


def transpose_pads(k: int, s: int, padding: str) -> tuple[int, int]:
    """(before, after) padding of the stride-dilated input along one axis,
    as ``lax.conv_transpose`` pads it for a "SAME" or "VALID" forward
    convolution (``jax._src.lax.convolution._conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        before = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        before = k - 1
    else:
        raise ValueError(f"conv2d_transpose pads 'SAME' or 'VALID', not "
                         f"{padding!r}")
    return before, pad_len - before


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None, *,
                     stride: _IntOrPair = 2,
                     padding: str = "SAME") -> torch.Tensor:
    """Fractionally-strided conv (the GAN generators'). x: [N,H,W,Cin],
    w: [kh,kw,Cin,Cout] HWIO as JAX holds it -> NHWC in x's dtype."""
    s = _pair(stride)
    k = tuple(w.shape[:2])
    pads = [transpose_pads(k[i], s[i], padding) for i in range(2)]
    # torch pads k - 1 - p before and k - 1 - p + output_padding after;
    # an after-pad shorter than the before-pad is cut off the output
    p = tuple(k[i] - 1 - pads[i][0] for i in range(2))
    extra = tuple(pads[i][1] - pads[i][0] for i in range(2))
    out_pad = tuple(max(e, 0) for e in extra)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           w.flip((0, 1)).permute(2, 3, 0, 1), bias,
                           stride=s, padding=p, output_padding=out_pad)
    y = y.permute(0, 2, 3, 1)
    cut_h, cut_w = (min(e, 0) for e in extra)
    return y[:, :y.shape[1] + cut_h, :y.shape[2] + cut_w]
