"""MobileNetV2 (inverted residuals, depthwise convs), NHWC.

Port of ``myconvnet_tpu/models/mobilenet.py``: ``V2_BLOCKS`` (expansion t,
channels c, repeats n, stride s), ``_round_filters``, the
``inverted_residual`` block (``conv_expand``/``bn_expand`` -> ReLU6 where
t != 1, the 3x3 ``dwconv``/``bn_dw`` -> ReLU6, the linear
``conv_project``/``bn_project``, the residual where the stride is 1 and
the width stays), scopes ``stem``, ``block{i}_{j}``, ``head``, ``logits``.
Every BN is momentum 0.9, eps 1e-3; ``width_multiplier`` rounds the
widths to multiples of 8, the head's 1280 only upward.

Eval routing (``models/blocks.py``): every conv -> BN -> ReLU6 is a cuDNN
conv (the depthwise ones grouped) and one pass of B1 with ``act="relu6"``:
the stem, 16 expansions, 17 depthwise convs and the head, 35 sites a
forward.  The projections' BN has no activation and stays a plain op.
JAX's fold pairs ``conv_expand``/``bn_expand``, ``conv_project``/
``bn_project`` and the stem's and head's ``conv``/``bn``, not ``dwconv``/
``bn_dw`` (the leaf does not start with ``conv``), and so does
``models/folding.py``.  The dropout before ``logits`` is the site
``head`` ([N, 1280]).
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import ConvBN, conv_bn_act, \
    draw_masks
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, DepthwiseConv,
                                    dropout, gap)

# (expansion t, channels c, repeats n, stride s): V2 paper table 2
V2_BLOCKS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _round_filters(c: int, multiplier: float, divisor: int = 8) -> int:
    c = c * multiplier
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:
        new += divisor
    return int(new)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-3, momentum=0.9)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, *, stride: int,
                 expand: int):
        super().__init__()
        hidden = cin * expand
        if expand != 1:
            self.conv_expand = Conv(cin, hidden, 1)
            self.bn_expand = _bn(hidden)
        self.expand = expand
        self.dwconv = DepthwiseConv(hidden, 3, stride=stride)
        self.bn_dw = _bn(hidden)
        self.conv_project = Conv(hidden, features, 1)
        self.bn_project = _bn(features)
        self.residual = stride == 1 and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand != 1:
            h = conv_bn_act(self.conv_expand, self.bn_expand, h, "relu6")
        h = conv_bn_act(self.dwconv, self.bn_dw, h, "relu6")
        h = self.bn_project(self.conv_project(h))
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> logits [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, *,
                 width_multiplier: float = 1.0, dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        first = _round_filters(32, width_multiplier)
        self.stem = ConvBN(3, first, 3, _bn, stride=2)
        cin, self.blocks = first, []
        for bi, (t, c, n, s) in enumerate(V2_BLOCKS):
            feats = _round_filters(c, width_multiplier)
            for i in range(n):
                blk = InvertedResidual(cin, feats, stride=s if i == 0 else 1,
                                       expand=t)
                self.add_module(f"block{bi + 1}_{i + 1}", blk)
                self.blocks.append(blk)
                cin = feats
        self.last = _round_filters(1280, max(1.0, width_multiplier))
        self.head = ConvBN(cin, self.last, 1, _bn)
        self.logits = Dense(self.last, num_classes)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """The keep mask of the head's dropout for a batch of ``n``."""
        return draw_masks({"head": ((n, self.last), self.dropout_rate)},
                          generator)

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        x = conv_bn_act(self.stem.conv, self.stem.bn, x, "relu6")
        for blk in self.blocks:
            x = blk(x)
        x = conv_bn_act(self.head.conv, self.head.bn, x, "relu6")
        x = dropout(gap(x), self.dropout_rate, train=self.training,
                    generator=generator,
                    mask=None if masks is None else masks.get("head"))
        return self.logits(x)


def mobilenet_v2(num_classes: int = 1000, **kwargs) -> MobileNetV2:
    return MobileNetV2(num_classes, **kwargs)
