"""MobileNetV3 (Howard et al. 2019) Large and Small, NHWC.

Port of ``myconvnet_tpu/models/mobilenetv3.py``: ``hard_sigmoid``,
``hard_swish``, the expanded-channel SE ``_se_v3`` (gap, ``fc1`` to
round8(expanded / 4), ReLU, ``fc2``, a hard-sigmoid gate cast to x's
dtype), the ``_bneck`` block (``conv_expand``/``bn_expand`` where the
expansion differs from the input width, ``dwconv``/``bn_dw``, the
activation, SE, ``conv_project``/``bn_project``, the residual), the
Large and Small tables, and the head: ``conv``/``bn`` -> hard-swish,
gap, the biased ``pre_logits`` dense -> hard-swish, dropout (the site
``pre_logits``), ``logits``.  Every BN is momentum 0.99, eps 1e-3.

Eval routing: the ReLU blocks' conv -> BN -> ReLU sites are a cuDNN conv
and B1 (11 sites in Large, 5 in Small); the hard-swish sites stay plain
ops, as B1 has no hard-swish (nor has the TPU kernel).
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import ConvBN, conv_bn_act, \
    draw_masks
from myconvnet_tpu_torch.models.mobilenet import _round_filters
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, DepthwiseConv,
                                    dropout, gap, relu, relu6)

# (kernel, exp, out, SE, hard-swish, stride): paper tables 1 / 2
V3_LARGE = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]
V3_SMALL = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return relu6(x + 3.0) * (1.0 / 6.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-3, momentum=0.99)


class SEV3(nn.Module):
    def __init__(self, c: int, expanded: int):
        super().__init__()
        red = _round_filters(expanded // 4, 1.0)
        self.fc1 = Dense(c, red)
        self.fc2 = Dense(red, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = relu(self.fc1(gap(x)))
        s = hard_sigmoid(self.fc2(s)).to(x.dtype)
        return x * s[:, None, None, :]


class Bneck(nn.Module):
    def __init__(self, cin: int, *, k: int, exp: int, out: int, se: bool,
                 hs: bool, stride: int):
        super().__init__()
        if exp != cin:
            self.conv_expand = Conv(cin, exp, 1)
            self.bn_expand = _bn(exp)
        self.expands = exp != cin
        self.dwconv = DepthwiseConv(exp, k, stride=stride)
        self.bn_dw = _bn(exp)
        if se:
            self.se = SEV3(exp, exp)
        self.conv_project = Conv(exp, out, 1)
        self.bn_project = _bn(out)
        self.hs = hs
        self.residual = stride == 1 and cin == out

    def _act(self, conv, bn, h):
        if self.hs:
            return hard_swish(bn(conv(h)))
        return conv_bn_act(conv, bn, h, "relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expands:
            h = self._act(self.conv_expand, self.bn_expand, h)
        h = self._act(self.dwconv, self.bn_dw, h)
        if hasattr(self, "se"):
            h = self.se(h)
        h = self.bn_project(self.conv_project(h))
        return h + x if self.residual else h


class MobileNetV3(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> logits [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int, blocks, last_conv: int,
                 head_dim: int, *, width_multiplier: float = 1.0,
                 dropout_rate: float = 0.2):
        super().__init__()
        wm = width_multiplier
        self.dropout_rate = dropout_rate
        cin = _round_filters(16, wm)
        self.stem = ConvBN(3, cin, 3, _bn, stride=2)
        self.blocks = []
        for i, (k, exp, out, se, hs, s) in enumerate(blocks):
            blk = Bneck(cin, k=k, exp=_round_filters(exp, wm),
                        out=_round_filters(out, wm), se=se, hs=hs, stride=s)
            self.add_module(f"block{i + 1}", blk)
            self.blocks.append(blk)
            cin = _round_filters(out, wm)
        last = _round_filters(last_conv, wm)
        self.head = ConvBN(cin, last, 1, _bn)
        self.head_dim = _round_filters(head_dim, wm)
        self.pre_logits = Dense(last, self.head_dim)
        self.logits = Dense(self.head_dim, num_classes)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """The keep mask of the dropout after ``pre_logits``."""
        return draw_masks(
            {"pre_logits": ((n, self.head_dim), self.dropout_rate)},
            generator)

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        x = hard_swish(self.stem.bn(self.stem.conv(x)))
        for blk in self.blocks:
            x = blk(x)
        x = hard_swish(self.head.bn(self.head.conv(x)))
        x = hard_swish(self.pre_logits(gap(x)))
        x = dropout(x, self.dropout_rate, train=self.training,
                    generator=generator,
                    mask=None if masks is None else masks.get("pre_logits"))
        return self.logits(x)


def mobilenet_v3_large(num_classes: int = 1000, **kwargs) -> MobileNetV3:
    return MobileNetV3(num_classes, V3_LARGE, 960, 1280, **kwargs)


def mobilenet_v3_small(num_classes: int = 1000, **kwargs) -> MobileNetV3:
    return MobileNetV3(num_classes, V3_SMALL, 576, 1024, **kwargs)
