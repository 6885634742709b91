"""Aligned Xception-65, NHWC: the classifier ``xception65`` and DeepLabv3+'s
``backbone="xception"``.

Port of ``myconvnet_tpu/models/xception.py``.  The separable conv
(``_sep_conv``, ``:22-37``): an optional ReLU first, the 3x3 depthwise
``dw`` (no bias) -> ``bn_dw`` -> ReLU, the 1x1 ``pw`` (no bias) ->
``bn_pw``; every BN momentum 0.9, eps 1e-3.  A block (``:40-59``) is three
separable convs, the last one strided, and a shortcut: ``conv`` (the 1x1
``skip_conv`` at the block's stride -> ``skip_bn``), ``sum`` (identity) or
none.  The backbone (``:62-124``): the stem (3x3/2 ``conv1`` -> ``bn1`` ->
ReLU, 3x3 ``conv2`` -> ``bn2`` -> ReLU), ``entry1`` (128, stride 2; its
output is the stride-4 tap of DeepLab's decoder), ``entry2`` (256),
``entry3`` (728), ``middle1``-``middle16`` (728, identity shortcuts),
``exit1`` (728, 1024, 1024) and ``exit2``'s three separable convs (1536,
1536, 2048) each followed by a ReLU.  Below ``output_stride`` 32 the
nominally stride-2 blocks from the one that would pass it keep stride 1
and the rate doubles after each, the converted block itself at the rate
before the doubling; the middle flow runs at the rate after entry3 and
``exit2`` at the rate after exit1 (at 16: exit1 undilated, exit2 at 2; at
8: entry3 undilated, the middle at 2, exit1 at 2, exit2 at 4).

``xception65`` is the backbone at output stride 32 (its scopes at the
root, as JAX calls it unscoped), global average pool, dropout 0.5 (site
``gap``, [N, 2048]) and the dense ``logits``.

Eval routing (``models/blocks.py``): each depthwise -> ``bn_dw`` -> ReLU
is a cuDNN depthwise conv + B1, so is ``exit2``'s ``pw`` -> ``bn_pw`` ->
ReLU and the stride-2 stem conv; the stem's 3x3 ``conv2`` (32 input
channels) is B4 on bf16 activations; a ReLU before a depthwise and the
``pw`` -> ``bn_pw`` without one stay plain ops.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, draw_masks, \
    fuses
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, DepthwiseConv,
                                    dropout, gap, relu)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-3, momentum=0.9)


class SepConv(nn.Module):
    def __init__(self, cin: int, features: int, *, stride: int = 1,
                 dilation: int = 1, relu_first: bool, relu_after: bool):
        super().__init__()
        self.relu_first, self.relu_after = relu_first, relu_after
        self.dw = DepthwiseConv(cin, 3, stride=stride, dilation=dilation)
        self.bn_dw = _bn(cin)
        self.pw = Conv(cin, features, 1)
        self.bn_pw = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.relu_first:
            x = relu(x)
        x = conv_bn_relu(self.dw, self.bn_dw, x)
        if self.relu_after:
            return conv_bn_relu(self.pw, self.bn_pw, x)
        return self.bn_pw(self.pw(x))


class XceptionBlock(nn.Module):
    def __init__(self, cin: int, features: tuple[int, ...], *,
                 stride: int = 1, dilation: int = 1, skip_kind: str,
                 relu_first: bool):
        super().__init__()
        self.skip_kind = skip_kind
        self.n = len(features)
        c = cin
        for i, f in enumerate(features):
            self.add_module(f"sep{i + 1}", SepConv(
                c, f, stride=stride if i == len(features) - 1 else 1,
                dilation=dilation, relu_first=relu_first, relu_after=False))
            c = f
        if skip_kind == "conv":
            self.skip_conv = Conv(cin, features[-1], 1, stride=stride)
            self.skip_bn = _bn(features[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n):
            h = getattr(self, f"sep{i + 1}")(h)
        if self.skip_kind == "conv":
            return h + self.skip_bn(self.skip_conv(x))
        if self.skip_kind == "sum":
            return h + x
        return h


def block_plan(output_stride: int) -> dict[str, tuple[int, int]]:
    """{block: (stride, dilation)} of the entry, middle and exit flows at
    ``output_stride`` (``xception.py:85-120``; ``exit2``'s stride is 1)."""
    if output_stride not in (8, 16, 32):
        raise ValueError("output_stride must be 8, 16 or 32")
    current, rate = 4, 1
    plan = {"entry1": (2, 1)}

    def block_stride():
        nonlocal current, rate
        if current >= output_stride:
            rate *= 2
            return 1, rate // 2
        current *= 2
        return 2, 1

    plan["entry2"] = block_stride()
    plan["entry3"] = block_stride()
    plan["middle"] = (1, rate)
    plan["exit1"] = block_stride()
    plan["exit2"] = (1, rate)
    return plan


class XceptionBackbone(nn.Module):
    """``forward(x, return_low_level=False)``: x [N, H, W, C] in the
    compute dtype -> the stride-``output_stride`` map (2048 channels), and
    entry1's stride-4 map (128 channels) with ``return_low_level``."""

    def __init__(self, *, output_stride: int = 32, in_channels: int = 3):
        super().__init__()
        plan = block_plan(output_stride)
        self.stem = nn.Module()
        self.stem.conv1 = Conv(in_channels, 32, 3, stride=2)
        self.stem.bn1 = _bn(32)
        self.stem.conv2 = Conv(32, 64, 3)
        self.stem.bn2 = _bn(64)
        self.stem_fused = fuses(self.stem.conv2)
        self.entry1 = XceptionBlock(64, (128, 128, 128), stride=2,
                                    skip_kind="conv", relu_first=False)
        s, d = plan["entry2"]
        self.entry2 = XceptionBlock(128, (256, 256, 256), stride=s,
                                    dilation=d, skip_kind="conv",
                                    relu_first=True)
        s, d = plan["entry3"]
        self.entry3 = XceptionBlock(256, (728, 728, 728), stride=s,
                                    dilation=d, skip_kind="conv",
                                    relu_first=True)
        for i in range(16):
            self.add_module(f"middle{i + 1}", XceptionBlock(
                728, (728, 728, 728), dilation=plan["middle"][1],
                skip_kind="sum", relu_first=True))
        s, d = plan["exit1"]
        self.exit1 = XceptionBlock(728, (728, 1024, 1024), stride=s,
                                   dilation=d, skip_kind="conv",
                                   relu_first=True)
        self.exit2 = nn.Module()
        c = 1024
        for i, f in enumerate((1536, 1536, 2048)):
            self.exit2.add_module(f"sep{i + 1}", SepConv(
                c, f, dilation=plan["exit2"][1], relu_first=False,
                relu_after=True))
            c = f
        self.out_channels = c
        self.low_level_channels = 128

    def forward(self, x: torch.Tensor, return_low_level: bool = False):
        st = self.stem
        x = conv_bn_relu(st.conv1, st.bn1, x)
        x = conv_bn_relu(st.conv2, st.bn2, x, self.stem_fused)
        x = low = self.entry1(x)
        x = self.entry3(self.entry2(x))
        for i in range(16):
            x = getattr(self, f"middle{i + 1}")(x)
        x = self.exit1(x)
        for i in range(3):
            x = getattr(self.exit2, f"sep{i + 1}")(x)
        return (x, low) if return_low_level else x


class Xception65(XceptionBackbone):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> logits [N, num_classes] in the compute dtype.  The
    backbone's scopes sit at the root, as JAX calls it unscoped."""

    def __init__(self, num_classes: int = 1000, *,
                 dropout_rate: float = 0.5):
        super().__init__(output_stride=32)
        self.dropout_rate = dropout_rate
        self.logits = Dense(self.out_channels, num_classes)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """The keep mask of the dropout before ``logits``."""
        return draw_masks({"gap": ((n, self.out_channels),
                                   self.dropout_rate)}, generator)

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        h = dropout(gap(super().forward(x)), self.dropout_rate,
                    train=self.training, generator=generator,
                    mask=None if masks is None else masks.get("gap"))
        return self.logits(h)


def xception65(num_classes: int = 1000, **kwargs) -> Xception65:
    return Xception65(num_classes, **kwargs)
