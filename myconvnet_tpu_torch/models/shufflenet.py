"""ShuffleNetV2 (channel split and shuffle), NHWC.

Port of ``myconvnet_tpu/models/shufflenet.py``: ``STAGE_CHANNELS`` (by
width multiplier), ``STAGE_REPEATS``, ``channel_shuffle``, ``_branch_main``
(1x1 ``conv1``/``bn1`` -> ReLU, 3x3 ``dwconv``/``bn_dw``, 1x1
``conv2``/``bn2`` -> ReLU) and ``shuffle_unit`` (stride 1: half the
channels ride the identity, the other half the ``main`` branch; stride 2:
the ``proj`` branch, ``dwconv``/``bn_dw`` -> 1x1 ``conv``/``bn`` -> ReLU,
beside ``main`` at stride 2; then concatenate and shuffle).  Scopes
``stem``, ``stage{2,3,4}_{i}``, ``conv5``, ``logits``.  Every BN is
momentum 0.9 with the default eps 1e-3.

Eval routing: each conv -> BN -> ReLU (stem, ``conv1``, ``conv2``, the
projection's ``conv`` and ``conv5``) is a cuDNN conv and B1; the depthwise
convs' BN has no activation and stays a plain op.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import ConvBN, conv_bn_relu
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, DepthwiseConv,
                                    gap, max_pool)

# out_channels per stage for width multipliers (paper table 5)
STAGE_CHANNELS = {
    0.5: (48, 96, 192, 1024),
    1.0: (116, 232, 464, 1024),
    1.5: (176, 352, 704, 1024),
    2.0: (244, 488, 976, 2048),
}
STAGE_REPEATS = (4, 8, 4)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, momentum=0.9)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups)
    return x.transpose(3, 4).reshape(n, h, w, c)


class BranchMain(nn.Module):
    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        self.conv1 = Conv(cin, features, 1)
        self.bn1 = _bn(features)
        self.dwconv = DepthwiseConv(features, 3, stride=stride)
        self.bn_dw = _bn(features)
        self.conv2 = Conv(features, features, 1)
        self.bn2 = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn_relu(self.conv1, self.bn1, x)
        x = self.bn_dw(self.dwconv(x))
        return conv_bn_relu(self.conv2, self.bn2, x)


class Proj(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.dwconv = DepthwiseConv(cin, 3, stride=2)
        self.bn_dw = _bn(cin)
        self.conv = Conv(cin, features, 1)
        self.bn = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_relu(self.conv, self.bn, self.bn_dw(self.dwconv(x)))


class ShuffleUnit(nn.Module):
    def __init__(self, cin: int, out: int, stride: int):
        super().__init__()
        self.stride = stride
        if stride == 1:
            self.half = cin // 2
            self.main = BranchMain(cin - self.half, out - self.half, 1)
        else:
            self.proj = Proj(cin, out // 2)
            self.main = BranchMain(cin, out - out // 2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            shortcut, h = x[..., :self.half], self.main(x[..., self.half:])
        else:
            shortcut, h = self.proj(x), self.main(x)
        return channel_shuffle(torch.cat([shortcut, h], dim=-1))


class ShuffleNetV2(nn.Module):
    """``forward(x)``: x [N, H, W, 3] in the compute dtype -> logits
    [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, *,
                 width_multiplier: float = 1.0):
        super().__init__()
        if width_multiplier not in STAGE_CHANNELS:
            raise ValueError(f"width_multiplier must be one of "
                             f"{sorted(STAGE_CHANNELS)}")
        c2, c3, c4, c5 = STAGE_CHANNELS[width_multiplier]
        self.stem = ConvBN(3, 24, 3, _bn, stride=2)
        cin, self.units = 24, []
        for si, (feats, reps) in enumerate(zip((c2, c3, c4), STAGE_REPEATS)):
            for i in range(reps):
                unit = ShuffleUnit(cin, feats, 2 if i == 0 else 1)
                self.add_module(f"stage{si + 2}_{i + 1}", unit)
                self.units.append(unit)
                cin = feats
        self.conv5 = ConvBN(cin, c5, 1, _bn)
        self.logits = Dense(c5, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn_relu(self.stem.conv, self.stem.bn, x)
        x = max_pool(x, 3, 2, padding="SAME")
        for unit in self.units:
            x = unit(x)
        x = conv_bn_relu(self.conv5.conv, self.conv5.bn, x)
        return self.logits(gap(x))


def shufflenet_v2(num_classes: int = 1000, **kwargs) -> ShuffleNetV2:
    return ShuffleNetV2(num_classes, **kwargs)
