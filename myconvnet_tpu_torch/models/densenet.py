"""DenseNet (depths 121, 169 and 201), NHWC (BASELINE config #3b).

Port of ``myconvnet_tpu/models/densenet.py:34-80``.  Scopes as in JAX:
``stem`` (7x7/2 conv -> BN -> ReLU -> 3x3/2 SAME max-pool), then four
dense blocks ``block{i}`` of ``layer{j}`` (BN -> ReLU -> 1x1 conv to
4 x growth_rate ``conv_bottleneck`` -> BN -> ReLU -> 3x3 conv to
growth_rate ``conv_grow``, its output concatenated onto the input on the
channel axis), a ``transition{i}`` between blocks (BN -> ReLU -> 1x1
``conv_transition`` to half the channels -> 2x2 VALID average pool), then
the final ``bn`` -> ReLU -> global average pool -> ``logits``.  JAX
restarts the auto-numbering inside each scope, so every dense layer has
``bn`` and ``bn_1``.  Every BN is momentum 0.9, eps 1e-5.

Eval mode (``models/blocks.py``): each pre-activation BN -> ReLU (on the
concatenation, at the transitions and at the end) is one pass of
``fused_scale_shift_act`` (B1), and so is the epilogue of the stem conv
and of each ``conv_bottleneck`` (cuDNN conv, then B1 with the BN folded
into its scale and shift): 1 + 2 a dense layer + 1 a transition + 1
launches, 121 in DenseNet-121.  ``conv_grow`` stays a cuDNN conv: what
follows it is the concatenation, not a BN -> ReLU of its own, so neither
``conv3x3_bn_relu`` (B4) nor the bottleneck pair (B5, which ends in
BN -> ReLU) fits it.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import bn_relu, conv_bn_relu
from myconvnet_tpu_torch.nn import BatchNorm, Conv, Dense, avg_pool, gap, \
    max_pool

STAGE_LAYERS = {121: (6, 12, 24, 16), 169: (6, 12, 32, 32),
                201: (6, 12, 48, 32)}
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, BN_EPS, BN_MOMENTUM)


class Stem(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = Conv(cin, features, 7, stride=2)
        self.bn = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn_relu(self.conv, self.bn, x, fused=False)
        return max_pool(x, 3, 2, padding="SAME")


class DenseLayer(nn.Module):
    """BN -> ReLU -> 1x1 (4k) -> BN -> ReLU -> 3x3 (k); the caller
    concatenates the output."""

    def __init__(self, cin: int, growth_rate: int):
        super().__init__()
        self.bn = _bn(cin)
        self.conv_bottleneck = Conv(cin, 4 * growth_rate, 1)
        self.bn_1 = _bn(4 * growth_rate)
        self.conv_grow = Conv(4 * growth_rate, growth_rate, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = bn_relu(self.bn, x)
        y = conv_bn_relu(self.conv_bottleneck, self.bn_1, y, fused=False)
        return self.conv_grow(y)


class Transition(nn.Module):
    def __init__(self, cin: int, compression: float = 0.5):
        super().__init__()
        self.bn = _bn(cin)
        self.conv_transition = Conv(cin, int(cin * compression), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_transition(bn_relu(self.bn, x))
        return avg_pool(y, 2, 2, padding="VALID")


class DenseNet(nn.Module):
    """``forward(x)``: x [N, H, W, C] in the compute dtype -> logits
    [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, depth: int = 121, *,
                 growth_rate: int = 32):
        super().__init__()
        if depth not in STAGE_LAYERS:
            raise ValueError(f"unsupported DenseNet depth {depth}; "
                             f"valid: {sorted(STAGE_LAYERS)}")
        self.stem = Stem(3, 2 * growth_rate)
        c = 2 * growth_rate
        stages = STAGE_LAYERS[depth]
        self.n_stages = len(stages)
        for i, n_layers in enumerate(stages):
            block = nn.Module()
            for j in range(n_layers):
                block.add_module(f"layer{j + 1}", DenseLayer(c, growth_rate))
                c += growth_rate
            self.add_module(f"block{i + 1}", block)
            if i < len(stages) - 1:
                self.add_module(f"transition{i + 1}", Transition(c))
                c = int(c * 0.5)
        self.bn = _bn(c)
        self.logits = Dense(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for i in range(self.n_stages):
            for layer in getattr(self, f"block{i + 1}").children():
                x = torch.cat([x, layer(x)], dim=-1)
            if i < self.n_stages - 1:
                x = getattr(self, f"transition{i + 1}")(x)
        return self.logits(gap(bn_relu(self.bn, x)))


def densenet121(num_classes: int = 1000, **kwargs) -> DenseNet:
    return DenseNet(num_classes, depth=121, **kwargs)


def densenet169(num_classes: int = 1000, **kwargs) -> DenseNet:
    return DenseNet(num_classes, depth=169, **kwargs)


def densenet201(num_classes: int = 1000, **kwargs) -> DenseNet:
    return DenseNet(num_classes, depth=201, **kwargs)
