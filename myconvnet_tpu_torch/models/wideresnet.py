"""Wide ResNet (Zagoruyko & Komodakis), NHWC.

Port of ``myconvnet_tpu/models/wideresnet.py``: pre-activation basic blocks
(BN -> ReLU -> conv), three groups of (depth - 4) / 6 blocks at widths 16k,
32k and 64k, dropout between a block's two convs.  Scopes as in JAX:
``stem/conv``, ``group{g}/block{b}/{preact_a, conv_proj, conv_a, preact_b,
conv_b}``, ``bn_final``, ``logits``.  The first block of a group projects
the pre-activated tensor (``conv_proj``).  Every BN is momentum 0.9, eps
1e-5, and is named ``preact_*``: it normalizes a conv's input, so folding
(``models/folding.py``) never pairs it, in JAX or here.

Eval routing (``models/blocks.py``): ``preact_a`` -> ReLU and ``bn_final``
-> ReLU are B1, as DenseNet's pre-activation is; ``conv_a`` -> ``preact_b``
-> ReLU is ``conv3x3_bn_relu`` (B4) at stride 1 on bf16 activations (10 of
WRN-28-10's 12 blocks) and a cuDNN conv + B1 at stride 2.

The dropout site of block b of group g is ``group{g}/block{b}``, a keep
mask of the block's [N, H, W, C] map at the model's ``input_hw``
(:meth:`WideResNet.sample_masks`, in forward order).
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import (bn_relu, conv_bn_relu,
                                               draw_masks, fuses)
from myconvnet_tpu_torch.nn import BatchNorm, Conv, Dense, dropout, gap

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, BN_EPS, BN_MOMENTUM)


class WideBlock(nn.Module):
    def __init__(self, cin: int, features: int, *, stride: int,
                 first: bool, dropout_rate: float, site: str):
        super().__init__()
        self.site = site
        self.dropout_rate = dropout_rate
        self.preact_a = _bn(cin)
        if first:
            self.conv_proj = Conv(cin, features, 1, stride=stride)
        self.conv_a = Conv(cin, features, 3, stride=stride)
        self.preact_b = _bn(features)
        self.conv_b = Conv(features, features, 3)
        self.first = first
        self.fused = fuses(self.conv_a)

    def forward(self, x, masks=None, generator=None):
        pre = bn_relu(self.preact_a, x)
        shortcut = self.conv_proj(pre) if self.first else x
        y = conv_bn_relu(self.conv_a, self.preact_b, pre, self.fused)
        y = dropout(y, self.dropout_rate, train=self.training,
                    generator=generator,
                    mask=None if masks is None else masks.get(self.site))
        return self.conv_b(y) + shortcut


class WideResNet(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, C] in the
    compute dtype -> logits [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 10, *, depth: int = 28,
                 width_mult: int = 10, dropout_rate: float = 0.0,
                 input_hw: tuple[int, int] = (32, 32)):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"WRN depth must be 6n+4, got {depth}")
        n = (depth - 4) // 6
        self.input_hw = tuple(input_hw)
        self.dropout_rate = dropout_rate
        self.stem = nn.Module()
        self.stem.conv = Conv(3, 16, 3)
        cin = 16
        self.groups = []
        for g in range(3):
            features = 16 * width_mult * 2 ** g
            group = nn.Module()
            for b in range(n):
                group.add_module(f"block{b + 1}", WideBlock(
                    cin, features, stride=2 if g > 0 and b == 0 else 1,
                    first=b == 0, dropout_rate=dropout_rate,
                    site=f"group{g + 1}/block{b + 1}"))
                cin = features
            self.add_module(f"group{g + 1}", group)
            self.groups.append(group)
        self.bn_final = _bn(cin)
        self.logits = Dense(cin, num_classes)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """Keep masks of every block's dropout for a batch of ``n`` at
        ``input_hw``, in forward order."""
        sites, (h, w) = {}, self.input_hw
        for group in self.groups:
            for blk in group.children():
                if blk.conv_a.stride == 2:   # SAME: a side rounds up
                    h, w = -(-h // 2), -(-w // 2)
                c = blk.conv_b.weight.shape[0]
                sites[blk.site] = ((n, h, w, c), self.dropout_rate)
        return draw_masks(sites, generator)

    def features(self, x, masks=None, generator=None) -> torch.Tensor:
        """The map after ``bn_final`` -> ReLU, before the pooling (the map
        the JAX model tags ``"features"``, ``wideresnet.py:73``)."""
        x = self.stem.conv(x)
        for group in self.groups:
            for blk in group.children():
                x = blk(x, masks, generator)
        return bn_relu(self.bn_final, x)

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        return self.logits(gap(self.features(x, masks, generator)))


def wide_resnet(num_classes: int = 10, **kwargs) -> WideResNet:
    return WideResNet(num_classes, **kwargs)


def wrn_28_10(num_classes: int = 10, **kwargs) -> WideResNet:
    return WideResNet(num_classes, **{"depth": 28, "width_mult": 10,
                                      **kwargs})


def wrn_16_8(num_classes: int = 10, **kwargs) -> WideResNet:
    return WideResNet(num_classes, **{"depth": 16, "width_mult": 8,
                                      **kwargs})
