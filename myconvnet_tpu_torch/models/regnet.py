"""RegNet (Radosavovic et al. 2020), X and Y at 400MF and 1.6GF.

Port of ``myconvnet_tpu/models/regnet.py``: ``REGNET_CFG`` (depths,
widths, group width, SE), the Y variants' ``_se`` (gap, ``fc1`` to the
block's INPUT width / 4, ReLU, ``fc2``, a sigmoid in x's dtype) and
``_block``: 1x1 ``conv_a``/``bn_a`` -> ReLU, the grouped 3x3
``conv_b``/``bn_b`` -> ReLU with ``groups = max(w_out // group_width,
1)``, SE, 1x1 ``conv_c``/``bn_c``, and the ``conv_proj``/``bn_proj``
shortcut where the stride or the width changes; scopes ``stem``,
``stage{s}/block{b}``, ``logits``.  The BNs take the layer defaults
(momentum 0.99, eps 1e-3).  :meth:`RegNet.features` is the map the JAX
model tags ``"features"`` (``regnet.py:82``).

Eval routing: every conv -> BN -> ReLU is a cuDNN conv (grouped for
conv_b) and B1; none is a 3x3 of one group, so B4 and B5 do not fit.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import ConvBN, conv_bn_relu
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, gap, relu,
                                    sigmoid)

# name -> (depths, widths, group_width, se)
REGNET_CFG = {
    "x_400mf": ((1, 2, 7, 12), (32, 64, 160, 384), 16, False),
    "y_400mf": ((1, 3, 6, 6), (48, 104, 208, 440), 8, True),
    "x_1_6gf": ((2, 4, 10, 2), (72, 168, 408, 912), 24, False),
    "y_1_6gf": ((2, 6, 17, 2), (48, 120, 336, 888), 24, True),
}


class SE(nn.Module):
    def __init__(self, c: int, w_in: int):
        super().__init__()
        self.fc1 = Dense(c, max(w_in // 4, 1))
        self.fc2 = Dense(max(w_in // 4, 1), c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = relu(self.fc1(gap(x)))
        s = sigmoid(self.fc2(s).to(x.dtype))
        return x * s[:, None, None, :]


class Block(nn.Module):
    def __init__(self, w_in: int, w_out: int, *, stride: int,
                 group_width: int, se: bool):
        super().__init__()
        groups = max(w_out // group_width, 1)
        self.conv_a = Conv(w_in, w_out, 1)
        self.bn_a = BatchNorm(w_out)
        self.conv_b = Conv(w_out, w_out, 3, stride=stride, groups=groups)
        self.bn_b = BatchNorm(w_out)
        if se:
            self.se = SE(w_out, w_in)
        self.conv_c = Conv(w_out, w_out, 1)
        self.bn_c = BatchNorm(w_out)
        self.projection = stride != 1 or w_in != w_out
        if self.projection:
            self.conv_proj = Conv(w_in, w_out, 1, stride=stride)
            self.bn_proj = BatchNorm(w_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn_relu(self.conv_a, self.bn_a, x)
        y = conv_bn_relu(self.conv_b, self.bn_b, y)
        if hasattr(self, "se"):
            y = self.se(y)
        y = self.bn_c(self.conv_c(y))
        shortcut = x
        if self.projection:
            shortcut = self.bn_proj(self.conv_proj(x))
        return relu(y + shortcut)


class RegNet(nn.Module):
    """``forward(x)``: x [N, H, W, 3] in the compute dtype -> logits
    [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, variant: str = "x_400mf"):
        super().__init__()
        if variant not in REGNET_CFG:
            raise ValueError(f"unknown RegNet variant {variant!r}; valid: "
                             f"{sorted(REGNET_CFG)}")
        depths, widths, gw, se = REGNET_CFG[variant]
        self.stem = ConvBN(3, 32, 3, BatchNorm, stride=2)
        cin, self.blocks = 32, []
        for si, (d, w) in enumerate(zip(depths, widths)):
            stage = nn.Module()
            for b in range(d):
                blk = Block(cin, w, stride=2 if b == 0 else 1,
                            group_width=gw, se=se)
                stage.add_module(f"block{b + 1}", blk)
                self.blocks.append(blk)
                cin = w
            self.add_module(f"stage{si + 1}", stage)
        self.logits = Dense(cin, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's map, before the pooling."""
        x = conv_bn_relu(self.stem.conv, self.stem.bn, x)
        for blk in self.blocks:
            x = blk(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits(gap(self.features(x)))


def _variant(v: str):
    def build(num_classes: int = 1000, **kwargs) -> RegNet:
        return RegNet(num_classes, variant=v, **kwargs)
    build.__name__ = f"regnet_{v}"
    return build


VARIANTS = {f"regnet_{v}": _variant(v) for v in REGNET_CFG}
