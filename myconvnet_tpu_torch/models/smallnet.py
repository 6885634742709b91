"""SmallNet, the CIFAR-10 / SVHN / Fashion-MNIST ConvNet (BASELINE config
#1), NHWC.

Port of ``myconvnet_tpu/models/smallnet.py:16-30``: three blocks of
(3x3 conv without bias -> BN -> ReLU) x 2 and a 2x2 SAME max-pool, at
widths ``width`` x (1, 2, 4); then global average pool -> dropout ->
``fc1`` (8 x width) -> ReLU -> dropout -> ``logits``.  The BNs take the
JAX defaults, momentum 0.99 and eps 1e-3 (``nn.py:254-255``).  The JAX
layers are auto-named at the root, so the modules are ``conv``,
``conv_1`` ... ``conv_5`` and ``bn`` ... ``bn_5``, then ``fc1`` and
``logits``.  :meth:`SmallNet.features` is the map the JAX model tags
``"features"`` (``smallnet.py:24``), the third block's pooled map.

Eval mode routes each conv -> BN -> ReLU through ``models/blocks.py``:
under bf16, 5 of the 6 convs (all but the C = 3 first) go through
``conv3x3_bn_relu`` and the first through cuDNN + ``fused_scale_shift_act``;
under float32 all six go through cuDNN + ``fused_scale_shift_act``.

The two dropout sites draw keep masks named ``gap`` ([N, 4 x width]) and
``fc1`` ([N, 8 x width]): :meth:`SmallNet.sample_masks` draws them from a
``torch.Generator`` and ``forward(x, masks)`` uses them, so a test can
hand over the masks JAX drew.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, fuses
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, dropout, gap,
                                    keep_mask, max_pool, relu)


def auto_name(base: str, i: int) -> str:
    """The JAX package's auto-numbered name of a scope's i-th ``base``."""
    return base if i == 0 else f"{base}_{i}"


class SmallNet(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, C] in the
    compute dtype -> logits [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 10, *, width: int = 32,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.width = width
        cin, self.n_convs = 3, 0
        for mult in (1, 2, 4):
            for _ in range(2):
                i = self.n_convs
                self.add_module(auto_name("conv", i),
                                Conv(cin, width * mult, 3))
                self.add_module(auto_name("bn", i), BatchNorm(width * mult))
                cin, self.n_convs = width * mult, i + 1
        self.fc1 = Dense(4 * width, 8 * width)
        self.logits = Dense(8 * width, num_classes)
        # static routing of the eval forward (models/blocks.py)
        self.fused = [fuses(c) for c in self.convs()]

    def convs(self) -> list[Conv]:
        return [getattr(self, auto_name("conv", i))
                for i in range(self.n_convs)]

    def bns(self) -> list[BatchNorm]:
        return [getattr(self, auto_name("bn", i))
                for i in range(self.n_convs)]

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """Keep masks of the two dropout sites of a train-mode forward of a
        batch of ``n``, in forward order, on the generator's device."""
        if self.dropout_rate <= 0:
            return {}
        r = self.dropout_rate
        return {"gap": keep_mask((n, 4 * self.width), r, generator),
                "fc1": keep_mask((n, 8 * self.width), r, generator)}

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The three conv blocks' output, before the pooling."""
        layers = list(zip(self.convs(), self.bns(), self.fused))
        for block in range(3):
            for conv, bn, fused in layers[2 * block:2 * block + 2]:
                x = conv_bn_relu(conv, bn, x, fused)
            x = max_pool(x, 2, 2)
        return x

    def forward(self, x: torch.Tensor, masks=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        masks = masks or {}
        x = dropout(gap(self.features(x)), self.dropout_rate,
                    train=self.training,
                    generator=generator, mask=masks.get("gap"))
        x = dropout(relu(self.fc1(x)), self.dropout_rate,
                    train=self.training, generator=generator,
                    mask=masks.get("fc1"))
        return self.logits(x)


def smallnet(num_classes: int = 10, **kwargs) -> SmallNet:
    return SmallNet(num_classes, **kwargs)
