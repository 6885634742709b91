"""VGG (depths 11, 16 and 19) with optional BN, NHWC (BASELINE config #3a).

Port of ``myconvnet_tpu/models/vgg.py:28-66``: the JAX table of conv
widths and 2x2 SAME max-pools, each conv 3x3 (with a bias only without
BN) -> BN -> ReLU; the default head is global average pool -> dropout ->
``logits``, ``classic_head=True`` the flatten -> ``fc1`` (4096) -> ReLU ->
dropout -> ``fc2`` (4096) -> ReLU -> dropout -> ``logits`` head, whose
``fc1`` is sized for ``input_hw``.  The BNs take the JAX defaults,
momentum 0.99 and eps 1e-3; the layers are auto-named at the root
(``conv``, ``conv_1`` ... and ``bn``, ``bn_1`` ...).  The JAX model's
``tag_intermediate`` taps (``relu{block}_{conv}``) feed only the
perceptual loss and Grad-CAM, which the port does not have yet; they are
left out.

Eval mode routes each conv -> BN -> ReLU through ``models/blocks.py``:
under bf16 every conv but the C = 3 first goes through
``conv3x3_bn_relu`` (12 of VGG-16's 13), the first through cuDNN +
``fused_scale_shift_act``; under float32 all through cuDNN +
``fused_scale_shift_act``.  The dropout sites draw keep masks named
``gap`` ([N, 512]), or ``fc1`` and ``fc2`` ([N, 4096]) with the classic
head, from :meth:`VGG.sample_masks`.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, fuses
from myconvnet_tpu_torch.models.smallnet import auto_name
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, dropout, gap,
                                    keep_mask, max_pool, relu)

# conv widths per block; int = conv, "M" = 2x2 max-pool
VGG_CFG = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, C] in the
    compute dtype -> logits [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, depth: int = 16, *,
                 use_bn: bool = True, dropout_rate: float = 0.5,
                 classic_head: bool = False,
                 input_hw: tuple[int, int] = (224, 224)):
        super().__init__()
        if depth not in VGG_CFG:
            raise ValueError(f"unsupported VGG depth {depth}; valid: "
                             f"{sorted(VGG_CFG)}")
        self.plan = VGG_CFG[depth]
        self.use_bn = use_bn
        self.dropout_rate = dropout_rate
        self.classic_head = classic_head
        cin, self.n_convs = 3, 0
        h, w = input_hw
        for item in self.plan:
            if item == "M":
                h, w = -(-h // 2), -(-w // 2)   # SAME pooling
                continue
            i = self.n_convs
            self.add_module(auto_name("conv", i),
                            Conv(cin, item, 3, bias=not use_bn))
            if use_bn:
                self.add_module(auto_name("bn", i), BatchNorm(item))
            cin, self.n_convs = item, i + 1
        if classic_head:
            self.fc1 = Dense(h * w * cin, 4096)
            self.fc2 = Dense(4096, 4096)
            cin = 4096
        self.head_width = cin
        self.logits = Dense(cin, num_classes)
        # static routing of the eval forward (models/blocks.py)
        self.fused = [fuses(self.conv_at(i)) for i in range(self.n_convs)]

    def conv_at(self, i: int) -> Conv:
        return getattr(self, auto_name("conv", i))

    def bn_at(self, i: int) -> BatchNorm | None:
        return getattr(self, auto_name("bn", i)) if self.use_bn else None

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """Keep masks of the head's dropout sites for a batch of ``n``, in
        forward order, on the generator's device."""
        if self.dropout_rate <= 0:
            return {}
        sites = ("fc1", "fc2") if self.classic_head else ("gap",)
        return {s: keep_mask((n, self.head_width), self.dropout_rate,
                             generator) for s in sites}

    def forward(self, x: torch.Tensor, masks=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        masks = masks or {}
        i = 0
        for item in self.plan:
            if item == "M":
                x = max_pool(x, 2, 2)
            else:
                x = conv_bn_relu(self.conv_at(i), self.bn_at(i), x,
                                 self.fused[i])
                i += 1

        def drop(v, site):
            return dropout(v, self.dropout_rate, train=self.training,
                           generator=generator, mask=masks.get(site))

        if self.classic_head:
            x = x.reshape(x.shape[0], -1)
            x = drop(relu(self.fc1(x)), "fc1")
            x = drop(relu(self.fc2(x)), "fc2")
        else:
            x = drop(gap(x), "gap")
        return self.logits(x)


def vgg11(num_classes: int = 1000, **kwargs) -> VGG:
    return VGG(num_classes, depth=11, **kwargs)


def vgg16(num_classes: int = 1000, **kwargs) -> VGG:
    return VGG(num_classes, depth=16, **kwargs)


def vgg19(num_classes: int = 1000, **kwargs) -> VGG:
    return VGG(num_classes, depth=19, **kwargs)
