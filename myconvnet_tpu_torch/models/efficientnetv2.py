"""EfficientNetV2 S, M and L: fused-MBConv early stages, MBConv late.

Port of ``myconvnet_tpu/models/efficientnetv2.py``: ``V2_STAGES`` (block,
kernel, channels, repeats, stride, expand, SE ratio), ``V2_STEM``,
``V2_DROPOUT`` and ``fused_mbconv`` (a kxk ``conv_expand``/``bn_expand``
-> swish, SE, the 1x1 ``conv_project``/``bn_project`` where the expansion
is not 1; else one kxk ``conv``/``bn`` -> swish; the residual through
drop-path), with ``models/efficientnet.py``'s ``MBConv`` for the late
stages.  Block i of the ``total`` drops its path at
``drop_connect * i / total``; every BN is momentum 0.9, eps 1e-3; the
head is a 1x1 conv to 1280.  Like EfficientNet, every activation is
swish and the eval forward is plain ops; the random sites are the
residual blocks' drop-path by scope, then ``head``.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import ConvBN, draw_masks
from myconvnet_tpu_torch.models.efficientnet import (MBConv, SqueezeExcite,
                                                     _bn)
from myconvnet_tpu_torch.nn import Conv, Dense, drop_path, dropout, gap, \
    swish

# (block, kernel, channels, repeats, stride, expand, se_ratio)
V2_STAGES = {
    "s": [
        ("fused", 3, 24, 2, 1, 1, 0.0),
        ("fused", 3, 48, 4, 2, 4, 0.0),
        ("fused", 3, 64, 4, 2, 4, 0.0),
        ("mb", 3, 128, 6, 2, 4, 0.25),
        ("mb", 3, 160, 9, 1, 6, 0.25),
        ("mb", 3, 256, 15, 2, 6, 0.25),
    ],
    "m": [
        ("fused", 3, 24, 3, 1, 1, 0.0),
        ("fused", 3, 48, 5, 2, 4, 0.0),
        ("fused", 3, 80, 5, 2, 4, 0.0),
        ("mb", 3, 160, 7, 2, 4, 0.25),
        ("mb", 3, 176, 14, 1, 6, 0.25),
        ("mb", 3, 304, 18, 2, 6, 0.25),
        ("mb", 3, 512, 5, 1, 6, 0.25),
    ],
    "l": [
        ("fused", 3, 32, 4, 1, 1, 0.0),
        ("fused", 3, 64, 7, 2, 4, 0.0),
        ("fused", 3, 96, 7, 2, 4, 0.0),
        ("mb", 3, 192, 10, 2, 4, 0.25),
        ("mb", 3, 224, 19, 1, 6, 0.25),
        ("mb", 3, 384, 25, 2, 6, 0.25),
        ("mb", 3, 512, 7, 1, 6, 0.25),
    ],
}

# stem channels, head dropout
V2_STEM = {"s": 24, "m": 24, "l": 32}
V2_DROPOUT = {"s": 0.2, "m": 0.3, "l": 0.4}


class FusedMBConv(nn.Module):
    def __init__(self, cin: int, features: int, *, kernel: int, stride: int,
                 expand: int, se_ratio: float, drop_rate: float, site: str):
        super().__init__()
        self.expand = expand
        if expand != 1:
            self.conv_expand = Conv(cin, cin * expand, kernel, stride=stride)
            self.bn_expand = _bn(cin * expand)
            if se_ratio:
                self.se = SqueezeExcite(cin * expand,
                                        max(1, int(cin * se_ratio)))
            self.conv_project = Conv(cin * expand, features, 1)
            self.bn_project = _bn(features)
        else:
            self.conv = Conv(cin, features, kernel, stride=stride)
            self.bn = _bn(features)
        self.residual = stride == 1 and cin == features
        self.drop_rate, self.site = drop_rate, site

    drop_sites = MBConv.drop_sites

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        if self.expand != 1:
            h = swish(self.bn_expand(self.conv_expand(x)))
            if hasattr(self, "se"):
                h = self.se(h)
            h = self.bn_project(self.conv_project(h))
        else:
            h = swish(self.bn(self.conv(x)))
        if not self.residual:
            return h
        return drop_path(h, self.drop_rate, train=self.training,
                         generator=generator,
                         mask=None if masks is None
                         else masks.get(self.site)) + x


class EfficientNetV2(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> logits [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, variant: str = "s", *,
                 drop_connect: float = 0.2):
        super().__init__()
        if variant not in V2_STAGES:
            raise ValueError(f"unsupported EfficientNetV2-{variant!r}; "
                             f"valid: {sorted(V2_STAGES)}")
        stages = V2_STAGES[variant]
        self.dropout_rate = V2_DROPOUT[variant]
        cin = V2_STEM[variant]
        self.stem = ConvBN(3, cin, 3, _bn, stride=2)
        total = sum(r for _, _, _, r, _, _, _ in stages)
        self.blocks, idx = [], 0
        for si, (kind, k, c, r, s, e, se) in enumerate(stages):
            block = FusedMBConv if kind == "fused" else MBConv
            for i in range(r):
                name = f"stage{si + 1}_block{i + 1}"
                blk = block(cin, c, kernel=k, stride=s if i == 0 else 1,
                            expand=e, se_ratio=se,
                            drop_rate=drop_connect * idx / total, site=name)
                self.add_module(name, blk)
                self.blocks.append(blk)
                cin, idx = c, idx + 1
        self.head = ConvBN(cin, 1280, 1, _bn)
        self.logits = Dense(1280, num_classes)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """Keep masks of the residual blocks' drop-path and the head's
        dropout for a batch of ``n``, in forward order."""
        sites = {}
        for blk in self.blocks:
            sites.update(blk.drop_sites(n))
        sites["head"] = ((n, 1280), self.dropout_rate)
        return draw_masks(sites, generator)

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        x = swish(self.stem.bn(self.stem.conv(x)))
        for blk in self.blocks:
            x = blk(x, masks, generator)
        x = swish(self.head.bn(self.head.conv(x)))
        x = dropout(gap(x), self.dropout_rate, train=self.training,
                    generator=generator,
                    mask=None if masks is None else masks.get("head"))
        return self.logits(x)


def _variant(v: str):
    def build(num_classes: int = 1000, **kwargs) -> EfficientNetV2:
        return EfficientNetV2(num_classes, variant=v, **kwargs)
    build.__name__ = f"efficientnet_v2_{v}"
    return build


VARIANTS = {f"efficientnet_v2_{v}": _variant(v) for v in V2_STAGES}
