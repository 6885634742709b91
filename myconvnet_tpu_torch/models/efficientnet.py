"""EfficientNet B0-B7 (MBConv + squeeze-excitation), NHWC.

Port of ``myconvnet_tpu/models/efficientnet.py``: ``B0_BLOCKS``,
``SCALING`` (width, depth, dropout of B0-B7), ``_round_filters``,
``_round_repeats``, ``squeeze_excite`` (gap kept [N, 1, 1, C], the biased
1x1 convs ``se/conv_reduce`` -> swish -> ``se/conv_expand`` -> sigmoid,
with no cast: the gate's dtype is the gap's, x's) and ``mbconv``
(``conv_expand``/``bn_expand`` -> swish where the expansion is not 1,
``dwconv``/``bn_dw`` -> swish, SE, ``conv_project``/``bn_project``, and
the residual through drop-path where the stride is 1 and the width
stays).  Block i of the ``total`` blocks (counted from 0) drops its path
at ``drop_connect * i / total``.  Every BN is momentum 0.9, eps 1e-3.

Every activation here is swish, which B1 does not have: the eval forward
is plain ops (cuDNN convs, grouped for the depthwise ones) and launches
none of the port's kernels.  The random sites of a train-mode forward are
each residual block's drop-path, named by its scope
(``stage2_block2``, [N]), then the dropout before ``logits`` (``head``,
[N, C]): :meth:`EfficientNet.sample_masks` draws them in that order from
the step's generator, as ViT's are.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import ConvBN, draw_masks
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, DepthwiseConv,
                                    drop_path, dropout, gap, sigmoid, swish)

# (kernel, channels, repeats, stride, expand): the B0 baseline
B0_BLOCKS = [
    (3, 16, 1, 1, 1),
    (3, 24, 2, 2, 6),
    (5, 40, 2, 2, 6),
    (3, 80, 3, 2, 6),
    (5, 112, 3, 1, 6),
    (5, 192, 4, 2, 6),
    (3, 320, 1, 1, 6),
]

# width_mult, depth_mult, dropout
SCALING = {
    0: (1.0, 1.0, 0.2),
    1: (1.0, 1.1, 0.2),
    2: (1.1, 1.2, 0.3),
    3: (1.2, 1.4, 0.3),
    4: (1.4, 1.8, 0.4),
    5: (1.6, 2.2, 0.4),
    6: (1.8, 2.6, 0.5),
    7: (2.0, 3.1, 0.5),
}


def _round_filters(c, mult, divisor=8):
    c *= mult
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:
        new += divisor
    return int(new)


def _round_repeats(r, mult):
    return int(math.ceil(r * mult))


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-3, momentum=0.9)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.conv_reduce = Conv(c, reduced, 1, bias=True)
        self.conv_expand = Conv(reduced, c, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = swish(self.conv_reduce(gap(x, keepdims=True)))
        return x * sigmoid(self.conv_expand(s))


class MBConv(nn.Module):
    def __init__(self, cin: int, features: int, *, kernel: int, stride: int,
                 expand: int, se_ratio: float, drop_rate: float, site: str):
        super().__init__()
        hidden = cin * expand
        if expand != 1:
            self.conv_expand = Conv(cin, hidden, 1)
            self.bn_expand = _bn(hidden)
        self.expand = expand
        self.dwconv = DepthwiseConv(hidden, kernel, stride=stride)
        self.bn_dw = _bn(hidden)
        if se_ratio:
            self.se = SqueezeExcite(hidden, max(1, int(cin * se_ratio)))
        self.conv_project = Conv(hidden, features, 1)
        self.bn_project = _bn(features)
        self.residual = stride == 1 and cin == features
        self.drop_rate, self.site = drop_rate, site

    def drop_sites(self, n: int) -> dict:
        return ({self.site: ((n,), self.drop_rate)} if self.residual
                else {})

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        h = x
        if self.expand != 1:
            h = swish(self.bn_expand(self.conv_expand(h)))
        h = swish(self.bn_dw(self.dwconv(h)))
        if hasattr(self, "se"):
            h = self.se(h)
        h = self.bn_project(self.conv_project(h))
        if not self.residual:
            return h
        return drop_path(h, self.drop_rate, train=self.training,
                         generator=generator,
                         mask=None if masks is None
                         else masks.get(self.site)) + x


class EfficientNet(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> logits [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, variant: int = 0, *,
                 se_ratio: float = 0.25, drop_connect: float = 0.2):
        super().__init__()
        if variant not in SCALING:
            raise ValueError(f"unsupported EfficientNet-B{variant}; "
                             f"valid: {sorted(SCALING)}")
        wm, dm, self.dropout_rate = SCALING[variant]
        cin = _round_filters(32, wm)
        self.stem = ConvBN(3, cin, 3, _bn, stride=2)
        total = sum(_round_repeats(r, dm) for _, _, r, _, _ in B0_BLOCKS)
        self.blocks, idx = [], 0
        for si, (k, c, r, s, t) in enumerate(B0_BLOCKS):
            feats = _round_filters(c, wm)
            for i in range(_round_repeats(r, dm)):
                name = f"stage{si + 1}_block{i + 1}"
                blk = MBConv(cin, feats, kernel=k, stride=s if i == 0 else 1,
                             expand=t, se_ratio=se_ratio,
                             drop_rate=drop_connect * idx / total, site=name)
                self.add_module(name, blk)
                self.blocks.append(blk)
                cin, idx = feats, idx + 1
        self.last = _round_filters(1280, wm)
        self.head = ConvBN(cin, self.last, 1, _bn)
        self.logits = Dense(self.last, num_classes)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """Keep masks of the residual blocks' drop-path and the head's
        dropout for a batch of ``n``, in forward order."""
        sites = {}
        for blk in self.blocks:
            sites.update(blk.drop_sites(n))
        sites["head"] = ((n, self.last), self.dropout_rate)
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


def _variant(v: int):
    def build(num_classes: int = 1000, **kwargs) -> EfficientNet:
        return EfficientNet(num_classes, variant=v, **kwargs)
    build.__name__ = f"efficientnet_b{v}"
    return build


VARIANTS = {f"efficientnet_b{v}": _variant(v) for v in SCALING}
efficientnet_b0 = VARIANTS["efficientnet_b0"]
