"""SSD300, SSD512 and tinydet: single-shot detectors, NHWC.

Port of ``myconvnet_tpu/models/ssd.py``.  The VGG-16 trunk with BN
(``_vgg_trunk``, ``:52-78``: 13 3x3 convs, 2x2 SAME pools, a 3x3 stride-1
pool5, fc6 a 3x3 conv at dilation 6, fc7 a 1x1, 1024 wide), the extra
stages (a 1x1 then a 3x3 at stride 2 SAME or stride 1 VALID), and a 3x3
multibox head pair (``cls{i}``, ``loc{i}``, with biases) a pyramid level,
reshaped cell-major to ``[B, H * W * a, k]`` and concatenated: (cls
logits [B, A, C] with background at 0, loc [B, A, 4]) in the compute
dtype.  The scopes are JAX's: ``backbone/conv`` ... ``backbone/conv_12``
and their ``bn`` ... ``bn_12`` (momentum 0.99, eps 1e-3),
``backbone/fc6/conv``, ``extras/stage8/conv_1``, ``heads/cls1``.  Each
model carries ``input_hw`` and ``anchor_spec`` as the JAX functions do.

Eval mode routes each conv -> BN -> ReLU through
``models/blocks.conv_bn_relu``: under bf16 the 12 trunk convs with C_in %
8 == 0 are ``conv3x3_bn_relu`` (B4), and the first (C = 3), fc6, fc7 and
the eight extras' convs are cuDNN + ``fused_scale_shift_act`` (B1): 12 B4
and 11 B1 launches a forward of SSD300.  The heads have no activation and
run as plain convs.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, fuses
from myconvnet_tpu_torch.models.smallnet import auto_name
from myconvnet_tpu_torch.nn import BatchNorm, Conv, max_pool
from myconvnet_tpu_torch.ops.boxes import SSD300_SPEC, SSD512_SPEC

# 2 + 2 * len(ratios) anchors a cell on each level of SSD300's spec
ANCHORS_PER_CELL = (4, 6, 6, 6, 4, 4)
NUM_ANCHORS = 8732
TRUNK = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
         "tap", "M", 512, 512, 512)
SSD300_EXTRAS = ((256, 512, 2, "SAME"), (128, 256, 2, "SAME"),
                 (128, 256, 1, "VALID"), (128, 256, 1, "VALID"))
SSD512_EXTRAS = ((256, 512, 2, "SAME"),) + ((128, 256, 2, "SAME"),) * 4
TINYDET_SPEC = (
    (12, 0.10, 0.25, (2.0,)),
    (6, 0.25, 0.50, (2.0,)),
    (3, 0.50, 0.80, (2.0,)),
)


class _Sites(nn.Module):
    """A scope of ``_conv_bn_relu`` sites, auto-named ``conv``,
    ``conv_1`` ... (and ``bn``, ``bn_1`` ...) as JAX names them, each with
    its routing decided at build time."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.use_bn: list[bool] = []
        self.fused: list[bool] = []

    def add(self, cin: int, cout: int, k: int, *, use_bn: bool,
            stride: int = 1, padding="SAME", dilation: int = 1) -> None:
        conv = Conv(cin, cout, k, stride=stride, padding=padding,
                    dilation=dilation, bias=not use_bn)
        self.add_module(auto_name("conv", self.n), conv)
        if use_bn:
            self.add_module(auto_name("bn", self.n), BatchNorm(cout))
        self.use_bn.append(use_bn)
        self.fused.append(fuses(conv))
        self.n += 1

    def run(self, i: int, x: torch.Tensor) -> torch.Tensor:
        bn = getattr(self, auto_name("bn", i)) if self.use_bn[i] else None
        return conv_bn_relu(getattr(self, auto_name("conv", i)), bn, x,
                            self.fused[i])


def _head(conv: Conv, fm: torch.Tensor, a: int) -> torch.Tensor:
    y = conv(fm)
    b, h, w, c = y.shape
    return y.reshape(b, h * w * a, c // a)


class SSD(nn.Module):
    """SSD on VGG-16: ``forward(x)`` -> (cls [B, A, C], loc [B, A, 4])."""

    def __init__(self, num_classes: int = 21, *, use_bn: bool = True,
                 extras=SSD300_EXTRAS, anchors_per_cell=ANCHORS_PER_CELL,
                 expect_sizes=(38, 19, 10, 5, 3, 1), what: str = "SSD300"):
        super().__init__()
        self.expect_sizes = tuple(expect_sizes)
        self.what = what
        self.anchors_per_cell = tuple(anchors_per_cell)
        self.backbone = _Sites()
        cin = 3
        for item in TRUNK:
            if isinstance(item, int):
                self.backbone.add(cin, item, 3, use_bn=use_bn)
                cin = item
        self.backbone.fc6 = _Sites()
        self.backbone.fc6.add(512, 1024, 3, use_bn=use_bn, dilation=6)
        self.backbone.fc7 = _Sites()
        self.backbone.fc7.add(1024, 1024, 1, use_bn=use_bn)
        self.extras = nn.Module()
        chans = [512, 1024]
        cin = 1024
        for i, (mid, out, stride, padding) in enumerate(extras):
            st = _Sites()
            st.add(cin, mid, 1, use_bn=use_bn)
            st.add(mid, out, 3, use_bn=use_bn, stride=stride,
                   padding=padding)
            self.extras.add_module(f"stage{i + 8}", st)
            chans.append(out)
            cin = out
        self.heads = nn.Module()
        for i, (c, a) in enumerate(zip(chans, self.anchors_per_cell)):
            self.heads.add_module(f"cls{i + 1}",
                                  Conv(c, a * num_classes, 3, bias=True))
            self.heads.add_module(f"loc{i + 1}", Conv(c, a * 4, 3,
                                                      bias=True))

    def forward(self, x: torch.Tensor):
        feats, i = [], 0
        for item in TRUNK:
            if item == "M":
                x = max_pool(x, 2, 2)
            elif item == "tap":
                feats.append(x)   # conv4_3
            else:
                x = self.backbone.run(i, x)
                i += 1
        x = max_pool(x, 3, 1)   # pool5 keeps the resolution
        x = self.backbone.fc7.run(0, self.backbone.fc6.run(0, x))
        feats.append(x)
        for st in self.extras.children():
            x = st.run(1, st.run(0, x))
            feats.append(x)
        return self._heads(feats)

    def _heads(self, feats):
        sizes = tuple(f.shape[1] for f in feats)
        if sizes != self.expect_sizes:
            raise ValueError(f"feature pyramid {sizes} does not match the "
                             f"{self.what} anchor spec — expected "
                             f"{self.expect_sizes}")
        cls_out, loc_out = [], []
        for i, (fm, a) in enumerate(zip(feats, self.anchors_per_cell)):
            cls_out.append(_head(getattr(self.heads, f"cls{i + 1}"), fm, a))
            loc_out.append(_head(getattr(self.heads, f"loc{i + 1}"), fm, a))
        return torch.cat(cls_out, 1), torch.cat(loc_out, 1)


class TinyDet(SSD):
    """The CPU detector: 96 x 96 input, three levels (12, 6, 3), 4 anchors
    a cell, 756 anchors."""

    def __init__(self, num_classes: int = 21, *, use_bn: bool = True,
                 width: int = 32):
        nn.Module.__init__(self)
        self.expect_sizes = tuple(s[0] for s in TINYDET_SPEC)
        self.what = "TINYDET_SPEC (input must be 96x96)"
        self.anchors_per_cell = (4, 4, 4)
        w = width
        self.backbone = _Sites()
        plan = ((3, w, 2), (w, 2 * w, 2), (2 * w, 2 * w, 1),
                (2 * w, 4 * w, 2), (4 * w, 4 * w, 2), (4 * w, 4 * w, 2))
        for cin, cout, stride in plan:
            self.backbone.add(cin, cout, 3, use_bn=use_bn, stride=stride)
        self.heads = nn.Module()
        for i in range(3):
            self.heads.add_module(f"cls{i + 1}",
                                  Conv(4 * w, 4 * num_classes, 3, bias=True))
            self.heads.add_module(f"loc{i + 1}", Conv(4 * w, 16, 3,
                                                      bias=True))

    def forward(self, x: torch.Tensor):
        feats = []
        for i in range(6):
            x = self.backbone.run(i, x)
            if i >= 3:
                feats.append(x)
        return self._heads(feats)


def ssd300(num_classes: int = 21, **kwargs) -> SSD:
    return SSD(num_classes, **kwargs)


def ssd512(num_classes: int = 21, **kwargs) -> SSD:
    return SSD(num_classes, extras=SSD512_EXTRAS,
               anchors_per_cell=(4, 6, 6, 6, 6, 4, 4),
               expect_sizes=(64, 32, 16, 8, 4, 2, 1), what="SSD512",
               **kwargs)


def tinydet(num_classes: int = 21, **kwargs) -> TinyDet:
    return TinyDet(num_classes, **kwargs)


ssd300.input_hw, ssd300.anchor_spec = (300, 300), SSD300_SPEC
ssd512.input_hw, ssd512.anchor_spec = (512, 512), SSD512_SPEC
tinydet.input_hw, tinydet.anchor_spec = (96, 96), TINYDET_SPEC
