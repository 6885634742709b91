"""RetinaNet and tinyretina: ResNet + FPN + weight-tied focal heads, NHWC.

Port of ``myconvnet_tpu/models/retinanet.py``.  A ResNet backbone
(``backbone/stem/conv`` ...) tapped at C3-C5, the feature pyramid
(``_fpn``, ``:39``: lateral 1x1 convs, nearest 2x top-down adds, 3x3
smoothing, P6 a 3x3 stride-2 conv on C5 and P7 one on relu(P6); every
conv with a bias) and two heads of ``head_depth`` relu(3x3 conv + bias)
layers and an ``out`` conv (``_shared_head``, ``:56``).  A head's weights
are shared by the five levels (JAX's ``nn.scope_shared``): here one module
a head, ``cls_head`` and ``box_head``, applied to every level, so its
scope appears once in ``weights.from_jax``'s tree.  The classification
head emits foreground logits only (num_classes - 1), its ``out`` drawn
from N(0, 0.01) with the bias at the prior -log((1 - 0.01) / 0.01).
Outputs: (cls [B, A, C - 1], loc [B, A, 4]) cell-major, octave-major and
ratio-minor within a cell, as ``ops.boxes.retina_anchors`` lays them out.

Eval mode: the backbone routes as the ResNet-50 eval forward (B5 at the 13
stride-1 bottlenecks, B1 at the stem and the other conv -> BN -> ReLU
sites: 7), and each head layer's relu(conv3x3 + bias) is
``conv3x3_bn_relu`` (B4) with scale 1 and the conv's bias as its
epilogue under bf16: 4 layers x 2 heads x 5 levels = 40 launches a
forward, on maps from 64² down to 4² at a 512 input.  The FPN convs and
the heads' ``out`` convs take no kernel.
"""

from __future__ import annotations

from math import log

import torch
from torch import nn

from myconvnet_tpu_torch.core.init import normal
from myconvnet_tpu_torch.models.blocks import conv_bn_relu, fuses
from myconvnet_tpu_torch.models.resnet import ResNetBackbone
from myconvnet_tpu_torch.nn import Conv, relu
from myconvnet_tpu_torch.ops.boxes import RETINA512_SPEC
from myconvnet_tpu_torch.ops.resize import upsample2x_nearest

ANCHORS_PER_CELL = 9   # 3 octaves x 3 ratios
PRIOR_BIAS = -log((1.0 - 0.01) / 0.01)
TINYRETINA_SPEC = tuple(
    (fm, base, (0.0, 0.5), (0.5, 1.0, 2.0))
    for fm, base in ((16, 0.15), (8, 0.35), (4, 0.7)))
TINY_APC = 6   # 2 octaves x 3 ratios


class FPN(nn.Module):
    """[C3, C4, C5] -> [P3, P4, P5] (+ P6, P7 with ``levels`` 5)."""

    def __init__(self, c3: int, c4: int, c5: int, ch: int,
                 levels: int = 5):
        super().__init__()
        self.levels = levels
        self.lat5 = Conv(c5, ch, 1, bias=True)
        self.lat4 = Conv(c4, ch, 1, bias=True)
        self.lat3 = Conv(c3, ch, 1, bias=True)
        self.smooth3 = Conv(ch, ch, 3, bias=True)
        self.smooth4 = Conv(ch, ch, 3, bias=True)
        self.smooth5 = Conv(ch, ch, 3, bias=True)
        if levels == 5:
            self.p6 = Conv(c5, ch, 3, stride=2, bias=True)
            self.p7 = Conv(ch, ch, 3, stride=2, bias=True)

    def forward(self, c3, c4, c5):
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + upsample2x_nearest(p5)
        p3 = self.lat3(c3) + upsample2x_nearest(p4)
        out = [self.smooth3(p3), self.smooth4(p4), self.smooth5(p5)]
        if self.levels == 5:
            p6 = self.p6(c5)
            out += [p6, self.p7(relu(p6))]
        return out


class SharedHead(nn.Module):
    """``depth`` relu(3x3 conv + bias) layers and the ``out`` conv, one
    set of weights for every level -> [B, H * W * a, k]."""

    def __init__(self, ch: int, out_per_anchor: int, depth: int,
                 anchors_per_cell: int, final_bias: float = 0.0):
        super().__init__()
        self.depth = depth
        self.a = anchors_per_cell
        self.final_bias = final_bias
        for i in range(depth):
            self.add_module(f"conv{i + 1}", Conv(ch, ch, 3, bias=True))
        self.out = Conv(ch, anchors_per_cell * out_per_anchor, 3, bias=True,
                        w_init=normal(0.01))
        self.fused = [fuses(getattr(self, f"conv{i + 1}"))
                      for i in range(depth)]

    @torch.no_grad()
    def init_own_params(self, generator: torch.Generator) -> None:
        """The ``out`` bias's constant init (``core.init.init_model``
        zeroes biases first)."""
        self.out.bias.fill_(self.final_bias)

    def forward(self, fm: torch.Tensor) -> torch.Tensor:
        y = fm
        for i in range(self.depth):
            y = conv_bn_relu(getattr(self, f"conv{i + 1}"), None, y,
                             self.fused[i])
        y = self.out(y)
        b, h, w, c = y.shape
        return y.reshape(b, h * w * self.a, c // self.a)


class _Detector(nn.Module):
    def _pyramid(self, feats, spec, what):
        sizes = tuple(f.shape[1] for f in feats)
        want = tuple(s[0] for s in spec)
        if sizes != want:
            raise ValueError(f"feature pyramid {sizes} != anchor spec "
                             f"{want} — {what}")
        return (torch.cat([self.cls_head(f) for f in feats], 1),
                torch.cat([self.box_head(f) for f in feats], 1))


class RetinaNet(_Detector):
    """``forward(x)``: x [B, 512, 512, 3] -> (cls [B, 49104, C - 1], loc
    [B, 49104, 4])."""

    def __init__(self, num_classes: int = 21, *, depth: int = 50,
                 fpn_channels: int = 256, head_depth: int = 4,
                 stem: str = "conv7"):
        super().__init__()
        self.backbone = ResNetBackbone(depth, stem=stem)
        _, c3, c4, c5 = self.backbone.stage_channels
        self.fpn = FPN(c3, c4, c5, fpn_channels)
        self.cls_head = SharedHead(fpn_channels, num_classes - 1,
                                   head_depth, ANCHORS_PER_CELL, PRIOR_BIAS)
        self.box_head = SharedHead(fpn_channels, 4, head_depth,
                                   ANCHORS_PER_CELL)

    def forward(self, x: torch.Tensor):
        _, c3, c4, c5 = self.backbone.stages(x)
        return self._pyramid(self.fpn(c3, c4, c5), RETINA512_SPEC,
                             "input must be 512x512")


def tiny_trunk(width: int) -> tuple[nn.Module, FPN]:
    """The CPU detectors' trunk (``faster_rcnn._tiny_trunk``): ``backbone``
    of five 3x3 stride-2 relu(conv + bias) layers ``c1``-``c5`` and a
    3-level ``fpn`` over c3-c5, 2 * ``width`` channels."""
    w = width
    backbone = nn.Module()
    for i, (cin, cout) in enumerate(((3, w), (w, w), (w, 2 * w),
                                     (2 * w, 2 * w), (2 * w, 4 * w))):
        backbone.add_module(f"c{i + 1}", Conv(cin, cout, 3, stride=2,
                                              bias=True))
    return backbone, FPN(2 * w, 2 * w, 4 * w, 2 * w, levels=3)


def tiny_pyramid(backbone: nn.Module, fpn: FPN, x: torch.Tensor):
    """[P3, P4, P5] of :func:`tiny_trunk` (each layer B1 in eval mode)."""
    feats = []
    for i in range(5):
        x = conv_bn_relu(getattr(backbone, f"c{i + 1}"), None, x)
        feats.append(x)
    return fpn(*feats[2:])


class TinyRetina(_Detector):
    """The CPU detector: 128 x 128 input, levels 16, 8, 4, 2016 anchors."""

    def __init__(self, num_classes: int = 21, *, width: int = 32):
        super().__init__()
        self.backbone, self.fpn = tiny_trunk(width)
        self.cls_head = SharedHead(2 * width, num_classes - 1, 1, TINY_APC,
                                   PRIOR_BIAS)
        self.box_head = SharedHead(2 * width, 4, 1, TINY_APC)

    def forward(self, x: torch.Tensor):
        return self._pyramid(tiny_pyramid(self.backbone, self.fpn, x),
                             TINYRETINA_SPEC, "input must be 128x128")


def retinanet(num_classes: int = 21, **kwargs) -> RetinaNet:
    return RetinaNet(num_classes, **kwargs)


def tinyretina(num_classes: int = 21, **kwargs) -> TinyRetina:
    return TinyRetina(num_classes, **kwargs)


for _fn, _hw, _spec in ((retinanet, (512, 512), RETINA512_SPEC),
                        (tinyretina, (128, 128), TINYRETINA_SPEC)):
    _fn.input_hw, _fn.anchor_spec = _hw, _spec
    _fn.anchor_kind, _fn.head = "retina", "sigmoid_focal"
