"""ResNet v1.5 (depths 18, 34, 50, 101 and 152), SE-ResNet and ResNeXt,
NHWC, train and eval forward, and its dilated backbone.

Port of ``myconvnet_tpu/models/resnet.py:61-269``.  Module paths equal the
JAX scope paths with "/" read as "." (``stem.conv``,
``stage1.block1.conv_a``, ``logits``), and both stems (``conv7``, ``s2d``)
and ``torch_padding`` carry over.  BN momentum is 0.9 and eps 1e-5
(``resnet.py:47``); each block's last BN starts with gamma 0 (``bn_b`` of a
basic block, ``bn_c`` of a bottleneck).  A projection shortcut sits only
where the shape changes, so stage 1 of ResNet-18/34 keeps identity
shortcuts (``resnet.py:199-210``).  A bottleneck's inner width is
``features * width_per_group * groups // 64`` and its 3x3 is grouped
(ResNeXt, ``resnet.py:92-118``); ``se_ratio`` adds the squeeze-excitation
gate after ``bn_c`` (:class:`SEBlock`, ``resnet.py:80-89``: gap, ``fc1``,
ReLU, ``fc2``, a sigmoid in x's dtype).  Groups and SE need bottlenecks
(depth >= 50), as JAX refuses them otherwise (``resnet.py:150-156``).

:class:`ResNetBackbone` is ``resnet_backbone`` (``resnet.py:121-233``):
the stem and the four stages without the head, at ``output_stride`` 8, 16
or 32.  Once the stride reached so far equals ``output_stride``, a stage's
stride 2 becomes stride 1 and the dilation doubles before the stage's
first block, so that block is dilated too (``resnet.py:188-194``; unlike
torchvision's ``replace_stride_with_dilation``).  A dilated 3x3 pads
(d, d) under ``torch_padding``, as ``_pad3`` does.  DeepLabv3+ takes the
last map and stage 1's (the low-level features).

In train mode (``module.training``) every layer is plain PyTorch, in the
JAX order: conv in the compute dtype -> BN (float32 statistics, output in
the compute dtype) -> ReLU.  The kernels are inference epilogues and run
only in eval mode:

* a bottleneck whose 3x3 has stride 1, no dilation and one group runs
  conv_a -> bn_a -> relu -> conv_b -> bn_b -> relu through
  ``conv1x1_conv3x3_bn_relu`` when its channel counts are ones the kernel
  takes (``Bottleneck.pair``) and the activations are bf16; in ResNet-50
  (and SE-ResNet-50) that is 13 of the 16 blocks, 30 of ResNet-101's 33,
  47 of ResNet-152's 50, in the ResNet-50 backbone at ``output_stride``
  16 the 11 undilated ones of stages 1-3 (the pair kernel pads its 3x3 by
  1 and takes no dilation); a ResNeXt's grouped conv_b and its conv_a
  take the last route;
* a basic block whose conv_a has stride 1 and no dilation runs conv_a ->
  bn_a -> relu through ``conv3x3_bn_relu`` (bf16); in ResNet-18 that is 5
  of the 8 blocks (stage1.block1-2, stage2-4.block2);
* every other conv -> BN -> ReLU (the stem; the remaining conv_a and the
  stride-2 or dilated conv_b of a bottleneck) is a cuDNN conv without
  bias followed by ``fused_scale_shift_act`` with the bias and BN folded
  into (a, b).

The last two are ``models/blocks.conv_bn_relu``, the routing the other
classifiers share.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, fuses
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, conv_epilogue,
                                    gap, relu, sigmoid)
from myconvnet_tpu_torch.ops.kernels import conv1x1_conv3x3_bn_relu
from myconvnet_tpu_torch.ops.kernels import conv_pair as conv_pair_lib
from myconvnet_tpu_torch.ops.pool import max_pool2d

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def _bn(c: int, zero_init: bool = False) -> BatchNorm:
    return BatchNorm(c, BN_EPS, BN_MOMENTUM, zero_init=zero_init)


def _pad3(dilation: int, torch_padding: bool):
    # torch pads a 3x3 by its dilation on both sides at any stride; TF-SAME
    # differs only at stride 2 (``resnet.py:52-58``)
    d = dilation
    return ((d, d), (d, d)) if torch_padding else "SAME"


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, *, stride: int,
                 projection: bool, torch_padding: bool = False,
                 dilation: int = 1):
        super().__init__()
        pad = _pad3(dilation, torch_padding)
        self.conv_a = Conv(cin, features, 3, stride=stride, padding=pad,
                           dilation=dilation)
        self.bn_a = _bn(features)
        self.conv_b = Conv(features, features, 3, padding=pad,
                           dilation=dilation)
        self.bn_b = _bn(features, zero_init=True)
        if projection:
            self.conv_proj = Conv(cin, features, 1, stride=stride)
            self.bn_proj = _bn(features)
        self.projection = projection
        # static routing: a stride-1 undilated conv_a (SAME and torch
        # padding agree there) goes through the fused conv3x3 kernel in
        # eval mode
        self.fused = fuses(self.conv_a)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn_relu(self.conv_a, self.bn_a, x, self.fused)
        y = self.bn_b(self.conv_b(y))
        shortcut = x
        if self.projection:
            shortcut = self.bn_proj(self.conv_proj(x))
        return relu(y + shortcut)


class SEBlock(nn.Module):
    """``se_block``: x * sigmoid(fc2(relu(fc1(gap(x))))), the gate cast to
    x's dtype before the sigmoid."""

    def __init__(self, c: int, ratio: int = 16):
        super().__init__()
        self.fc1 = Dense(c, max(c // ratio, 1))
        self.fc2 = Dense(max(c // ratio, 1), c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = relu(self.fc1(gap(x)))
        s = sigmoid(self.fc2(s).to(x.dtype))
        return x * s[:, None, None, :]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, *, stride: int,
                 projection: bool, torch_padding: bool = False,
                 dilation: int = 1, groups: int = 1,
                 width_per_group: int = 64, se_ratio: int = 0):
        super().__init__()
        out = 4 * features
        inner = features * width_per_group * groups // 64
        self.conv_a = Conv(cin, inner, 1)
        self.bn_a = _bn(inner)
        self.conv_b = Conv(inner, inner, 3, stride=stride,
                           padding=_pad3(dilation, torch_padding),
                           dilation=dilation, groups=groups)
        self.bn_b = _bn(inner)
        self.conv_c = Conv(inner, out, 1)
        self.bn_c = _bn(out, zero_init=True)
        if se_ratio:
            self.se = SEBlock(out, se_ratio)
        if projection:
            self.conv_proj = Conv(cin, out, 1, stride=stride)
            self.bn_proj = _bn(out)
        self.projection = projection
        # static routing: conv_a + conv_b go through the fused pair kernel
        # when the 3x3 has stride 1, no dilation and one group (SAME and
        # torch padding agree there; the kernel pads by 1) and the kernel
        # takes these channel counts
        self.pair = (stride == 1 and dilation == 1 and groups == 1
                     and conv_pair_lib.supports(cin, inner, inner))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pair and not self.training and x.dtype == torch.bfloat16:
            a1, b1 = conv_epilogue(self.conv_a, self.bn_a)
            a3, b3 = conv_epilogue(self.conv_b, self.bn_b)
            y = conv1x1_conv3x3_bn_relu(x, self.conv_a.w.to(x.dtype), a1, b1,
                                        self.conv_b.w.to(x.dtype), a3, b3)
        else:
            y = conv_bn_relu(self.conv_a, self.bn_a, x)
            y = conv_bn_relu(self.conv_b, self.bn_b, y)
        y = self.bn_c(self.conv_c(y))
        if hasattr(self, "se"):
            y = self.se(y)
        shortcut = x
        if self.projection:
            shortcut = self.bn_proj(self.conv_proj(x))
        return relu(y + shortcut)


class Stem(nn.Module):
    def __init__(self, cin: int, width: int, kind: str,
                 torch_padding: bool):
        super().__init__()
        if kind not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {kind!r}")
        if torch_padding and kind == "s2d":
            raise ValueError("torch_padding reproduces the torchvision "
                             "conv7 stem; combine it with stem='conv7'")
        self.kind = kind
        self.torch_padding = torch_padding
        if kind == "s2d":
            # 2x2 space-to-depth, then a 4x4 stride-1 conv
            self.conv = Conv(4 * cin, width, 4)
        else:
            self.conv = Conv(cin, width, 7, stride=2,
                             padding=((3, 3), (3, 3)) if torch_padding
                             else "SAME")
        self.bn = _bn(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "s2d":
            n, h, w, c = x.shape
            x = (x.reshape(n, h // 2, 2, w // 2, 2, c)
                 .permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2,
                                                    4 * c))
        x = conv_bn_relu(self.conv, self.bn, x)
        return max_pool2d(x, 3, 2, padding=((1, 1), (1, 1))
                          if self.torch_padding else "SAME")


class ResNetBackbone(nn.Module):
    """``forward(x)``: x [N, H, W, C] in the compute dtype -> the last
    stage's map, or (it, stage 1's map) with ``return_low_level``."""

    def __init__(self, depth: int = 50, *, width: int = 64,
                 stem: str = "conv7", torch_padding: bool = False,
                 in_channels: int = 3, output_stride: int = 32,
                 groups: int = 1, width_per_group: int = 64,
                 se_ratio: int = 0):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise ValueError(f"the port has ResNet depth "
                             f"{sorted(STAGE_BLOCKS)}, not {depth}")
        if output_stride not in (8, 16, 32):
            raise ValueError("output_stride must be 8, 16 or 32")
        if depth >= 50:
            block = functools.partial(Bottleneck, groups=groups,
                                      width_per_group=width_per_group,
                                      se_ratio=se_ratio)
            expansion = Bottleneck.expansion
        else:
            if groups != 1 or width_per_group != 64:
                raise ValueError("grouped (ResNeXt) blocks need depth >= 50")
            if se_ratio:
                raise ValueError("SE variants are built on bottleneck "
                                 "blocks (depth >= 50)")
            block, expansion = BasicBlock, BasicBlock.expansion
        self.stem = Stem(in_channels, width, stem, torch_padding)
        cin, reached, dilation = width, 4, 1
        self.stage_channels = []
        for s, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            features = width * 2 ** s
            out = expansion * features
            stride = 1 if s == 0 else 2
            if reached >= output_stride and stride == 2:
                # swap the stride for dilation (resnet.py:188-194)
                dilation *= 2
                stride = 1
            stage = nn.Module()
            for b in range(n_blocks):
                blk_stride = stride if b == 0 else 1
                stage.add_module(f"block{b + 1}", block(
                    cin, features, stride=blk_stride,
                    projection=b == 0 and (blk_stride != 1 or cin != out),
                    torch_padding=torch_padding, dilation=dilation))
                cin = out
            self.add_module(f"stage{s + 1}", stage)
            self.stage_channels.append(out)
            reached *= stride
        self.n_stages = len(STAGE_BLOCKS[depth])
        self.out_channels = cin

    def stages(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The four stages' outputs."""
        x = self.stem(x)
        out = []
        for s in range(self.n_stages):
            for blk in getattr(self, f"stage{s + 1}").children():
                x = blk(x)
            out.append(x)
        return out

    def forward(self, x: torch.Tensor, return_low_level: bool = False):
        stages = self.stages(x)
        return (stages[-1], stages[0]) if return_low_level else stages[-1]


class ResNet(ResNetBackbone):
    """``forward(x)``: x [N, H, W, C] in the compute dtype -> logits
    [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, depth: int = 50, *,
                 width: int = 64, stem: str = "conv7",
                 torch_padding: bool = False, in_channels: int = 3,
                 groups: int = 1, width_per_group: int = 64,
                 se_ratio: int = 0):
        super().__init__(depth, width=width, stem=stem,
                         torch_padding=torch_padding,
                         in_channels=in_channels, groups=groups,
                         width_per_group=width_per_group, se_ratio=se_ratio)
        self.logits = Dense(self.out_channels, num_classes)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's map, before the pooling (the map the JAX
        model tags ``"features"``, ``resnet.py:227``)."""
        return self.stages(x)[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits(gap(self.features(x)))


def resnet18(num_classes: int = 1000, **kwargs) -> ResNet:
    return ResNet(num_classes, depth=18, **kwargs)


def resnet34(num_classes: int = 1000, **kwargs) -> ResNet:
    return ResNet(num_classes, depth=34, **kwargs)


def resnet50(num_classes: int = 1000, **kwargs) -> ResNet:
    return ResNet(num_classes, depth=50, **kwargs)


def _variant(name: str, **preset):
    """A named ResNet (``resnet.py:263-269``'s partials): ``preset``'s
    keywords, which the caller's override."""
    def build(num_classes: int = 1000, **kwargs) -> ResNet:
        return ResNet(num_classes, **{**preset, **kwargs})
    build.__name__ = name
    return build


resnet101 = _variant("resnet101", depth=101)
resnet152 = _variant("resnet152", depth=152)
# squeeze-excitation and aggregated (grouped) variants
se_resnet50 = _variant("se_resnet50", depth=50, se_ratio=16)
se_resnet101 = _variant("se_resnet101", depth=101, se_ratio=16)
resnext50_32x4d = _variant("resnext50_32x4d", depth=50, groups=32,
                           width_per_group=4)
resnext101_32x8d = _variant("resnext101_32x8d", depth=101, groups=32,
                            width_per_group=8)
se_resnext50_32x4d = _variant("se_resnext50_32x4d", depth=50, groups=32,
                              width_per_group=4, se_ratio=16)
