"""PSPNet and FCN semantic segmentation on the dilated ResNet backbone,
NHWC.

Port of ``myconvnet_tpu/models/pspnet.py`` and ``models/fcn.py``.  Both
run ``models/resnet.ResNetBackbone`` (scope ``backbone``) at
``output_stride`` (PSPNet 8, FCN 16 by default) and end in a 1x1 conv
with bias, a bilinear resize to the input's size in float32
(``ops/resize``, the input's dtype) and a widening to float32.

* PSPNet: the pyramid pooling module ``ppm`` (``pspnet.py:29-45``): for
  each bin count b of (1, 2, 3, 6) the adaptive average pool to b x b
  (``ops/pool.adaptive_avg_pool2d``), the 1x1 ``ppm/bin{b}/project``
  conv -> BN -> ReLU to C / 4 channels and a bilinear resize back; the
  concat with the features; the 3x3 ``head`` conv -> BN -> ReLU (4096 ->
  512 on ResNet-50), dropout 0.1 and the root ``logits``.
* FCN: ``head/conv`` (3x3, no bias) -> ``head/bn`` -> ReLU, dropout 0.1,
  ``head/logits``.

Every BN is momentum 0.9, eps 1e-5 (``nn.conv_bn_relu``'s).  Eval
routing, bf16: the backbone's undilated stride-1 bottlenecks go through
``conv1x1_conv3x3_bn_relu`` (B5), the 3x3 heads through
``conv3x3_bn_relu`` (B4), every other conv -> BN -> ReLU (the stem, the
stride-2 and dilated convs, the pyramid's projections) through cuDNN +
``fused_scale_shift_act`` (B1).

The dropout site is ``dropout``: a keep mask of the head's map [N, h, w,
head_features] at the model's ``input_hw`` (h = ceil(H / output_stride)
under SAME padding), drawn by ``sample_masks`` as DeepLab's is.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import ConvBNReLU, conv_bn_relu, \
    draw_masks, fuses
from myconvnet_tpu_torch.models.resnet import ResNetBackbone
from myconvnet_tpu_torch.nn import BatchNorm, Conv, adaptive_avg_pool, \
    dropout
from myconvnet_tpu_torch.ops.resize import resize_bilinear

BINS = (1, 2, 3, 6)


class _Segmenter(nn.Module):
    """The backbone, the dropout site and the masks both models share."""

    def __init__(self, backbone_depth: int, output_stride: int,
                 head_features: int, dropout_rate: float,
                 input_hw: tuple[int, int]):
        super().__init__()
        self.input_hw = tuple(input_hw)
        self.output_stride = output_stride
        self.head_features = head_features
        self.dropout_rate = dropout_rate
        self.backbone = ResNetBackbone(backbone_depth,
                                       output_stride=output_stride)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """The keep mask of the head's dropout for a batch of ``n`` at
        ``input_hw``, on the generator's device."""
        h, w = (-(-v // self.output_stride) for v in self.input_hw)
        return draw_masks({"dropout": ((n, h, w, self.head_features),
                                       self.dropout_rate)}, generator)

    def _drop(self, y, masks, generator):
        return dropout(y, self.dropout_rate, train=self.training,
                       generator=generator,
                       mask=(masks or {}).get("dropout"))


class PSPNet(_Segmenter):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> float32 logits [N, H, W, num_classes]."""

    def __init__(self, num_classes: int = 21, *, backbone_depth: int = 50,
                 output_stride: int = 8, head_features: int = 512,
                 dropout_rate: float = 0.1,
                 input_hw: tuple[int, int] = (473, 473)):
        super().__init__(backbone_depth, output_stride, head_features,
                         dropout_rate, input_hw)
        c = self.backbone.out_channels
        branch = max(c // len(BINS), 1)
        self.ppm = nn.Module()
        for b in BINS:
            level = nn.Module()
            level.project = ConvBNReLU(c, branch, 1)
            self.ppm.add_module(f"bin{b}", level)
        self.head = ConvBNReLU(c + len(BINS) * branch, head_features, 3)
        self.logits = Conv(head_features, num_classes, 1, bias=True)

    def pyramid(self, x: torch.Tensor) -> torch.Tensor:
        hw = tuple(x.shape[1:3])
        outs = [x]
        for b in BINS:
            p = adaptive_avg_pool(x, b)
            p = getattr(self.ppm, f"bin{b}").project(p)
            outs.append(resize_bilinear(p, hw).to(x.dtype))
        return torch.cat(outs, dim=-1)

    def forward(self, x: torch.Tensor, masks=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        in_hw = tuple(x.shape[1:3])
        y = self.head(self.pyramid(self.backbone(x)))
        y = self._drop(y, masks, generator)
        return resize_bilinear(self.logits(y), in_hw).float()


class FCNHead(nn.Module):
    def __init__(self, cin: int, features: int, num_classes: int):
        super().__init__()
        self.conv = Conv(cin, features, 3)
        self.bn = BatchNorm(features, eps=1e-5, momentum=0.9)
        self.logits = Conv(features, num_classes, 1, bias=True)
        self.fused = fuses(self.conv)


class FCN(_Segmenter):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> float32 logits [N, H, W, num_classes]."""

    def __init__(self, num_classes: int = 21, *, backbone_depth: int = 50,
                 output_stride: int = 16, head_features: int = 512,
                 dropout_rate: float = 0.1,
                 input_hw: tuple[int, int] = (513, 513)):
        super().__init__(backbone_depth, output_stride, head_features,
                         dropout_rate, input_hw)
        self.head = FCNHead(self.backbone.out_channels, head_features,
                            num_classes)

    def forward(self, x: torch.Tensor, masks=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        in_hw = tuple(x.shape[1:3])
        head = self.head
        y = conv_bn_relu(head.conv, head.bn, self.backbone(x), head.fused)
        y = self._drop(y, masks, generator)
        return resize_bilinear(head.logits(y), in_hw).float()


def pspnet(num_classes: int = 21, **kwargs) -> PSPNet:
    return PSPNet(num_classes, **kwargs)


def fcn(num_classes: int = 21, **kwargs) -> FCN:
    return FCN(num_classes, **kwargs)
