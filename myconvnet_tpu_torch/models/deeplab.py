"""DeepLabv3+ semantic segmentation, NHWC (BASELINE config #4).

Port of ``myconvnet_tpu/models/deeplab.py``: a dilated ResNet backbone
(``models/resnet.ResNetBackbone``) or, with ``backbone="xception"``, the
aligned Xception-65 (``models/xception.XceptionBackbone``, its entry1
map at stride 4 with 128 channels the low-level tap) at
``output_stride`` 16 or 8, ASPP
(``:33-53``: a 1x1 branch, three atrous 3x3 branches at rates (6, 12, 18),
or (12, 24, 36) at any other stride, and the image-level pooling branch),
dropout 0.1, and the decoder (``:56-98``): the low-level features of
stage 1 projected to 48 channels, the ASPP map resized to their size and
concatenated, two 3x3 refinements and the 1x1 ``logits`` (with bias), then
the resize back to the input's size.  Module paths are the JAX scopes:
``backbone.stem.conv``, ``aspp_1x1``, ``aspp_rate{r}``, ``aspp_pool``,
``aspp_project`` (each a ``conv`` and a ``bn``) and
``decoder.{low_level_project,refine1,refine2,logits}``.

Rounding follows JAX: the pooling branch's mean is float32, cast to the
compute dtype; both bilinear resizes run in float32 and return the
input's dtype (``ops/resize.resize_bilinear``), so under bf16 the logits
are rounded after the resize to the input's size and only then widened
to float32.

Eval routing (``models/blocks.py``, ``models/resnet.py``), bf16 at
``output_stride`` 16: the 11 undilated stride-1 bottlenecks of stages 1-3
go through ``conv1x1_conv3x3_bn_relu``; ``decoder.refine1`` (304 input
channels) and ``refine2`` through ``conv3x3_bn_relu``; the 18 other conv
-> BN -> ReLU sites (the stem, the stride-2 and dilated convs, the ASPP
branches and projection, ``low_level_project``) through cuDNN +
``fused_scale_shift_act``.  The dilated 3x3s take neither fused kernel
(neither takes a dilation).  On the Xception backbone the backbone's
sites are its own (``models/xception.py``).

The dropout site is ``dropout``: :meth:`DeepLabV3Plus.sample_masks` draws
its keep mask [N, h, w, aspp_features] for the model's ``input_hw``
(the ASPP map is ceil(H / output_stride) on a side under SAME padding) and
``forward(x, masks)`` uses it, so a test can hand over JAX's draw.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import ConvBNReLU
from myconvnet_tpu_torch.models.resnet import ResNetBackbone
from myconvnet_tpu_torch.models.xception import XceptionBackbone
from myconvnet_tpu_torch.nn import Conv, dropout, keep_mask
from myconvnet_tpu_torch.ops.resize import resize_bilinear

DROPOUT_RATE = 0.1


class DeepLabV3Plus(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> float32 logits [N, H, W, num_classes]."""

    def __init__(self, num_classes: int = 21, *, backbone: str = "resnet",
                 backbone_depth: int = 50, output_stride: int = 16,
                 aspp_features: int = 256, decoder_low_features: int = 48,
                 input_hw: tuple[int, int] = (513, 513)):
        super().__init__()
        self.input_hw = tuple(input_hw)
        self.output_stride = output_stride
        self.aspp_features = aspp_features
        self.rates = (6, 12, 18) if output_stride == 16 else (12, 24, 36)
        if backbone == "resnet":
            self.backbone = ResNetBackbone(backbone_depth,
                                           output_stride=output_stride)
            low_cin = self.backbone.stage_channels[0]
        elif backbone == "xception":
            self.backbone = XceptionBackbone(output_stride=output_stride)
            low_cin = self.backbone.low_level_channels
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        cin = self.backbone.out_channels
        self.aspp_1x1 = ConvBNReLU(cin, aspp_features, 1)
        for r in self.rates:
            self.add_module(f"aspp_rate{r}",
                            ConvBNReLU(cin, aspp_features, 3, dilation=r))
        self.aspp_pool = ConvBNReLU(cin, aspp_features, 1)
        self.aspp_project = ConvBNReLU(5 * aspp_features, aspp_features, 1)
        self.decoder = nn.Module()
        self.decoder.low_level_project = ConvBNReLU(
            low_cin, decoder_low_features, 1)
        self.decoder.refine1 = ConvBNReLU(
            aspp_features + decoder_low_features, aspp_features, 3)
        self.decoder.refine2 = ConvBNReLU(aspp_features, aspp_features, 3)
        self.decoder.logits = Conv(aspp_features, num_classes, 1, bias=True)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """The keep mask of the ASPP dropout of a train-mode forward of a
        batch of ``n`` at ``input_hw``, on the generator's device."""
        # SAME padding: each stride 2 halves a side, rounding up
        h, w = (-(-v // self.output_stride) for v in self.input_hw)
        shape = (n, h, w, self.aspp_features)
        return {"dropout": keep_mask(shape, DROPOUT_RATE, generator)}

    def aspp(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        branches = [self.aspp_1x1(x)]
        branches += [getattr(self, f"aspp_rate{r}")(x) for r in self.rates]
        pooled = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        pooled = self.aspp_pool(pooled)
        branches.append(pooled.expand(n, h, w, pooled.shape[-1]))
        return self.aspp_project(torch.cat(branches, dim=-1))

    def forward(self, x: torch.Tensor, masks=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        in_hw = tuple(x.shape[1:3])
        feats, low = self.backbone(x, return_low_level=True)
        y = dropout(self.aspp(feats), DROPOUT_RATE, train=self.training,
                    generator=generator, mask=(masks or {}).get("dropout"))
        dec = self.decoder
        low = dec.low_level_project(low)
        y = resize_bilinear(y, tuple(low.shape[1:3])).to(low.dtype)
        y = dec.refine2(dec.refine1(torch.cat([y, low], dim=-1)))
        logits = resize_bilinear(dec.logits(y), in_hw)
        return logits.float()


def deeplab_v3_plus(num_classes: int = 21, **kwargs) -> DeepLabV3Plus:
    return DeepLabV3Plus(num_classes, **kwargs)
