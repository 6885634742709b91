"""Monocular depth: the DispNet-style ResNet encoder-decoder and tinydepth.

Port of ``myconvnet_tpu/models/depth.py``.  :class:`DepthUNet`
(``depth_unet``, ``:59``) is a ResNet backbone's four stages (strides
4-32; its scopes at the root, ``stem/conv``, ``stage1/block1/conv_a``, as
JAX's ``resnet_backbone(..., return_stages=True)`` names them) and a
decoder of five up blocks (``_up_block``, ``:36``: conv_pre -> BN -> ReLU,
a bilinear 2x upsample, the encoder skip concatenated, conv_post -> BN ->
ReLU; the BNs at JAX's layer defaults, momentum 0.99 and eps 1e-3) with
monodepth2's widths (256, 128, 64, 32, 16) scaled by ``decoder_width /
32``, and the inverse-depth head (``_disp_head``, ``:52``): a 3x3 conv to
one channel with a bias, its sigmoid s in float32, ``disp = 1 / max_depth
+ s (1 / min_depth - 1 / max_depth)``, depth ``1 / disp`` in metres,
``[N, H, W, 1]`` float32.  :class:`TinyDepth` (``tinydepth``, ``:99``) is
the three-level plain conv encoder-decoder of the CPU runs.  Only the
batch norm is ported (``norm="group"`` is refused by name).

In eval mode every decoder conv -> BN -> ReLU is a 3x3 stride-1 SAME
conv, so it runs through ``models/blocks.conv_bn_relu`` with the routing
decided at build time: under bf16, ``conv3x3_bn_relu`` (B4) where its
input channels are a multiple of 8 (all ten at the recipe's width),
cuDNN + B1 otherwise; the encoder routes as the ResNet-18 eval forward
(B4 at the five stride-1 ``conv_a``, B1 after the stem and the three
stride-2 ``conv_a``).  TinyDepth's relu(conv + bias) sites take the same
routing.  The upsample is ``ops.resize.resize_bilinear``.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, fuses
from myconvnet_tpu_torch.models.resnet import ResNetBackbone
from myconvnet_tpu_torch.nn import BatchNorm, Conv
from myconvnet_tpu_torch.ops.resize import resize_bilinear


def disp_to_depth(logit: torch.Tensor, min_depth: float,
                  max_depth: float) -> torch.Tensor:
    """The head's conv output -> metric depth through the sigmoid
    inverse-depth parameterization, in float32."""
    s = torch.sigmoid(logit.float())
    d_min, d_max = 1.0 / max_depth, 1.0 / min_depth
    return 1.0 / (d_min + s * (d_max - d_min))


class UpBlock(nn.Module):
    """conv_pre -> BN -> ReLU, bilinear 2x, concat the skip, conv_post ->
    BN -> ReLU."""

    def __init__(self, cin: int, skip: int, features: int):
        super().__init__()
        self.conv_pre = Conv(cin, features, 3)
        self.bn_pre = BatchNorm(features)
        self.conv_post = Conv(features + skip, features, 3)
        self.bn_post = BatchNorm(features)
        self.fused = (fuses(self.conv_pre), fuses(self.conv_post))

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None
                ) -> torch.Tensor:
        _, h, w, _ = x.shape
        x = conv_bn_relu(self.conv_pre, self.bn_pre, x, self.fused[0])
        x = resize_bilinear(x, (2 * h, 2 * w))
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return conv_bn_relu(self.conv_post, self.bn_post, x, self.fused[1])


class DepthUNet(ResNetBackbone):
    """``forward(x)``: x [N, H, W, 3] in the compute dtype, H and W
    divisible by 32 -> depth [N, H, W, 1] float32 metres."""

    def __init__(self, num_classes: int = 0, *, depth: int = 18,
                 min_depth: float = 0.1, max_depth: float = 10.0,
                 decoder_width: int = 32, norm: str = "batch",
                 stem: str = "conv7"):
        if norm != "batch":
            raise ValueError(f"depth_unet norm={norm!r} is not ported (the "
                             "port's ResNet backbone has batch norm only)")
        super().__init__(depth, stem=stem)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        k = decoder_width / 32.0
        widths = [int(w * k) for w in (256, 128, 64, 32, 16)]
        c2, c3, c4, c5 = self.stage_channels
        self.decoder = nn.Module()
        cin = c5
        for i, (f, skip) in enumerate(zip(widths, (c4, c3, c2, 0, 0))):
            self.decoder.add_module(f"up{i + 1}", UpBlock(cin, skip, f))
            cin = f
        self.decoder.disp = Conv(cin, 1, 3, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(
                f"depth_unet needs input_hw divisible by 32 (the encoder's "
                f"total stride), got ({x.shape[1]}, {x.shape[2]})")
        c2, c3, c4, c5 = self.stages(x)
        d = self.decoder
        h = d.up1(c5, c4)
        h = d.up2(h, c3)
        h = d.up3(h, c2)
        h = d.up4(h, None)
        h = d.up5(h, None)
        return disp_to_depth(d.disp(h), self.min_depth, self.max_depth)


class TinyDepth(nn.Module):
    """The CPU variant: x [N, H, W, 3], H and W divisible by 8 -> depth
    [N, H, W, 1] float32."""

    def __init__(self, num_classes: int = 0, *, width: int = 8,
                 min_depth: float = 0.1, max_depth: float = 10.0):
        super().__init__()
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        w = width
        self.enc1 = Conv(3, w, 3, stride=2, bias=True)
        self.enc2 = Conv(w, 2 * w, 3, stride=2, bias=True)
        self.enc3 = Conv(2 * w, 4 * w, 3, stride=2, bias=True)
        self.mid = Conv(4 * w, 4 * w, 3, bias=True)
        self.dec1 = Conv(6 * w, 2 * w, 3, bias=True)
        self.dec2 = Conv(3 * w, w, 3, bias=True)
        self.dec3 = Conv(w, w, 3, bias=True)
        self.disp = Conv(w, 1, 3, bias=True)
        self.fused = {n: fuses(getattr(self, n))
                      for n in ("mid", "dec1", "dec2", "dec3")}

    def _relu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_relu(getattr(self, name), None, x,
                            self.fused.get(name, False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 8 or x.shape[2] % 8:
            raise ValueError(f"tinydepth needs input_hw divisible by 8, "
                             f"got ({x.shape[1]}, {x.shape[2]})")
        e1 = self._relu("enc1", x)
        e2 = self._relu("enc2", e1)
        e3 = self._relu("enc3", e2)
        h = self._relu("mid", e3)
        _, hh, ww, _ = h.shape
        h = resize_bilinear(h, (2 * hh, 2 * ww))
        h = self._relu("dec1", torch.cat([h, e2.to(h.dtype)], -1))
        h = resize_bilinear(h, (4 * hh, 4 * ww))
        h = self._relu("dec2", torch.cat([h, e1.to(h.dtype)], -1))
        h = resize_bilinear(h, (8 * hh, 8 * ww))
        h = self._relu("dec3", h)
        return disp_to_depth(self.disp(h), self.min_depth, self.max_depth)


def depth_unet(num_classes: int = 0, **kwargs) -> DepthUNet:
    return DepthUNet(num_classes, **kwargs)


def tinydepth(num_classes: int = 0, **kwargs) -> TinyDepth:
    return TinyDepth(num_classes, **kwargs)


DEPTH_MODELS = {"depth_unet": depth_unet, "tinydepth": tinydepth}
