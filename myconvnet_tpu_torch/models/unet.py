"""U-Net semantic segmentation, NHWC.

Port of ``myconvnet_tpu/models/unet.py``: ``depth`` levels of a double
conv (3x3 SAME conv without bias -> BN (momentum 0.9, eps 1e-5) -> ReLU,
twice) and a 2x2 max pool, widths doubling from ``base_features``; a
``bottleneck`` double conv; then, level by level back up, a bilinear
resize to the skip's size (``align_corners=False``, ``ops/resize``, in the
skip's dtype), the 1x1 ``up{level}/reduce`` conv without bias, the concat
with the skip and the ``up{level}_refine`` double conv; the 1x1 ``logits``
conv with bias, widened to float32.  Scopes as in JAX:
``down{level}/{conv1,bn1,conv2,bn2}``, ``bottleneck/...``,
``up{level}/reduce``, ``up{level}_refine/...``, ``logits``.

Eval routing (``models/blocks.py``): every double conv's conv -> BN ->
ReLU is ``conv3x3_bn_relu`` (B4) on bf16 activations where its input
channels take it, the C = 3 first conv a cuDNN conv + B1; at depth 4 a
forward is 17 launches of B4 and 1 of B1.  No dropout, so no masks.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, fuses
from myconvnet_tpu_torch.nn import BatchNorm, Conv, max_pool
from myconvnet_tpu_torch.ops.resize import resize_bilinear


class DoubleConv(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        for i, c in ((1, cin), (2, features)):
            self.add_module(f"conv{i}", Conv(c, features, 3))
            self.add_module(f"bn{i}", BatchNorm(features, eps=1e-5,
                                                momentum=0.9))
        self.fused = (fuses(self.conv1), fuses(self.conv2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn_relu(self.conv1, self.bn1, x, self.fused[0])
        return conv_bn_relu(self.conv2, self.bn2, x, self.fused[1])


class UNet(nn.Module):
    """``forward(x)``: x [N, H, W, C] in the compute dtype, H and W
    divisible by 2**depth -> float32 logits [N, H, W, num_classes]."""

    def __init__(self, num_classes: int = 21, *, base_features: int = 64,
                 depth: int = 4, in_channels: int = 3):
        super().__init__()
        self.depth = depth
        cin, feats = in_channels, base_features
        for level in range(depth):
            self.add_module(f"down{level}", DoubleConv(cin, feats))
            cin, feats = feats, feats * 2
        self.bottleneck = DoubleConv(cin, feats)
        for level in reversed(range(depth)):
            skip = feats // 2
            up = nn.Module()
            up.reduce = Conv(feats, skip, 1)
            self.add_module(f"up{level}", up)
            self.add_module(f"up{level}_refine", DoubleConv(2 * skip, skip))
            feats = skip
        self.logits = Conv(feats, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        step = 1 << self.depth
        if x.shape[1] % step or x.shape[2] % step:
            raise ValueError(f"input {x.shape[1]}x{x.shape[2]} not "
                             f"divisible by {step}")
        skips = []
        for level in range(self.depth):
            x = getattr(self, f"down{level}")(x)
            skips.append(x)
            x = max_pool(x, 2, 2)
        x = self.bottleneck(x)
        for level in reversed(range(self.depth)):
            skip = skips[level]
            x = resize_bilinear(x, tuple(skip.shape[1:3])).to(skip.dtype)
            x = getattr(self, f"up{level}").reduce(x)
            x = getattr(self, f"up{level}_refine")(
                torch.cat([x, skip], dim=-1))
        return self.logits(x).float()


def unet(num_classes: int = 21, **kwargs) -> UNet:
    return UNet(num_classes, **kwargs)
