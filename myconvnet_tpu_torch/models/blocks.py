"""Conv -> BN -> ReLU and BN -> ReLU with the eval-mode kernel routing of
the classifiers (ResNet, SmallNet, VGG, DenseNet and the grouped and
depthwise families).

In train mode (``module.training``) both are plain PyTorch in the JAX
order: conv in the compute dtype (+ bias) -> BN (float32 statistics,
output in the compute dtype) -> ReLU.  In eval mode the routing is static,
by the layer's shape and the activations' dtype:

* a 3x3 stride-1 SAME conv whose input channels ``conv3x3_bn_relu`` takes
  (C % 8 == 0), on bf16 activations, runs conv -> BN -> ReLU as that one
  kernel (B4), the BN's scale and shift (or the conv's bias where there is
  no BN) as its epilogue, where the model asks for it (ResNet asks only
  for a basic block's conv_a; its bottlenecks go through
  ``conv1x1_conv3x3_bn_relu`` in ``models/resnet.py``);
* every other conv -> BN -> ReLU (the C = 3 first convs, the 7x7 and 1x1
  convs, the stride-2 convs, the grouped and depthwise convs, and every
  conv under the float32 policy) is a cuDNN conv without bias, then
  ``fused_scale_shift_act`` (B1) with the bias and BN folded into (a, b);
  :func:`conv_bn_act` takes ReLU6 there too (MobileNetV2's sites), which
  B1 has;
* a pre-activation BN -> ReLU (DenseNet's, on the concatenation) is B1
  with the BN's (scale, shift); :func:`bn_act` takes the activation by
  name (the GAN generators' BN -> ReLU and BN -> leaky ReLU(0.2)).

A site the kernels do not take goes to cuDNN + B1 by this routing, not by
a fallback: a kernel launch that fails raises.

:class:`ConvBNReLU` is ``nn.conv_bn_relu`` (``myconvnet_tpu/nn.py:408-419``),
the segmentation heads' block: children ``conv`` (no bias) and ``bn``
(momentum 0.9, eps 1e-5), so the scopes read ``<name>/conv`` and
``<name>/bn``, and the forward is :func:`conv_bn_relu` with the routing
decided when it is built.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.nn import BatchNorm, Conv, conv_epilogue, \
    keep_mask, leaky_relu, relu, relu6
from myconvnet_tpu_torch.ops.kernels import conv3x3_bn_relu, \
    fused_scale_shift_act
from myconvnet_tpu_torch.ops.kernels import conv_fused as conv_fused_lib


def fuses(conv: Conv) -> bool:
    """Whether ``conv``'s eval forward goes through ``conv3x3_bn_relu``
    on bf16 activations: a 3x3 stride-1 undilated ungrouped SAME conv
    (TF's SAME and torch's pad of 1 agree at stride 1) with input channels
    the kernel takes."""
    cout, cin, kh, kw = conv.weight.shape
    return ((kh, kw) == (3, 3) and conv.stride == 1 and conv.dilation == 1
            and conv.groups == 1
            and conv.padding in ("SAME", ((1, 1), (1, 1)))
            and conv_fused_lib.supports(cin))


ACTS = {"relu": relu, "relu6": relu6,
        "leaky_relu": leaky_relu}   # leaky: slope 0.2


def conv_bn_act(conv: Conv, bn: BatchNorm | None, x: torch.Tensor,
                act: str = "relu", fused: bool = False) -> torch.Tensor:
    """act(bn(conv(x))), or act(conv(x)) without a BN, ``act`` one of
    :data:`ACTS`.  ``fused``: the conv is one :func:`fuses` takes
    (decided when the model is built) and ``act`` is "relu"."""
    if conv.training:
        y = conv(x)
        return ACTS[act](bn(y) if bn is not None else y)
    a, b = conv_epilogue(conv, bn)
    if fused and act == "relu" and x.dtype == torch.bfloat16:
        return conv3x3_bn_relu(x.contiguous(), conv.w.to(x.dtype), a, b)
    return fused_scale_shift_act(conv(x, add_bias=False).contiguous(), a, b,
                                 act)


def conv_bn_relu(conv: Conv, bn: BatchNorm | None, x: torch.Tensor,
                 fused: bool = False) -> torch.Tensor:
    """relu(bn(conv(x))) by :func:`conv_bn_act`."""
    return conv_bn_act(conv, bn, x, "relu", fused)


def bn_act(bn: BatchNorm, x: torch.Tensor, act: str = "relu"
           ) -> torch.Tensor:
    """act(bn(x)), ``act`` one of :data:`ACTS`: plain in train mode, one
    pass of B1 in eval mode."""
    if bn.training:
        return ACTS[act](bn(x))
    a, b = bn.scale_shift()
    return fused_scale_shift_act(x.contiguous(), a, b, act)


def bn_relu(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """relu(bn(x)): plain in train mode, one pass of B1 in eval mode."""
    return bn_act(bn, x, "relu")


class ConvBN(nn.Module):
    """Scopes ``conv`` (no bias) and ``bn``: the stems and heads of the
    mobile and RegNet families; ``bn(c)`` makes the family's BN."""

    def __init__(self, cin: int, cout: int, kernel_size: int, bn, *,
                 stride: int = 1):
        super().__init__()
        self.conv = Conv(cin, cout, kernel_size, stride=stride)
        self.bn = bn(cout)


class ConvBNReLU(nn.Module):
    """relu(bn(conv(x))): a stride-1 ``kernel_size`` conv without bias at
    ``dilation`` (SAME padding), then BN and ReLU."""

    def __init__(self, cin: int, features: int, kernel_size: int, *,
                 dilation: int = 1):
        super().__init__()
        self.conv = Conv(cin, features, kernel_size, dilation=dilation)
        self.bn = BatchNorm(features, eps=1e-5, momentum=0.9)
        self.fused = fuses(self.conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_relu(self.conv, self.bn, x, self.fused)


def draw_masks(sites: dict, generator: torch.Generator
               ) -> dict[str, torch.Tensor]:
    """Keep masks {site: mask} of the sites ``{site: (shape, rate)}`` with
    a rate above 0, in the order given (a model's forward order), on the
    generator's device."""
    return {site: keep_mask(shape, rate, generator)
            for site, (shape, rate) in sites.items() if rate > 0.0}
