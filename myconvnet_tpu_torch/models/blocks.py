"""Conv -> BN -> ReLU and BN -> ReLU with the eval-mode kernel routing of
ResNet, SmallNet, VGG and DenseNet.

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
  convs, the stride-2 convs, and every conv under the float32 policy) is a
  cuDNN conv without bias, then ``fused_scale_shift_act`` (B1) with the
  bias and BN folded into (a, b);
* a pre-activation BN -> ReLU (DenseNet's, on the concatenation) is B1
  with the BN's (scale, shift).

A site the kernels do not take goes to cuDNN + B1 by this routing, not by
a fallback: a kernel launch that fails raises.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch.nn import BatchNorm, Conv, conv_epilogue, relu
from myconvnet_tpu_torch.ops.kernels import conv3x3_bn_relu, \
    fused_scale_shift_act
from myconvnet_tpu_torch.ops.kernels import conv_fused as conv_fused_lib


def fuses(conv: Conv) -> bool:
    """Whether ``conv``'s eval forward goes through ``conv3x3_bn_relu``
    on bf16 activations: a 3x3 stride-1 undilated SAME conv (TF's SAME and
    torch's pad of 1 agree at stride 1) with input channels the kernel
    takes."""
    cout, cin, kh, kw = conv.weight.shape
    return ((kh, kw) == (3, 3) and conv.stride == 1 and conv.dilation == 1
            and conv.padding in ("SAME", ((1, 1), (1, 1)))
            and conv_fused_lib.supports(cin))


def conv_bn_relu(conv: Conv, bn: BatchNorm | None, x: torch.Tensor,
                 fused: bool = False) -> torch.Tensor:
    """relu(bn(conv(x))), or relu(conv(x)) without a BN.  ``fused``: the
    conv is one :func:`fuses` takes (decided when the model is built)."""
    if conv.training:
        y = conv(x)
        return relu(bn(y) if bn is not None else y)
    a, b = conv_epilogue(conv, bn)
    if fused and x.dtype == torch.bfloat16:
        return conv3x3_bn_relu(x.contiguous(), conv.w.to(x.dtype), a, b)
    return fused_scale_shift_act(conv(x, add_bias=False).contiguous(), a, b,
                                 "relu")


def bn_relu(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """relu(bn(x)): plain in train mode, one pass of B1 in eval mode."""
    if bn.training:
        return relu(bn(x))
    a, b = bn.scale_shift()
    return fused_scale_shift_act(x.contiguous(), a, b, "relu")
