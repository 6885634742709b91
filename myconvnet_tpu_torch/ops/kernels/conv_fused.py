"""3x3 stride-1 SAME conv -> BN apply -> ReLU as one implicit-GEMM kernel.

Port of ``myconvnet_tpu/ops/pallas/conv_fused.py`` (``conv3x3_bn_relu`` at
``:82``).  The CUDA kernel is ``csrc/conv_fused.cu``: each block computes
64 output pixels x 64 output channels, streaming K = 9 * C one tap x 32
input channels at a time through shared memory (cp.async, two buffers,
zero fill for SAME padding), bf16 WMMA with float32 accumulators, and the
``relu(acc * scale + bias)`` epilogue on the float32 sum before the single
bf16 store.  Taps that read only padding (the off-centre rows at H = 1,
columns at W = 1) are skipped.

In ResNet-18/34's eval forward it is conv_a -> bn_a -> ReLU of every
stride-1 basic block, with the BN's (scale, shift) or a folded bias as the
epilogue.  The Pallas function's ``images_per_block`` (a TPU tiling knob)
is dropped: the CUDA kernel tiles by pixels over the whole batch.

On a CPU tensor the wrapper runs :func:`conv3x3_bn_relu_reference`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from myconvnet_tpu_torch.ops.kernels import _build


def supports(c: int) -> bool:
    """Input channel counts the kernel takes: rows of 16-byte vectors."""
    return c > 0 and c % 8 == 0


def _check_shapes(x, w3, scale, bias):
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if w3.dim() != 4 or tuple(w3.shape[:3]) != (3, 3, c):
        raise ValueError(f"w3 {tuple(w3.shape)} is not [3, 3, {c}, Cout]")
    cout = w3.shape[-1]
    for name, v in (("scale", scale), ("bias", bias)):
        if tuple(v.shape) != (cout,):
            raise ValueError(f"{name} {tuple(v.shape)} is not [{cout}]")
    return c, cout


def conv3x3_bn_relu_reference(x, w3, scale, bias):
    """Plain PyTorch version with the kernel's rounding points: bf16
    inputs, a float32 sum (float32 convolutions of bf16 values are exact
    products summed in float32, with TF32 off on the card), the epilogue
    in float32 and one bf16 rounding."""
    _check_shapes(x, w3, scale, bias)
    y = F.conv2d(x.to(torch.bfloat16).float().permute(0, 3, 1, 2),
                 w3.to(torch.bfloat16).float().permute(3, 2, 0, 1),
                 padding=1)
    y = torch.relu(y * scale.float()[:, None, None]
                   + bias.float()[:, None, None])
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def conv3x3_bn_relu(x: torch.Tensor, w3: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """y = relu(conv3x3_same(x, w3) * scale + bias), NHWC bf16.

    x: [N, H, W, C] bf16; w3: [3, 3, C, Cout] (HWIO) bf16; scale, bias:
    [Cout] float32.  The weight goes to the kernel as OIHW channels_last
    ([Cout, 3, 3, C]), which costs no copy for an ``nn.Conv`` weight.
    """
    c, cout = _check_shapes(x, w3, scale, bias)
    if x.device.type == "cpu":
        return conv3x3_bn_relu_reference(x, w3, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no conv_fused kernel for device {x.device}")
    for name, t in (("x", x), ("w3", w3)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv_fused kernel takes bf16 {name}, not "
                            f"{t.dtype}")
    if not supports(c):
        raise ValueError(f"conv_fused kernel takes C % 8 == 0, not C = {c}")
    if not x.is_contiguous():
        raise ValueError("conv_fused kernel needs a contiguous NHWC x")
    n, h, w, _ = x.shape
    dev = x.device
    wk = w3.permute(3, 0, 1, 2).contiguous()
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=dev)
    if x.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("conv_fused kernel needs 16-byte aligned x and w3")
    code = _build.library().mcn_conv3x3_bn_relu(
        x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), n, h, w, c, cout,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("mcn_conv3x3_bn_relu", code)
    conv3x3_bn_relu.launches += 1
    return y


conv3x3_bn_relu.launches = 0
