"""Fused inference BN / scale-shift + activation: y = act(x * a + b).

Port of ``myconvnet_tpu/ops/pallas/bn_act.py`` (``fused_scale_shift_act``
at ``:48`` and ``bn_inference_fused`` at ``:84``).  The CUDA kernel is
``csrc/bn_act.cu``: one read of x and one write of y, 16-byte vector
accesses when C is a multiple of the vector width; it is bandwidth-bound
on the H100, and that one pass is its floor.  In ResNet-50's eval forward
it is the bias + ReLU epilogue of the seven convs that stay in cuDNN and
are followed by a ReLU (the stem conv; conv_a and the stride-2 conv_b of
the first block of stages 2-4), or the BN + ReLU there when BN is not
folded.

On a CPU tensor the wrapper runs :func:`scale_shift_act_reference`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch.ops.batch_norm import bn_scale_shift
from myconvnet_tpu_torch.ops.kernels import _build

ACTS = {"none": 0, "relu": 1, "relu6": 2, "leaky_relu": 3}
_ENTRY = {torch.float32: "mcn_scale_shift_act_f32",
          torch.bfloat16: "mcn_scale_shift_act_bf16"}


def scale_shift_act_reference(x: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor, act: str = "relu"
                              ) -> torch.Tensor:
    """Plain PyTorch version: float32 math, cast back to x's dtype."""
    y = x.float() * a.float() + b.float()
    if act == "relu":
        y = torch.relu(y)
    elif act == "relu6":
        y = torch.clamp(y, 0.0, 6.0)
    elif act == "leaky_relu":
        y = torch.where(y >= 0.0, y, 0.2 * y)
    elif act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return y.to(x.dtype)


def fused_scale_shift_act(x: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, act: str = "relu"
                          ) -> torch.Tensor:
    """y = act(x * a + b) over the last axis.  x: [..., C] float32 or
    bfloat16; a, b: [C] (used as float32)."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    c = x.shape[-1]
    if a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)} do not "
                         f"match {c} channels")
    if x.device.type == "cpu":
        return scale_shift_act_reference(x, a, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"no bn_act kernel for device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"bn_act kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bn_act kernel needs a contiguous [..., C] tensor")
    a = a.to(device=x.device, dtype=torch.float32).contiguous()
    b = b.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    entry = _ENTRY[x.dtype]
    code = getattr(_build.library(), entry)(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        x.numel() // c if c else 0, c, ACTS[act],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(entry, code)
    fused_scale_shift_act.launches += 1
    return y


fused_scale_shift_act.launches = 0


def bn_inference_fused(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, mean: torch.Tensor,
                       var: torch.Tensor, eps: float = 1e-3,
                       act: str = "none") -> torch.Tensor:
    """Inference BN + activation as one pass of the kernel above."""
    a, b = bn_scale_shift(gamma, beta, mean, var, eps)
    return fused_scale_shift_act(x, a, b, act)
