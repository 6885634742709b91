"""Inference batch normalization over the last (channel) axis.

Port of ``myconvnet_tpu/ops/batch_norm.py:batch_norm_inference``: one
scale and shift per channel, computed in float32 and cast back to x's
dtype.  Training-mode BN belongs to the training slice.
"""

from __future__ import annotations

import torch


def bn_scale_shift(gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (a, b) with bn(x) == x * a + b, in float32."""
    a = gamma.float() * torch.rsqrt(var.float() + eps)
    return a, beta.float() - mean.float() * a


def batch_norm_inference(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, eps: float = 1e-3
                         ) -> torch.Tensor:
    a, b = bn_scale_shift(gamma, beta, mean, var, eps)
    return (x.float() * a + b).to(x.dtype)
