"""Batch normalization over the last (channel) axis, train and inference.

Port of ``myconvnet_tpu/ops/batch_norm.py``.  Statistics and the
normalization math are float32 under any compute dtype; outputs are cast
back to x's dtype.

* :func:`batch_norm_train` (``:28-70``) normalizes by the *biased* batch
  variance, computed as ``mean(x^2) - mean^2`` clamped at 0 (``:38-40``),
  not ``torch.var_mean``'s two-pass form, and returns (y, mean, var) for
  the caller's moving-average update.  Its backward restates the JAX
  ``custom_vjp`` (``_bn_train_bwd``, ``:52-67``): it uses the saved
  (mean, rstd) and ignores the statistics' cotangents, which only feed the
  EMA.
* :func:`batch_norm_inference` (``:72-79``) is one scale and shift.
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


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        axes = tuple(range(x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dim=axes)
        var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = (xf - mean) * rstd * gamma.float() + beta.float()
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, rstd = ctx.saved_tensors
        axes = tuple(range(x.dim() - 1))
        m = x.numel() // x.shape[-1]
        dyf = dy.float()
        xhat = (x.float() - mean) * rstd
        dbeta = dyf.sum(dim=axes)
        dgamma = (dyf * xhat).sum(dim=axes)
        scale = gamma.float() * rstd / m
        dx = scale * (m * dyf - dbeta - xhat * dgamma)
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-3
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, batch_mean, batch_var); reduces over all but the last axis."""
    return _BatchNormTrain.apply(x, gamma, beta, eps)
