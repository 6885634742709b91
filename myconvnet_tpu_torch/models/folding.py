"""Fold each eval BN into the conv before it, for serving.

Port of ``myconvnet_tpu/models/folding.py``.  Pairs are found by the same
naming convention (a child ``conv<suffix>`` and a sibling ``bn<suffix>``
with a matching channel count), and each is folded in float64 as
``_fold_one`` does (``folding.py:25-32``):

    w' = w * gamma * rstd          (per output channel)
    b' = beta + (b - mean) * gamma * rstd

Folding works module by module, so every BN uses its own eps; the JAX
package's empirical ``resolve_bn_eps`` (``serving.py:33-55``) has no
counterpart here.  A folded BN becomes the identity.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch.nn import BatchNorm, Conv


def fold_one(w, b, gamma, beta, mean, var, eps):
    """numpy float64 fold of HWIO ``w`` and optional ``b``; float32 out."""
    rstd = 1.0 / np.sqrt(np.asarray(var, np.float64) + eps)
    scale = np.asarray(gamma, np.float64) * rstd
    w2 = np.asarray(w, np.float64) * scale
    b0 = np.zeros_like(scale) if b is None else np.asarray(b, np.float64)
    b2 = np.asarray(beta, np.float64) + (
        b0 - np.asarray(mean, np.float64)) * scale
    return w2.astype(np.float32), b2.astype(np.float32)


def conv_bn_pairs(model: nn.Module):
    """Yield (conv, bn) sibling pairs by the zoo's naming convention."""
    for parent in model.modules():
        children = dict(parent.named_children())
        for name, conv in children.items():
            if not (name.startswith("conv") and isinstance(conv, Conv)):
                continue
            bn = children.get("bn" + name[len("conv"):])
            if (isinstance(bn, BatchNorm) and not bn.folded
                    and bn.gamma.shape[0] == conv.weight.shape[0]):
                yield conv, bn


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


@torch.no_grad()
def fold_batch_norms(model: nn.Module) -> int:
    """Fold in place; returns the number of BNs folded."""
    count = 0
    for conv, bn in list(conv_bn_pairs(model)):
        w2, b2 = fold_one(_np(conv.w),
                          None if conv.bias is None else _np(conv.bias),
                          _np(bn.gamma), _np(bn.beta), _np(bn.moving_mean),
                          _np(bn.moving_var), bn.eps)
        dev, dt = conv.weight.device, conv.weight.dtype
        conv.w.copy_(torch.from_numpy(w2))
        conv.bias = nn.Parameter(torch.from_numpy(b2).to(dev, dt))
        bn.mark_folded()
        count += 1
    return count
