"""Softmax cross-entropy, reduced in float32 under any compute dtype.

Port of ``myconvnet_tpu/train/losses.py:15-28``.
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          num_classes: int | None = None,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE.  ``labels``: int [N] or one-hot / soft [N, C]."""
    logits = logits.float()
    nc = num_classes or logits.shape[-1]
    if labels.dim() == logits.dim() - 1:
        onehot = torch.nn.functional.one_hot(labels.long(), nc).float()
    else:
        onehot = labels.float()
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / nc
    logp = torch.log_softmax(logits, dim=-1)
    return -(onehot * logp).sum(dim=-1).mean()
