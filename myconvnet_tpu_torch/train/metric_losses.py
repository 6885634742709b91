"""Metric-learning losses: the ArcFace and CosFace margin softmaxes and the
batch-hard triplet loss, in float32.

Port of ``myconvnet_tpu/train/metric_losses.py``.  The margin losses take
the raw cosines of ``models.embedding.EmbeddingNet`` in train mode (both
the embedding and the class-weight columns unit-norm) and put the margin
on the target column alone; the triplet loss takes the unit-norm
embeddings.  Gradients follow JAX's rules at ties: ``jnp.clip`` and
``jnp.maximum`` split a tie's gradient in halves (``torch.maximum`` and
``torch.minimum`` do too, ``torch.clamp`` does not), and ``jnp.max`` /
``jnp.min`` over an axis split it evenly among the tied elements
(``amax`` / ``amin``; ``max(dim)`` would give it all to one).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a maximum, then a minimum, each splitting a tie."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def _target_nll(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def arcface_loss(cos: torch.Tensor, labels: torch.Tensor, *,
                 s: float = 64.0, m: float = 0.5) -> torch.Tensor:
    """Additive angular margin over cosines [N, C] and int labels [N]: the
    target column becomes cos(theta + m) where theta + m stays below pi
    (cos > cos(pi - m)), else the linear fallback cos - m sin(pi - m);
    sin is sqrt of 1 - cos² clipped to [1e-12, 1], so |cos| = 1 has a
    finite gradient."""
    cos = cos.float()
    sin = torch.sqrt(_clip(1.0 - cos * cos, 1e-12, 1.0))
    phi = cos * math.cos(m) - sin * math.sin(m)
    phi = torch.where(cos > math.cos(math.pi - m), phi,
                      cos - math.sin(math.pi - m) * m)
    onehot = F.one_hot(labels.long(), cos.shape[-1]).float()
    return _target_nll(s * (onehot * phi + (1.0 - onehot) * cos), onehot)


def cosface_loss(cos: torch.Tensor, labels: torch.Tensor, *,
                 s: float = 30.0, m: float = 0.35) -> torch.Tensor:
    """Additive cosine margin: the target logit is s (cos - m)."""
    cos = cos.float()
    onehot = F.one_hot(labels.long(), cos.shape[-1]).float()
    return _target_nll(s * (cos - m * onehot), onehot)


def pairwise_distances(emb: torch.Tensor, *,
                       squared: bool = False) -> torch.Tensor:
    """[N, N] Euclidean distances of [N, D] embeddings by |a|² + |b|² -
    2ab (one matmul), floored at 0; ``+1e-12`` under the square root keeps
    the diagonal's gradient finite."""
    emb = emb.float()
    dot = emb @ emb.T
    sq = torch.diagonal(dot)
    d2 = torch.maximum(sq[:, None] + sq[None, :] - 2.0 * dot,
                       dot.new_zeros(()))
    return d2 if squared else torch.sqrt(d2 + 1e-12)


def batch_hard_triplet_loss(emb: torch.Tensor, labels: torch.Tensor, *,
                            margin: float = 0.3,
                            soft: bool = False) -> torch.Tensor:
    """Batch-hard triplet loss over [N, D] embeddings and int [N] labels:
    for each anchor the farthest positive and the nearest negative, then
    ``relu(hp - hn + margin)`` or, with ``soft``, ``softplus(hp - hn)``;
    anchors without a positive and a negative in the batch are left out
    of the mean."""
    d = pairwise_distances(emb)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=d.device)
    pos_mask = same & ~eye
    neg_mask = ~same
    inf = d.new_tensor(math.inf)
    hardest_pos = torch.where(pos_mask, d, -inf).amax(1)
    hardest_neg = torch.where(neg_mask, d, inf).amin(1)
    valid = pos_mask.any(1) & neg_mask.any(1)
    gap = torch.where(valid, hardest_pos - hardest_neg, d.new_zeros(()))
    if soft:
        per = torch.logaddexp(gap, gap.new_zeros(()))
    else:
        per = torch.relu(gap + margin)
    per = torch.where(valid, per, per.new_zeros(()))
    return per.sum() / valid.float().sum().clamp(min=1.0)
