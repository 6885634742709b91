"""GAN evaluation metrics: the Frechet distance (FID) and the Inception
Score, over any feature extractor or classifier.

Port of ``myconvnet_tpu/eval/gan_metrics.py``: ``activation_statistics``
(``:22``), ``_sqrtm_psd`` (``:34``), ``frechet_distance`` (``:41``),
``fid_from_features`` (``:53``) and ``inception_score`` (``:60``).  The
extractor is a parameter (a trained classifier's ``features``); the
canonical Inception-v3 needs weights the repo does not hold.

Float32 throughout, as JAX computes: the means, covariances and the two
symmetric eigensolves of ``trace(S1 + S2 - 2 (S1^1/2 S2 S1^1/2)^1/2)``,
eigenvalues clamped at 0.  ``torch.linalg.eigh`` and ``jnp.linalg.eigh``
order their round-off differently; near a rank-deficient covariance (N <=
D) the clamp magnifies it, so the two FIDs agree to the tolerance
``tests/test_torch_gan_metrics.py`` states, not to the last bit.
"""

from __future__ import annotations

import numpy as np
import torch


def activation_statistics(features) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean [D], covariance [D, D]) of [N, D] (or [N, ..., D]) features,
    float32."""
    f = torch.as_tensor(features).float()
    if f.ndim > 2:
        f = f.reshape(f.shape[0], -1)
    mu = f.mean(0)
    d = f - mu
    cov = d.T @ d / max(f.shape[0] - 1, 1)
    return mu, cov


def _sqrtm_psd(m: torch.Tensor) -> torch.Tensor:
    """Square root of a symmetric PSD matrix by eigh, eigenvalues clamped
    at 0."""
    vals, vecs = torch.linalg.eigh((m + m.T) / 2.0)
    vals = vals.clamp_min(0.0)
    return (vecs * vals.sqrt()[None, :]) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2) -> torch.Tensor:
    """||mu1 - mu2||^2 + tr(C1 + C2 - 2 (C1^1/2 C2 C1^1/2)^1/2)."""
    mu1, mu2, cov1, cov2 = (torch.as_tensor(t).float()
                            for t in (mu1, mu2, cov1, cov2))
    diff = (mu1 - mu2).square().sum()
    s1h = _sqrtm_psd(cov1)
    cross = _sqrtm_psd(s1h @ cov2 @ s1h)
    return diff + cov1.trace() + cov2.trace() - 2.0 * cross.trace()


def fid_from_features(real_features, fake_features) -> float:
    """FID of two [N, D] feature batches from the same extractor."""
    mu1, c1 = activation_statistics(real_features)
    mu2, c2 = activation_statistics(fake_features)
    return float(frechet_distance(mu1, c1, mu2, c2))


def inception_score(logits, *, splits: int = 10) -> tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over a classifier's logits: (mean,
    std) over ``splits`` partitions."""
    probs = torch.softmax(torch.as_tensor(logits).float(), -1)
    probs = probs.cpu().numpy()
    n = probs.shape[0]
    scores = []
    splits = max(1, min(splits, n))
    for part in np.array_split(probs, splits):
        marginal = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(np.maximum(part, 1e-12)) -
                            np.log(np.maximum(marginal, 1e-12))), axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))
