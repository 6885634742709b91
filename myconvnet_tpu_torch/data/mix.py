"""Batch mixing (MixUp, CutMix) with sampling split from applying.

Port of ``myconvnet_tpu/data/mix.py:34-126``: ``MixConfig``,
``mixup_cutmix`` and the rectangle masks.  One per-pixel weight map
expresses both mixes:

    out[n] = w[n] * x[n] + (1 - w[n]) * x[perm[n]]

MixUp sets ``w[n] = lam_n`` everywhere; CutMix sets ``w[n] = 1 - inbox[n]``
for a rectangle clamped to the frame; a sample that is not mixed keeps
``w = 1``.  The soft label uses the realized ratio ``mean(w[n])``.

torch's Beta and Gamma samplers take no generator, so :func:`sample_mix`
draws every random number of a batch (the permutation, the lambdas, the
switches and the rectangle centres) from a seeded
``numpy.random.Generator`` on the host, packs them into one pinned buffer
and copies it to the device without a sync.  :func:`mixup_cutmix` applies
them; tests hand it JAX's draws (``mix.py:93-116``) instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MixConfig(NamedTuple):
    """Configuration for batch mixing; zero alphas/probs disable parts."""
    mixup_alpha: float = 0.2       # Beta(a, a) for MixUp; 0 disables
    cutmix_alpha: float = 1.0      # Beta(a, a) for CutMix; 0 disables
    prob: float = 1.0              # per-sample probability of mixing at all
    switch_prob: float = 0.5       # P(CutMix | mixing) when both enabled
    label_smoothing: float = 0.0   # folded into the soft labels


class MixDraws(NamedTuple):
    """One batch's random numbers, on the device."""
    perm: torch.Tensor      # [N] int64, the partner of each sample
    lam_mix: torch.Tensor   # [N] float32, MixUp ratio (1 = no mix)
    lam_cut: torch.Tensor   # [N] float32, CutMix lambda (1 = no box)
    use_cut: torch.Tensor   # [N] bool, CutMix rather than MixUp
    centre: torch.Tensor    # [N, 2] float32 uniforms: box centre / (H, W)
    apply: torch.Tensor     # [N] bool, mix this sample at all


def sample_mix(rng: np.random.Generator, n: int, cfg: MixConfig,
               device: torch.device) -> MixDraws:
    """Draw one batch's mixing on the host, in float32 as the JAX draws,
    and move it to ``device`` in one non-blocking copy."""
    ones = np.ones(n)
    perm = rng.permutation(n)
    lam_mix = (rng.beta(cfg.mixup_alpha, cfg.mixup_alpha, n)
               if cfg.mixup_alpha > 0.0 else ones)
    lam_cut = (rng.beta(cfg.cutmix_alpha, cfg.cutmix_alpha, n)
               if cfg.cutmix_alpha > 0.0 else ones)
    if cfg.mixup_alpha > 0.0 and cfg.cutmix_alpha > 0.0:
        use_cut = rng.random(n) < cfg.switch_prob
    else:
        use_cut = np.full(n, cfg.mixup_alpha <= 0.0)
    centre = rng.random((n, 2))
    apply = rng.random(n) < cfg.prob
    packed = np.stack([perm, lam_mix, lam_cut, use_cut, centre[:, 0],
                       centre[:, 1], apply], axis=1).astype(np.float32)
    host = torch.from_numpy(packed)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    dev = host.to(device, non_blocking=True)
    return MixDraws(perm=dev[:, 0].long(), lam_mix=dev[:, 1],
                    lam_cut=dev[:, 2], use_cut=dev[:, 3] > 0.5,
                    centre=dev[:, 4:6], apply=dev[:, 6] > 0.5)


def _rect_mask_sized(centre: torch.Tensor, hw: tuple[int, int],
                     cut_h: torch.Tensor, cut_w: torch.Tensor
                     ) -> torch.Tensor:
    """[N, H, W, 1] float rectangle masks of per-image size (cut_h, cut_w)
    centred at ``centre * (H, W)``, clamped to the frame; pixel centres at
    i + 0.5."""
    h, w = hw
    cy, cx = centre[:, 0] * h, centre[:, 1] * w
    y0 = torch.clamp(cy - cut_h / 2, 0.0, float(h))
    y1 = torch.clamp(cy + cut_h / 2, 0.0, float(h))
    x0 = torch.clamp(cx - cut_w / 2, 0.0, float(w))
    x1 = torch.clamp(cx + cut_w / 2, 0.0, float(w))
    rows = torch.arange(h, dtype=torch.float32, device=centre.device) + 0.5
    cols = torch.arange(w, dtype=torch.float32, device=centre.device) + 0.5
    in_r = (rows[None, :] >= y0[:, None]) & (rows[None, :] < y1[:, None])
    in_c = (cols[None, :] >= x0[:, None]) & (cols[None, :] < x1[:, None])
    return (in_r[:, :, None] & in_c[:, None, :]).float()[..., None]


def _rect_mask(centre: torch.Tensor, hw: tuple[int, int],
               lam: torch.Tensor) -> torch.Tensor:
    """CutMix rectangles: area ~= (1 - lam) * H * W (up to clamping)."""
    h, w = hw
    ratio = torch.sqrt(torch.clamp(1.0 - lam, 0.0, 1.0))
    return _rect_mask_sized(centre, hw, ratio * h, ratio * w)


def soft_labels(labels: torch.Tensor, num_classes: int,
                cfg: MixConfig) -> torch.Tensor:
    """Integer [N] or soft [N, C] labels -> float32 [N, C], smoothed."""
    if labels.dim() == 1:
        y = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    else:
        y = labels.float()
    if cfg.label_smoothing > 0.0:
        y = y * (1.0 - cfg.label_smoothing) + \
            cfg.label_smoothing / num_classes
    return y


def mixup_cutmix(x: torch.Tensor, labels: torch.Tensor, num_classes: int,
                 cfg: MixConfig, draws: MixDraws
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply ``draws`` to a batch: x [N, H, W, C] float images, labels
    int [N] or soft [N, C] -> (mixed x in x's dtype, soft labels [N, C])."""
    _, h, w, _ = x.shape
    y = soft_labels(labels, num_classes, cfg)
    if cfg.mixup_alpha <= 0.0 and cfg.cutmix_alpha <= 0.0:
        return x, y
    inbox = _rect_mask(draws.centre, (h, w), draws.lam_cut)
    w_map = torch.where(draws.use_cut[:, None, None, None], 1.0 - inbox,
                        draws.lam_mix[:, None, None, None])
    w_map = torch.where(draws.apply[:, None, None, None], w_map, 1.0)
    xf = x.float()
    mixed = w_map * xf + (1.0 - w_map) * xf[draws.perm]
    lam_eff = w_map.mean(dim=(1, 2, 3))
    soft = lam_eff[:, None] * y + (1.0 - lam_eff[:, None]) * y[draws.perm]
    return mixed.to(x.dtype), soft
