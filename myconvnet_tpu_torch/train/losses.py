"""Losses, reduced in float32 under any compute dtype.

Port of ``myconvnet_tpu/train/losses.py``: softmax cross-entropy
(``:15-28``), its per-pixel form with the ignore label (``:31-44``), the
soft Dice loss (``:49-68``) and the fused CE + Dice (``:113-139``), the
focal loss (``:71-110``, over [N, C] or [N, H, W, C]), the
scale-invariant log loss of monocular depth (``:142-156``) and the
optical-flow objectives (``:159-334``): the Charbonnier end-point error
with NaN-masked targets, its multi-scale form for the coarse-to-fine nets,
and the unsupervised photometric + smoothness objective with its forward-
backward occlusion gate; and the GAN objectives (``:376-443``):
``sigmoid_bce``, ``l1_loss`` and the (D loss, G loss) pairs of
``GAN_LOSSES`` (non-saturating, least-squares, hinge).
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


def pixel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                        ignore_label: int | None = 255,
                        label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-pixel CE over [N, H, W, C] logits and [N, H, W] int labels, in
    float32: pixels at ``ignore_label`` are left out and the sum is divided
    by the valid pixels' count (at least 1)."""
    logits = logits.float()
    nc = logits.shape[-1]
    valid = (torch.ones_like(labels, dtype=torch.bool) if ignore_label is None
             else labels != ignore_label)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    if label_smoothing > 0.0:
        ce = (1.0 - label_smoothing) * ce \
            - (label_smoothing / nc) * logp.sum(dim=-1)
    vf = valid.float()
    return (ce * vf).sum() / vf.sum().clamp(min=1.0)


def _valid_onehot(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_label: int | None):
    """(valid float mask, one-hot float32 targets) of int labels, the
    ignored pixels' class read as 0."""
    valid = (torch.ones(labels.shape, device=logits.device)
             if ignore_label is None else (labels != ignore_label).float())
    safe = torch.where(valid > 0, labels, torch.zeros_like(labels)).long()
    return valid, torch.nn.functional.one_hot(safe,
                                              logits.shape[-1]).float()


def _dice(probs: torch.Tensor, onehot: torch.Tensor, eps: float
          ) -> torch.Tensor:
    """1 - mean over images and classes of (2 |P∩Y| + eps) / (|P| + |Y| +
    eps), the sums over H and W of masked probabilities and targets."""
    inter = (probs * onehot).sum(dim=(1, 2))
    denom = (probs + onehot).sum(dim=(1, 2))
    return 1.0 - ((2.0 * inter + eps) / (denom + eps)).mean()


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, *,
              ignore_label: int | None = 255, eps: float = 1.0
              ) -> torch.Tensor:
    """Soft Dice over [N, H, W, C] logits and [N, H, W] int labels, in
    float32; ignored pixels leave both the overlap and the sizes."""
    logits = logits.float()
    valid, onehot = _valid_onehot(logits, labels, ignore_label)
    v = valid[..., None]
    return _dice(torch.softmax(logits, dim=-1) * v, onehot * v, eps)


def ce_dice_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                 ignore_label: int | None = 255, dice_weight: float = 1.0,
                 label_smoothing: float = 0.0, eps: float = 1.0
                 ) -> torch.Tensor:
    """Per-pixel CE (valid pixels' mean) + ``dice_weight`` x soft Dice,
    sharing the mask, the one-hot and the log-softmax as JAX's fused form
    does (the Dice's probabilities are exp(log-softmax))."""
    logits = logits.float()
    nc = logits.shape[-1]
    valid, onehot = _valid_onehot(logits, labels, ignore_label)
    logp = torch.log_softmax(logits, dim=-1)
    target = onehot
    if label_smoothing > 0.0:
        target = onehot * (1.0 - label_smoothing) + label_smoothing / nc
    ce = -(target * logp).sum(dim=-1) * valid
    ce = ce.sum() / valid.sum().clamp(min=1.0)
    v = valid[..., None]
    return ce + dice_weight * _dice(torch.exp(logp) * v, onehot * v, eps)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, *,
               gamma: float = 2.0, alpha=None,
               ignore_label: int | None = None) -> torch.Tensor:
    """Focal loss, CE scaled by (1 - p_t)^gamma, over [N, C] or
    [N, H, W, C] logits and int labels of one rank less; the sum over
    valid elements divided by their count (at least 1).  ``alpha``: a
    length-C sequence weights each target class (alpha_t), a scalar
    rescales uniformly.  Soft labels are refused, as JAX refuses them."""
    logits = logits.float()
    if labels.dim() != logits.dim() - 1:
        raise ValueError(
            "focal_loss needs integer class labels; soft labels "
            "(MixUp/CutMix) have no standard focal form — use "
            "softmax_cross_entropy for mixed batches")
    nc = logits.shape[-1]
    valid = (torch.ones(labels.shape, device=logits.device)
             if ignore_label is None else (labels != ignore_label).float())
    safe = torch.where(valid > 0, labels, torch.zeros_like(labels)).long()
    onehot = torch.nn.functional.one_hot(safe, nc).float()
    logp = torch.log_softmax(logits, dim=-1)
    logp_t = (onehot * logp).sum(dim=-1)
    p_t = torch.exp(logp_t)
    w = (1.0 - p_t) ** gamma
    if alpha is not None:
        a = torch.as_tensor(alpha, dtype=torch.float32, device=logits.device)
        if a.dim() == 1:
            if a.shape[0] != nc:
                raise ValueError(f"per-class alpha needs length {nc}, got "
                                 f"{a.shape[0]}")
            w = w * (onehot * a).sum(dim=-1)   # alpha_t by target
        else:
            w = w * a                          # uniform rescale
    loss = -w * logp_t * valid
    return loss.sum() / valid.sum().clamp(min=1.0)


def silog_loss(pred: torch.Tensor, target: torch.Tensor, *,
               lam: float = 0.5, eps: float = 1e-6) -> torch.Tensor:
    """Eigen's scale-invariant log loss over the valid pixels (target >
    0): ``d = log(pred) - log(gt)``, ``mean(d²) - lam mean(d)²``, in
    float32.  ``jnp.maximum``'s gradient split at a tie with ``eps`` is
    ``torch.maximum``'s."""
    p = pred.float()
    p = torch.maximum(p, p.new_tensor(eps))
    t = target.float()
    valid = (t > 0).float()
    n = torch.clamp(valid.sum(), min=1.0)
    d = (torch.log(p) - torch.log(torch.maximum(t, t.new_tensor(eps)))) \
        * valid
    return (d * d).sum() / n - lam * torch.square(d.sum() / n)


def epe_loss(pred: torch.Tensor, target: torch.Tensor, *,
             eps: float = 1e-3) -> torch.Tensor:
    """End-point-error loss for optical flow: the mean over valid pixels
    of ``sqrt(du^2 + dv^2 + eps^2)``.  ``target`` is ``[N, H, W, 2]``; a
    pixel with a NaN component (the .flo unknown sentinel) is masked out.
    Unknown targets are zeroed BEFORE the subtraction, so no NaN reaches
    the gradient."""
    p = pred.float()
    t = target.float()
    valid = torch.isfinite(t).all(dim=-1)
    t = torch.where(valid[..., None], t, torch.zeros_like(t))
    d = p - t
    epe = torch.sqrt((d * d).sum(dim=-1) + eps * eps)
    vf = valid.float()
    return (epe * vf).sum() / vf.sum().clamp(min=1.0)


_PWC_LEVEL_WEIGHTS = (0.32, 0.08, 0.02, 0.01, 0.005)  # levels 6..2


def _nan_avg_pool_flow(target: torch.Tensor, hw) -> torch.Tensor:
    """NaN-aware average pooling of a ``[N, H, W, 2]`` flow map to ``hw``
    (H, W integer multiples of it): unknown (NaN) pixels are left out of
    each window's mean; an all-unknown window stays NaN, so
    :func:`epe_loss` keeps masking it."""
    n, h, w, c = target.shape
    oh, ow = hw
    if h % oh or w % ow:
        raise ValueError(f"cannot pool {(h, w)} to {tuple(hw)}: "
                         "non-integer stride")
    ky, kx = h // oh, w // ow
    t = target.reshape(n, oh, ky, ow, kx, c)
    valid = torch.isfinite(t).all(dim=-1, keepdim=True)
    tz = torch.where(valid, t, torch.zeros_like(t))
    cnt = valid.sum(dim=(2, 4))
    s = tz.sum(dim=(2, 4))
    return torch.where(cnt > 0, s / cnt.clamp(min=1),
                       torch.full_like(s, float("nan")))


def multiscale_epe_loss(preds, target: torch.Tensor, *, weights=None,
                        eps: float = 1e-3) -> torch.Tensor:
    """Multi-scale deep supervision of a coarse-to-fine flow net: a
    weighted Charbonnier EPE per pyramid level, each against the NaN-aware
    average-pooled ground truth.  ``preds`` is the coarse-to-fine list of
    ``[N, h_l, w_l, 2]`` flows in full-resolution pixels; the default
    ``weights`` are the PWC-Net paper's alphas when five levels are
    supervised, uniform otherwise."""
    preds = list(preds)
    if weights is None:
        weights = (_PWC_LEVEL_WEIGHTS if len(preds) == 5
                   else (1.0 / len(preds),) * len(preds))
    if len(weights) != len(preds):
        raise ValueError(f"{len(weights)} weights for {len(preds)} "
                         "pyramid levels")
    total = 0.0
    for w_l, p in zip(weights, preds):
        t_l = _nan_avg_pool_flow(target, tuple(p.shape[1:3]))
        total = total + w_l * epe_loss(p, t_l, eps=eps)
    return total


def occlusion_mask(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor, *,
                   alpha1: float = 0.01, alpha2: float = 0.5
                   ) -> torch.Tensor:
    """Forward-backward consistency mask: 1 where the forward flow and the
    backward flow sampled at the forward target roughly cancel,
    ``|f + b(f)|^2 < alpha1 (|f|^2 + |b(f)|^2) + alpha2``.  ``[N, H, W, 1]``
    float32 in {0, 1}; callers detach it."""
    from myconvnet_tpu_torch.ops.warp import warp_bilinear

    f = flow_fwd.float()
    b = warp_bilinear(flow_bwd.float(), f)
    sq_sum = (f + b).square().sum(dim=-1, keepdim=True)
    sq_mag = (f.square().sum(dim=-1, keepdim=True)
              + b.square().sum(dim=-1, keepdim=True))
    return (sq_sum < alpha1 * sq_mag + alpha2).float()


def _photo_smooth(fl, f_src, f_tgt, *, edge_sharpness, eps, mask=None):
    """Masked photometric Charbonnier (f_src against f_tgt warped by fl)
    and the edge-aware smoothness of fl along f_src's edges."""
    from myconvnet_tpu_torch.ops.warp import abs_jax, warp_bilinear

    warped = warp_bilinear(f_tgt, fl)
    err = torch.sqrt((f_src - warped).square() + eps * eps)
    if mask is None:
        photo = err.mean()
    else:
        m = mask.detach()
        # by the live-pixel count, so a shrinking mask cannot shrink the
        # loss; the mask itself carries no gradient
        photo = (err * m).sum() / (m.sum() * err.shape[-1] + 1e-6)
    # jnp.abs's gradient at 0 is +1, which a constant flow (the zero
    # heads' first step) meets everywhere
    du_x = abs_jax(fl[:, :, 1:] - fl[:, :, :-1]).sum(-1)
    du_y = abs_jax(fl[:, 1:] - fl[:, :-1]).sum(-1)
    gx = (f_src[:, :, 1:] - f_src[:, :, :-1]).abs().mean(dim=-1)
    gy = (f_src[:, 1:] - f_src[:, :-1]).abs().mean(dim=-1)
    smooth = ((du_x * torch.exp(-edge_sharpness * gx)).mean()
              + (du_y * torch.exp(-edge_sharpness * gy)).mean())
    return photo, smooth


def unsupervised_flow_loss(pred, frames: torch.Tensor, *,
                           smooth_weight: float = 0.05,
                           edge_sharpness: float = 50.0, eps: float = 1e-3,
                           occlusion: bool = False,
                           occ_alpha1: float = 0.01,
                           occ_alpha2: float = 0.5) -> torch.Tensor:
    """Photometric Charbonnier between frame 1 and frame 2 warped back by
    the predicted flow, plus first-order edge-aware smoothness.  ``pred``
    is ``[N, h, w, 2]`` or the coarse-to-fine list (the finest level is
    upsampled and supervised); ``frames`` the ``[N, H, W, 6]`` pair in
    [0, 1].  ``occlusion=True`` is the bidirectional form: ``pred`` holds
    2N flows, the second N for the swapped pairs, and both photometric
    terms are gated by :func:`occlusion_mask`."""
    from myconvnet_tpu_torch.ops.resize import resize_bilinear

    if isinstance(pred, (list, tuple)):
        pred = pred[-1]
    fr = frames.float()
    n, h, w, _ = fr.shape
    fl = pred.float()
    if tuple(fl.shape[1:3]) != (h, w):
        fl = resize_bilinear(fl, (h, w))
    f1, f2 = fr[..., :3], fr[..., 3:]
    kw = dict(edge_sharpness=edge_sharpness, eps=eps)
    if not occlusion:
        if fl.shape[0] != n:
            raise ValueError(f"{fl.shape[0]} flows for {n} frame pairs")
        photo, smooth = _photo_smooth(fl, f1, f2, **kw)
        return photo + smooth_weight * smooth
    if fl.shape[0] != 2 * n:
        raise ValueError(
            f"occlusion=True needs 2N={2 * n} flows (forward pairs "
            f"then swapped pairs), got {fl.shape[0]}")
    f_fwd, f_bwd = fl[:n], fl[n:]
    m_fwd = occlusion_mask(f_fwd, f_bwd, alpha1=occ_alpha1,
                           alpha2=occ_alpha2)
    m_bwd = occlusion_mask(f_bwd, f_fwd, alpha1=occ_alpha1,
                           alpha2=occ_alpha2)
    p_f, s_f = _photo_smooth(f_fwd, f1, f2, mask=m_fwd, **kw)
    p_b, s_b = _photo_smooth(f_bwd, f2, f1, mask=m_bwd, **kw)
    return 0.5 * (p_f + p_b) + smooth_weight * 0.5 * (s_f + s_b)


def sigmoid_bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean sigmoid binary CE against a constant target, in float32, in
    the stable form max(x, 0) - x t + log(1 + exp(-|x|))."""
    x = logits.float()
    return (torch.clamp(x, min=0.0) - x * target
            + torch.log1p(torch.exp(-x.abs()))).mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def gan_discriminator_loss(real: torch.Tensor, fake: torch.Tensor
                           ) -> torch.Tensor:
    """Non-saturating D loss: real -> 1, fake -> 0."""
    return sigmoid_bce(real, 1.0) + sigmoid_bce(fake, 0.0)


def gan_generator_loss(fake: torch.Tensor) -> torch.Tensor:
    """Non-saturating G loss: fake -> 1."""
    return sigmoid_bce(fake, 1.0)


def lsgan_discriminator_loss(real: torch.Tensor, fake: torch.Tensor
                             ) -> torch.Tensor:
    return 0.5 * ((real.float() - 1.0).square().mean()
                  + fake.float().square().mean())


def lsgan_generator_loss(fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (fake.float() - 1.0).square().mean()


def hinge_discriminator_loss(real: torch.Tensor, fake: torch.Tensor
                             ) -> torch.Tensor:
    return (torch.relu(1.0 - real.float()).mean()
            + torch.relu(1.0 + fake.float()).mean())


def hinge_generator_loss(fake: torch.Tensor) -> torch.Tensor:
    return -fake.float().mean()


GAN_LOSSES = {
    "nonsaturating": (gan_discriminator_loss, gan_generator_loss),
    "lsgan": (lsgan_discriminator_loss, lsgan_generator_loss),
    "hinge": (hinge_discriminator_loss, hinge_generator_loss),
}


def get_gan_losses(name: str):
    """(d_loss(real, fake), g_loss(fake)) of the objective ``name``."""
    try:
        return GAN_LOSSES[name]
    except KeyError as e:
        raise ValueError(f"unknown GAN loss {name!r}; valid: "
                         f"{sorted(GAN_LOSSES)}") from e
