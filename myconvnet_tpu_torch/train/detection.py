"""Detection training: anchor matching, the multibox and focal losses, the
on-device augmentation, the step and the post-process.

Port of ``myconvnet_tpu/train/detection.py``:

* ``match_anchors`` / ``match_anchors_band`` (``:33``, ``:131``), over a
  batch at once: each anchor's best ground truth by IoU, every ground
  truth's best anchor forced positive, RetinaNet's ignore band; the
  matched rows are gathered (JAX's ``precision="highest"`` one-hot
  einsum, an exact selection);
* ``multibox_loss`` (``:58``, hard negatives at 3:1 by the double-argsort
  rank, stable as ``jnp.argsort``) and ``focal_det_loss`` (``:183``,
  smooth-L1 or GIoU boxes), in float32;
* the input chain: ``preprocess_batch`` (``:275``; uint8 -> (x / 255 -
  mean) / std is ``normalize_u8``, B2), ``DetAugment`` (``:297``), the
  windows of zoom-out and the IoU-constrained crop
  (``sample_detection_windows``, ``:339``, and ``apply_detection_window``,
  ``:404``), the mosaic (``:477``), ``augment_detection_batch`` (``:437``;
  its first step, uint8 -> x / 255, is B2 at mean 0 and std 1);
* :class:`DetectionTrainer`, the step of ``make_detection_step``
  (``:561``) over a module and an optimizer, with JAX's ``DetState``
  checkpoint layout (``params``, ``state``, ``opt``, ``step``, ``rng``);
* ``make_postprocess`` (``:582``): softmax or sigmoid scores, the best
  foreground class, the clipped decode, the top 1000 by a stable sort
  (``lax.top_k``'s tie rule), class-aware NMS (``ops.boxes``), the rows
  gathered.

The step's random numbers are drawn apart from their use
(:func:`sample_draws`, from a ``torch.Generator`` reseeded from (seed,
step)), so that a test hands JAX's draws over.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from myconvnet_tpu_torch import weights
from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
from myconvnet_tpu_torch.core.precision import Policy
from myconvnet_tpu_torch.data.augment import (JitterDraws, _axis_matrix,
                                              batched_crop_resize,
                                              color_jitter, sample_jitter)
from myconvnet_tpu_torch.ops import boxes as box_ops
from myconvnet_tpu_torch.ops.kernels.normalize_u8 import normalize_u8
from myconvnet_tpu_torch.train.trainer import KEEP, rng_data, seed_of

# ------------------------------------------------------ matching + losses


def match_anchors_band(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                       gt_labels: torch.Tensor, pos_threshold: float = 0.5,
                       neg_threshold: float = 0.4):
    """RetinaNet matching of a batch: anchors [A, 4], gt_boxes [B, M, 4],
    gt_labels [B, M] (-1 padding) -> (matched boxes [B, A, 4], matched
    labels [B, A] (0 background), positive [B, A], ignore [B, A]).
    Positive: best IoU >= ``pos_threshold``, or the best anchor of a
    ground truth; ignored: best IoU in [neg_threshold, pos_threshold)."""
    valid = gt_labels >= 0
    iou = box_ops.box_iou(anchors[None], gt_boxes)            # [B, A, M]
    iou = torch.where(valid[:, None, :], iou, iou.new_tensor(-1.0))
    best_iou = iou.amax(2)
    best_gt = iou.argmax(2)       # the first of equal maxima, as JAX's
    best_anchor = iou.argmax(1)                                # [B, M]
    a_range = torch.arange(anchors.shape[0], device=anchors.device)
    forced_oh = ((best_anchor[:, :, None] == a_range[None, None, :])
                 & valid[:, :, None])                         # [B, M, A]
    forced = forced_oh.any(1)
    forced_gt = forced_oh.to(torch.uint8).argmax(1)            # first True
    positive = (best_iou >= pos_threshold) | forced
    ignore = (best_iou >= neg_threshold) & ~positive
    gt_idx = torch.where(forced, forced_gt, best_gt)
    matched_boxes = torch.gather(
        gt_boxes, 1, gt_idx[..., None].expand(*gt_idx.shape, 4))
    labels = torch.gather(torch.clamp(gt_labels, min=0).long(), 1, gt_idx)
    matched_labels = torch.where(positive, labels, torch.zeros_like(labels))
    return matched_boxes, matched_labels, positive, ignore


def match_anchors(anchors, gt_boxes, gt_labels, iou_threshold: float = 0.5):
    """SSD matching: the band with an empty ignore zone -> (matched boxes,
    matched labels, positive)."""
    mb, ml, pos, _ = match_anchors_band(anchors, gt_boxes, gt_labels,
                                        iou_threshold, iou_threshold)
    return mb, ml, pos


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def multibox_loss(cls_logits: torch.Tensor, loc: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  anchors: torch.Tensor, *, iou_threshold: float = 0.5,
                  neg_pos_ratio: float = 3.0):
    """SSD's loss over a batch (cls [B, A, C], class 0 background; loc
    [B, A, 4]): smooth-L1 on the positives' encoded boxes, softmax CE on
    the positives and on the ``neg_pos_ratio`` hardest negatives of each
    image, over the number of positives.  -> (loss, metrics)."""
    cls_logits = cls_logits.float()
    loc = loc.float()
    with torch.no_grad():
        m_boxes, m_labels, positive = match_anchors(
            anchors, gt_boxes, gt_labels, iou_threshold)
        loc_t = box_ops.encode_boxes(m_boxes, anchors[None])
    zero = cls_logits.new_zeros(())
    loc_err = _smooth_l1(loc - loc_t).sum(-1)
    loc_loss = torch.where(positive, loc_err, zero).sum()
    ce = -torch.gather(torch.log_softmax(cls_logits, -1), -1,
                       m_labels[..., None])[..., 0]
    pos_ce = torch.where(positive, ce, zero).sum()
    with torch.no_grad():
        neg_ce = torch.where(positive, ce.new_tensor(-float("inf")), ce)
        order = torch.argsort(-neg_ce, dim=1, stable=True)
        rank = torch.argsort(order, dim=1)    # 0: the hardest negative
        n_pos = positive.sum(1, keepdim=True)
        n_neg = torch.minimum((neg_pos_ratio * n_pos.float()).int(),
                              (~positive).sum(1, keepdim=True).int())
        mined = (rank < n_neg) & ~positive
    neg_loss = torch.where(mined, ce, zero).sum()
    denom = torch.clamp(n_pos.sum(), min=1).float()
    loss = (loc_loss + pos_ce + neg_loss) / denom
    return loss, {"loss": loss.detach(), "loc_loss": loc_loss.detach() / denom,
                  "cls_loss": (pos_ce + neg_loss).detach() / denom,
                  "n_pos": n_pos.sum()}


def focal_det_loss(cls_logits: torch.Tensor, loc: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   anchors: torch.Tensor, *, alpha: float = 0.25,
                   gamma: float = 2.0, pos_threshold: float = 0.5,
                   neg_threshold: float = 0.4,
                   loc_loss_kind: str = "smooth_l1",
                   giou_weight: float = 2.0):
    """RetinaNet's loss (cls [B, A, C - 1] foreground logits): sigmoid
    focal loss over every anchor outside the ignore band, plus smooth-L1
    on encoded boxes or ``giou_weight (1 - GIoU)`` on decoded ones at the
    positives, over the number of positives.  -> (loss, metrics)."""
    cls_logits = cls_logits.float()
    loc = loc.float()
    with torch.no_grad():
        m_boxes, m_labels, positive, ignore = match_anchors_band(
            anchors, gt_boxes, gt_labels, pos_threshold, neg_threshold)
    zero = cls_logits.new_zeros(())
    if loc_loss_kind == "giou":
        # mask (and clamp) the deltas before the decode's exp: a masked
        # anchor's inf would come back as a NaN gradient
        clipped = torch.minimum(torch.maximum(loc, loc.new_tensor(-40.0)),
                                loc.new_tensor(40.0))
        safe = torch.where(positive[..., None], clipped, zero)
        pred = box_ops.decode_boxes(safe, anchors[None])
        loc_err = giou_weight * (1.0 - box_ops.aligned_giou(pred, m_boxes))
    elif loc_loss_kind == "smooth_l1":
        with torch.no_grad():
            loc_t = box_ops.encode_boxes(m_boxes, anchors[None])
        loc_err = _smooth_l1(loc - loc_t).sum(-1)
    else:
        raise ValueError(f"unknown loc_loss_kind {loc_loss_kind!r}")
    loc_loss = torch.where(positive, loc_err, zero).sum()
    k = cls_logits.shape[-1]
    classes = torch.arange(k, device=cls_logits.device)
    targets = (((m_labels - 1)[..., None] == classes)
               & positive[..., None]).float()
    p = torch.sigmoid(cls_logits)
    bce = (torch.maximum(cls_logits, zero) - cls_logits * targets
           + torch.log1p(torch.exp(-cls_logits.abs())))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    focal = alpha_t * (1.0 - p_t) ** gamma * bce
    cls_loss = torch.where(ignore[..., None], zero, focal).sum()
    n_pos = positive.sum()
    denom = torch.clamp(n_pos, min=1).float()
    loss = (cls_loss + loc_loss) / denom
    return loss, {"loss": loss.detach(), "loc_loss": loc_loss.detach() / denom,
                  "cls_loss": cls_loss.detach() / denom, "n_pos": n_pos}


# ------------------------------------------------------------ the input


class DetAugment(NamedTuple):
    """The SSD augmentation policy (``:297-337``): a mosaic first
    (``mosaic_prob``), zoom-out onto a mean-filled canvas
    (``expand_prob``, ratio up to ``expand_max``), the IoU-constrained
    zoom-in crop (``iou_crop``: a threshold from ``{keep} + iou_menu``,
    the first of ``crop_candidates`` patches whose best IoU passes and
    which holds a ground truth's centre), colour jitter, the box-aware
    flip, then the normalize."""
    hflip: bool = True
    mosaic_prob: float = 0.0
    expand_prob: float = 0.0
    expand_max: float = 4.0
    iou_crop: bool = False
    iou_menu: tuple = (0.0, 0.1, 0.3, 0.5, 0.7, 0.9)
    crop_candidates: int = 8
    scale_range: tuple = (0.3, 1.0)
    aspect_range: tuple = (0.5, 2.0)
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    mean: tuple | None = None
    std: tuple | None = None

    @property
    def has_geometry(self) -> bool:
        return self.expand_prob > 0.0 or self.iou_crop

    @property
    def has_photometric(self) -> bool:
        return (self.brightness > 0.0 or self.contrast > 0.0
                or self.saturation > 0.0 or self.hue > 0.0)


class WindowDraws(NamedTuple):
    """The sampling windows' draws, as JAX draws them: ``expand`` [B]
    bool and ``r`` [B] in [1, expand_max) (None without zoom-out), the
    canvas offset's uniforms ``off_u`` [B, 2]; the crop's menu choice
    ``opt`` [B] in [0, len(menu)], sizes ``wh`` [B, K, 2] in
    ``scale_range`` and corner uniforms ``xy_u`` [B, K, 2] (None without
    the crop)."""
    expand: torch.Tensor | None
    r: torch.Tensor | None
    off_u: torch.Tensor | None
    opt: torch.Tensor | None = None
    wh: torch.Tensor | None = None
    xy_u: torch.Tensor | None = None


class DetDraws(NamedTuple):
    """One step's draws: the mosaic's centres [B, 2] and choices [B]
    (None when off), the windows, the jitter factors and the flips."""
    mosaic: tuple | None
    window: WindowDraws | None
    jitter: JitterDraws | None
    flip: torch.Tensor | None


def sample_draws(generator: torch.Generator, n: int, cfg: DetAugment
                 ) -> DetDraws:
    """A batch's draws from ``generator``, on its device."""
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    mosaic = window = None
    if cfg.mosaic_prob > 0.0:
        mosaic = (uniform((n, 2), 0.25, 0.75),
                  uniform((n,)) < cfg.mosaic_prob)
    if cfg.has_geometry:
        expand = r = off_u = None
        if cfg.expand_prob > 0.0:
            expand = uniform((n,)) < cfg.expand_prob
            r = uniform((n,), 1.0, cfg.expand_max)
            off_u = uniform((n, 2))
        opt = wh = xy_u = None
        if cfg.iou_crop:
            k = cfg.crop_candidates
            opt = torch.randint(0, len(cfg.iou_menu) + 1, (n,),
                                generator=generator, device=dev)
            wh = uniform((n, k, 2), *cfg.scale_range)
            xy_u = uniform((n, k, 2))
        window = WindowDraws(expand, r, off_u, opt, wh, xy_u)
    jitter = sample_jitter(generator, n, brightness=cfg.brightness,
                           contrast=cfg.contrast, saturation=cfg.saturation,
                           hue=cfg.hue)
    flip = uniform((n,)) < 0.5 if cfg.hflip else None
    return DetDraws(mosaic, window, jitter, flip)


def sample_detection_windows(gt_boxes: torch.Tensor,
                             gt_labels: torch.Tensor, cfg: DetAugment,
                             draws: WindowDraws) -> torch.Tensor:
    """One window a image -> [B, 4] xyxy in normalized image coordinates
    (outside [0, 1] on a zoom-out canvas): the canvas, or with the crop the
    first acceptable patch of it (the whole canvas when none is)."""
    b = gt_labels.shape[0]
    dev = gt_boxes.device
    if draws.expand is not None:
        r = torch.where(draws.expand, draws.r, torch.ones_like(draws.r))
        off = draws.off_u * (r[:, None] - 1.0)
    else:
        r = torch.ones(b, device=dev)
        off = torch.zeros(b, 2, device=dev)
    off4 = torch.cat([off, off], dim=-1)
    canvas = torch.cat([-off, r[:, None] - off], dim=-1)
    if not cfg.iou_crop:
        return canvas
    menu = torch.tensor(cfg.iou_menu, dtype=torch.float32, device=dev)
    thresh = menu[torch.clamp(draws.opt - 1, min=0)]
    wh = draws.wh
    aspect = wh[..., 0] / wh[..., 1]
    aspect_ok = (aspect >= cfg.aspect_range[0]) & (aspect
                                                   <= cfg.aspect_range[1])
    xy0 = draws.xy_u * (1.0 - wh)
    patch = torch.cat([xy0, xy0 + wh], dim=-1)                  # [B, K, 4]
    valid = gt_labels >= 0
    gtc = (gt_boxes + off4[:, None, :]) / r[:, None, None]
    iou = box_ops.box_iou(patch, gtc)                           # [B, K, M]
    best_iou = torch.where(valid[:, None, :], iou,
                           iou.new_tensor(-1.0)).amax(-1)
    centers = 0.5 * (gtc[..., :2] + gtc[..., 2:])
    inside = ((centers[:, None] > patch[:, :, None, :2])
              & (centers[:, None] < patch[:, :, None, 2:])).all(-1)
    has_center = (inside & valid[:, None, :]).any(-1)
    ok = aspect_ok & (best_iou >= thresh[:, None]) & has_center
    first = ok.to(torch.uint8).argmax(1)
    chosen = torch.gather(patch, 1, first[:, None, None].expand(b, 1, 4))[:, 0]
    use_patch = (draws.opt > 0) & ok.any(1)
    full = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    patch = torch.where(use_patch[:, None], chosen, full[None, :])
    return patch * r[:, None] - off4


def apply_detection_window(images01: torch.Tensor, boxes: torch.Tensor,
                           labels: torch.Tensor, window: torch.Tensor,
                           fill):
    """Resample each [0, 1] image to its window (out of frame reads
    ``fill``) and move the boxes into it: a ground truth survives when its
    centre lies strictly inside, clipped to the window; the others get
    label -1."""
    _, h, w, _ = images01.shape
    wx0, wy0, wx1, wy1 = window.unbind(1)
    crop = torch.stack([wy0 * h, wx0 * w, (wy1 - wy0) * h,
                        (wx1 - wx0) * w], dim=1)
    out = batched_crop_resize(images01, crop, (h, w), fill=torch.as_tensor(
        fill, dtype=torch.float32))
    origin = torch.stack([wx0, wy0, wx0, wy0], dim=1)[:, None, :]
    size = torch.stack([wx1 - wx0, wy1 - wy0], dim=1)
    size = torch.cat([size, size], dim=1)[:, None, :]
    new_boxes = (boxes - origin) / torch.clamp(size, min=1e-9)
    centers = 0.5 * (new_boxes[..., :2] + new_boxes[..., 2:])
    inside = ((centers > 0.0) & (centers < 1.0)).all(-1)
    new_labels = torch.where(inside & (labels >= 0), labels,
                             torch.full_like(labels, -1))
    return out, torch.clamp(new_boxes, 0.0, 1.0), new_labels


def hflip_batch(x: torch.Tensor, boxes: torch.Tensor, flip: torch.Tensor):
    """Flip the images and their boxes (x1' = 1 - x2, x2' = 1 - x1) where
    ``flip``."""
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    flipped = torch.stack([1.0 - boxes[..., 2], boxes[..., 1],
                           1.0 - boxes[..., 0], boxes[..., 3]], dim=-1)
    return x, torch.where(flip[:, None, None], flipped, boxes)


def mosaic_batch(images01: torch.Tensor, boxes: torch.Tensor,
                 labels: torch.Tensor, centers: torch.Tensor,
                 use: torch.Tensor):
    """The 4-image mosaic (``:477-558``): each output image composites
    itself and its next three batch neighbours into quadrants split at
    ``centers`` [B, 2], each whole source warped into its quadrant; the
    targets grow to 4M rows.  Where ``use`` is False the image passes
    through with its boxes in the first M rows."""
    b, h, w, _ = images01.shape
    m = boxes.shape[1]
    cx, cy = centers[:, 0], centers[:, 1]
    dev = images01.device
    xg = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    yg = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    out = torch.zeros_like(images01)
    out_boxes, out_labels = [], []
    for q in range(4):
        img = torch.roll(images01, -q, 0)
        bx = torch.roll(boxes, -q, 0)
        lb = torch.roll(labels, -q, 0)
        left, top = q % 2 == 0, q < 2
        fx0 = torch.zeros_like(cx) if left else cx
        fx1 = cx if left else torch.ones_like(cx)
        fy0 = torch.zeros_like(cy) if top else cy
        fy1 = cy if top else torch.ones_like(cy)
        ex = w / torch.clamp(fx1 - fx0, min=1e-6)
        ey = h / torch.clamp(fy1 - fy0, min=1e-6)
        mh = _axis_matrix(-fy0 * ey, ey, h, h, clamp=False)
        mw = _axis_matrix(-fx0 * ex, ex, w, w, clamp=False)
        warped = torch.einsum("nih,nhwc->niwc", mh, img)
        warped = torch.einsum("njw,niwc->nijc", mw, warped)
        mask = (((xg[None, :] >= fx0[:, None])
                 & (xg[None, :] < fx1[:, None]))[:, None, :]
                & ((yg[None, :] >= fy0[:, None])
                   & (yg[None, :] < fy1[:, None]))[:, :, None])
        out = out + warped * mask[..., None]
        sx = (fx1 - fx0)[:, None]
        sy = (fy1 - fy0)[:, None]
        out_boxes.append(torch.stack([fx0[:, None] + bx[..., 0] * sx,
                                      fy0[:, None] + bx[..., 1] * sy,
                                      fx0[:, None] + bx[..., 2] * sx,
                                      fy0[:, None] + bx[..., 3] * sy], -1))
        out_labels.append(lb)
    pad_boxes = torch.cat([boxes, boxes.new_zeros(b, 3 * m, 4)], 1)
    pad_labels = torch.cat([labels, torch.full_like(labels, -1).repeat(
        1, 3)], 1)
    return (torch.where(use[:, None, None, None], out, images01),
            torch.where(use[:, None, None], torch.cat(out_boxes, 1),
                        pad_boxes),
            torch.where(use[:, None], torch.cat(out_labels, 1),
                        pad_labels))


def _unit(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> x / 255 in float32 (B2 at mean 0, std 1); a float batch
    as float32."""
    if images.dtype == torch.uint8:
        c = images.shape[-1]
        return normalize_u8(images.contiguous(), [0.0] * c, [1.0] * c)
    return images.float()


def preprocess_batch(images: torch.Tensor, mean=None, std=None
                     ) -> torch.Tensor:
    """The eval input (``:275-294``): uint8 -> (x / 255 - mean) / std, one
    B2 launch; a float batch of [0, 1] images is normalized in float32."""
    if images.dtype == torch.uint8:
        c = images.shape[-1]
        if mean is None:
            mean, std = [0.0] * c, [1.0] * c
        return normalize_u8(images.contiguous(), mean, std)
    x = images.float()
    if mean is None:
        return x
    m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def augment_detection_batch(images: torch.Tensor, boxes: torch.Tensor,
                            labels: torch.Tensor, cfg: DetAugment,
                            draws: DetDraws):
    """The train chain: x / 255 (B2), mosaic, the window's warp,
    photometric jitter, the flip, the normalize."""
    x = _unit(images)
    if draws.mosaic is not None:
        x, boxes, labels = mosaic_batch(x, boxes, labels, *draws.mosaic)
    if cfg.has_geometry:
        window = sample_detection_windows(boxes, labels, cfg, draws.window)
        fill = cfg.mean if cfg.mean is not None else (0.5, 0.5, 0.5)
        x, boxes, labels = apply_detection_window(x, boxes, labels, window,
                                                  fill)
    x = color_jitter(x, draws.jitter)
    if draws.flip is not None:
        x, boxes = hflip_batch(x, boxes, draws.flip)
    if cfg.mean is not None:
        m = torch.as_tensor(cfg.mean, dtype=x.dtype, device=x.device)
        s = torch.as_tensor(cfg.std, dtype=x.dtype, device=x.device)
        x = (x - m) / s
    return x, boxes, labels


# ------------------------------------------------------- the post-process


def make_postprocess(anchors: torch.Tensor, num_classes: int, *,
                     score_threshold: float = 0.05,
                     iou_threshold: float = 0.45,
                     max_detections: int = 100,
                     score_activation: str = "softmax",
                     pre_nms_topk: int = 1000,
                     nms_method: str = "jacobi") -> Callable:
    """(cls [B, A, C], loc [B, A, 4]) -> (boxes float32 [B, D, 4], scores
    float32 [B, D], labels int32 [B, D] in 1..C-1, valid bool [B, D]),
    D = ``max_detections``.  "softmax": SSD's heads (background column 0
    dropped); "sigmoid": RetinaNet's foreground logits.  The scores keep
    the logits' dtype until the rows are gathered, as in JAX.
    ``nms_method`` "sequential" is the form ``torch.export`` traces."""
    if score_activation not in ("softmax", "sigmoid"):
        raise ValueError(f"unknown score_activation {score_activation!r}")

    def postprocess(cls_logits: torch.Tensor, loc: torch.Tensor):
        if score_activation == "softmax":
            probs = torch.softmax(cls_logits, -1)[..., 1:]
        else:
            probs = torch.sigmoid(cls_logits)
        scores = probs.amax(-1)
        labels = probs.argmax(-1) + 1
        decoded = box_ops.decode_boxes(loc, anchors.to(loc.device)[None])
        decoded = torch.clamp(decoded, 0.0, 1.0)
        if pre_nms_topk and pre_nms_topk < scores.shape[1]:
            scores, idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
            scores, idx = scores[:, :pre_nms_topk], idx[:, :pre_nms_topk]
            decoded = torch.gather(decoded, 1,
                                   idx[..., None].expand(*idx.shape, 4))
            labels = torch.gather(labels, 1, idx)
        keep, valid = box_ops.batched_nms_batch(
            decoded, scores, labels, iou_threshold, max_detections,
            score_threshold, nms_method)
        return (torch.gather(decoded, 1,
                             keep[..., None].expand(*keep.shape, 4)),
                torch.gather(scores, 1, keep).float(),
                torch.gather(labels, 1, keep).to(torch.int32), valid)

    return postprocess


# -------------------------------------------------------------- the step


class DetectionTrainer:
    """A one-stage detector, its optimizer and its step: ``train_step(
    images_u8, gt_boxes, gt_labels)`` augments on the device, runs the
    train forward, the loss (``multibox_loss`` or the recipe's focal
    closure, ``loss_fn(cls, loc, boxes, labels, anchors)``), backward
    and the optimizer; ``predict(images_u8)`` is the eval chain: B2's
    normalize, the eval forward, the post-process."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 anchors: torch.Tensor, loss_fn: Callable,
                 postprocess: Callable, *, augment: DetAugment | None,
                 mean, std, device: torch.device, policy: Policy,
                 seed: int = 0):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.anchors = anchors.to(self.device)
        self.loss_fn = loss_fn
        self.postprocess = postprocess
        self.augment = augment
        self.mean = torch.as_tensor(mean, dtype=torch.float32,
                                    device=self.device)
        self.std = torch.as_tensor(std, dtype=torch.float32,
                                   device=self.device)
        self.policy = policy
        self.seed = seed
        self.step = 0
        self._gen = torch.Generator(device=self.device)

    def sample(self, n: int) -> DetDraws | None:
        """This step's draws, a function of (seed, step)."""
        if self.augment is None:
            return None
        self._gen.manual_seed((self.seed << 32) + self.step)
        return sample_draws(self._gen, n, self.augment)

    def _input(self, images, boxes, labels, draws):
        if self.augment is None:
            return preprocess_batch(images, self.mean, self.std), boxes, \
                labels
        return augment_detection_batch(images, boxes.float(), labels,
                                       self.augment, draws)

    def loss(self, images, boxes, labels, draws=None):
        """(loss with its graph, metrics) of one batch, train mode."""
        if draws is None:
            draws = self.sample(images.shape[0])
        x, boxes, labels = self._input(images, boxes, labels, draws)
        self.model.train()
        cls_logits, loc = self.model(x.to(self.policy.compute_dtype))
        return self.loss_fn(cls_logits, loc, boxes, labels, self.anchors)

    def train_step(self, images: torch.Tensor, boxes: torch.Tensor,
                   labels: torch.Tensor, draws: DetDraws | None = None
                   ) -> dict:
        """One step; the metrics as device tensors (no sync)."""
        self.optimizer.zero_grad()
        loss, metrics = self.loss(images, boxes, labels, draws)
        loss.backward()
        self.optimizer.step(self.step)
        self.step += 1
        return metrics

    @torch.no_grad()
    def forward_eval(self, x: torch.Tensor):
        """(cls, loc) of a normalized batch, eval mode (kernels on)."""
        self.model.eval()
        return self.model(x.to(self.policy.compute_dtype))

    @torch.no_grad()
    def predict(self, images: torch.Tensor):
        """The post-processed detections of a uint8 (or [0, 1] float)
        batch."""
        return self.postprocess(*self.forward_eval(
            preprocess_batch(images, self.mean, self.std)))

    def evaluate(self, batches: Iterable, evaluator) -> float:
        """Score (images, boxes, labels) batches: a short tail is padded to
        the first batch's size and its rows sliced back
        (``recipes/detection.py:528-556``)."""
        evaluator.reset()
        full = None
        try:
            for images, *targets in batches:
                n = images.shape[0]
                full = n if full is None else full
                if n < full:
                    images = torch.cat([images, images.new_zeros(
                        (full - n, *images.shape[1:]))])
                preds = [t[:n] for t in self.predict(images)]
                evaluator.update(preds, targets)
        finally:
            if hasattr(batches, "close"):
                batches.close()
        return evaluator.score()

    # ------------------------------------------------------ checkpoints

    def state(self) -> dict:
        """JAX's ``DetState._asdict()``: params, BN state, optimizer
        state, step, rng."""
        params, model_state = weights.to_jax(self.model)
        return {"params": params, "state": model_state,
                "opt": weights.optimizer_to_jax(self.model, self.optimizer),
                "step": np.asarray(self.step, np.int32),
                "rng": rng_data(self.seed)}

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        weights.from_jax(self.model, state["params"], state["state"])
        weights.optimizer_from_jax(self.model, self.optimizer, state["opt"])
        self.step = int(state["step"])
        self.seed = seed_of(state["rng"])

    def save(self, directory: str, metric: float | None = None,
             is_best: bool = False) -> str:
        return ckpt_lib.save_checkpoint(directory, self.step, self.state(),
                                        keep=KEEP, metric=metric,
                                        is_best=is_best)

    def restore(self, path: str) -> None:
        """Load a checkpoint file, or the newest one in a directory."""
        self.load_state(ckpt_lib.restore_checkpoint(path, self.state()))
