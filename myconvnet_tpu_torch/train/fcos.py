"""FCOS training and post-process: anchor-free targets by broadcast
arithmetic, the focal / GIoU / centerness objective, the decode and NMS.

Port of ``myconvnet_tpu/train/fcos.py``, over a batch at once:

* ``fcos_targets`` (``:35``): a point is a candidate for a ground truth
  when it lies inside it and its longest distance falls in the level's
  band; the smallest-area candidate wins (the first of equal areas; a
  point with none takes row 0, as ``argmin`` over a row of inf), its
  distances, label and centerness gathered (JAX's one-hot einsum at
  ``precision="highest"``, an exact selection);
* ``decode_points`` (``:73``), ``_focal_bce`` (``:84``) and ``fcos_loss``
  (``:93``), in float32 whatever the heads' dtype, each term over the
  positive count;
* the step of ``make_fcos_step`` (``:135``) is
  ``train.detection.DetectionTrainer`` with :func:`fcos_loss` (family
  "fcos");
* ``make_fcos_postprocess`` (``:176``): sqrt(sigmoid(cls) *
  sigmoid(ctr)) scores, the best class, the clipped decode, the top 1000
  by a stable sort, class-aware NMS, the rows gathered.
"""

from __future__ import annotations

from typing import Callable

import torch

from myconvnet_tpu_torch.ops import boxes as box_ops
from myconvnet_tpu_torch.train.detection import _bce_logits


def fcos_targets(points: torch.Tensor, ranges: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_labels: torch.Tensor):
    """(points [L, 2], ranges [L, 2], gt_boxes [B, M, 4], gt_labels [B, M])
    -> (labels int32 [B, L] (0 background), dist_targets [B, L, 4],
    centerness [B, L], pos [B, L])."""
    px, py = points[:, 0:1], points[:, 1:2]                   # [L, 1]
    gx0, gy0, gx1, gy1 = (gt_boxes[..., k][:, None, :] for k in range(4))
    dist = torch.stack([px - gx0, py - gy0, gx1 - px, gy1 - py],
                       -1)                                    # [B, L, M, 4]
    inside = dist.amin(-1) > 0.0
    far = dist.amax(-1)
    in_band = (far > ranges[:, 0:1]) & (far <= ranges[:, 1:2])
    cand = inside & in_band & (gt_labels >= 1)[:, None, :]
    area = ((gt_boxes[..., 2] - gt_boxes[..., 0])
            * (gt_boxes[..., 3] - gt_boxes[..., 1]))          # [B, M]
    cost = torch.where(cand, area[:, None, :],
                       area.new_tensor(float("inf")))
    pick = cost.argmin(2)                                     # [B, L]
    pos = cand.any(2)
    d = torch.gather(dist, 2, pick[..., None, None].expand(
        *pick.shape, 1, 4))[:, :, 0]                          # [B, L, 4]
    lab = torch.gather(gt_labels.long(), 1, pick)
    labels = torch.where(pos, lab, torch.zeros_like(lab)).to(torch.int32)
    lr = torch.stack([d[..., 0], d[..., 2]], -1)
    tb = torch.stack([d[..., 1], d[..., 3]], -1)
    ctr = torch.sqrt(torch.clamp(
        (lr.amin(-1) / torch.clamp(lr.amax(-1), min=1e-9))
        * (tb.amin(-1) / torch.clamp(tb.amax(-1), min=1e-9)), 0.0, 1.0))
    return labels, d, torch.where(pos, ctr, ctr.new_zeros(())), pos


def decode_points(points: torch.Tensor, dists: torch.Tensor
                  ) -> torch.Tensor:
    """(points [..., 2], distances [..., 4] l, t, r, b) -> xyxy boxes."""
    return torch.stack(
        [points[..., 0] - dists[..., 0], points[..., 1] - dists[..., 1],
         points[..., 0] + dists[..., 2], points[..., 1] + dists[..., 3]],
        -1)


def _focal_bce(logits, onehot, alpha, gamma):
    p = torch.sigmoid(logits)
    ce = _bce_logits(logits, onehot)
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    a_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    return a_t * (1.0 - p_t) ** gamma * ce


def fcos_loss(cls_logits: torch.Tensor, ctr_logits: torch.Tensor,
              dists: torch.Tensor, points: torch.Tensor,
              ranges: torch.Tensor, gt_boxes: torch.Tensor,
              gt_labels: torch.Tensor, *, alpha: float = 0.25,
              gamma: float = 2.0, reg_weight: float = 1.0):
    """Focal CE over every point and class, 1 - GIoU and the centerness
    BCE over the positives, each over the positive count, in float32 ->
    (loss, metrics)."""
    cls_logits = cls_logits.float()
    ctr_logits = ctr_logits.float()
    dists = dists.float()
    with torch.no_grad():
        labels, d_tgt, ctr_tgt, pos = fcos_targets(points, ranges,
                                                   gt_boxes.float(),
                                                   gt_labels)
    f = cls_logits.shape[-1]
    classes = torch.arange(f, device=cls_logits.device)
    onehot = (((labels.long() - 1)[..., None] == classes)
              & pos[..., None]).float()
    n_pos = torch.clamp(pos.sum(), min=1).float()
    cls_loss = _focal_bce(cls_logits, onehot, alpha, gamma).sum() / n_pos
    zero = cls_logits.new_zeros(())
    pred_boxes = decode_points(points[None], dists)
    tgt_boxes = decode_points(points[None], d_tgt)
    giou = box_ops.aligned_giou(pred_boxes, tgt_boxes)
    reg_loss = torch.where(pos, 1.0 - giou, zero).sum() / n_pos
    ctr_loss = torch.where(pos, _bce_logits(ctr_logits, ctr_tgt),
                           zero).sum() / n_pos
    loss = cls_loss + reg_weight * reg_loss + ctr_loss
    return loss, {"loss": loss.detach(), "cls_loss": cls_loss.detach(),
                  "reg_loss": reg_loss.detach(),
                  "ctr_loss": ctr_loss.detach(), "n_pos": pos.sum()}


def make_fcos_postprocess(points: torch.Tensor, num_classes: int, *,
                          score_threshold: float = 0.05,
                          iou_threshold: float = 0.45,
                          max_detections: int = 100,
                          pre_nms_topk: int = 1000,
                          nms_method: str = "jacobi") -> Callable:
    """(cls [B, L, C - 1], ctr [B, L], dists [B, L, 4]) -> (boxes float32
    [B, D, 4], scores float32 [B, D], labels int32 [B, D], valid [B, D]);
    ``nms_method`` "sequential" is the form ``torch.export`` traces."""

    def postprocess(cls_logits, ctr_logits, dists):
        probs = torch.sigmoid(cls_logits)
        ctr = torch.sigmoid(ctr_logits)[..., None]
        scored = torch.sqrt(torch.clamp(probs * ctr, 1e-12, 1.0))
        scores = scored.amax(-1)
        labels = scored.argmax(-1) + 1
        decoded = torch.clamp(decode_points(
            points.to(dists.device)[None], dists), 0.0, 1.0)
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
