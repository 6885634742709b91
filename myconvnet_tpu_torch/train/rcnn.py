"""Faster R-CNN training and post-process: the RPN and RoI-head losses and
the two-stage decode and NMS.

Port of the box-level half of ``myconvnet_tpu/train/rcnn.py`` (the mask,
panoptic and keypoint parts wait for ROADMAP A17c(iii)):

* ``rpn_loss`` (``:44``): anchors matched in RetinaNet's band
  (``train.detection.match_anchors_band`` at 0.7 / 0.3), ``num_samples``
  anchors an image at most half foreground by the boosted-priority top-k
  (``ops.roi.quota_sample``) over the caller's uniform priorities
  ``rand`` [B, A] (JAX's ``jax.random.uniform`` of each image's key), the
  objectness BCE over the sampled anchors and smooth-L1 of the
  unit-variance targets (detached) at the sampled positives, both over
  the sample count;
* ``roi_head_loss`` (``:94``): softmax CE over the valid RoIs, smooth-L1
  of the target class's deltas (the targets detached) at the positives,
  over the valid count;
* the step of ``make_rcnn_step`` (``:140``) is
  ``train.detection.DetectionTrainer`` (family "two_stage"): the train
  forward with the ground truth and the RoI priorities, then
  ``rpn_loss + roi_head_loss``;
* ``make_rcnn_postprocess`` (``:562``): softmax over the head, each
  class's deltas decoded against its RoI, the [S, C - 1] candidates
  flattened, the top 1000 by a stable sort, class-aware NMS, the rows
  gathered.

The losses keep the heads' dtype, as JAX's do.
"""

from __future__ import annotations

from typing import Callable

import torch

from myconvnet_tpu_torch.ops import boxes as box_ops
from myconvnet_tpu_torch.ops.roi import quota_sample
from myconvnet_tpu_torch.train.detection import (_bce_logits, _smooth_l1,
                                                 match_anchors_band)


def rpn_loss(rand: torch.Tensor, rpn_logits: torch.Tensor,
             rpn_loc: torch.Tensor, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, anchors: torch.Tensor, *,
             num_samples: int = 256, fg_fraction: float = 0.5,
             pos_iou: float = 0.7, neg_iou: float = 0.3):
    """RPN objectness and box loss: rand [B, A], rpn_logits [B, A],
    rpn_loc [B, A, 4], gt_boxes [B, M, 4], gt_labels [B, M] (-1 padding),
    anchors [A, 4] -> (loss, metrics)."""
    with torch.no_grad():
        m_boxes, _, positive, ignore = match_anchors_band(
            anchors, gt_boxes, gt_labels, pos_iou, neg_iou)
        negative = ~positive & ~ignore
        sel, sel_valid = quota_sample(rand, positive, negative, num_samples,
                                      fg_fraction)
    z = torch.gather(rpn_logits, 1, sel)
    is_pos = torch.gather(positive, 1, sel) & sel_valid
    y = is_pos.to(z.dtype)
    zero = z.new_zeros(())
    obj = torch.where(sel_valid, _bce_logits(z, y), zero)
    n_sampled = torch.clamp(sel_valid.sum(), min=1).to(z.dtype)
    obj_loss = obj.sum() / n_sampled
    with torch.no_grad():
        targets = box_ops.encode_boxes(m_boxes, anchors[None],
                                       variances=(1.0, 1.0))
        t_sel = torch.gather(targets, 1, sel[..., None].expand(
            *sel.shape, 4))
    l_sel = torch.gather(rpn_loc, 1, sel[..., None].expand(*sel.shape, 4))
    reg = _smooth_l1(l_sel - t_sel).sum(-1)
    reg_loss = torch.where(is_pos, reg, reg.new_zeros(())).sum() / n_sampled
    loss = obj_loss + reg_loss
    return loss, {"rpn_obj": obj_loss.detach(), "rpn_reg": reg_loss.detach(),
                  "rpn_pos": is_pos.sum()}


def roi_head_loss(roi_cls: torch.Tensor, roi_reg: torch.Tensor,
                  labels: torch.Tensor, targets: torch.Tensor,
                  pos: torch.Tensor, valid: torch.Tensor):
    """Second-stage loss: roi_cls [B, S, C], roi_reg [B, S, C, 4] and the
    forward's sampled labels, targets, pos and valid -> (loss,
    metrics)."""
    lab = labels.long()
    ce = -torch.gather(torch.log_softmax(roi_cls, -1), -1,
                       lab[..., None])[..., 0]
    n = torch.clamp(valid.sum(), min=1).to(roi_cls.dtype)
    cls_loss = torch.where(valid, ce, ce.new_zeros(())).sum() / n
    reg_t = torch.gather(roi_reg, 2, lab[..., None, None].expand(
        *lab.shape, 1, 4))[:, :, 0]                           # [B, S, 4]
    reg = _smooth_l1(reg_t - targets.detach()).sum(-1)
    reg_loss = torch.where(pos, reg, reg.new_zeros(())).sum() / n
    acc = valid & (roi_cls.argmax(-1) == lab)
    metrics = {"roi_cls": cls_loss.detach(), "roi_reg": reg_loss.detach(),
               "roi_acc": acc.sum() / n, "roi_pos": pos.sum()}
    return cls_loss + reg_loss, metrics


def make_rcnn_postprocess(num_classes: int, *,
                          score_threshold: float = 0.05,
                          iou_threshold: float = 0.5,
                          max_detections: int = 100,
                          pre_nms_topk: int = 1000,
                          nms_method: str = "jacobi") -> Callable:
    """``FRCNNOut`` of an eval forward -> (boxes float32 [B, D, 4], scores
    float32 [B, D], labels int32 [B, D], valid [B, D]); ``nms_method``
    "sequential" is the form ``torch.export`` traces."""

    def postprocess(out):
        rois, roi_valid = out.rois, out.roi_valid
        probs = torch.softmax(out.roi_cls, -1)[..., 1:]        # [B, S, F]
        deltas = out.roi_reg[..., 1:, :]                       # [B, S, F, 4]
        boxes = torch.clamp(box_ops.decode_boxes(deltas, rois[:, :, None]),
                            0.0, 1.0)
        b, s, f = probs.shape
        scores = torch.where(roi_valid[..., None], probs,
                             probs.new_zeros(()))
        flat_scores = scores.reshape(b, s * f)
        flat_boxes = boxes.reshape(b, s * f, 4)
        flat_labels = torch.arange(1, f + 1, dtype=torch.int32,
                                   device=probs.device).repeat(b, s)
        k = min(pre_nms_topk, s * f)
        top, idx = torch.sort(flat_scores, dim=1, descending=True,
                              stable=True)
        top, idx = top[:, :k], idx[:, :k]
        top_boxes = torch.gather(flat_boxes, 1,
                                 idx[..., None].expand(*idx.shape, 4))
        top_labels = torch.gather(flat_labels, 1, idx)
        keep, valid = box_ops.batched_nms_batch(
            top_boxes, top, top_labels, iou_threshold, max_detections,
            score_threshold, nms_method)
        return (torch.gather(top_boxes, 1,
                             keep[..., None].expand(*keep.shape, 4)),
                torch.gather(top, 1, keep).float(),
                torch.gather(top_labels, 1, keep), valid)

    return postprocess
