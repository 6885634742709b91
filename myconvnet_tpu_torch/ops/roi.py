"""Region-of-interest ops of the two-stage detectors: RoIAlign as matrix
products, fixed-count proposals, the train-time RoI subsample.

Port of ``myconvnet_tpu/ops/roi.py:35-209``, over a batch at once (JAX
vmaps each function over the images):

* ``_pooled_axis_weights`` (``:35``) and ``roi_align`` (``:59``): each
  RoI's 7x7 crop is two products against per-RoI interpolation weights
  [P, bins, size] of one axis (2 taps a bin at torchvision's
  ``aligned=True`` positions, clamped to the border, averaged into the
  matrix), rows then columns.  The weights are float32 and a bf16 map is
  read as float32, so the crops are float32 as JAX's einsum promotes them.
  The images and RoIs of a level go through one batched product; the RoIs
  are cut into chunks only as far as :data:`ROI_ALIGN_BYTES` bounds the
  [B, chunk, bins, W, C] intermediate (``chunk`` RoIs an image at the
  least: JAX's ``roi_chunk``, which moves no result);
* ``assign_levels`` (``:91``) and ``multilevel_roi_align`` (``:103``):
  crops on every level, blended by the one-hot of each RoI's level;
* ``generate_proposals`` (``:123``): sigmoid scores, the unit-variance
  decode clipped to the frame, the top ``pre_topk`` by a stable sort
  (``lax.top_k``'s lowest-index rule), NMS (``ops.boxes``; ``method``
  "sequential" is the fixed-trip form ``torch.export`` traces) to a fixed
  ``post_count`` with a ``valid`` mask, invalid rows zeroed;
* ``match_and_sample_rois`` (``:153``): ground truths appended to the
  proposals, best-IoU matching, ``num_samples`` RoIs by one stable top-k
  over boosted priorities (the foreground within its quota ranked by a
  stable double argsort).  The uniform priorities ``rand`` [B, P + M] are
  the caller's draws (JAX's ``jax.random.uniform(key, (P + M,))``), so a
  test hands JAX's over.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch.ops import boxes as box_ops

# the most bytes one level's [B, chunk, bins, W, C] float32 intermediate
# may take before the RoIs are cut into chunks
ROI_ALIGN_BYTES = 1 << 30


def _pooled_axis_weights(lo: torch.Tensor, hi: torch.Tensor, size: int,
                         bins: int, samples: int = 2) -> torch.Tensor:
    """Interpolation weights [..., bins, size] of one axis for RoI extents
    ``lo``/``hi`` [...] (normalized): each bin the mean of ``samples``
    bilinear taps, the sample positions clamped to [0, size - 1]."""
    dev = lo.device
    span = (hi - lo) * size
    bw = span / bins
    offs = (torch.arange(bins, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(samples, dtype=torch.float32, device=dev)[None]
               + 0.5) / samples)                              # [bins, S]
    pos = lo[..., None, None] * size + offs * bw[..., None, None] - 0.5
    pos = torch.clamp(pos, 0.0, size - 1.0)                   # [..., bins, S]
    grid = torch.arange(size, dtype=pos.dtype, device=dev)
    w = torch.clamp(1.0 - (pos[..., None] - grid).abs(), min=0.0)
    return w.mean(-2)                                         # [..., bins, size]


def roi_align(feats: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              samples: int = 2, chunk: int = 128) -> torch.Tensor:
    """RoIAlign of one level: feats [B, H, W, C], rois [B, P, 4] normalized
    xyxy -> float32 crops [B, P, out_size, out_size, C]."""
    b, h, w, c = feats.shape
    p = rois.shape[1]
    f = feats.float()
    rois = rois.float()
    per_roi = b * out_size * w * c * 4
    step = min(p, max(chunk, ROI_ALIGN_BYTES // per_roi))
    out = []
    for lo in range(0, p, step):
        r = rois[:, lo:lo + step]
        n = r.shape[1]
        rw = _pooled_axis_weights(r[..., 1], r[..., 3], h, out_size,
                                  samples)                    # [B, n, o, H]
        cw = _pooled_axis_weights(r[..., 0], r[..., 2], w, out_size,
                                  samples)                    # [B, n, o, W]
        t = torch.bmm(rw.reshape(b, n * out_size, h), f.reshape(b, h, w * c))
        t = t.reshape(b * n, out_size, w, c)                  # rows done
        crop = torch.matmul(cw.reshape(b * n, 1, out_size, w), t)
        out.append(crop.reshape(b, n, out_size, out_size, c))
    return out[0] if len(out) == 1 else torch.cat(out, 1)


def assign_levels(rois: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Each RoI's FPN level (an image-sized RoI the top one, each halving
    of sqrt(area) a level down): rois [..., 4] -> int64 [...]."""
    wh = torch.clamp(rois[..., 2:] - rois[..., :2], min=0.0)
    scale = torch.sqrt(wh[..., 0] * wh[..., 1])
    lvl = (num_levels - 1) + torch.log2(torch.clamp(scale, min=1e-6))
    return torch.clamp(torch.floor(lvl + 0.5), 0, num_levels - 1).long()


def multilevel_roi_align(feats: list[torch.Tensor], rois: torch.Tensor,
                         out_size: int = 7, samples: int = 2,
                         chunk: int = 128) -> torch.Tensor:
    """RoIAlign over a pyramid: every level's crops, blended by the
    one-hot (in the maps' dtype) of :func:`assign_levels`."""
    lvl = assign_levels(rois, len(feats))
    out = None
    for li, f in enumerate(feats):
        crop = roi_align(f, rois, out_size, samples, chunk)
        wgt = (lvl == li).to(f.dtype)[..., None, None, None]
        out = crop * wgt if out is None else out + crop * wgt
    return out


def generate_proposals(objectness: torch.Tensor, deltas: torch.Tensor,
                       anchors: torch.Tensor, *, pre_topk: int = 2000,
                       post_count: int = 1000, nms_iou: float = 0.7,
                       min_size: float = 0.0, method: str = "jacobi"):
    """RPN outputs -> fixed-count proposals of each image: objectness
    [B, A] logits, deltas [B, A, 4], anchors [A, 4] -> (boxes [B,
    post_count, 4] clipped xyxy, scores [B, post_count], valid [B,
    post_count]); rows past an image's kept count are zero."""
    scores = torch.sigmoid(objectness)
    boxes = box_ops.decode_boxes(deltas, anchors[None],
                                 variances=(1.0, 1.0))
    boxes = torch.clamp(boxes, 0.0, 1.0)
    if min_size > 0.0:
        wh = boxes[..., 2:] - boxes[..., :2]
        keep = (wh[..., 0] >= min_size) & (wh[..., 1] >= min_size)
        scores = torch.where(keep, scores, torch.zeros_like(scores))
    k = min(pre_topk, scores.shape[1])
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))
    sel, valid = box_ops.nms_batch(top_boxes, top_scores, nms_iou,
                                   post_count, method=method)
    picked = torch.gather(top_boxes, 1, sel[..., None].expand(*sel.shape, 4))
    return (picked * valid[..., None],
            torch.gather(top_scores, 1, sel) * valid, valid)


def _stable_top(prio: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values and indices, equal values
    in index order."""
    vals, idx = torch.sort(prio, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def quota_sample(rand: torch.Tensor, fg: torch.Tensor, bg: torch.Tensor,
                 num_samples: int, fg_fraction: float):
    """The boosted-priority subsample of ``rcnn.py:61-69`` and
    ``roi.py:189-196``: at most round(num_samples * fg_fraction)
    foreground (the first by ``rand``), background after, -> (indices [...,
    num_samples], valid [..., num_samples])."""
    n_fg_max = int(round(num_samples * fg_fraction))
    neg_inf = rand.new_tensor(-float("inf"))
    fg_rand = torch.where(fg, rand, neg_inf)
    order = torch.argsort(-fg_rand, dim=-1, stable=True)
    fg_rank = torch.argsort(order, dim=-1)                    # 0 = first
    prio = torch.where(fg & (fg_rank < n_fg_max), rand + 2.0,
                       torch.where(bg, rand, neg_inf))
    vals, sel = _stable_top(prio, num_samples)
    return sel, vals > -float("inf")


def match_and_sample_rois(rand: torch.Tensor, proposals: torch.Tensor,
                          prop_valid: torch.Tensor, gt_boxes: torch.Tensor,
                          gt_labels: torch.Tensor, *, num_samples: int = 512,
                          fg_fraction: float = 0.25, fg_iou: float = 0.5,
                          bg_iou_hi: float = 0.5, bg_iou_lo: float = 0.0):
    """The second stage's training subsample of each image: rand [B, P + M]
    uniform priorities, proposals [B, P, 4], prop_valid [B, P], gt_boxes
    [B, M, 4], gt_labels [B, M] (-1 padding) -> (rois [B, S, 4], labels
    int32 [B, S] (0 background), reg_targets [B, S, 4], pos [B, S], valid
    [B, S], matched_gt int32 [B, S])."""
    gt_valid = gt_labels >= 0
    cand = torch.cat([proposals, gt_boxes.to(proposals.dtype)], 1)
    cand_valid = torch.cat([prop_valid, gt_valid], 1)
    iou = box_ops.box_iou(cand, gt_boxes)                     # [B, P+M, M]
    iou = torch.where(gt_valid[:, None, :], iou, iou.new_tensor(-1.0))
    best_iou = torch.clamp(iou.amax(2), min=0.0)
    best_gt = iou.argmax(2)
    fg = cand_valid & (best_iou >= fg_iou)
    bg = cand_valid & (best_iou < bg_iou_hi) & (best_iou >= bg_iou_lo)
    sel, valid = quota_sample(rand, fg, bg, num_samples, fg_fraction)

    rois = torch.gather(cand, 1, sel[..., None].expand(*sel.shape, 4))
    pos = torch.gather(fg, 1, sel) & valid
    matched_gt = torch.gather(best_gt, 1, sel)
    labels_all = torch.gather(torch.clamp(gt_labels, min=0).long(), 1,
                              matched_gt)
    labels = torch.where(pos, labels_all, torch.zeros_like(labels_all)).to(
        torch.int32)
    matched_boxes = torch.gather(
        gt_boxes, 1, matched_gt[..., None].expand(*matched_gt.shape, 4))
    full = rois.new_tensor([0.0, 0.0, 1.0, 1.0])
    safe_rois = torch.where(valid[..., None], rois, full)
    targets = box_ops.encode_boxes(matched_boxes, safe_rois)
    targets = torch.where(pos[..., None], targets, targets.new_zeros(()))
    return rois, labels, targets, pos, valid, matched_gt.to(torch.int32)
