"""Detection test-time augmentation: horizontal-flip averaging.

Port of ``myconvnet_tpu/eval/det_tta.py``: the predict chain runs on the
images and on their mirror, the mirrored detections are mapped back (x1'
= 1 - x2, x2' = 1 - x1), and the two padded sets merge by one more
class-aware NMS over the 2D candidates (invalid rows at the finite
sentinel -1e9, below the merge's -1e8 floor), the rows gathered.  A
library API, as in JAX: no entry point calls it.
"""

from __future__ import annotations

from typing import Callable

import torch

from myconvnet_tpu_torch.ops import boxes as box_ops


def flip_boxes_x(boxes: torch.Tensor) -> torch.Tensor:
    """Mirror xyxy boxes horizontally in normalized coordinates."""
    return torch.stack([1.0 - boxes[..., 2], boxes[..., 1],
                        1.0 - boxes[..., 0], boxes[..., 3]], -1)


def make_flip_tta(predict: Callable, *, iou_threshold: float = 0.5,
                  max_detections: int | None = None) -> Callable:
    """``predict(images [B, H, W, C]) -> (boxes [B, D, 4], scores, labels,
    valid)`` -> ``tta(images)`` with the same outputs (D' =
    ``max_detections`` or D)."""

    def tta(images):
        b1, s1, l1, v1 = predict(images)
        b2, s2, l2, v2 = predict(images.flip(2))
        boxes = torch.cat([b1, flip_boxes_x(b2)], 1)         # [B, 2D, 4]
        scores = torch.cat([s1, s2], 1)
        labels = torch.cat([l1, l2], 1)
        valid = torch.cat([v1, v2], 1)
        scores = torch.where(valid, scores, scores.new_tensor(-1e9))
        keep, ok = box_ops.batched_nms_batch(
            boxes, scores, labels, iou_threshold,
            max_detections or b1.shape[1], -1e8)
        out_s = torch.gather(scores, 1, keep)
        return (torch.gather(boxes, 1, keep[..., None].expand(
            *keep.shape, 4)), torch.where(ok, out_s, out_s.new_zeros(())),
            torch.gather(labels, 1, keep).to(torch.int32), ok)

    return tta
