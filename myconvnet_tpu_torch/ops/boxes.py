"""Bounding-box ops for detection: IoU, encode/decode, anchors, NMS.

Port of ``myconvnet_tpu/ops/boxes.py``.  Boxes are ``[..., 4]`` in
normalized ``(x1, y1, x2, y2)`` order.  The anchor grids are host numpy
(cached), cell-major as the heads emit them; the specs ``SSD300_SPEC``,
``SSD512_SPEC`` and ``RETINA512_SPEC`` are this package's own copies.

NMS has no Pallas kernel in the JAX package (it is XLA), so it is plain
PyTorch here, with JAX's static output: ``[max_out]`` indices and a
``valid`` mask.  :func:`nms_batch` takes a batch of images at once:

* ``method="jacobi"`` is JAX's blocked fixpoint (``boxes.py:199-302``):
  candidates sorted by score (a stable sort, as ``jnp.argsort``), the
  suppression matrix cut into 128-wide blocks resolved in order, each
  block iterated to its fixpoint.  The loop is eager, so each block and
  each sweep asks the host whether to go on: one sync a sweep for the
  whole batch, counted by :func:`sync_count`.
* ``method="sequential"`` is the fixed-trip greedy sweep (``:305-327``):
  ``min(max_out, n)`` rounds of argmax-select and suppress, no host sync,
  so ``torch.export`` traces it whole.  Its kept set and order are the
  blocked form's; only the indices behind ``valid == False`` differ (0
  here, as JAX's sweep leaves them).

Ties follow JAX: ``jnp.maximum`` splits a tie's gradient in half, as
``torch.maximum`` does (``torch.clamp`` would not); the sort and the
top-k are stable (equal scores keep index order, ``lax.top_k``'s
lowest-index rule); ``argmax`` takes the first maximum.
"""

from __future__ import annotations

from functools import lru_cache
from math import sqrt

import numpy as np
import torch

_NMS_SYNCS = [0]   # host syncs of the blocked NMS since the last reset


def sync_count() -> int:
    """Host syncs the blocked NMS made since :func:`reset_sync_count`."""
    return _NMS_SYNCS[0]


def reset_sync_count() -> None:
    _NMS_SYNCS[0] = 0


def _synced(flag: torch.Tensor) -> bool:
    _NMS_SYNCS[0] += 1
    return bool(flag)


def _at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: a tie's gradient split in half."""
    return torch.maximum(x, x.new_tensor(lo))


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] xyxy -> [...] area (zero for a degenerate box)."""
    w = _at_least(boxes[..., 2] - boxes[..., 0], 0.0)
    h = _at_least(boxes[..., 3] - boxes[..., 1], 0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = _at_least(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / _at_least(union, 1e-9)


def aligned_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise generalized IoU of paired boxes [..., 4] -> [...]."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = _at_least(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    iou = inter / _at_least(union, 1e-9)
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    ewh = _at_least(erb - elt, 0.0)
    enclose = _at_least(ewh[..., 0] * ewh[..., 1], 1e-9)
    return iou - (enclose - union) / enclose


def _to_center(boxes: torch.Tensor):
    size = boxes[..., 2:] - boxes[..., :2]
    return boxes[..., :2] + 0.5 * size, size


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 variances: tuple[float, float] = (0.1, 0.2)
                 ) -> torch.Tensor:
    """xyxy boxes -> SSD regression targets against ``anchors``."""
    bc, bs = _to_center(boxes)
    ac, as_ = _to_center(anchors)
    as_ = _at_least(as_, 1e-9)
    txy = (bc - ac) / as_ / variances[0]
    twh = torch.log(_at_least(bs, 1e-9) / as_) / variances[1]
    return torch.cat([txy, twh], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 variances: tuple[float, float] = (0.1, 0.2)
                 ) -> torch.Tensor:
    """Inverse of :func:`encode_boxes`: regression output -> xyxy."""
    ac, as_ = _to_center(anchors)
    cxy = deltas[..., :2] * variances[0] * as_ + ac
    wh = torch.exp(deltas[..., 2:] * variances[1]) * as_
    return torch.cat([cxy - 0.5 * wh, cxy + 0.5 * wh], dim=-1)


# --------------------------------------------------------------- anchors

# (feature-map size, scale, next scale, aspect ratios): 8732 anchors
SSD300_SPEC = (
    (38, 0.10, 0.20, (2.0,)),
    (19, 0.20, 0.37, (2.0, 3.0)),
    (10, 0.37, 0.54, (2.0, 3.0)),
    (5, 0.54, 0.71, (2.0, 3.0)),
    (3, 0.71, 0.88, (2.0,)),
    (1, 0.88, 1.05, (2.0,)),
)
# the paper's larger model: 24564 anchors
SSD512_SPEC = (
    (64, 0.04, 0.10, (2.0,)),
    (32, 0.10, 0.26, (2.0, 3.0)),
    (16, 0.26, 0.42, (2.0, 3.0)),
    (8, 0.42, 0.58, (2.0, 3.0)),
    (4, 0.58, 0.74, (2.0, 3.0)),
    (2, 0.74, 0.90, (2.0,)),
    (1, 0.90, 1.06, (2.0,)),
)
# (feature-map size, base size, octaves, ratios) of RetinaNet's P3-P7 at a
# 512 input: 9 anchors a cell, 49104 in all
RETINA512_SPEC = tuple(
    (fm, base, (0.0, 1 / 3, 2 / 3), (0.5, 1.0, 2.0))
    for fm, base in ((64, 0.0625), (32, 0.125), (16, 0.25),
                     (8, 0.5), (4, 1.0)))


def _cell_grid(fm: int, whs) -> np.ndarray:
    """One level's anchors [fm * fm * len(whs), 4], cell-major (row, col,
    variant): a head's [H, W, a * k] output reshaped to [H * W * a, k]
    lines up with it."""
    centers = (np.arange(fm, dtype=np.float32) + 0.5) / fm
    cx, cy = np.meshgrid(centers, centers)
    cxy = np.stack([cx, cy], axis=-1)[:, :, None, :]
    wh = np.asarray(whs, np.float32)[None, None, :, :]
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=-1).reshape(
        -1, 4)


@lru_cache(maxsize=8)
def ssd_anchors(spec=SSD300_SPEC, clip: bool = True) -> np.ndarray:
    """SSD anchor grid [A, 4]: per cell an s x s square, a sqrt(s s')
    square and a +-aspect pair per ratio."""
    out = []
    for fm, s, s_next, ratios in spec:
        whs = [(s, s), (sqrt(s * s_next),) * 2]
        for r in ratios:
            whs.append((s * sqrt(r), s / sqrt(r)))
            whs.append((s / sqrt(r), s * sqrt(r)))
        out.append(_cell_grid(fm, whs))
    anchors = np.concatenate(out, axis=0).astype(np.float32)
    return np.clip(anchors, 0.0, 1.0) if clip else anchors


@lru_cache(maxsize=8)
def retina_anchors(spec=RETINA512_SPEC, clip: bool = False) -> np.ndarray:
    """FPN anchor grid [A, 4]: per cell ``base * 2^octave * (sqrt(r),
    1/sqrt(r))``, octave-major and ratio-minor, unclipped by default."""
    out = []
    for fm, base, octaves, ratios in spec:
        whs = [(base * 2.0 ** o * sqrt(r), base * 2.0 ** o / sqrt(r))
               for o in octaves for r in ratios]
        out.append(_cell_grid(fm, whs))
    anchors = np.concatenate(out, axis=0).astype(np.float32)
    return np.clip(anchors, 0.0, 1.0) if clip else anchors


# ------------------------------------------------------------------- NMS

BLOCK = 128   # the blocked NMS's block width


def nms_batch(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float = 0.45, max_out: int = 100,
              score_threshold: float = -float("inf"),
              method: str = "jacobi") -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of each image of a batch: boxes [B, N, 4], scores [B, N]
    -> (indices int64 [B, max_out], valid bool [B, max_out]).  Entries
    past an image's kept count have ``valid`` False."""
    if method == "sequential":
        return _nms_sequential(boxes, scores, iou_threshold, max_out,
                               score_threshold)
    if method != "jacobi":
        raise ValueError(f"unknown NMS method {method!r}; valid: ['jacobi', "
                         "'sequential']")
    bsz, n = scores.shape
    k = min(max_out, n)
    g = min(BLOCK, n)
    nb = -(-n // g)
    total = nb * g
    order = torch.argsort(-scores, dim=1, stable=True)
    s = torch.gather(scores, 1, order)
    sb = torch.gather(boxes, 1, order[..., None].expand(bsz, n, 4))
    live = s > score_threshold
    sup = torch.triu(box_iou(sb, sb) > iou_threshold, 1)
    if total > n:   # whole blocks: padding is dead and overlaps nothing
        live = torch.nn.functional.pad(live, (0, total - n))
        sup = torch.nn.functional.pad(sup, (0, total - n, 0, total - n))
        s = torch.nn.functional.pad(s, (0, total - n),
                                    value=-float("inf"))
    keep = torch.zeros_like(live)
    kept = torch.zeros(bsz, dtype=torch.int64, device=scores.device)
    for b in range(nb):
        if b and not _synced((kept < max_out).any()):
            break   # every image decided max_out keepers in its prefix
        lo, hi = b * g, (b + 1) * g
        # suppressed by the decided prefix (keep is False past it)
        blk_live = live[:, lo:hi] & ~(keep[:, :, None]
                                      & sup[:, :, lo:hi]).any(1)
        sup_blk = sup[:, lo:hi, lo:hi]
        kb = blk_live
        while True:   # the block's fixpoint (unique: strictly triangular)
            new = blk_live & ~(kb[:, :, None] & sup_blk).any(1)
            changed = _synced((new != kb).any())
            kb = new
            if not changed:
                break
        keep[:, lo:hi] = kb
        kept += kb.sum(1)
    masked = torch.where(keep, s, torch.full_like(s, -float("inf")))
    vals, pos = torch.sort(masked, dim=1, descending=True, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    valid = vals > -float("inf")
    idxs = torch.gather(torch.nn.functional.pad(order, (0, total - n)), 1,
                        pos)
    if k < max_out:
        idxs = torch.nn.functional.pad(idxs, (0, max_out - k))
        valid = torch.nn.functional.pad(valid, (0, max_out - k))
    return idxs, valid


def _nms_sequential(boxes, scores, iou_threshold, max_out,
                    score_threshold):
    """The fixed-trip greedy sweep, all images at once: ``min(max_out,
    n)`` rounds of select (the first maximum) and suppress, six ops a
    round (the exported graph holds them unrolled).  A box is alive only
    while its score passes ``score_threshold`` (so it is finite), so a
    round that finds none alive finds a maximum of -inf and suppresses
    nothing more: JAX's ``& ok`` is implied."""
    bsz, n = scores.shape
    dev = scores.device
    # row j of an image: what keeping box j removes (the boxes it
    # overlaps, and j), the images' rows stacked for one index_select
    kills = ((box_iou(boxes, boxes) > iou_threshold) | torch.eye(
        n, dtype=torch.bool, device=dev)).reshape(bsz * n, n)
    first = torch.arange(bsz, device=dev) * n
    alive = scores > score_threshold
    neg = torch.full_like(scores, -float("inf"))
    idxs, valid = [], []
    for _ in range(min(max_out, n)):
        top, best = torch.where(alive, scores, neg).max(1)
        idxs.append(best)
        valid.append(top > -float("inf"))
        # alive and not killed (bools: True > False only)
        alive = alive > kills.index_select(0, first + best)
    short = max_out - len(idxs)
    idxs = torch.nn.functional.pad(torch.stack(idxs, 1), (0, short))
    valid = torch.nn.functional.pad(torch.stack(valid, 1), (0, short))
    return idxs, valid


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.45, max_out: int = 100,
        score_threshold: float = -float("inf"), method: str = "jacobi"
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One image: boxes [N, 4], scores [N] -> (indices [max_out], valid
    [max_out]) (:func:`nms_batch`)."""
    idx, valid = nms_batch(boxes[None], scores[None], iou_threshold,
                           max_out, score_threshold, method)
    return idx[0], valid[0]


def batched_nms_batch(boxes: torch.Tensor, scores: torch.Tensor,
                      labels: torch.Tensor, iou_threshold: float = 0.45,
                      max_out: int = 100,
                      score_threshold: float = -float("inf"),
                      method: str = "jacobi"):
    """Class-aware NMS of each image: each label's boxes are offset into
    a region of their own (4 * label), then one plain NMS."""
    offsets = labels.to(boxes.dtype)[..., None] * 4.0
    return nms_batch(boxes + offsets, scores, iou_threshold, max_out,
                     score_threshold, method)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, iou_threshold: float = 0.45,
                max_out: int = 100,
                score_threshold: float = -float("inf"),
                method: str = "jacobi"):
    """One image's class-aware NMS (:func:`batched_nms_batch`)."""
    idx, valid = batched_nms_batch(boxes[None], scores[None], labels[None],
                                   iou_threshold, max_out, score_threshold,
                                   method)
    return idx[0], valid[0]
