"""Detection metrics: VOC mean average precision and COCO's sweep.

Port of ``myconvnet_tpu/eval/detection.py:22-228``: ``_iou_matrix``,
``average_precision`` (all-point or VOC2007's 11-point), and the
evaluators, which match on the host in numpy (the devkit's single argmax
over an image's real and ``difficult`` rows; a detection on a difficult
object is neither a TP nor an FP) and take the outputs of
``train.detection.make_postprocess`` as tensors or arrays.  The mask and
keypoint evaluators (``:230-430``) are ROADMAP A17c(iii).
"""

from __future__ import annotations

import numpy as np
import torch

from myconvnet_tpu_torch.eval.evaluators import Evaluator


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = a.float() if a.is_floating_point() else a
        return a.numpy()
    return np.asarray(a)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, M] IoU, numpy."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * \
        np.clip(x[:, 3] - x[:, 1], 0, None)  # noqa: E731
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      interpolation: str = "all") -> float:
    """AP from a PR curve (recall ascending)."""
    if interpolation == "11point":
        ap = 0.0
        for t in np.linspace(0.0, 1.0, 11):
            mask = recall >= t
            ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    # all-point: area under the monotone-precision envelope
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]
    steps = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[steps + 1] - r[steps]) * p[steps + 1]))


class MeanAPEvaluator(Evaluator):
    """mAP at a fixed IoU threshold (default 0.5 — PASCAL VOC).

    ``update(preds, targets)`` takes one batch:
      preds   = (boxes [B,D,4], scores [B,D], labels [B,D], valid [B,D])
                — the output of train/detection.make_postprocess;
      targets = (gt_boxes [B,M,4], gt_labels [B,M]) with label -1 padding.
    Labels share one id space (0 background, 1..C-1 foreground).
    """

    name = "mAP"
    # devkit matching (single argmax over real + ignore rows) unless a
    # subclass opts into pycocotools' real-gts-first order
    match_real_first = False

    def __init__(self, num_classes: int, iou_threshold: float = 0.5,
                 interpolation: str = "all"):
        if interpolation not in ("all", "11point"):
            raise ValueError(f"unknown interpolation {interpolation!r}; "
                             "valid: ['all', '11point']")
        self.num_classes = num_classes
        self.iou_threshold = iou_threshold
        self.interpolation = interpolation
        self.reset()

    def reset(self):
        self._dets: list[tuple] = []  # (img, label, score, box)
        self._gts: list[tuple] = []  # (img, label, box)
        self._n_img = 0

    def update(self, preds, targets):
        """Labels <= -2 in the targets mark VOC ``difficult`` objects
        (encoded -(class_id + 1), subsets/voc.py) — kept as ignore
        zones: a detection matched to one is neither TP nor FP."""
        boxes, scores, labels, valid = (_host(t) for t in preds)
        gt_boxes, gt_labels = (_host(t) for t in targets[:2])
        for b in range(boxes.shape[0]):
            img = self._n_img
            self._n_img += 1
            for d in range(boxes.shape[1]):
                if valid[b, d]:
                    self._dets.append((img, int(labels[b, d]),
                                       float(scores[b, d]), boxes[b, d]))
            for m in range(gt_boxes.shape[1]):
                lab = int(gt_labels[b, m])
                if lab >= 1:
                    self._gts.append((img, lab, gt_boxes[b, m], False))
                elif lab <= -2:  # difficult: -(class_id + 1)
                    self._gts.append((img, -lab - 1, gt_boxes[b, m],
                                      True))

    def per_class_ap(self, iou_threshold: float | None = None
                     ) -> dict[int, float]:
        """AP per foreground class that has ground truth (at
        ``iou_threshold``, defaulting to the evaluator's own)."""
        thr = self.iou_threshold if iou_threshold is None else iou_threshold
        aps = {}
        for c in range(1, self.num_classes):
            # gt rows are (img, lab, box, diff, *extra) — subclasses may
            # carry payload past the devkit fields (mask evaluators
            # append the instance id); same for det rows past index 3
            gts = [(g[0], g[2:]) for g in self._gts if g[1] == c]
            n_real = sum(1 for _, cand in gts if not cand[1])
            if not n_real:
                continue
            dets = sorted((d for d in self._dets if d[1] == c),
                          key=lambda d: -d[2])
            # per image: gt (box, diff, *extra) rows + matched flags
            by_img: dict[int, list] = {}
            for i, cand in gts:
                by_img.setdefault(i, []).append(cand)
            matched = {i: np.zeros(len(v), bool) for i, v in by_img.items()}
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            ign = np.zeros(len(dets), bool)
            for k, det in enumerate(dets):
                img = det[0]
                cand = by_img.get(img)
                if cand is None:
                    fp[k] = 1
                    continue
                ious = self._candidate_ious(det, cand)
                if self.match_real_first:
                    # pycocotools order: real gts absorb matches first;
                    # ignore rows only take leftovers.  Needed when the
                    # ignore-row similarity lives on a different scale
                    # than the real one (keypoint OKS vs the box-IoU
                    # fallback) — a single argmax would let an ignore
                    # row hijack a should-be TP.
                    real = np.asarray([not cc[1] for cc in cand])
                    riou = np.where(real, ious, -np.inf)
                    if real.any() and riou.max() >= thr:
                        best = int(np.argmax(riou))
                        if not matched[img][best]:
                            matched[img][best] = True
                            tp[k] = 1
                        else:
                            fp[k] = 1
                    elif (~real).any() and \
                            np.where(~real, ious, -np.inf).max() >= thr:
                        ign[k] = 1
                    else:
                        fp[k] = 1
                    continue
                best = int(np.argmax(ious))
                if ious[best] >= thr:
                    if cand[best][1]:          # difficult: devkit-style
                        ign[k] = 1             # ignore — no TP, no FP
                    elif not matched[img][best]:
                        matched[img][best] = True
                        tp[k] = 1
                    else:
                        fp[k] = 1
                else:
                    fp[k] = 1
            if not dets:
                aps[c] = 0.0
                continue
            keep = ~ign
            ctp, cfp = np.cumsum(tp[keep]), np.cumsum(fp[keep])
            recall = ctp / n_real
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            aps[c] = average_precision(recall, precision,
                                       self.interpolation)
        return aps

    def _candidate_ious(self, det: tuple, cand: list) -> np.ndarray:
        """IoU of one detection row against an image's candidate gt rows
        ((box, diff, *extra) tuples).  The box-overlap default; mask
        evaluators override this with mask overlap."""
        return _iou_matrix(det[3][None], np.stack([c[0] for c in cand]))[0]

    def score(self) -> float:
        aps = self.per_class_ap()
        return float(np.mean(list(aps.values()))) if aps else 0.0


class COCOMeanAPEvaluator(MeanAPEvaluator):
    """COCO-style mAP: AP averaged over IoU thresholds 0.50:0.05:0.95.

    Same accumulation as :class:`MeanAPEvaluator` (detections and ground
    truth are threshold-independent); only scoring re-runs the matching
    per threshold.  ``per_threshold()`` exposes the mAP curve — its 0.5
    entry equals the VOC number, the 0.75 entry is COCO's strict AP75.
    """

    name = "mAP@[.5:.95]"
    IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))

    def reset(self):
        super().reset()
        self._sweep_cache: tuple[tuple, dict] | None = None

    def per_threshold(self) -> dict[float, float]:
        """The mAP-vs-IoU curve.  The 10-threshold matching sweep is the
        expensive part, so it is cached per accumulation state — keyed
        on the accumulator sizes rather than an update-counter so that
        SUBCLASS update() overrides (mask/keypoint evaluators) also
        invalidate it; score() and a subsequent curve printout share
        one sweep."""
        key = (self._n_img, len(self._dets), len(self._gts))
        if self._sweep_cache is not None and \
                self._sweep_cache[0] == key:
            return self._sweep_cache[1]
        out = {}
        for t in self.IOU_THRESHOLDS:
            aps = self.per_class_ap(float(t))
            out[float(t)] = (float(np.mean(list(aps.values())))
                             if aps else 0.0)
        self._sweep_cache = (key, out)
        return out

    def score(self) -> float:
        per = self.per_threshold()
        return float(np.mean(list(per.values()))) if per else 0.0
