"""Evaluators and ``decode_predictions``.

Port of ``myconvnet_tpu/eval/evaluators.py``: the ``Evaluator`` interface
(``score``/``is_better``/``worst_score``), ``top_k_correct`` (``:21``) and
``AccuracyEvaluator`` (``:86-109``, top-k over the last axis, counted on
the logits' device), ``ConfusionMatrixEvaluator`` (``:151``, with its
report) and ``JointEvaluator`` (``:243``),
segmentation's ``confusion_matrix``, ``miou_from_confusion`` and
``pixel_accuracy_from_confusion`` (``:36-60``) with ``MeanIoUEvaluator``
(``:118-146``), and ``decode_predictions``.

The confusion counts are int64, made by one ``torch.bincount`` on the
predictions' device and copied to the host once a batch; JAX's float32
one-hot product gives the same counts below 2^24 pixels a batch.  The
scores are float64 numpy over the counts.
"""

from __future__ import annotations

import numpy as np
import torch


class Evaluator:
    """Accumulate batches -> score() -> is_better(curr, best)."""

    name = "metric"
    higher_is_better = True

    def reset(self) -> None:
        raise NotImplementedError

    def update(self, outputs, labels) -> None:
        raise NotImplementedError

    def score(self) -> float:
        raise NotImplementedError

    def worst_score(self) -> float:
        return -np.inf if self.higher_is_better else np.inf

    def is_better(self, curr: float, best: float) -> bool:
        return curr > best if self.higher_is_better else curr < best


class AccuracyEvaluator(Evaluator):
    name = "accuracy"

    def __init__(self, k: int = 1):
        self.k = k
        if k > 1:
            self.name = f"top{k}_accuracy"
        self.reset()

    def reset(self):
        self._correct = 0
        self._total = 0

    def update(self, logits, labels):
        logits = torch.as_tensor(logits)
        self._correct += int(top_k_correct(logits, labels, self.k))
        # element count, not batch size: spatial labels score per pixel
        self._total += int(np.prod(np.shape(labels)))

    def score(self) -> float:
        return self._correct / max(self._total, 1)


def top_k_correct(logits: torch.Tensor, labels, k: int = 1) -> torch.Tensor:
    """The number of top-k-correct predictions (an int64 scalar on the
    logits' device); spatial logits count per element."""
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels, device=logits.device).long()
    flat = logits.reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1, 1)
    if k == 1:  # argmax takes the first of tied maxima, as JAX
        hit = flat.argmax(dim=-1, keepdim=True) == labels
    else:
        hit = (flat.topk(k, dim=-1).indices == labels).any(dim=-1)
    return hit.sum()


def confusion_matrix(pred: torch.Tensor, labels: torch.Tensor,
                     num_classes: int, ignore_label: int | None = None
                     ) -> torch.Tensor:
    """[C, C] int64 counts on ``pred``'s device (rows = truth).  A label
    outside [0, C) (``ignore_label`` among them) counts nowhere, as JAX's
    all-zero one-hot row."""
    labels = torch.as_tensor(labels, device=pred.device).reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (labels >= 0) & (labels < num_classes)
    if ignore_label is not None:
        valid &= labels != ignore_label
    idx = (labels * num_classes + pred)[valid]
    return torch.bincount(idx, minlength=num_classes * num_classes
                          ).reshape(num_classes, num_classes)


def miou_from_confusion(cm) -> float:
    """Mean IoU over the classes present in the truth."""
    cm = np.asarray(cm, np.float64)
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    iou = inter / np.maximum(union, 1.0)
    present = (cm.sum(1) > 0).astype(np.float64)
    return float((iou * present).sum() / max(present.sum(), 1.0))


def pixel_accuracy_from_confusion(cm) -> float:
    cm = np.asarray(cm, np.float64)
    return float(np.diag(cm).sum() / max(cm.sum(), 1.0))


class MeanIoUEvaluator(Evaluator):
    name = "miou"

    def __init__(self, num_classes: int, ignore_label: int | None = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.reset()

    def reset(self):
        self._cm = np.zeros((self.num_classes, self.num_classes), np.int64)

    def update(self, logits_or_pred, labels):
        """[N, H, W, C] logits (argmax taken) or [N, H, W] predictions."""
        arr = torch.as_tensor(logits_or_pred)
        pred = arr.argmax(dim=-1) if arr.dim() == 4 else arr
        self._cm += confusion_matrix(pred, labels, self.num_classes,
                                     self.ignore_label).cpu().numpy()

    def score(self) -> float:
        return miou_from_confusion(self._cm)

    def pixel_accuracy(self) -> float:
        return pixel_accuracy_from_confusion(self._cm)

    def per_class_iou(self) -> np.ndarray:
        """[C] IoU per class (NaN for classes absent from the truth)."""
        cm = self._cm.astype(np.float64)
        inter = np.diag(cm)
        union = cm.sum(0) + cm.sum(1) - inter
        present = cm.sum(1) > 0
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        return np.where(present, iou, np.nan)


class ConfusionMatrixEvaluator(Evaluator):
    """Classification accuracy over the full confusion matrix, with the
    per-class precision/recall/F1 report (``evaluators.py:151-240``)."""

    name = "accuracy"

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self._cm = np.zeros((self.num_classes, self.num_classes), np.int64)

    def update(self, logits, labels):
        arr = torch.as_tensor(logits)
        labels = torch.as_tensor(labels, device=arr.device)
        pred = arr.argmax(dim=-1) if arr.dim() > labels.dim() else arr
        self._cm += confusion_matrix(pred, labels,
                                     self.num_classes).cpu().numpy()

    def score(self) -> float:
        return float(self._cm.trace() / max(self._cm.sum(), 1.0))

    @property
    def matrix(self) -> np.ndarray:
        """[C, C] counts, rows = truth, columns = prediction."""
        return self._cm.astype(np.float64)

    def per_class(self) -> dict[str, np.ndarray]:
        """precision/recall/f1/support [C]; zero where a class has no
        predictions or no truth."""
        cm = self._cm.astype(np.float64)
        tp = np.diag(cm)
        pred_tot, true_tot = cm.sum(0), cm.sum(1)
        precision = np.where(pred_tot > 0, tp / np.maximum(pred_tot, 1e-12),
                             0.0)
        recall = np.where(true_tot > 0, tp / np.maximum(true_tot, 1e-12),
                          0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall
                      / np.maximum(precision + recall, 1e-12), 0.0)
        return {"precision": precision, "recall": recall, "f1": f1,
                "support": true_tot}

    def macro_f1(self) -> float:
        pc = self.per_class()
        present = pc["support"] > 0
        return float(pc["f1"][present].mean()) if present.any() else 0.0

    def report(self, class_names: list[str] | None = None) -> str:
        """sklearn-style per-class text report."""
        pc = self.per_class()
        names = class_names or [str(i) for i in range(self.num_classes)]
        width = max(12, max(len(n) for n in names) + 2)
        lines = [f"{'':<{width}}{'precision':>10}{'recall':>10}"
                 f"{'f1':>10}{'support':>10}"]
        for i, n in enumerate(names):
            lines.append(
                f"{n:<{width}}{pc['precision'][i]:>10.4f}"
                f"{pc['recall'][i]:>10.4f}{pc['f1'][i]:>10.4f}"
                f"{int(pc['support'][i]):>10d}")
        lines.append(f"{'accuracy':<{width}}{'':>10}{'':>10}"
                     f"{self.score():>10.4f}{int(self._cm.sum()):>10d}")
        lines.append(f"{'macro f1':<{width}}{'':>10}{'':>10}"
                     f"{self.macro_f1():>10.4f}{'':>10}")
        return "\n".join(lines)


class JointEvaluator(Evaluator):
    """One stream of updates into several evaluators: the first is primary
    (its score and direction), ``report()`` comes from the first member
    after it that has one, then from the first."""

    def __init__(self, *members: Evaluator):
        if not members:
            raise ValueError("JointEvaluator needs at least one member")
        self.members = members
        self.name = members[0].name
        self.higher_is_better = members[0].higher_is_better

    def reset(self):
        for m in self.members:
            m.reset()

    def update(self, outputs, labels):
        for m in self.members:
            m.update(outputs, labels)

    def score(self) -> float:
        return self.members[0].score()

    def report(self, class_names=None) -> str:
        for m in self.members[1:] + self.members[:1]:
            if hasattr(m, "report"):
                return m.report(class_names)
        raise AttributeError("no member evaluator exposes report()")


def softmax(logits: np.ndarray) -> np.ndarray:
    z = np.asarray(logits, np.float32)
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def decode_predictions(logits, class_names: list[str], top: int = 5
                       ) -> list[list[tuple[str, float]]]:
    """Human-readable top-k: [[(class_name, prob), ...] per image]."""
    out = []
    for row in softmax(logits):
        idx = np.argsort(row)[::-1][:top]
        out.append([(class_names[i], float(row[i])) for i in idx])
    return out
