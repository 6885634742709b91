"""Evaluators and ``decode_predictions``.

Port of ``myconvnet_tpu/eval/evaluators.py``: the ``Evaluator`` interface
(``score``/``is_better``/``worst_score``), ``AccuracyEvaluator``
(``:86-109``, top-k over the last axis, counted on the logits' device)
and ``decode_predictions``.
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
        labels = torch.as_tensor(labels, device=logits.device).long()
        flat = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1, 1)
        if self.k == 1:  # argmax takes the first of tied maxima, as JAX
            hit = flat.argmax(dim=-1, keepdim=True) == labels
        else:
            hit = (flat.topk(self.k, dim=-1).indices == labels).any(dim=-1)
        self._correct += int(hit.sum())
        # element count, not batch size: spatial labels score per pixel
        self._total += labels.numel()

    def score(self) -> float:
        return self._correct / max(self._total, 1)


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
