"""Port of ``myconvnet_tpu/eval/evaluators.decode_predictions``."""

from __future__ import annotations

import numpy as np


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
