"""Optical-flow metrics.

Port of ``myconvnet_tpu/eval/flow.py``: average end-point error (AEPE) and
the KITTI outlier fraction Fl (EPE > 3 px and > 5% of the ground truth's
magnitude), plus the < 1 px and < 3 px inlier rates; per-image means
averaged over images, in float64 numpy on the host.  Pixels whose ground
truth has a NaN component (the .flo unknown sentinel) are left out.
"""

from __future__ import annotations

import numpy as np
import torch

from myconvnet_tpu_torch.eval.evaluators import Evaluator


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float64)


class FlowEvaluator(Evaluator):
    """Streaming AEPE / Fl metrics.  ``update(preds, labels)``: both
    ``[N, H, W, 2]`` pixel flows (tensors or arrays).  ``metric`` picks
    the headline, ``epe`` or ``fl``; both are lower-is-better."""

    name = "flow"
    higher_is_better = False

    def __init__(self, metric: str = "epe"):
        if metric not in ("epe", "fl"):
            raise ValueError(f"unknown flow metric {metric!r}; valid: "
                             "['epe', 'fl']")
        self.metric = metric
        self.reset()

    def reset(self):
        self._sums = dict.fromkeys(("epe", "fl", "px1", "px3"), 0.0)
        self._images = 0

    def update(self, preds, labels):
        for p, t in zip(_host(preds), _host(labels)):
            valid = np.isfinite(t).all(axis=-1)
            if not valid.any():
                continue
            pv, tv = p[valid], t[valid]
            epe = np.sqrt(np.sum((pv - tv) ** 2, axis=-1))
            mag = np.sqrt(np.sum(tv ** 2, axis=-1))
            s = self._sums
            s["epe"] += float(np.mean(epe))
            s["fl"] += float(np.mean((epe > 3.0) & (epe > 0.05 * mag)))
            s["px1"] += float(np.mean(epe < 1.0))
            s["px3"] += float(np.mean(epe < 3.0))
            self._images += 1

    def report(self, names=None) -> dict:
        del names
        n = max(self._images, 1)
        return {k: self._sums[k] / n for k in ("epe", "fl", "px1", "px3")}

    def score(self) -> float:
        return self.report()[self.metric]
