"""Monocular-depth metrics: the Eigen protocol.

Port of ``myconvnet_tpu/eval/depth.py``: over the valid pixels (ground
truth in (``min_depth``, ``max_depth``)) AbsRel, RMSE, RMSE(log), log10
and the threshold accuracies delta < 1.25, 1.25², 1.25³, computed per
image in float64 numpy on the host and averaged over images (RMSE is the
mean of the images' roots, as the published evaluation scripts take it).
``median_scaling`` rescales each prediction by median(gt) / median(pred)
first, the protocol for models trained without metric supervision.
"""

from __future__ import annotations

import numpy as np
import torch

from myconvnet_tpu_torch.eval.evaluators import Evaluator

_METRICS = ("absrel", "rmse", "rmse_log", "log10",
            "delta1", "delta2", "delta3")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float64)


class DepthEvaluator(Evaluator):
    """Streaming Eigen metrics of predictions and labels, both ``[N, H, W,
    1]`` metres (labels 0 where invalid).  ``metric`` is the headline:
    ``absrel`` (default), ``rmse``, ``rmse_log``, ``log10`` (lower is
    better) or ``delta1``-``delta3`` (higher); :meth:`report` gives all
    seven."""

    name = "depth"

    def __init__(self, metric: str = "absrel", min_depth: float = 1e-3,
                 max_depth: float = np.inf, median_scaling: bool = False):
        if metric not in _METRICS:
            raise ValueError(f"unknown depth metric {metric!r}; valid: "
                             f"{list(_METRICS)}")
        self.metric = metric
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        self.median_scaling = bool(median_scaling)
        self.reset()

    @property
    def higher_is_better(self) -> bool:
        return self.metric.startswith("delta")

    def reset(self):
        self._sums = dict.fromkeys(_METRICS, 0.0)
        self._images = 0

    def update(self, preds, labels):
        for p, t in zip(_host(preds), _host(labels)):
            mask = (t > max(self.min_depth, 0.0)) & (t < self.max_depth)
            if not mask.any():
                continue
            pv, tv = p[mask], t[mask]
            if self.median_scaling:
                pv = pv * (np.median(tv) / max(np.median(pv), 1e-12))
            pv = np.clip(pv, self.min_depth,
                         None if np.isinf(self.max_depth)
                         else self.max_depth)
            err = pv - tv
            log_err = np.log(pv) - np.log(tv)
            ratio = np.maximum(pv / tv, tv / pv)
            s = self._sums
            s["absrel"] += float(np.mean(np.abs(err) / tv))
            s["rmse"] += float(np.sqrt(np.mean(err * err)))
            s["rmse_log"] += float(np.sqrt(np.mean(log_err * log_err)))
            s["log10"] += float(np.mean(np.abs(np.log10(pv / tv))))
            s["delta1"] += float(np.mean(ratio < 1.25))
            s["delta2"] += float(np.mean(ratio < 1.25 ** 2))
            s["delta3"] += float(np.mean(ratio < 1.25 ** 3))
            self._images += 1

    def report(self, names=None) -> dict:
        """All seven metrics (``names`` is taken and ignored, the call
        shape of ``test --report``)."""
        n = max(self._images, 1)
        return {k: self._sums[k] / n for k in _METRICS}

    def score(self) -> float:
        return self.report()[self.metric]
