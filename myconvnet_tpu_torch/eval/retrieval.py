"""Retrieval evaluation for the metric-learning recipes.

Port of ``myconvnet_tpu/eval/retrieval.py``, on the host in numpy as in
JAX: leave-one-out Recall@K over the validation split (each example
queries the rest of the split by cosine similarity; a hit is a
same-identity neighbour in the top K), mAP@R and ``report``.  The
embeddings gather on the host in float32 (a 10k x 512 split is 20 MB);
the similarity pass is one [N, N] product in row blocks of ``_CHUNK``.
"""

from __future__ import annotations

import numpy as np
import torch

from myconvnet_tpu_torch.eval.evaluators import Evaluator

_CHUNK = 1024


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy() if a.is_floating_point() \
            else a.cpu().numpy()
    return np.asarray(a)


class RetrievalEvaluator(Evaluator):
    """Recall@K (K = ``k``) with leave-one-out cosine retrieval.  A query
    whose identity has no second example in the split cannot be matched
    and is left out of the denominator."""

    def __init__(self, k: int = 1):
        self.k = int(k)
        self.name = f"recall@{self.k}"
        self.reset()

    def reset(self):
        self._embs: list[np.ndarray] = []
        self._labels: list[np.ndarray] = []

    def update(self, outputs, labels):
        e = np.asarray(_host(outputs), np.float32)
        if e.ndim != 2:
            raise ValueError(
                f"RetrievalEvaluator expects [N, D] embeddings, got "
                f"{e.shape} — metric-task models must return embeddings "
                "in eval mode")
        self._embs.append(e)
        self._labels.append(_host(labels).reshape(-1))

    def _gather(self):
        e = np.concatenate(self._embs)
        y = np.concatenate(self._labels)
        n = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
        return n, y

    def _ranked_hits(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Each query's [n, min(k, n - 1)] hit mask, and the valid-query
        mask."""
        n, y = self._gather()
        nq = len(y)
        counts = np.bincount(y, minlength=y.max() + 1)
        valid = counts[y] >= 2
        k = min(k, nq - 1)
        if k < 1:   # a one-example gallery: nothing to retrieve
            return np.zeros((nq, 1), bool), np.zeros(nq, bool)
        hits = np.zeros((nq, k), bool)
        for s in range(0, nq, _CHUNK):
            rows = slice(s, min(s + _CHUNK, nq))
            sim = n[rows] @ n.T
            idx = np.arange(rows.start, rows.stop)
            sim[np.arange(len(idx)), idx] = -np.inf   # the self-match
            top = np.argpartition(-sim, k - 1, axis=1)[:, :k]
            order = np.take_along_axis(sim, top, 1).argsort(axis=1)
            top = np.take_along_axis(top, order[:, ::-1], 1)
            hits[rows] = y[top] == y[idx, None]
        return hits, valid

    def recall_at(self, k: int, _ranked=None) -> float:
        """``_ranked``: a :meth:`_ranked_hits` of k' >= k, so that
        :meth:`report` pays for the [N, N] pass once."""
        hits, valid = _ranked if _ranked is not None \
            else self._ranked_hits(k)
        if not valid.any():
            return 0.0
        return float(hits[valid, :k].any(axis=1).mean())

    def mean_average_precision(self, r: int | None = None,
                               _ranked=None) -> float:
        """mAP@R: AP over the first R ranks, R the query's same-identity
        count (or a fixed ``r``)."""
        _, y = self._gather()
        counts = np.bincount(y, minlength=y.max() + 1)
        rmax = int(min((counts.max() - 1) if len(counts) else 1,
                       len(y) - 1))
        if rmax < 1:
            return 0.0
        hits, valid = _ranked if _ranked is not None \
            else self._ranked_hits(rmax)
        hits = hits[:, :rmax]
        rel = counts[y] - 1 if r is None else np.full(len(y), r)
        rel = np.clip(rel, 0, rmax)
        cum = np.cumsum(hits, axis=1)
        prec = cum / np.arange(1, rmax + 1)[None, :]
        rank_live = np.arange(rmax)[None, :] < rel[:, None]
        ap = np.sum(prec * hits * rank_live, axis=1) / np.maximum(rel, 1)
        ok = valid & (rel > 0)
        return float(ap[ok].mean()) if ok.any() else 0.0

    def score(self) -> float:
        if not self._embs:
            return 0.0
        return self.recall_at(self.k)

    def report(self, class_names=None) -> str:
        """Recall@1, 2, 4, 8 and mAP@R (``class_names``: taken for the
        shared ``--report`` interface; identities are anonymous)."""
        if not self._embs:
            return "queries: 0"
        y = np.concatenate(self._labels)
        counts = np.bincount(y, minlength=y.max() + 1)
        rmax = int(min((counts.max() - 1) if len(counts) else 1,
                       len(y) - 1))
        ranked = self._ranked_hits(max(8, rmax))
        lines = [f"queries: {len(y)}"]
        for k in (1, 2, 4, 8):
            lines.append(
                f"recall@{k}: {self.recall_at(k, _ranked=ranked):.4f}")
        lines.append(f"mAP@R: "
                     f"{self.mean_average_precision(_ranked=ranked):.4f}")
        return "\n".join(lines)
