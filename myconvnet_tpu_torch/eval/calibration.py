"""Post-hoc confidence calibration: temperature scaling and the ECE.

Port of ``myconvnet_tpu/eval/calibration.py:16-73``.  One temperature T,
fitted on the validation split's negative log-likelihood, calibrates the
softmax without moving the argmax.  The fit is JAX's guarded Newton on
log T (its gradient and second derivative by autograd, float32, 50 steps,
T kept in [1 / max_t, max_t]); the ECE bins the float32 softmax's
confidence as JAX does, in numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def nll(logits: torch.Tensor, labels: torch.Tensor,
        temperature: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under softmax(logits /
    temperature), in float32."""
    logp = torch.log_softmax(logits.float() / temperature, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def fit_temperature(logits, labels, *, steps: int = 50, init: float = 1.0,
                    max_t: float = 100.0) -> float:
    """T in [1 / max_t, max_t] minimizing the NLL: a Newton step on log T
    where the second derivative exceeds 1e-8 in magnitude (else a gradient
    step), each step clipped to [-1, 1].  The bound keeps T finite for an
    untrained model whose optimum is T -> inf (uniform probabilities)."""
    logits = torch.as_tensor(np.asarray(logits, np.float32))
    labels = torch.as_tensor(np.asarray(labels))
    bound = float(np.log(np.float32(max_t)))
    log_t = torch.log(torch.tensor(init, dtype=torch.float32))
    for _ in range(steps):
        x = log_t.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(nll(logits, labels, torch.exp(x)), x,
                                   create_graph=True)
        (h,) = torch.autograd.grad(g, x)
        g, h = g.detach(), h.detach()
        step = torch.where(h.abs() > 1e-8, g / h, g)
        log_t = torch.clamp(log_t - torch.clamp(step, -1.0, 1.0), -bound,
                            bound)
    return float(torch.exp(log_t))


def expected_calibration_error(logits, labels, *, n_bins: int = 15,
                               temperature: float = 1.0) -> float:
    """Confidence-binned |accuracy - confidence|, weighted by each bin's
    share of the examples."""
    logits = np.asarray(logits, np.float32) / temperature
    labels = np.asarray(labels)
    probs = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    conf = probs.max(-1)
    correct = probs.argmax(-1) == labels
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    n = len(conf)
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        if not in_bin.any():
            continue
        ece += (in_bin.sum() / n) * abs(correct[in_bin].mean()
                                        - conf[in_bin].mean())
    return float(ece)
