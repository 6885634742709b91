"""SGD with (nesterov) momentum, the weight-decay mask, LR schedules.

Port of the parts of ``myconvnet_tpu/train/optim.py`` the CIFAR recipe
uses: ``cosine_decay``/``cosine_restarts`` (``:62-101``), ``warmup``
(``:104-112``), ``norm_and_bias_exclusion`` and the decay mask
(``:131-157``), ``sgd``/``momentum`` (``:159-199``) and ``make_schedule``
/ ``make_optimizer`` (``:374-415``).

A schedule is a function of the step counter evaluated in float32, as the
JAX schedules are inside the jitted step.  The update is the JAX one:

    gd = g + wd * p        (coupled L2; 0 for excluded parameters)
    m  = momentum * m + gd (m starts at 0, so the first m is gd)
    d  = gd + momentum * m (nesterov) or m
    p  = p - lr(step) * d

``torch.optim.SGD`` with ``dampening=0`` computes exactly this (its first
step copies gd into the buffer, which equals 0.9 * 0 + gd), so
:class:`SGD` drives it with two parameter groups, decayed and excluded,
and sets the learning rate of both before every step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

Schedule = Callable[[int], float]
F32 = np.float32


def constant(lr: float) -> Schedule:
    return lambda step: float(F32(lr))


def cosine_decay(lr: float, total_steps: int, alpha: float = 0.0
                 ) -> Schedule:
    def fn(step):
        t = np.clip(F32(step) / F32(total_steps), F32(0), F32(1))
        cos = F32(0.5) * (F32(1) + np.cos(F32(math.pi) * t))
        return float(F32(lr) * ((F32(1) - F32(alpha)) * cos + F32(alpha)))
    return fn


def cosine_restarts(lr: float, first_decay_steps: int, t_mul: float = 2.0,
                    m_mul: float = 1.0, alpha: float = 0.0) -> Schedule:
    """SGDR: cosine cycles of geometrically growing length (t_mul) and
    decaying peak (m_mul), in the JAX closed form (the cycle index comes
    from a log, not a loop)."""
    def fn(step):
        t = F32(step) / F32(first_decay_steps)
        if t_mul == 1.0:
            i = np.floor(t)
            frac = t - i
        else:
            i = np.floor(np.log1p(t * F32(t_mul - 1.0)) / np.log(F32(t_mul)))
            start = (F32(t_mul) ** i - F32(1)) / F32(t_mul - 1.0)
            frac = (t - start) / (F32(t_mul) ** i)
        peak = F32(m_mul) ** i
        cos = F32(0.5) * (F32(1) + np.cos(F32(math.pi)
                                          * np.clip(frac, F32(0), F32(1))))
        return float(F32(lr) * peak
                     * ((F32(1) - F32(alpha)) * cos + F32(alpha)))
    return fn


def warmup(schedule: Schedule, warmup_steps: int) -> Schedule:
    """Linear warmup wrapped around any schedule; step 0 already gets
    1 / warmup_steps of it, as ``(step + 1) / warmup_steps`` in JAX."""
    if warmup_steps <= 0:
        return schedule

    def fn(step):
        scale = min(F32(1), F32(step + 1) / F32(warmup_steps))
        return float(F32(scale) * F32(schedule(step)))
    return fn


def make_schedule(cfg: dict) -> Schedule:
    """Config-dict schedule: {"kind": ..., "lr": ..., "warmup_steps": ...}."""
    cfg = dict(cfg)
    kind = cfg.pop("kind", "constant")
    warmup_steps = cfg.pop("warmup_steps", 0)
    table = {"constant": constant, "cosine": cosine_decay,
             "cosine_restarts": cosine_restarts}
    if kind not in table:
        raise ValueError(f"the port has schedules {sorted(table)}, not "
                         f"{kind!r}")
    return warmup(table[kind](**cfg), warmup_steps)


def norm_and_bias_exclusion(path: str, p) -> bool:
    """Exclude biases and norm scales/offsets from weight decay (any
    rank <= 1 parameter, plus b/beta/gamma by name, and the ViT embedding
    tokens).  ``path`` is the JAX scope path, ``stage1/block1/bn_a/gamma``."""
    name = path.rsplit("/", 1)[-1]
    return (name in ("b", "beta", "gamma", "cls_token", "pos_embed")
            or getattr(p, "ndim", 2) <= 1)


def decay_mask(named_params: Iterable[tuple[str, torch.Tensor]],
               exclude=None) -> dict[str, bool]:
    """{path: True where weight decay applies} (``_decay_mask``)."""
    return {path: exclude is None or not exclude(path, p)
            for path, p in named_params}


class SGD:
    """``optim.sgd``/``momentum`` over (JAX path, parameter) pairs;
    ``step(i)`` applies the update with ``lr(i)``."""

    def __init__(self, named_params: list[tuple[str, torch.Tensor]], lr, *,
                 momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0, weight_decay_exclude=None):
        self.schedule = lr if callable(lr) else constant(float(lr))
        self.paths = {p: path for path, p in named_params}
        mask = decay_mask(named_params, weight_decay_exclude)
        groups = [
            {"params": [p for path, p in named_params if mask[path]],
             "weight_decay": weight_decay},
            {"params": [p for path, p in named_params if not mask[path]],
             "weight_decay": 0.0}]
        self.opt = torch.optim.SGD([g for g in groups if g["params"]],
                                   lr=0.0, momentum=momentum,
                                   nesterov=nesterov)
        self.momentum = momentum

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self, step: int) -> float:
        lr = self.schedule(step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        return lr

    def momentum_buffers(self) -> dict[str, torch.Tensor]:
        """{path: momentum buffer}, zeros before the first step (as the
        JAX state starts)."""
        if self.momentum == 0.0:
            return {}
        out = {}
        for p, path in self.paths.items():
            buf = self.opt.state.get(p, {}).get("momentum_buffer")
            out[path] = torch.zeros_like(p) if buf is None else buf
        return out

    def load_momentum_buffers(self, buffers: dict[str, torch.Tensor]
                              ) -> None:
        for p, path in self.paths.items():
            if path in buffers:  # in the parameter's memory layout
                self.opt.state[p]["momentum_buffer"] = \
                    torch.empty_like(p).copy_(buffers[path])


def make_optimizer(named_params, name: str, lr, **kwargs) -> SGD:
    """Config-string optimizer factory (``sgd`` and ``momentum``)."""
    if name == "momentum":
        kwargs["momentum"] = kwargs.pop("momentum_coef", 0.9)
    elif name != "sgd":
        raise ValueError(f"the port has optimizers ['momentum', 'sgd'], "
                         f"not {name!r}")
    return SGD(list(named_params), lr, **kwargs)
