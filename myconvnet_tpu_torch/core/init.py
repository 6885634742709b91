"""Weight initializers (He / Glorot / normal / zeros) drawn from a
``torch.Generator``.

Port of ``myconvnet_tpu/core/init.py:31-80`` for the layers the port has.
Fans follow the JAX package's HWIO / [in, out] layouts (``_fans``); the
draws match JAX in distribution, not bit for bit (threefry and torch's
generators differ), so parity tests carry weights across with
``weights.from_jax`` instead.

:func:`init_model` initialises a fresh model in place: He-normal convs
(truncated at 2 sigma) unless the layer names another initialiser
(``Conv(w_init=zeros)``, the flow heads of ``models/flow.py:55-58``;
N(0, 0.02) everywhere in the GANs), N(0, 0.02) transposed convs
(``nn.py:169``), Glorot-uniform dense weights unless named, zero biases.  BN
gamma/beta and moving statistics and LN gamma/beta keep their constructor
values (ones, or zeros for a zero-init gamma; zeros for beta).  A module
with parameters of its own (the ViT's ``cls_token`` and ``pos_embed``)
initialises them in its ``init_own_params(generator)``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

Initializer = Callable[[tuple, torch.Generator], torch.Tensor]


def _fans(shape: tuple) -> tuple[float, float]:
    if len(shape) < 1:
        return 1.0, 1.0
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    receptive = math.prod(shape[:-2])
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def variance_scaling(scale: float = 2.0, mode: str = "fan_in",
                     distribution: str = "truncated_normal") -> Initializer:
    """``init(shape, generator) -> float32 tensor`` on the generator's
    device, for a shape in the JAX layout (HWIO, [in, out])."""
    def init(shape, generator):
        fan_in, fan_out = _fans(tuple(shape))
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        variance = scale / max(denom, 1.0)
        out = torch.empty(shape, device=generator.device)
        if distribution == "truncated_normal":
            # stddev correction for truncation at 2 sigma
            std = math.sqrt(variance) / 0.87962566103423978
            return nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                         generator=generator) * std
        if distribution == "normal":
            return out.normal_(generator=generator) * math.sqrt(variance)
        if distribution == "uniform":
            limit = math.sqrt(3.0 * variance)
            return out.uniform_(-limit, limit, generator=generator)
        raise ValueError(f"unknown distribution {distribution!r}")
    return init


def he_normal() -> Initializer:
    return variance_scaling(2.0, "fan_in", "truncated_normal")


def glorot_uniform() -> Initializer:
    return variance_scaling(1.0, "fan_avg", "uniform")


def normal(stddev: float = 0.01) -> Initializer:
    def init(shape, generator):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * stddev
    return init


def zeros(shape, generator=None) -> torch.Tensor:
    return torch.zeros(shape)


@torch.no_grad()
def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every conv and dense weight of ``model`` from ``generator``
    (in module order) and zero their biases."""
    from myconvnet_tpu_torch.nn import Conv, ConvTranspose, Dense
    he, glorot, n002 = he_normal(), glorot_uniform(), normal(0.02)
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            default = he if isinstance(m, Conv) else n002
            m.w.copy_((m.w_init or default)(tuple(m.w.shape), generator))
        elif isinstance(m, Dense):
            m.weight.copy_((m.w_init or glorot)(
                tuple(m.weight.shape[::-1]), generator).T)
        else:
            continue
        if m.bias is not None:
            m.bias.copy_(zeros(tuple(m.bias.shape)))
    for m in model.modules():
        if hasattr(m, "init_own_params"):
            m.init_own_params(generator)
    return model
