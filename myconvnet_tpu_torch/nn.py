"""Layers of the train and eval paths, as ``torch.nn`` modules on NHWC
tensors.

Port of the subset of ``myconvnet_tpu/nn.py`` that the ResNets, the ViTs,
the flow models, SmallNet, VGG, DenseNet and the GANs use (``max_pool``,
``avg_pool`` and ``gap`` are the pooling ops of ``ops/pool.py``).
Module names follow the JAX scope names, so ``weights.from_jax`` maps
``{"stage1/block1/conv_a": {"w": ...}}`` onto ``stage1.block1.conv_a``.

* :class:`Conv` keeps its weight OIHW in channels_last memory (the layout
  cuDNN and the CUDA kernels read without a copy) and exposes it in the
  JAX package's HWIO layout through :attr:`Conv.w`.  Its bias is optional
  and is filled in when a following BN is folded into it (``nn.py:100-105``).
  Parameters stay float32 under the bf16 policy and are cast to the
  activations' dtype at use, as ``pol.cast_to_compute(w)`` does
  (``nn.py:97``); a served model casts them once instead.
* :class:`ConvTranspose` (``nn.py:159``) keeps its weight as torch's
  [Cin, Cout, kh, kw] in channels_last memory and exposes it as JAX's
  HWIO through :attr:`ConvTranspose.w`; ``ops.conv.conv2d_transpose``
  flips it in space at use (JAX's kernel is not flipped).
* :class:`BatchNorm` (``nn.py:254-282``) normalizes with batch statistics
  when the module is training and updates its moving statistics in place,
  ``moving = m * moving + (1 - m) * batch`` on the biased variance; torch's
  ``BatchNorm2d`` keeps an unbiased running variance and the inverse
  momentum, so it is not used.  In eval mode it normalizes with the moving
  statistics, and it becomes the identity once folded.  With
  ``update_stats`` False a training BN leaves its moving statistics as
  they are (the GAN step's passes whose state JAX discards).
* :class:`Dense` (``nn.py:200``): ``bias=False`` is ``use_bias=False``
  (DCGAN's ``project``).
* ``spectral_norm=True`` on :class:`Conv` and :class:`Dense`
  (``nn.py:61``, ``:209``; SN-GAN's discriminators) divides the weight by
  its leading singular value, estimated by one power iteration an apply
  (:func:`spectral_normalize`, ``nn.py:229-248``) from the persistent
  buffer ``sn_u`` [out] (``ones / sqrt(out)`` at first; the JAX state
  ``<scope>/sn_u``).  A training forward writes the new vector back unless
  ``update_stats`` is off (the GAN step's G pass, whose D state JAX
  discards); an eval forward leaves it, as every JAX caller of an eval
  apply drops the state.
* :class:`InstanceNorm` (``nn.py:299``): eps 1e-5, float32 statistics over
  H and W per image and channel, float32 gamma/beta, no state.
* :class:`LayerNorm` (``nn.py:285-296``): eps 1e-6 (torch's default is
  1e-5), float32 statistics and float32 gamma/beta, output in the input's
  dtype (the compute dtype).
* :func:`gelu` is the exact (erf) GELU of ``vit.py:73-75``.
* :func:`dropout` and :func:`drop_path` (``nn.py:340-345``, ``:422-433``)
  keep ``x / keep`` where a Bernoulli(keep) mask is true and 0 elsewhere;
  the mask is given (tests hand both frameworks the same one) or drawn
  from an explicit ``torch.Generator`` by :func:`keep_mask`.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.ops.batch_norm import (batch_norm_inference,
                                                batch_norm_train,
                                                bn_scale_shift)
from myconvnet_tpu_torch.ops.conv import Padding, conv2d, conv2d_transpose
from myconvnet_tpu_torch.ops.pool import avg_pool2d, global_avg_pool, \
    max_pool2d


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum() + 1e-12)


def spectral_normalize(layer: nn.Module, w: torch.Tensor) -> torch.Tensor:
    """``w`` (the JAX layout: HWIO or [in, out]) over its leading singular
    value from one power iteration on ``layer.sn_u``; u and v are
    constants for the gradient, which flows through sigma and the
    divide."""
    out = w.shape[-1]
    w_mat = w.float().reshape(-1, out)                      # [in, out]
    with torch.no_grad():
        v = _l2(w_mat @ layer.sn_u.float())
        u_new = _l2(w_mat.T @ v)
        if layer.training and layer.update_stats:
            layer.sn_u.copy_(u_new)
    sigma = v @ w_mat @ u_new
    return (w_mat / sigma.clamp_min(1e-12)).reshape(w.shape).to(w.dtype)


def _add_spectral_norm(layer: nn.Module, out: int, on: bool) -> None:
    layer.spectral_norm = on
    if on:
        layer.update_stats = True
        layer.register_buffer(
            "sn_u", torch.ones(out) / torch.tensor(float(out)).sqrt())


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int, *,
                 stride: int = 1, padding: Padding = "SAME",
                 dilation: int = 1, bias: bool = False, w_init=None,
                 spectral_norm: bool = False):
        super().__init__()
        self.w_init = w_init    # core.init.init_model: None is He-normal
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        w = torch.empty(cout, cin, kernel_size, kernel_size)
        self.weight = nn.Parameter(
            w.contiguous(memory_format=torch.channels_last))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(cout)) if bias else None)
        _add_spectral_norm(self, cout, spectral_norm)

    @property
    def w(self) -> torch.Tensor:
        """The weight in HWIO, a view of the OIHW channels_last storage."""
        return self.weight.permute(2, 3, 1, 0)

    def forward(self, x: torch.Tensor, add_bias: bool = True
                ) -> torch.Tensor:
        b = self.bias.to(x.dtype) if add_bias and self.bias is not None \
            else None
        w = spectral_normalize(self, self.w) if self.spectral_norm \
            else self.w
        return conv2d(x, w.to(x.dtype), b, stride=self.stride,
                      padding=self.padding, dilation=self.dilation)


class ConvTranspose(nn.Module):
    """``nn.conv_transpose``: a fractionally-strided conv, "SAME" or
    "VALID", optional bias; N(0, 0.02) init unless ``w_init`` names
    another."""

    def __init__(self, cin: int, cout: int, kernel_size: int, *,
                 stride: int = 2, padding: str = "SAME", bias: bool = True,
                 w_init=None):
        super().__init__()
        self.w_init = w_init    # core.init.init_model: None is N(0, 0.02)
        self.stride = stride
        self.padding = padding
        w = torch.empty(cin, cout, kernel_size, kernel_size)
        self.weight = nn.Parameter(
            w.contiguous(memory_format=torch.channels_last))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(cout)) if bias else None)

    @property
    def w(self) -> torch.Tensor:
        """The weight in HWIO, a view of the [Cin, Cout, kh, kw] storage."""
        return self.weight.permute(2, 3, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return conv2d_transpose(x, self.w.to(x.dtype), b,
                                stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """BN over the last axis: float32 gamma/beta and moving stats.
    ``zero_init`` starts gamma at 0 (a residual branch's last BN)."""

    def __init__(self, c: int, eps: float = 1e-3, momentum: float = 0.99,
                 zero_init: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.folded = False
        self.update_stats = True
        self.gamma = nn.Parameter(torch.zeros(c) if zero_init
                                  else torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))
        self.register_buffer("moving_mean", torch.zeros(c))
        self.register_buffer("moving_var", torch.ones(c))

    def mark_folded(self) -> None:
        """Drop the parameters: the preceding conv now carries them."""
        self.folded = True
        self.gamma = self.beta = None
        self.moving_mean = self.moving_var = None

    def scale_shift(self) -> tuple[torch.Tensor, torch.Tensor]:
        return bn_scale_shift(self.gamma, self.beta, self.moving_mean,
                              self.moving_var, self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if self.folded:
                raise RuntimeError("a folded BN cannot train")
            y, mean, var = batch_norm_train(x, self.gamma, self.beta,
                                            self.eps)
            if not self.update_stats:
                return y
            m = self.momentum
            with torch.no_grad():
                self.moving_mean.copy_(m * self.moving_mean + (1.0 - m) * mean)
                self.moving_var.copy_(m * self.moving_var + (1.0 - m) * var)
            return y
        if self.folded:
            return x
        return batch_norm_inference(x, self.gamma, self.beta,
                                    self.moving_mean, self.moving_var,
                                    self.eps)


def conv_epilogue(conv: Conv, bn: BatchNorm | None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 (a, b) with bn(conv(x)) == conv_nobias(x)*a + b:
    (1, bias) once the BN is folded or where there is none, the BN's scale
    and shift otherwise."""
    b = (conv.bias.float() if conv.bias is not None
         else torch.zeros(conv.weight.shape[0], device=conv.weight.device))
    if bn is None or bn.folded:
        return torch.ones_like(b), b
    a, shift = bn.scale_shift()
    return a, b * a + shift


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, *, bias: bool = True,
                 w_init=None, spectral_norm: bool = False):
        super().__init__()
        self.w_init = w_init    # core.init.init_model: None is Glorot
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(cout)) if bias else None)
        _add_spectral_norm(self, cout, spectral_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        w = self.weight
        if self.spectral_norm:
            w = spectral_normalize(self, w.t()).t()
        return torch.nn.functional.linear(x, w.to(x.dtype), b)


class LayerNorm(nn.Module):
    """LN over the last axis: float32 math and parameters, output in x's
    dtype."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.gamma \
            + self.beta
        return y.to(x.dtype)


class InstanceNorm(nn.Module):
    """Instance norm over H and W of NHWC: float32 math and parameters,
    output in x's dtype."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean((1, 2), keepdim=True)
        var = (xf - mean).square().mean((1, 2), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.gamma \
            + self.beta
        return y.to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, alpha)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return torch.nn.functional.gelu(x, approximate="none")


def keep_mask(shape, rate: float, generator: torch.Generator
              ) -> torch.Tensor:
    """Bernoulli(1 - rate) bool mask on the generator's device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) < 1.0 - rate


def _drop(x, rate, train, shape, generator, mask, what):
    if not train or rate <= 0.0:
        return x
    if mask is None:
        if generator is None:
            raise ValueError(f"{what} with rate > 0 in training needs a "
                             "mask or a generator")
        mask = keep_mask(shape, rate, generator)
    keep = 1.0 - rate
    mask = mask.to(x.device).reshape(shape)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, *, train: bool,
            generator: torch.Generator | None = None,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Elementwise dropout; ``mask`` (x's shape, True = keep) or a draw
    from ``generator``."""
    return _drop(x, rate, train, tuple(x.shape), generator, mask, "dropout")


def drop_path(x: torch.Tensor, rate: float, *, train: bool,
              generator: torch.Generator | None = None,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample;
    ``mask`` is [N] (True = keep) or a draw from ``generator``."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return _drop(x, rate, train, shape, generator, mask, "drop_path")


gap = global_avg_pool
max_pool = max_pool2d
avg_pool = avg_pool2d
