"""The GAN family of BASELINE config #5: DCGAN and pix2pix, NHWC.

Port of ``myconvnet_tpu/models/gan.py``: ``dcgan_generator`` (``:29``),
``dcgan_discriminator`` (``:56``), ``unet_generator`` (``:85``) and
``patchgan_discriminator`` (``:123``).  Every weight starts from N(0, 0.02)
(``:25``); the BNs take momentum 0.9 and eps 1e-3.  Module names follow
the JAX scopes: DCGAN's ``project``, ``bn_project``, ``conv_transpose``,
``conv_transpose_1``, ``bn``, ``bn_1`` and ``to_rgb``; its discriminator's
``conv``, ``conv_1``, ... (only the first biased), ``bn``, ... and
``logits``; the U-Net's ``enc<i>/conv`` and ``enc<i>/bn`` (or
``enc<i>/in`` under ``norm="instance"``), ``dec<i>/deconv`` and
``dec<i>/bn``; the PatchGAN's ``conv``, ``conv_1``, ..., ``bn``, ... and
``logits``.  JAX reads the input size from the sample input at init; the
port's modules take it when they are built (``image_size``): it sets the
DCGAN discriminator's ``logits`` width and clamps the U-Net's levels
(``:94``).

``spectral_norm=True`` gives the discriminators' SN-GAN form
(``:56-82``, ``:123-158``): every conv and the head spectral-normalized
(``nn.Conv``/``nn.Dense`` with ``spectral_norm``, each with its ``sn_u``
buffer), no BN or instance norm, and a bias on every conv (none of them
has a norm to absorb its shift).

Eval mode routes each generator BN -> activation through B1
(``models/blocks.bn_act``): DCGAN's three BN -> ReLU sites (``bn_project``
and the two deconv BNs at 32x32; ``to_rgb`` + tanh stays plain) and, under
``norm="batch"``, the U-Net's BN -> leaky ReLU(0.2) encoder sites and BN ->
ReLU decoder sites (6 and 7 at 256x256 with 8 levels).  The U-Net keeps an
encoder level's pre-activation as its skip and applies ReLU to each
decoder level's concatenation; where the encoder's BN -> leaky ReLU is one
launch, the launch's output is both the next level's input and the skip,
since relu(leaky_relu(s)) == relu(s) exactly at slope 0.2, and the decoder
applies ReLU to the skip half.  ``forward(..., kernels=False)`` runs the
eval forward without the routing (the plain path the routing equals).
Train mode is plain PyTorch; the discriminators are plain in both modes.

The U-Net's train-mode dropout (0.5, the three innermost decoder levels,
``:114-115``) takes keep masks by site (``dec<i>``) from ``masks`` or draws
them from ``generator``; :meth:`UNetGenerator.sample_masks` draws a
forward's masks, so a test can hand over the ones JAX drew.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.core.init import normal
from myconvnet_tpu_torch.models.blocks import ACTS, bn_act
from myconvnet_tpu_torch.models.smallnet import auto_name
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, ConvTranspose, Dense,
                                    InstanceNorm, dropout, keep_mask,
                                    leaky_relu, relu, tanh)

W_INIT = normal(0.02)   # DCGAN-standard N(0, 0.02) everywhere
MOMENTUM = 0.9


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, momentum=MOMENTUM)


def _doublings(size: int) -> int:
    """How many times 4 doubles up to ``size`` (DCGAN's loops)."""
    n, s = 0, 4
    while s < size:
        s *= 2
        n += 1
    return n


# ------------------------------------------------------------------- DCGAN

class DCGANGenerator(nn.Module):
    """``forward(z)``: z [N, latent_dim] -> images [N, S, S, C] in [-1, 1],
    S = ``image_size``."""

    def __init__(self, latent_dim: int = 100, *, out_channels: int = 3,
                 base_features: int = 512, image_size: int = 64):
        super().__init__()
        self.base = base_features
        n_up = _doublings(image_size)
        self.project = Dense(latent_dim, 16 * base_features, bias=False,
                             w_init=W_INIT)
        self.bn_project = _bn(base_features)
        feats, self.n_deconv = base_features, n_up - 1
        for i in range(self.n_deconv):
            self.add_module(auto_name("conv_transpose", i), ConvTranspose(
                feats, feats // 2, 4, bias=False, w_init=W_INIT))
            feats //= 2
            self.add_module(auto_name("bn", i), _bn(feats))
        self.to_rgb = ConvTranspose(feats, out_channels, 4, w_init=W_INIT)

    def forward(self, z: torch.Tensor, *, kernels: bool = True
                ) -> torch.Tensor:
        act = bn_act if kernels else _plain_bn_act
        x = self.project(z).reshape(-1, 4, 4, self.base)
        x = act(self.bn_project, x, "relu")
        for i in range(self.n_deconv):
            x = getattr(self, auto_name("conv_transpose", i))(x)
            x = act(getattr(self, auto_name("bn", i)), x, "relu")
        return tanh(self.to_rgb(x))


def _plain_bn_act(bn, x, act):
    return ACTS[act](bn(x))


class DCGANDiscriminator(nn.Module):
    """``forward(x)``: images [N, S, S, C] -> logits [N, 1]: strided 4x4
    convs down to 4x4 (no BN on the first; none at all under
    ``spectral_norm``), leaky ReLU(0.2), then the NHWC-flattened map
    through ``logits``."""

    def __init__(self, *, in_channels: int = 3, base_features: int = 64,
                 image_size: int = 64, spectral_norm: bool = False):
        super().__init__()
        self.sn = sn = spectral_norm
        size, self.n_down = image_size, 0
        while size > 4:
            size //= 2
            self.n_down += 1
        cin, feats = in_channels, base_features
        for i in range(self.n_down):
            self.add_module(auto_name("conv", i), Conv(
                cin, feats, 4, stride=2, bias=i == 0 or sn, w_init=W_INIT,
                spectral_norm=sn))
            if i > 0 and not sn:
                self.add_module(auto_name("bn", i - 1), _bn(feats))
            cin, feats = feats, min(feats * 2, 512)
        self.logits = Dense(size * size * cin, 1, w_init=W_INIT,
                            spectral_norm=sn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_down):
            x = getattr(self, auto_name("conv", i))(x)
            if i > 0 and not self.sn:
                x = getattr(self, auto_name("bn", i - 1))(x)
            x = leaky_relu(x, 0.2)
        return self.logits(x.reshape(x.shape[0], -1))


# ----------------------------------------------------------------- pix2pix

def _norm(c: int, norm: str) -> nn.Module:
    if norm == "batch":
        return _bn(c)
    if norm == "instance":
        return InstanceNorm(c)
    raise ValueError(f"unknown norm {norm!r}; valid: batch, instance")


def _norm_name(norm: str) -> str:
    return "bn" if norm == "batch" else "in"


class _Level(nn.Module):
    """One U-Net level's scope: its conv (``conv`` or ``deconv``) and its
    norm, named as JAX names them."""

    def __init__(self, conv_name: str, conv: nn.Module,
                 norm: nn.Module | None, norm_name: str):
        super().__init__()
        self.add_module(conv_name, conv)
        self.conv_name, self.norm_name = conv_name, norm_name
        if norm is not None:
            self.add_module(norm_name, norm)

    def conv_layer(self) -> nn.Module:
        return self._modules[self.conv_name]

    def norm_layer(self) -> nn.Module | None:
        return self._modules.get(self.norm_name)


class UNetGenerator(nn.Module):
    """pix2pix's U-Net: ``forward(x, masks=None, generator=None)``, x
    [N, S, S, C] in [-1, 1] -> [N, S, S, out_channels] in [-1, 1]."""

    def __init__(self, *, in_channels: int = 3, out_channels: int = 3,
                 base_features: int = 64, n_levels: int = 8,
                 norm: str = "batch", image_size: int = 256):
        super().__init__()
        self.norm = norm
        self.n_levels = n = min(n_levels,
                                1 + max(0, image_size.bit_length() - 1))
        self.feats = [min(base_features * 2 ** i, 512) for i in range(n)]
        self.size = image_size
        cin = in_channels
        for i, feats in enumerate(self.feats):
            self.add_module(f"enc{i + 1}", _Level("conv", Conv(
                cin, feats, 4, stride=2, bias=i in (0, n - 1),
                w_init=W_INIT), _norm(feats, norm) if 0 < i < n - 1 else None,
                _norm_name(norm)))
            cin = feats
        for i in range(n - 1, 0, -1):
            feats = self.feats[i - 1]
            self.add_module(f"dec{i + 1}", _Level("deconv", ConvTranspose(
                cin, feats, 4, bias=False, w_init=W_INIT),
                _norm(feats, norm), _norm_name(norm)))
            cin = 2 * feats
        self.add_module("dec1", _Level("deconv", ConvTranspose(
            cin, out_channels, 4, w_init=W_INIT), None, ""))

    def dropout_sites(self) -> dict[str, tuple]:
        """{site: per-image mask shape} of the three innermost decoder
        levels, in forward order."""
        n = self.n_levels
        return {f"dec{i + 1}": (self.size >> i, self.size >> i,
                                self.feats[i - 1])
                for i in range(n - 1, 0, -1) if i >= n - 3}

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """Keep masks of one train-mode forward of ``n`` images, in forward
        order, on the generator's device."""
        return {site: keep_mask((n, *shape), 0.5, generator)
                for site, shape in self.dropout_sites().items()}

    def forward(self, x: torch.Tensor, masks=None,
                generator: torch.Generator | None = None, *,
                kernels: bool = True) -> torch.Tensor:
        masks = masks or {}
        n = self.n_levels
        route = kernels and not self.training and self.norm == "batch"
        skips, h = [], x
        for i in range(n):
            level = getattr(self, f"enc{i + 1}")
            y, norm = level.conv_layer()(h), level.norm_layer()
            if norm is not None and route:
                # lrelu(bn(y)) in one launch: the next input and the skip
                h = bn_act(norm, y, "leaky_relu")
                skips.append(h)
                continue
            if norm is not None:
                y = norm(y)
            skips.append(y)
            h = leaky_relu(y, 0.2)
        for i in range(n - 1, 0, -1):
            level = getattr(self, f"dec{i + 1}")
            y, norm = level.conv_layer()(h), level.norm_layer()
            if route:   # eval: dropout is the identity
                h = torch.cat([bn_act(norm, y, "relu"),
                               relu(skips[i - 1])], dim=-1)
                continue
            y = norm(y)
            if i >= n - 3:
                site = f"dec{i + 1}"
                y = dropout(y, 0.5, train=self.training,
                            generator=generator, mask=masks.get(site))
            h = relu(torch.cat([y, skips[i - 1]], dim=-1))
        return tanh(self.dec1.conv_layer()(h))


class PatchGANDiscriminator(nn.Module):
    """70x70 PatchGAN: ``forward(x, y=None)`` on the channel concatenation
    of (x, y) -> patch logits [N, S/2^n_layers, S/2^n_layers, 1].  Under
    ``spectral_norm`` no norm layer, and every conv biased."""

    def __init__(self, *, in_channels: int = 6, base_features: int = 64,
                 n_layers: int = 3, norm: str = "batch",
                 spectral_norm: bool = False):
        super().__init__()
        self.sn = sn = spectral_norm
        self.n_layers = n_layers
        self.conv = Conv(in_channels, base_features, 4, stride=2, bias=True,
                         w_init=W_INIT, spectral_norm=sn)
        name = _norm_name(norm)
        cin = base_features
        for i in range(1, n_layers + 1):
            feats = min(cin * 2, 512)
            self.add_module(auto_name("conv", i), Conv(
                cin, feats, 4, stride=2 if i < n_layers else 1, bias=sn,
                w_init=W_INIT, spectral_norm=sn))
            if not sn:
                self.add_module(auto_name(name, i - 1), _norm(feats, norm))
            cin = feats
        self.norm_name = name
        self.logits = Conv(cin, 1, 4, bias=True, w_init=W_INIT,
                           spectral_norm=sn)

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None
                ) -> torch.Tensor:
        h = x if y is None else torch.cat([x, y], dim=-1)
        h = leaky_relu(self.conv(h), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, auto_name("conv", i))(h)
            if not self.sn:
                h = getattr(self, auto_name(self.norm_name, i - 1))(h)
            h = leaky_relu(h, 0.2)
        return self.logits(h)
