"""ConvNeXt (tiny, small, base), NHWC.

Port of ``myconvnet_tpu/models/convnext.py``: the patchify stem (a 4x4
stride-4 ``stem/conv`` with bias -> ``stem/ln``), before each later stage
a ``down{s}/ln`` -> 2x2 stride-2 ``down{s}/conv`` with bias, and the
blocks ``stage{s}_block{b}``: the 7x7 ``dwconv`` with bias -> ``ln`` ->
``pw1`` (4C) -> GELU -> ``pw2`` (C) -> the per-channel ``layer_scale``
(a float32 parameter of the block's scope, 1e-6 at init) -> drop-path ->
the residual add; then global average pool -> ``head/ln`` ->
``head/logits``.  Every LN has eps 1e-6 (``nn.LayerNorm``).  The GELU is
JAX's ``jax.nn.gelu`` default, the tanh approximation
(``approximate=True``), which ``nn.gelu`` of the JAX package calls.

Drop-path ramps linearly over the blocks: block i of ``sum(depths)``
drops at ``drop_path_rate * i / (sum(depths) - 1)`` (the first at 0, so
it draws nothing); the site of a block is its scope name, a [N] keep mask
drawn by :meth:`ConvNeXt.sample_masks` in forward order.  No kernel of
the port runs here: LN, GELU and the 7x7 depthwise conv are plain ops,
as XLA builds them in the JAX package without Pallas.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import draw_masks
from myconvnet_tpu_torch.nn import (Conv, Dense, DepthwiseConv, LayerNorm,
                                    drop_path, gap)

# depths / dims per variant (the paper's table 1)
VARIANTS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
}


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)``: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, *, drop_rate: float,
                 layer_scale_init: float, site: str):
        super().__init__()
        self.drop_rate, self.site = drop_rate, site
        self.dwconv = DepthwiseConv(dim, 7, bias=True)
        self.ln = LayerNorm(dim)
        self.pw1 = Dense(dim, 4 * dim)
        self.pw2 = Dense(4 * dim, dim)
        if layer_scale_init > 0:
            self.layer_scale = nn.Parameter(
                torch.full((dim,), float(layer_scale_init)))
        else:
            self.layer_scale = None

    def forward(self, x, masks=None, generator=None):
        h = self.pw2(gelu_tanh(self.pw1(self.ln(self.dwconv(x)))))
        if self.layer_scale is not None:
            h = h * self.layer_scale.to(h.dtype)
        h = drop_path(h, self.drop_rate, train=self.training,
                      generator=generator,
                      mask=None if masks is None else masks.get(self.site))
        return x + h


class ConvNeXt(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> logits [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, *, variant: str = "tiny",
                 drop_path_rate: float = 0.1,
                 layer_scale_init: float = 1e-6, in_channels: int = 3):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown ConvNeXt variant {variant!r}; "
                             f"valid: {sorted(VARIANTS)}")
        depths, dims = VARIANTS[variant]
        total = sum(depths)
        self.stem = nn.Module()
        self.stem.conv = Conv(in_channels, dims[0], 4, stride=4, bias=True)
        self.stem.ln = LayerNorm(dims[0])
        self.stages, self.rates = [], {}
        idx, cin = 0, dims[0]
        for stage, (depth, dim) in enumerate(zip(depths, dims)):
            down = None
            if stage > 0:
                down = nn.Module()
                down.ln = LayerNorm(cin)
                down.conv = Conv(cin, dim, 2, stride=2, bias=True)
                self.add_module(f"down{stage}", down)
            blocks = []
            for b in range(depth):
                rate = drop_path_rate * idx / max(total - 1, 1)
                site = f"stage{stage + 1}_block{b + 1}"
                blk = ConvNeXtBlock(dim, drop_rate=rate,
                                    layer_scale_init=layer_scale_init,
                                    site=site)
                self.add_module(site, blk)
                blocks.append(blk)
                self.rates[site] = rate
                idx += 1
            self.stages.append((down, blocks))
            cin = dim
        self.width = cin
        self.head = nn.Module()
        self.head.ln = LayerNorm(cin)
        self.head.logits = Dense(cin, num_classes)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """The drop-path keep masks [n] of the blocks with a rate above
        0, in forward order."""
        return draw_masks({site: ((n,), rate)
                           for site, rate in self.rates.items()}, generator)

    def trunk(self, x, masks=None, generator=None) -> torch.Tensor:
        """The last stage's map, before the pooling (JAX tags none of
        this model's maps ``features``, so it has no ``features``)."""
        x = self.stem.ln(self.stem.conv(x))
        for down, blocks in self.stages:
            if down is not None:
                x = down.conv(down.ln(x))
            for blk in blocks:
                x = blk(x, masks, generator)
        return x

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        h = gap(self.trunk(x, masks, generator))
        return self.head.logits(self.head.ln(h))


def convnext(num_classes: int = 1000, **kwargs) -> ConvNeXt:
    return ConvNeXt(num_classes, **kwargs)


def convnext_tiny(num_classes: int = 1000, **kwargs) -> ConvNeXt:
    return ConvNeXt(num_classes, variant="tiny", **kwargs)


def convnext_small(num_classes: int = 1000, **kwargs) -> ConvNeXt:
    return ConvNeXt(num_classes, variant="small", **kwargs)
