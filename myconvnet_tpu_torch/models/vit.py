"""Vision Transformer (Dosovitskiy et al., 2021), NHWC input.

Port of ``myconvnet_tpu/models/vit.py:36-149``.  Module paths equal the
JAX scope paths with "/" read as "." (``patch_embed``, ``block1.ln1``,
``block1.qkv``, ``block1.proj``, ``block1.ln2``, ``block1.mlp.fc1``,
``block1.mlp.fc2``, ``ln``, ``head.logits``); ``cls_token`` and
``pos_embed`` sit on the root module, the JAX root scope ``~``.

The block is the JAX one: LN -> packed qkv dense, reshaped to
[B, L, 3, H, D] (``vit.py:50-52``) -> attention
(``ops.attention.multi_head_attention``: the flash kernels for bf16 CUDA
tensors, einsum otherwise) -> proj -> dropout -> drop-path -> residual;
LN -> fc1 -> exact GELU -> dropout -> fc2 -> dropout -> drop-path ->
residual.  Block ``i`` (from 0) drops its path at
``drop_path_rate * i / (depth - 1)``.  The classifier reads the CLS token
after the final LN; ``repr_dim`` adds the tanh pre-logits dense.

Every random draw of a train-mode forward (drop-path, and dropout where
its rate is > 0) is a keep mask named by its site (``block3/path_attn``,
...): :meth:`ViT.sample_masks` draws all of one batch from a
``torch.Generator``, and ``forward(x, masks)`` uses them, so a test or a
card-against-host check can hand the same masks to both sides.  A site
whose mask is missing draws from ``generator`` and fails without one.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.core.init import normal
from myconvnet_tpu_torch.nn import (Conv, Dense, LayerNorm, drop_path,
                                    dropout, gelu, keep_mask)
from myconvnet_tpu_torch.ops.attention import multi_head_attention

# name: (patch, dim, depth, heads, mlp_dim)
VARIANTS = {
    "ti16": (16, 192, 12, 3, 768),
    "s16": (16, 384, 12, 6, 1536),
    "b16": (16, 768, 12, 12, 3072),
    "b32": (32, 768, 12, 12, 3072),
    "l16": (16, 1024, 24, 16, 4096),
    # CPU-test scale: 2 blocks, 8x8 inputs with patch 4 -> L = 5
    "test": (4, 32, 2, 2, 64),
}


def _drop(fn, x, rate, train, masks, generator, site):
    return fn(x, rate, train=train, generator=generator,
              mask=None if masks is None else masks.get(site))


class MLP(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.fc1 = Dense(dim, mlp_dim)
        self.fc2 = Dense(mlp_dim, dim)


class Block(nn.Module):
    def __init__(self, name: str, dim: int, heads: int, mlp_dim: int,
                 dropout_rate: float, attn_dropout: float,
                 drop_path_rate: float):
        super().__init__()
        self.name = name
        self.heads = heads
        self.dropout_rate = dropout_rate
        self.attn_dropout = attn_dropout
        self.drop_path_rate = drop_path_rate
        self.ln1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.ln2 = LayerNorm(dim)
        self.mlp = MLP(dim, mlp_dim)

    def mask_shapes(self, n: int, length: int) -> dict[str, tuple]:
        """{site: (mask shape, rate)} of the sites with a rate > 0."""
        dim, mlp_dim = self.qkv.weight.shape[1], self.mlp.fc1.weight.shape[0]
        sites = {
            "attn": ((n, self.heads, length, length), self.attn_dropout),
            "proj": ((n, length, dim), self.dropout_rate),
            "path_attn": ((n,), self.drop_path_rate),
            "mlp": ((n, length, mlp_dim), self.dropout_rate),
            "mlp_out": ((n, length, dim), self.dropout_rate),
            "path_mlp": ((n,), self.drop_path_rate)}
        return {f"{self.name}/{k}": v for k, v in sites.items() if v[1] > 0}

    def _attention(self, x, masks, generator):
        b, l, dim = x.shape
        heads = self.heads
        qkv = self.qkv(x).view(b, l, 3, heads, dim // heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        rate = self.attn_dropout if self.training else 0.0
        mask = None
        if rate > 0.0:
            mask = None if masks is None else masks.get(f"{self.name}/attn")
            if mask is None:
                if generator is None:
                    raise ValueError("attention dropout in training needs "
                                     "a mask or a generator")
                mask = keep_mask((b, heads, l, l), rate, generator)
        out = multi_head_attention(q, k, v, dropout_rate=rate,
                                   dropout_mask=mask,
                                   use_flash=False if rate > 0.0 else None)
        out = self.proj(out.transpose(1, 2).reshape(b, l, dim))
        return _drop(dropout, out, self.dropout_rate, self.training, masks,
                     generator, f"{self.name}/proj")

    def forward(self, x, masks=None, generator=None):
        train, name = self.training, self.name
        h = self._attention(self.ln1(x), masks, generator)
        x = x + _drop(drop_path, h, self.drop_path_rate, train, masks,
                      generator, f"{name}/path_attn")
        h = gelu(self.mlp.fc1(self.ln2(x)))
        h = _drop(dropout, h, self.dropout_rate, train, masks, generator,
                  f"{name}/mlp")
        h = _drop(dropout, self.mlp.fc2(h), self.dropout_rate, train, masks,
                  generator, f"{name}/mlp_out")
        return x + _drop(drop_path, h, self.drop_path_rate, train, masks,
                         generator, f"{name}/path_mlp")


class Head(nn.Module):
    def __init__(self, dim: int, num_classes: int, repr_dim: int | None):
        super().__init__()
        if repr_dim is not None:
            self.pre_logits = Dense(dim, repr_dim)
            dim = repr_dim
        self.logits = Dense(dim, num_classes)

    def forward(self, x):
        if hasattr(self, "pre_logits"):
            x = torch.tanh(self.pre_logits(x))
        return self.logits(x)


class ViT(nn.Module):
    def __init__(self, num_classes: int = 1000, *, variant: str = "b16",
                 input_hw: tuple[int, int] = (224, 224),
                 dropout: float = 0.0, attn_dropout: float = 0.0,
                 drop_path_rate: float = 0.0, repr_dim: int | None = None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown ViT variant {variant!r}; "
                             f"valid: {sorted(VARIANTS)}")
        patch, dim, depth, heads, mlp_dim = VARIANTS[variant]
        h, w = input_hw
        if h % patch or w % patch:
            raise ValueError(f"input {h}x{w} not divisible by patch {patch}")
        self.patch, self.dim = patch, dim
        self.input_hw = (h, w)
        self.dropout_rate = dropout
        self.patch_embed = Conv(3, dim, patch, stride=patch,
                                padding="VALID", bias=True)
        n = (h // patch) * (w // patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim))
        total = max(depth - 1, 1)
        for i in range(depth):
            self.add_module(f"block{i + 1}", Block(
                f"block{i + 1}", dim, heads, mlp_dim, dropout, attn_dropout,
                drop_path_rate * i / total))
        self.depth = depth
        self.ln = LayerNorm(dim)
        self.head = Head(dim, num_classes, repr_dim)

    def blocks(self):
        return [getattr(self, f"block{i + 1}") for i in range(self.depth)]

    @torch.no_grad()
    def init_own_params(self, generator: torch.Generator) -> None:
        """``pos_embed`` from normal(0.02), ``cls_token`` zeros
        (``vit.py:101-110``)."""
        self.cls_token.zero_()
        self.pos_embed.copy_(normal(0.02)(tuple(self.pos_embed.shape),
                                          generator))

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """Keep masks of every random site of a train-mode forward of a
        batch of ``n``, in forward order, on the generator's device."""
        length = self.pos_embed.shape[1]
        sites = {}
        if self.dropout_rate > 0:
            sites["embed"] = ((n, length, self.dim), self.dropout_rate)
        for block in self.blocks():
            sites.update(block.mask_shapes(n, length))
        return {site: keep_mask(shape, rate, generator)
                for site, (shape, rate) in sites.items()}

    def forward(self, x: torch.Tensor, masks=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: [B, H, W, 3] in the compute dtype -> logits [B, classes]."""
        b = x.shape[0]
        x = self.patch_embed(x).reshape(b, -1, self.dim)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = _drop(dropout, x, self.dropout_rate, self.training, masks,
                  generator, "embed")
        for block in self.blocks():
            x = block(x, masks, generator)
        return self.head(self.ln(x)[:, 0])


def vit(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes, **kw)


def vit_ti16(num_classes=1000, **kw):
    return ViT(num_classes, variant="ti16", **kw)


def vit_s16(num_classes=1000, **kw):
    return ViT(num_classes, variant="s16", **kw)


def vit_b16(num_classes=1000, **kw):
    return ViT(num_classes, variant="b16", **kw)


def vit_b32(num_classes=1000, **kw):
    return ViT(num_classes, variant="b32", **kw)


def vit_l16(num_classes=1000, **kw):
    return ViT(num_classes, variant="l16", **kw)


def tinyvit(num_classes=10, **kw):
    return ViT(num_classes, variant="test", **kw)
