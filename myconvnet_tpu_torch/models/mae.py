"""Masked Autoencoder (He et al., 2022): self-supervised ViT pretraining.

Port of ``myconvnet_tpu/models/mae.py``.  The encoder is the port's ViT
(``patch_embed``, the root ``cls_token`` and ``pos_embed``, ``block{i}``
as :class:`.vit.Block`, ``ln``), so its scopes are the ones a ViT
classifier has and an exported encoder warm-starts one.  The decoder sits
under ``decoder`` (``embed``, its own ``mask_token`` and ``pos_embed``,
``block{i}``, ``ln``, ``pred``).  Attention goes through
``ops.attention.multi_head_attention``: bf16 CUDA tensors without dropout
reach the flash kernels (B6) in every encoder and decoder block.

:func:`random_masking` (``mae.py:58-77``) keeps ``max(int(n * (1 -
mask_ratio)), 1)`` tokens per image: those of the smallest ``noise``, a
[B, N] draw that is uniform in JAX.  Here the draw is a ``torch.rand``
from an explicit ``torch.Generator``, or handed in (``noise``), so that a
test can give the port a draw with JAX's kept set.  The encoder's result
does not depend on the order of the kept tokens (the position embedding
is added before the shuffle and attention is order-free), and the decoder
puts them back in token order, so equal kept sets give equal outputs.

``forward(x)`` returns ``(pred, target, mask)`` as JAX's; the
``norm_pix`` target normalizes each patch in float32 by its mean and its
variance with ddof 0 (``jnp.var``), ``+1e-6`` inside the square root.
``features(x)`` (JAX's ``features_only=True``) skips the masking and the
decoder and returns the mean of the patch tokens after ``ln``, the kNN
probe's feature.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.core.init import normal
from myconvnet_tpu_torch.models.vit import VARIANTS, Block
from myconvnet_tpu_torch.nn import Conv, Dense, LayerNorm


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch*patch*C], row-major patches (the
    token order of the stride-``patch`` embedding conv)."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def unpatchify(p: torch.Tensor, patch: int, hw: tuple[int, int],
               channels: int = 3) -> torch.Tensor:
    """Inverse of :func:`patchify`."""
    b = p.shape[0]
    gh, gw = hw[0] // patch, hw[1] // patch
    x = p.reshape(b, gh, gw, patch, patch, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * patch, gw * patch, channels)


def keep_count(n: int, mask_ratio: float) -> int:
    """Tokens kept per image, as ``mae.py:66`` computes it."""
    return max(int(n * (1.0 - mask_ratio)), 1)


def random_masking(x: torch.Tensor, mask_ratio: float,
                   noise: torch.Tensor):
    """x [B, N, D] and a [B, N] draw -> (x_kept [B, K, D], mask [B, N]
    with 1 = masked in x's dtype, ids_restore [B, N])."""
    b, n, d = x.shape
    keep = keep_count(n, mask_ratio)
    ids_shuffle = torch.argsort(noise.to(x.device), dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :keep]
    kept = torch.gather(x, 1, ids_keep[:, :, None].expand(b, keep, d))
    mask = torch.cat([x.new_zeros((b, keep)), x.new_ones((b, n - keep))],
                     dim=1)
    return kept, torch.gather(mask, 1, ids_restore), ids_restore


class Decoder(nn.Module):
    def __init__(self, dim: int, n: int, dec_dim: int, depth: int,
                 heads: int, out_dim: int):
        super().__init__()
        self.dim, self.depth = dec_dim, depth
        self.embed = Dense(dim, dec_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dec_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dec_dim))
        for i in range(depth):
            self.add_module(f"block{i + 1}", Block(
                f"decoder/block{i + 1}", dec_dim, heads, 4 * dec_dim,
                0.0, 0.0, 0.0))
        self.ln = LayerNorm(dec_dim)
        self.pred = Dense(dec_dim, out_dim)

    @torch.no_grad()
    def init_own_params(self, generator: torch.Generator) -> None:
        """``mask_token`` and ``pos_embed`` from normal(0.02)."""
        for p in (self.mask_token, self.pos_embed):
            p.copy_(normal(0.02)(tuple(p.shape), generator))

    def forward(self, y, ids_restore):
        b, n = ids_restore.shape
        y = self.embed(y)
        k = y.shape[1] - 1
        fill = self.mask_token.to(y.dtype).expand(b, n - k, self.dim)
        filled = torch.cat([y[:, 1:], fill], dim=1)
        filled = torch.gather(filled, 1, ids_restore[:, :, None].expand(
            b, n, self.dim))
        y = torch.cat([y[:, :1], filled], dim=1) + self.pos_embed.to(y.dtype)
        for i in range(self.depth):
            y = getattr(self, f"block{i + 1}")(y)
        return self.pred(self.ln(y))[:, 1:]


class MAE(nn.Module):
    def __init__(self, *, variant: str = "b16",
                 input_hw: tuple[int, int] = (224, 224),
                 mask_ratio: float = 0.75, decoder_dim: int = 512,
                 decoder_depth: int = 8, decoder_heads: int = 16,
                 norm_pix: bool = True):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown ViT variant {variant!r}; "
                             f"valid: {sorted(VARIANTS)}")
        patch, dim, depth, heads, mlp_dim = VARIANTS[variant]
        h, w = input_hw
        if h % patch or w % patch:
            raise ValueError(f"input {h}x{w} not divisible by patch {patch}")
        self.patch, self.dim, self.depth = patch, dim, depth
        self.input_hw = (h, w)
        self.mask_ratio, self.norm_pix = mask_ratio, norm_pix
        n = (h // patch) * (w // patch)
        self.tokens = n
        self.patch_embed = Conv(3, dim, patch, stride=patch,
                                padding="VALID", bias=True)
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        for i in range(depth):
            self.add_module(f"block{i + 1}", Block(
                f"block{i + 1}", dim, heads, mlp_dim, 0.0, 0.0, 0.0))
        self.ln = LayerNorm(dim)
        self.decoder = Decoder(dim, n, decoder_dim, decoder_depth,
                               decoder_heads, patch * patch * 3)

    @torch.no_grad()
    def init_own_params(self, generator: torch.Generator) -> None:
        """``pos_embed`` from normal(0.02), ``cls_token`` zeros
        (``mae.py:112-114``)."""
        self.pos_embed.copy_(normal(0.02)(tuple(self.pos_embed.shape),
                                          generator))
        self.cls_token.zero_()

    def sample_noise(self, n: int, generator: torch.Generator
                     ) -> torch.Tensor:
        """A batch's masking draw: uniform [n, N] on the generator's
        device."""
        return torch.rand((n, self.tokens), generator=generator,
                          device=generator.device)

    def _encode(self, x, noise):
        b = x.shape[0]
        tok = self.patch_embed(x).reshape(b, -1, self.dim)
        tok = tok + self.pos_embed[:, 1:].to(tok.dtype)
        mask = ids_restore = None
        if noise is not None:
            tok, mask, ids_restore = random_masking(tok, self.mask_ratio,
                                                    noise)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(tok.dtype)
        y = torch.cat([cls.expand(b, 1, self.dim), tok], dim=1)
        for i in range(self.depth):
            y = getattr(self, f"block{i + 1}")(y)
        return self.ln(y), mask, ids_restore

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of the patch tokens after ``ln``, [B, dim]."""
        y, _, _ = self._encode(x, None)
        return y[:, 1:].mean(dim=1)

    def target(self, x: torch.Tensor) -> torch.Tensor:
        """The reconstruction target: the patches, normalized each by its
        own mean and variance (ddof 0) in float32 under ``norm_pix``, in
        x's dtype."""
        t = patchify(x, self.patch)
        if not self.norm_pix:
            return t
        t32 = t.float()
        mean = t32.mean(dim=-1, keepdim=True)
        var = t32.var(dim=-1, keepdim=True, correction=0)
        return ((t32 - mean) / torch.sqrt(var + 1e-6)).to(t.dtype)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """x: [B, H, W, 3] in the compute dtype -> (pred, target, mask);
        ``noise`` [B, N] is the masking draw, else one from
        ``generator``."""
        if noise is None:
            if generator is None:
                raise ValueError("MAE's masking needs a noise draw or a "
                                 "generator")
            noise = self.sample_noise(x.shape[0], generator)
        y, mask, ids_restore = self._encode(x, noise)
        return self.decoder(y, ids_restore), self.target(x), mask


def mae_b16(**kw) -> MAE:
    return MAE(variant="b16", **kw)


def mae_l16(**kw) -> MAE:
    return MAE(variant="l16", **kw)


def tinymae(**kw) -> MAE:
    """CPU-test scale: ViT 'test' variant encoder + 1-block decoder."""
    kw.setdefault("decoder_dim", 32)
    kw.setdefault("decoder_depth", 1)
    kw.setdefault("decoder_heads", 2)
    return MAE(variant="test", **kw)
