"""Swin Transformer (Liu et al., 2021), NHWC input.

Port of ``myconvnet_tpu/models/swin.py``.  Module paths equal the JAX
scope paths with "/" read as "." (``patch_embed``, ``ln_embed``,
``stage1_block1.ln1``, ``stage1_block1.attn.qkv``, ``.attn.proj``, the
table ``stage1_block1.attn`` / ``rel_bias``, ``.ln2``, ``.mlp.fc1``,
``.mlp.fc2``, ``merge1.ln``, ``merge1.reduce`` (no bias), ``ln``,
``head.logits``).

* Window partition and reverse are the JAX reshapes and transposes
  (``swin.py:48-63``); the relative-position index (``:66-73``) and the
  shift mask (``:76-91``, additive -1e9 in float32) are made with numpy
  when the model is built at its ``input_hw``, and kept as buffers, so
  nothing is cached at run time (no tensor made under inference mode or
  while ``torch.export`` traces).
* Window attention (``:94-121``) is plain ops, as in JAX (an einsum
  chain, not a Pallas kernel): the scores in float32 from q and k cast to
  float32, the bias table gathered by the index, the mask, a float32
  softmax, ``p v`` in float32, cast back.  It does not reach the flash
  kernels (B6), which take no additive bias.  The gradient of the gather
  is a sum over each table entry's positions in a fixed order
  (:class:`_GatherRows`), not an ``index_add`` with atomics, so a step's
  bits do not change from run to run on the card.
* The block (``:124-152``) rolls by (-shift, -shift) on (H, W) before
  the attention and back after it; patch merging (``:155-166``) takes the
  2x2 neighbours in the order (dy, dx, c) of JAX's reshape (not timm's
  x0..x3); the stage loop (``:169-215``) clips the window to the map,
  turns the shift off where one window covers it, and drops block ``i``'s
  path at ``rate * i / (sum(depths) - 1)``.
* :meth:`Swin.features` is the pooled [B, C] the JAX model tags
  ``"features"`` (``:213``).  Dropout and drop-path take keep masks by
  site (``embed``, ``<block>/path_attn``, ``<block>/mlp``,
  ``<block>/mlp_out``, ``<block>/path_mlp``) from
  :meth:`Swin.sample_masks`, as :mod:`.vit` does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch.core.init import normal
from myconvnet_tpu_torch.nn import (Conv, Dense, LayerNorm, drop_path,
                                    dropout, gelu, keep_mask)

# name: (embed_dim, depths, heads, window)
VARIANTS = {
    "t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
    "s": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7),
    "b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 7),
    # CPU-test scale: 2 stages on 32x32 inputs (patch 2 -> 16 -> 8)
    "test": (16, (1, 1), (2, 2), 4),
}


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C] (row-major windows)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, hw: tuple[int, int],
                   b: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    h, w = hw
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """Static [ws², ws²] index into the (2w-1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def shift_attn_mask(hw: tuple[int, int], ws: int, shift: int) -> np.ndarray:
    """Static additive mask [nW, n, n] of shifted-window attention: 0
    within a region, -1e9 across the regions the roll brought together."""
    h, w = hw
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = window_partition(torch.from_numpy(img), ws)[..., 0].numpy()
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


def _positions_by_entry(index: np.ndarray, entries: int) -> np.ndarray:
    """[entries, m] positions of ``index`` (flat) holding each table entry,
    padded with ``index.size`` (a zero row appended to the gradient)."""
    flat = index.reshape(-1)
    lists = [np.flatnonzero(flat == e) for e in range(entries)]
    m = max(len(p) for p in lists)
    out = np.full((entries, m), flat.size, np.int64)
    for e, p in enumerate(lists):
        out[e, :len(p)] = p
    return out


class _GatherRows(torch.autograd.Function):
    """``table[index]`` whose gradient sums each entry's rows in one fixed
    order (a gather and a sum, no atomics)."""

    @staticmethod
    def forward(ctx, table, index, positions):
        ctx.save_for_backward(positions)
        return table.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (positions,) = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return padded[positions].sum(1), None, None


class WindowAttention(nn.Module):
    """``_window_attention``: qkv and proj denses, the float32 score chain
    with the relative-position bias and the shift mask."""

    def __init__(self, dim: int, heads: int, ws: int,
                 mask: np.ndarray | None):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        entries = (2 * ws - 1) ** 2
        self.rel_bias = nn.Parameter(torch.zeros(entries, heads))
        index = relative_position_index(ws)
        self.register_buffer("rel_index", torch.from_numpy(
            index.reshape(-1).astype(np.int64)), persistent=False)
        self.register_buffer("rel_positions", torch.from_numpy(
            _positions_by_entry(index, entries)), persistent=False)
        self.register_buffer(
            "mask", None if mask is None else torch.from_numpy(mask),
            persistent=False)

    @torch.no_grad()
    def init_own_params(self, generator: torch.Generator) -> None:
        """``rel_bias`` from normal(0.02) (``swin.py:107-108``)."""
        self.rel_bias.copy_(normal(0.02)(tuple(self.rel_bias.shape),
                                         generator))

    def bias(self) -> torch.Tensor:
        """[heads, n, n] float32 relative-position bias."""
        n = self.ws * self.ws
        if torch.is_grad_enabled() and self.rel_bias.requires_grad:
            rows = _GatherRows.apply(self.rel_bias, self.rel_index,
                                     self.rel_positions)
        else:   # no gradient: the plain gather (an exported graph's)
            rows = self.rel_bias.index_select(0, self.rel_index)
        return rows.reshape(n, n, self.heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn, n, c = x.shape
        heads = self.heads
        qkv = self.qkv(x).reshape(bn, n, 3, heads, c // heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scale = float(c // heads) ** -0.5
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        s = s + self.bias()[None]
        if self.mask is not None:
            nw = self.mask.shape[0]
            s = (s.reshape(bn // nw, nw, heads, n, n)
                 + self.mask[None, :, None]).reshape(bn, heads, n, n)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
        out = out.to(x.dtype).transpose(1, 2).reshape(bn, n, c)
        return self.proj(out)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)


class SwinBlock(nn.Module):
    """``_swin_block``: one W-MSA or SW-MSA block on the [B, H*W, C]
    token grid."""

    def __init__(self, name: str, dim: int, hw: tuple[int, int], *,
                 heads: int, ws: int, shift: int, mlp_ratio: float,
                 dropout_rate: float, drop_path_rate: float):
        super().__init__()
        self.name, self.hw, self.ws, self.shift = name, hw, ws, shift
        self.dropout_rate, self.drop_path_rate = dropout_rate, drop_path_rate
        self.ln1 = LayerNorm(dim)
        self.attn = WindowAttention(
            dim, heads, ws, shift_attn_mask(hw, ws, shift) if shift > 0
            else None)
        self.ln2 = LayerNorm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio))

    def mask_shapes(self, n: int) -> dict[str, tuple]:
        """{site: (mask shape, rate)} of the sites with a rate > 0."""
        length = self.hw[0] * self.hw[1]
        dim, hidden = self.mlp.fc2.weight.shape[0], \
            self.mlp.fc1.weight.shape[0]
        sites = {"path_attn": ((n,), self.drop_path_rate),
                 "mlp": ((n, length, hidden), self.dropout_rate),
                 "mlp_out": ((n, length, dim), self.dropout_rate),
                 "path_mlp": ((n,), self.drop_path_rate)}
        return {f"{self.name}/{k}": v for k, v in sites.items() if v[1] > 0}

    def _drop(self, fn, x, rate, masks, generator, site):
        return fn(x, rate, train=self.training, generator=generator,
                  mask=None if masks is None
                  else masks.get(f"{self.name}/{site}"))

    def forward(self, x, masks=None, generator=None):
        b, l, c = x.shape
        h, w = self.hw
        shift, ws = self.shift, self.ws
        y = self.ln1(x).reshape(b, h, w, c)
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, ws)), ws, (h, w), b)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self._drop(drop_path, y.reshape(b, l, c),
                           self.drop_path_rate, masks, generator,
                           "path_attn")
        y = gelu(self.mlp.fc1(self.ln2(x)))
        y = self._drop(dropout, y, self.dropout_rate, masks, generator, "mlp")
        y = self._drop(dropout, self.mlp.fc2(y), self.dropout_rate, masks,
                       generator, "mlp_out")
        return x + self._drop(drop_path, y, self.drop_path_rate, masks,
                              generator, "path_mlp")


class PatchMerging(nn.Module):
    """2x2 space-to-depth (channels in (dy, dx, c) order) + LN + a dense
    to 2C without bias."""

    def __init__(self, dim: int, hw: tuple[int, int]):
        super().__init__()
        self.hw = hw
        self.ln = LayerNorm(4 * dim)
        self.reduce = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, _, c = x.shape
        h, w = self.hw
        y = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.reduce(self.ln(y))


class Head(nn.Module):
    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.logits = Dense(dim, num_classes)


class Swin(nn.Module):
    def __init__(self, num_classes: int = 1000, *, variant: str = "t",
                 input_hw: tuple[int, int] = (224, 224), patch: int = 4,
                 mlp_ratio: float = 4.0, dropout: float = 0.0,
                 drop_path_rate: float = 0.2):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown Swin variant {variant!r}; "
                             f"valid: {sorted(VARIANTS)}")
        dim, depths, heads, ws = VARIANTS[variant]
        h, w = input_hw
        if h % patch or w % patch:
            raise ValueError(f"input {h}x{w} not divisible by patch {patch}")
        self.input_hw, self.dim = (h, w), dim
        self.dropout_rate = dropout
        self.patch_embed = Conv(3, dim, patch, stride=patch,
                                padding="VALID", bias=True)
        hw = (h // patch, w // patch)
        self.embed_hw = hw
        self.ln_embed = LayerNorm(dim)
        total = max(sum(depths) - 1, 1)
        blk = 0
        self.layers = []
        c = dim
        for stage, (depth, n_heads) in enumerate(zip(depths, heads)):
            if stage > 0:
                merge = PatchMerging(c, hw)
                self.add_module(f"merge{stage}", merge)
                self.layers.append(f"merge{stage}")
                hw, c = (hw[0] // 2, hw[1] // 2), 2 * c
            eff_ws = min(ws, hw[0], hw[1])
            if hw[0] % eff_ws or hw[1] % eff_ws:
                raise ValueError(f"stage {stage}: resolution {hw} not "
                                 f"divisible by window {eff_ws}")
            for i in range(depth):
                shift = (eff_ws // 2) if (i % 2 == 1) \
                    and eff_ws < min(hw) else 0
                name = f"stage{stage + 1}_block{i + 1}"
                self.add_module(name, SwinBlock(
                    name, c, hw, heads=n_heads, ws=eff_ws, shift=shift,
                    mlp_ratio=mlp_ratio, dropout_rate=dropout,
                    drop_path_rate=drop_path_rate * blk / total))
                self.layers.append(name)
                blk += 1
        self.ln = LayerNorm(c)
        self.head = Head(c, num_classes)

    def blocks(self) -> list[SwinBlock]:
        return [m for m in map(self.get_submodule, self.layers)
                if isinstance(m, SwinBlock)]

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """Keep masks of every random site of a train-mode forward of a
        batch of ``n``, in forward order, on the generator's device."""
        sites = {}
        if self.dropout_rate > 0:
            length = self.embed_hw[0] * self.embed_hw[1]
            sites["embed"] = ((n, length, self.dim), self.dropout_rate)
        for block in self.blocks():
            sites.update(block.mask_shapes(n))
        return {site: keep_mask(shape, rate, generator)
                for site, (shape, rate) in sites.items()}

    def features(self, x: torch.Tensor, masks=None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """The pooled tokens after the final LN, [B, C] (the JAX tag
        ``features``)."""
        b = x.shape[0]
        x = self.patch_embed(x).reshape(b, -1, self.dim)
        x = dropout(self.ln_embed(x), self.dropout_rate, train=self.training,
                    generator=generator,
                    mask=None if masks is None else masks.get("embed"))
        for name in self.layers:
            layer = getattr(self, name)
            x = layer(x, masks, generator) if isinstance(layer, SwinBlock) \
                else layer(x)
        return self.ln(x).mean(dim=1)

    def forward(self, x: torch.Tensor, masks=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: [B, H, W, 3] in the compute dtype -> logits [B, classes]."""
        return self.head.logits(self.features(x, masks, generator))


def swin(num_classes: int = 1000, **kw) -> Swin:
    return Swin(num_classes, **kw)


def swin_t(num_classes=1000, **kw):
    return Swin(num_classes, variant="t", **kw)


def swin_s(num_classes=1000, **kw):
    return Swin(num_classes, variant="s", **kw)


def swin_b(num_classes=1000, **kw):
    return Swin(num_classes, variant="b", **kw)


def tinyswin(num_classes=10, **kw):
    kw.setdefault("patch", 2)
    kw.setdefault("drop_path_rate", 0.0)
    return Swin(num_classes, variant="test", **kw)
