"""RandAugment and AutoAugment as branch-free batch transforms.

Port of ``myconvnet_tpu/data/randaugment.py``: every op of ``POOL``
(``:48-234``), ``SIGNED``, ``CANONICAL_OPS``, ``FAST_OPS``,
``DEFAULT_OPS``, ``AUTOAUGMENT_IMAGENET`` (``:327-353``), RandAugment in
both backends (``rand_augment``, ``:255-309``) and AutoAugment
(``auto_augment``, ``:358-398``).  Images are [N, H, W, C] float32 in
[0, 1], before the normalize; an op takes them and a per-image magnitude
``mag01`` [N, 1, 1, 1] in [-1, 1] (signed for the ops in ``SIGNED``).

Sampling is split from applying, as in ``data/augment.py``:
:func:`sample_randaugment` and :func:`sample_autoaugment` draw on the
generator's device; :func:`rand_augment` and :func:`auto_augment` apply
the draws (tests hand them JAX's draws instead).  The application keeps
JAX's where-fold (``:303-308``, ``:392-397``): every op of the pool runs
on the whole batch and the draw selects one per image, so there is no
host sync and the launch counts do not depend on the draws.

* ``backend="xla"``: the fold over ``ops`` (default ``FAST_OPS``) in plain
  PyTorch.  The elementwise ops are the formulas of the ``randaugment_ew``
  kernel's plain version; sharpness is a float32 stencil over shifted
  slices (a float32 ``conv2d`` would run in TF32 on the card); equalize
  builds its histograms with ``scatter_add_`` (integer counts in float32,
  as exact as JAX's one-hot sums) and applies its table with ``gather``;
  translate gathers whole pixels (JAX's one-hot matmuls select the same
  ones); rotate, shear_x and shear_y are the ``affine`` kernels (B7:
  three launches for rotate, one for each shear).
* ``backend="pallas"``: one launch of the ``randaugment_ew`` kernel (B8)
  a layer over ``PALLAS_POOL``'s ops.

A draw's op index is its position in ``ops`` under both backends; the
pallas backend maps it into ``PALLAS_POOL`` through a table
(``randaugment.py:283-287``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from myconvnet_tpu_torch.ops.kernels import affine
from myconvnet_tpu_torch.ops.kernels import randaugment_ew as ew
from myconvnet_tpu_torch.ops.kernels.randaugment_ew import (PALLAS_POOL,
                                                            true_div)

_MAX_MAGNITUDE = 30.0
_SHEAR_MAX = 0.3            # AutoAugment's shear range at M = 30
_ROTATE_MAX = 30.0          # degrees at M = 30
# PIL's smooth kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 in float32
_SMOOTH = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) \
    / np.float32(13.0)


def _blend(a, b, factor):
    """PIL's enhance: factor 0 gives a, 1 gives b, clipped."""
    return torch.clamp(a + (b - a) * factor, 0.0, 1.0)


def _gray(x):
    return ew.gray(x)[..., None]


def _on_device(values, dtype, device) -> torch.Tensor:
    """A small constant table on ``device`` without a host sync (one
    non-blocking copy from pinned memory)."""
    host = torch.tensor(values, dtype=dtype)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


# Every op: (x [N, H, W, C] in [0, 1], mag01 [N, 1, 1, 1]) -> x.

def op_identity(x, mag01):
    return x


def op_brightness(x, mag01):
    return ew.brightness(x, mag01)


def op_contrast(x, mag01):
    return ew.contrast(x, mag01, _gray(x).mean(dim=(1, 2, 3), keepdim=True))


def op_color(x, mag01):
    return _blend(_gray(x), x, 1.0 + 0.9 * mag01)


def op_sharpness(x, mag01):
    """Blend with PIL's smooth filter, whose 3x3 blur applies to the
    interior only (edges kept)."""
    _, h, w, _ = x.shape
    blur = x
    if h > 2 and w > 2:
        acc = None
        for dy in range(3):
            for dx in range(3):
                tap = x[:, dy:h - 2 + dy, dx:w - 2 + dx] \
                    * float(_SMOOTH[dy, dx])
                acc = tap if acc is None else acc + tap
        blur = x.clone()
        blur[:, 1:-1, 1:-1] = acc
    return _blend(blur, x, 1.0 + 0.9 * mag01)


def op_posterize(x, mag01):
    return ew.posterize(x, mag01)


def op_solarize(x, mag01):
    return ew.solarize(x, mag01)


def op_solarize_add(x, mag01):
    return ew.solarize_add(x, mag01)


def op_invert(x, mag01):
    return 1.0 - x


def op_autocontrast(x, mag01):
    return ew.autocontrast(x, x.amin(dim=(1, 2), keepdim=True),
                           x.amax(dim=(1, 2), keepdim=True))


def op_equalize(x, mag01):
    """PIL's ``ImageOps.equalize`` per image and channel, on 256 bins of
    round(255 x).  JAX's formula (``randaugment.py:113-143``) with the
    histogram from ``scatter_add_`` and the table applied by ``gather``
    (JAX's one-hot [N, H, W, C, 256] would take 158 GB at the ViT
    recipe's batch if materialized).  Counts are integers in float32, so
    the result is JAX's bit for bit.  Magnitude-free."""
    n, h, w, c = x.shape
    bins = torch.clamp(torch.round(x.float() * 255.0), 0, 255).long()
    rows = bins.permute(0, 3, 1, 2).reshape(n * c, h * w)
    ones = x.new_ones((), dtype=torch.float32).expand(rows.shape)
    hist = x.new_zeros((n * c, 256), dtype=torch.float32).scatter_add_(
        1, rows, ones)
    nz = hist > 0
    iota = torch.arange(256, device=x.device)
    last_idx = torch.where(nz, iota, -1).argmax(-1, keepdim=True)
    last_count = hist.gather(1, last_idx)[:, 0]
    step = torch.floor(true_div(h * w - last_count, 255.0))     # [N * C]
    cum = torch.cumsum(hist, -1) - hist                        # below bin
    lut = torch.floor((cum + torch.floor(step / 2.0)[:, None])
                      / torch.clamp(step, min=1.0)[:, None] + 1e-4)
    lut = torch.clamp(lut, 0.0, 255.0)
    out = true_div(lut.gather(1, rows), 255.0)
    out = out.view(n, c, h, w).permute(0, 2, 3, 1)
    identity = (step < 1.0) | (nz.sum(-1) <= 1)               # PIL's no-ops
    return torch.where(identity.view(n, 1, 1, c), x, out.to(x.dtype))


def _translate(x, shift_px, axis: int, fill: float = 0.5):
    """out[i] = in[round(i + shift)] along ``axis``, ``fill`` outside."""
    size = x.shape[axis]
    i = torch.arange(size, dtype=torch.float32, device=x.device)
    src = torch.round(i[None, :] + shift_px[:, None])          # [N, size]
    inside = (src >= 0) & (src <= size - 1)
    view = [x.shape[0], 1, 1, 1]
    view[axis] = size
    idx = src.clamp(0, size - 1).long().view(view).expand(x.shape)
    return torch.where(inside.view(view), torch.gather(x, axis, idx), fill)


def op_translate_x(x, mag01):
    return _translate(x, mag01[:, 0, 0, 0] * (x.shape[2] / 3.0), axis=2)


def op_translate_y(x, mag01):
    return _translate(x, mag01[:, 0, 0, 0] * (x.shape[1] / 3.0), axis=1)


def op_shear_x(x, mag01):
    return affine.shear_x(x, mag01[:, 0, 0, 0] * _SHEAR_MAX,
                          max_abs_slope=_SHEAR_MAX)


def op_shear_y(x, mag01):
    return affine.shear_y(x, mag01[:, 0, 0, 0] * _SHEAR_MAX,
                          max_abs_slope=_SHEAR_MAX)


def op_rotate(x, mag01):
    rad = mag01[:, 0, 0, 0] * (_ROTATE_MAX * math.pi / 180.0)
    return affine.rotate(x, rad,
                         max_abs_radians=_ROTATE_MAX * math.pi / 180.0)


POOL = {
    "identity": op_identity,
    "autocontrast": op_autocontrast,
    "equalize": op_equalize,
    "invert": op_invert,
    "posterize": op_posterize,
    "solarize": op_solarize,
    "solarize_add": op_solarize_add,
    "color": op_color,
    "contrast": op_contrast,
    "brightness": op_brightness,
    "sharpness": op_sharpness,
    "translate_x": op_translate_x,
    "translate_y": op_translate_y,
    "rotate": op_rotate,
    "shear_x": op_shear_x,
    "shear_y": op_shear_y,
}
# signed ops draw a random direction per image
SIGNED = {"color", "contrast", "brightness", "sharpness",
          "translate_x", "translate_y", "rotate", "shear_x", "shear_y"}
# the paper's canonical 14-op pool (full geometry + equalize)
CANONICAL_OPS = ("identity", "autocontrast", "equalize", "rotate",
                 "solarize", "color", "posterize", "contrast",
                 "brightness", "sharpness", "shear_x", "shear_y",
                 "translate_x", "translate_y")
# the cheap pool: the where-fold runs every op for every image each layer,
# so geometry (three resampling passes for rotate) and equalize would tax
# every layer by their full cost
FAST_OPS = ("identity", "autocontrast", "invert", "posterize",
            "solarize", "solarize_add", "color", "contrast",
            "brightness", "sharpness", "translate_x", "translate_y")
DEFAULT_OPS = FAST_OPS


def resolve_ops(ops, backend: str) -> tuple[str, ...]:
    """The pool a backend runs: ``ops`` or the backend's default; the
    pallas backend takes only PALLAS_POOL's ops."""
    if backend == "pallas":
        ops = PALLAS_POOL if ops is None else tuple(ops)
        bad = set(ops) - set(PALLAS_POOL)
        if bad:
            raise ValueError(
                f"ops {sorted(bad)} need lane-crossing work; use "
                f"backend='xla' (pallas pool: {PALLAS_POOL})")
        return ops
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    return DEFAULT_OPS if ops is None else tuple(ops)


class RandAugmentDraws(NamedTuple):
    """One batch's RandAugment random numbers, on the device."""
    op: torch.Tensor      # [layers, N] int64: a position in the pool
    sign: torch.Tensor    # [layers, N] float32: +1 or -1


def _signs(generator, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return torch.where(u < 0.5, 1.0, -1.0)


def sample_randaugment(generator: torch.Generator, n: int, *,
                       num_layers: int, num_ops: int) -> RandAugmentDraws:
    """Per layer, an op position in [0, num_ops) and a sign per image,
    drawn on the generator's device."""
    op = torch.randint(0, num_ops, (num_layers, n), generator=generator,
                       device=generator.device)
    return RandAugmentDraws(op, _signs(generator, (num_layers, n)))


def rand_augment(x: torch.Tensor, draws: RandAugmentDraws, *,
                 magnitude: float = 9.0,
                 ops: tuple[str, ...] | None = None,
                 backend: str = "xla") -> torch.Tensor:
    """Apply one op per image and layer (``draws``) at the global
    ``magnitude`` (0..30).  x: [N, H, W, C] float32 in [0, 1]."""
    ops = resolve_ops(ops, backend)
    mag = float(np.float32(magnitude) / np.float32(_MAX_MAGNITUDE))
    if backend == "pallas":
        table = _on_device([PALLAS_POOL.index(name) for name in ops],
                           torch.int64, x.device)
        for op, sign in zip(draws.op, draws.sign):
            x = ew.apply_layer(x, table[op], mag * sign)
        return x
    fns = [POOL[name] for name in ops]
    for op, sign in zip(draws.op, draws.sign):
        mag01 = (mag * sign)[:, None, None, None]
        out = x
        for k, (name, fn) in enumerate(zip(ops, fns)):
            m = mag01 if name in SIGNED else mag01.abs()
            out = torch.where((op == k)[:, None, None, None], fn(x, m), out)
        x = out
    return x


# ------------------------------------------------------------ AutoAugment
#
# 25 learned sub-policies of two (op, probability, level) steps; each image
# draws one sub-policy and applies each step with its probability.  Per
# step, a where-fold over the distinct ops that column uses.  level / 10
# maps onto the ranges the RandAugment pool uses at |mag01| = 1.

# the published ImageNet policy (torchvision layout); level None: the op
# takes no magnitude
AUTOAUGMENT_IMAGENET = (
    (("posterize", 0.4, 8), ("rotate", 0.6, 9)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, None)),
    (("equalize", 0.8, None), ("equalize", 0.6, None)),
    (("posterize", 0.6, 7), ("posterize", 0.6, 6)),
    (("equalize", 0.4, None), ("solarize", 0.2, 4)),
    (("equalize", 0.4, None), ("rotate", 0.8, 8)),
    (("solarize", 0.6, 3), ("equalize", 0.6, None)),
    (("posterize", 0.8, 5), ("equalize", 1.0, None)),
    (("rotate", 0.2, 3), ("solarize", 0.6, 8)),
    (("equalize", 0.6, None), ("posterize", 0.4, 6)),
    (("rotate", 0.8, 8), ("color", 0.4, 0)),
    (("rotate", 0.4, 9), ("equalize", 0.6, None)),
    (("equalize", 0.0, None), ("equalize", 0.8, None)),
    (("invert", 0.6, None), ("equalize", 1.0, None)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("rotate", 0.8, 8), ("color", 1.0, 2)),
    (("color", 0.8, 8), ("solarize", 0.8, 7)),
    (("sharpness", 0.4, 7), ("invert", 0.6, None)),
    (("shear_x", 0.6, 5), ("equalize", 1.0, None)),
    (("color", 0.4, 0), ("equalize", 0.6, None)),
    (("equalize", 0.4, None), ("solarize", 0.2, 4)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, None)),
    (("invert", 0.6, None), ("equalize", 1.0, None)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("equalize", 0.8, None), ("equalize", 0.6, None)),
)

_AA_POLICIES = {"imagenet": AUTOAUGMENT_IMAGENET}


def policy_table(policy) -> tuple:
    """A registered policy's table, or a custom table of ``((op, p,
    level), (op, p, level))`` rows as it is."""
    if not isinstance(policy, str):
        return tuple(policy)
    if policy not in _AA_POLICIES:
        raise ValueError(
            f"unknown AutoAugment policy {policy!r}; registered: "
            f"{sorted(_AA_POLICIES)} (or pass a custom sub-policy table)")
    return _AA_POLICIES[policy]


class AutoAugmentDraws(NamedTuple):
    """One batch's AutoAugment random numbers, on the device."""
    subpolicy: torch.Tensor   # [N] int64: a row of the policy table
    run: torch.Tensor         # [2, N] bool: apply the row's step 0 / 1
    sign: torch.Tensor        # [2, N] float32: +1 or -1


def sample_autoaugment(generator: torch.Generator, n: int,
                       policy="imagenet") -> AutoAugmentDraws:
    """A sub-policy per image, then per step a Bernoulli draw at the
    step's probability and a sign, on the generator's device."""
    table = policy_table(policy)
    dev = generator.device
    sp = torch.randint(0, len(table), (n,), generator=generator, device=dev)
    probs = _on_device([[row[col][1] for row in table] for col in (0, 1)],
                       torch.float32, dev)                     # [2, rows]
    u = torch.rand((2, n), generator=generator, device=dev)
    run = u < probs.gather(1, sp.expand(2, n))
    return AutoAugmentDraws(sp, run, _signs(generator, (2, n)))


def auto_augment(x: torch.Tensor, draws: AutoAugmentDraws, *,
                 policy="imagenet") -> torch.Tensor:
    """Apply each image's sub-policy (``draws``) to x [N, H, W, C] float32
    in [0, 1]."""
    table = policy_table(policy)
    sp = draws.subpolicy
    for col in (0, 1):
        steps = [row[col] for row in table]
        names = sorted({name for name, _, _ in steps})
        index_of = {name: i for i, name in enumerate(names)}
        op_ids = _on_device([index_of[name] for name, _, _ in steps],
                            torch.int64, x.device)
        mags = _on_device([0.0 if lv is None else lv / 10.0
                           for _, _, lv in steps], torch.float32, x.device)
        idx = op_ids[sp]
        mag01 = (mags[sp] * draws.sign[col])[:, None, None, None]
        out = x
        for k, name in enumerate(names):
            m = mag01 if name in SIGNED else mag01.abs()
            sel = ((idx == k) & draws.run[col])[:, None, None, None]
            out = torch.where(sel, POOL[name](x, m), out)
        x = out
    return x
