"""On-device augmentation: sampled geometry, applied by kernels or by
two float32 matmuls.

Port of the parts of ``myconvnet_tpu/data/augment.py`` the CIFAR and
ViT recipes use: ``AugmentConfig`` (``:36-73``), ``_axis_matrix`` and
``batched_crop_resize`` (``:78-145``), ``random_resized_crop_boxes``
(``:148-188``), ``pad_crop_boxes`` (``:191-203``), ``center_crop_boxes``
(``:205-212``), ``_sample_geometry`` (``:329-347``), ``augment_train``
(``:350-388``, with RandAugment or AutoAugment from
``data/randaugment.py``), ``augment_eval`` (``:391-402``) and
``normalize`` (``:320-324``), and ``color_jitter`` (``:272-317``); for
segmentation ``batched_crop_nearest`` (``:215-264``), ``augment_train_pair``
(``:407-427``) and ``augment_eval_pair`` (``:430-441``).

Sampling is split from applying.  :func:`sample_geometry` draws the crop
boxes and the flips, :func:`sample_jitter` the colour-jitter factors and
:func:`sample_policy` the RandAugment or AutoAugment draws, from a
``torch.Generator`` on the device (threefry
and torch's generators give different numbers, so tests inject JAX's
draws into the application instead).  The random-resized boxes are
clamped to the frame rather than rejected, as in JAX.  The application:

* the pad-crop mode at the input's size is the ``pad_crop_flip_normalize``
  kernel (integer boxes, zero fill outside the frame, crop then flip), and
  :func:`augment_eval` at the model's size is the ``normalize_u8`` kernel;
* every other box (random-resized crop, the eval centre crop at
  ``crop_fraction`` 0.875, a resize) goes through
  :func:`batched_crop_resize`: per-image bilinear sampling matrices and two
  float32 einsums, which cuBLAS runs in true float32 (PyTorch leaves
  ``torch.backends.cuda.matmul.allow_tf32`` off by default, the
  counterpart of JAX's ``precision="highest"``), then x / 255, the colour
  jitter, the policy (RandAugment or AutoAugment; a pad-crop batch with
  jitter or a policy also takes this path, as JAX does) and the mean/std
  normalize as plain ops.  ``interp_dtype="bfloat16"`` reproduces JAX's
  bf16 interpolation (``augment.py:141-152``): the sampling matrices and
  the pixels rounded to bf16, each product summed in float32 (JAX's
  ``preferred_element_type``), the intermediate rounded to bf16 between
  the two.  A bf16 ``torch.matmul`` would round the second product's
  output too, so both products run as float32 matmuls of the rounded
  operands (exact products, TF32 off).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from myconvnet_tpu_torch.data import randaugment as ra
from myconvnet_tpu_torch.ops.kernels import pad_crop_flip_normalize
from myconvnet_tpu_torch.ops.kernels.normalize_u8 import normalize_u8

# ImageNet statistics (the reference pipeline's per-channel normalize)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AugmentConfig(NamedTuple):
    """The JAX package's fields, so every recipe's ``augment`` block
    parses; see ``myconvnet_tpu/data/augment.py:36-73``."""
    out_hw: tuple[int, int] = (224, 224)
    out_dtype: str = "float32"
    interp_dtype: str = "float32"
    area_range: tuple[float, float] | None = (0.08, 1.0)
    aspect_range: tuple[float, float] = (3 / 4, 4 / 3)
    flip: bool = True
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    pad: int = 0
    randaugment: tuple[int, float] | None = None
    randaugment_backend: str = "xla"
    randaugment_ops: "tuple[str, ...] | str | None" = None
    autoaugment: "str | tuple | None" = None
    mean: tuple[float, ...] = IMAGENET_MEAN
    std: tuple[float, ...] = IMAGENET_STD


def stats(cfg: AugmentConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) float32 tensors on ``device``; make them once, so the
    kernels' callers do not copy them to the device on every batch."""
    return (torch.tensor(cfg.mean, dtype=torch.float32, device=device),
            torch.tensor(cfg.std, dtype=torch.float32, device=device))


def _check_train_mode(cfg: AugmentConfig) -> None:
    if cfg.randaugment is not None and cfg.autoaugment is not None:
        raise ValueError("set randaugment OR autoaugment, not both")


def _randaugment_ops(cfg: AugmentConfig) -> tuple[str, ...]:
    """The RandAugment pool: a named pool resolved, then the backend's
    default or check (``augment.py:373-381``)."""
    ops = cfg.randaugment_ops
    if isinstance(ops, str):
        named = {"canonical": ra.CANONICAL_OPS, "fast": ra.FAST_OPS}
        if ops not in named:
            raise ValueError(
                f"randaugment_ops={ops!r}: named pools are "
                f"{sorted(named)} (or pass a tuple of op names)")
        ops = named[ops]
    return ra.resolve_ops(ops, cfg.randaugment_backend)


def sample_policy(generator: torch.Generator, n: int, cfg: AugmentConfig
                  ) -> ra.RandAugmentDraws | ra.AutoAugmentDraws | None:
    """The RandAugment or AutoAugment draws of a batch of ``n`` (None
    when the config sets neither), on the generator's device."""
    _check_train_mode(cfg)
    if cfg.randaugment is not None:
        return ra.sample_randaugment(
            generator, n, num_layers=int(cfg.randaugment[0]),
            num_ops=len(_randaugment_ops(cfg)))
    if cfg.autoaugment is not None:
        return ra.sample_autoaugment(generator, n, cfg.autoaugment)
    return None


def apply_policy(x: torch.Tensor, cfg: AugmentConfig, draws
                 ) -> torch.Tensor:
    """RandAugment or AutoAugment of [0, 1] floats with their draws."""
    if cfg.randaugment is not None:
        layers, mag = cfg.randaugment
        if not isinstance(draws, ra.RandAugmentDraws) \
                or draws.op.shape[0] != int(layers):
            raise ValueError(f"randaugment={cfg.randaugment} needs the "
                             "RandAugment draws of sample_policy")
        return ra.rand_augment(x, draws, magnitude=float(mag),
                               ops=_randaugment_ops(cfg),
                               backend=cfg.randaugment_backend)
    if cfg.autoaugment is not None:
        if not isinstance(draws, ra.AutoAugmentDraws):
            raise ValueError("autoaugment needs the AutoAugment draws of "
                             "sample_policy")
        return ra.auto_augment(x, draws, policy=cfg.autoaugment)
    return x


class JitterDraws(NamedTuple):
    """One batch's colour-jitter factors, each [N] float32 or None for a
    term that is off."""
    brightness: torch.Tensor | None = None   # added delta in [-b, b]
    contrast: torch.Tensor | None = None     # factor in [1 - c, 1 + c]
    saturation: torch.Tensor | None = None   # factor in [1 - s, 1 + s]
    hue: torch.Tensor | None = None          # share of the wheel, [-h, h]


def sample_jitter(generator: torch.Generator, n: int, *,
                  brightness: float = 0.0, contrast: float = 0.0,
                  saturation: float = 0.0, hue: float = 0.0
                  ) -> JitterDraws | None:
    """The factors of :func:`color_jitter` for a batch of ``n``, uniform
    in each term's range, on the generator's device; None when every term
    is off."""
    def uniform(lo, hi):
        u = torch.rand(n, generator=generator, device=generator.device)
        return lo + (hi - lo) * u

    if not (brightness or contrast or saturation or hue):
        return None
    return JitterDraws(
        uniform(-brightness, brightness) if brightness > 0.0 else None,
        uniform(1.0 - contrast, 1.0 + contrast) if contrast > 0.0 else None,
        uniform(1.0 - saturation, 1.0 + saturation) if saturation > 0.0
        else None,
        uniform(-hue, hue) if hue > 0.0 else None)


def config_jitter(generator: torch.Generator, n: int, cfg: AugmentConfig
                  ) -> JitterDraws | None:
    """:func:`sample_jitter` with the config's four ranges."""
    return sample_jitter(generator, n, brightness=cfg.brightness,
                         contrast=cfg.contrast, saturation=cfg.saturation,
                         hue=cfg.hue)


_TO_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322),
           (0.211, -0.523, 0.312))


def _rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    coef = torch.tensor(_TO_YIQ[0], dtype=x.dtype, device=x.device)
    return (x * coef).sum(dim=-1, keepdim=True)


def color_jitter(x: torch.Tensor, draws: JitterDraws | None
                 ) -> torch.Tensor:
    """Brightness, contrast, saturation and hue on [0, 1] float images
    [N, H, W, 3] with the factors of :func:`sample_jitter`, in that
    order, then a clip to [0, 1].  tf.image's conventions: brightness adds
    a delta; contrast scales around the image's mean grey and saturation
    around each pixel's grey; hue rotates the chroma as a rotation in YIQ
    (a 3x3 matrix, its inverse computed in float64 so that a zero angle
    is the identity)."""
    if draws is None:
        return x

    def per_image(t):
        return t.to(device=x.device, dtype=x.dtype).reshape(-1, 1, 1, 1)

    if draws.brightness is not None:
        x = x + per_image(draws.brightness)
    if draws.contrast is not None:
        mean = _rgb_to_gray(x).mean(dim=(1, 2), keepdim=True)
        x = (x - mean) * per_image(draws.contrast) + mean
    if draws.saturation is not None:
        gray = _rgb_to_gray(x)
        x = gray + (x - gray) * per_image(draws.saturation)
    if draws.hue is not None:
        to = np.array(_TO_YIQ, np.float64)
        to_yiq = torch.tensor(to, dtype=x.dtype, device=x.device)
        from_yiq = torch.tensor(np.linalg.inv(to), dtype=x.dtype,
                                device=x.device)
        theta = per_image(draws.hue)[..., 0] * (2.0 * math.pi)
        yiq = torch.einsum("nhwc,dc->nhwd", x, to_yiq)
        cos, sin = torch.cos(theta), torch.sin(theta)
        i, q = yiq[..., 1], yiq[..., 2]
        yiq = torch.stack([yiq[..., 0], cos * i - sin * q,
                           sin * i + cos * q], dim=-1)
        x = torch.einsum("nhwd,cd->nhwc", yiq, from_yiq)
    return x.clamp(0.0, 1.0)


def _axis_matrix(start: torch.Tensor, extent: torch.Tensor, in_size: int,
                 out_size: int, flip: torch.Tensor | None = None,
                 clamp: bool = True) -> torch.Tensor:
    """Per-image bilinear sampling matrix [N, out_size, in_size]: output
    index i reads source coordinate start + (i + 0.5) * extent / out_size
    - 0.5 (half-pixel), reversed where ``flip``; ``clamp=False`` leaves
    out-of-frame rows all-zero (zero padding)."""
    n, dev = start.shape[0], start.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    frac = ((i + 0.5) / out_size)[None, :].expand(n, out_size)
    if flip is not None:
        frac = torch.where(flip[:, None], 1.0 - frac, frac)
    src = start[:, None] + frac * extent[:, None] - 0.5
    if clamp:
        src = torch.clamp(src, 0.0, in_size - 1.0)
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    return torch.clamp(1.0 - torch.abs(src[:, :, None] - j[None, None, :]),
                       min=0.0)


def batched_crop_resize(images: torch.Tensor, boxes: torch.Tensor,
                        out_hw: tuple[int, int],
                        flip: torch.Tensor | None = None,
                        clamp: bool = True,
                        interp_dtype: str = "float32",
                        fill: torch.Tensor | None = None) -> torch.Tensor:
    """Crop + bilinear resize (+ horizontal flip) of every image with its
    own box.  images [N, H, W, C] (any dtype), boxes [N, 4] float32
    (y0, x0, h, w) in pixels, flip [N] bool or None -> [N, OH, OW, C]
    float32, by two float32 einsums; under ``interp_dtype="bfloat16"`` the
    matrices, the pixels and the intermediate are rounded to bf16 first.
    ``fill`` ([C] float32; implies ``clamp=False``): out-of-frame samples
    read it, weighted by the product of the two axes' row-sum deficits
    (``augment.py:142-147``, SSD's zoom-out canvas)."""
    if interp_dtype not in _DTYPES:
        raise ValueError(f"interp_dtype {interp_dtype!r}: one of "
                         f"{sorted(_DTYPES)}")
    _, h, w, _ = images.shape
    oh, ow = out_hw
    boxes = boxes.float()
    if fill is not None:
        clamp = False
    mh = _axis_matrix(boxes[:, 0], boxes[:, 2], h, oh, clamp=clamp)
    mw = _axis_matrix(boxes[:, 1], boxes[:, 3], w, ow, flip, clamp=clamp)
    bf16 = interp_dtype == "bfloat16"

    def rounded(t):
        return t.to(torch.bfloat16).float() if bf16 else t

    y = torch.einsum("nih,nhwc->niwc", rounded(mh), rounded(images.float()))
    y = torch.einsum("njw,niwc->nijc", rounded(mw), rounded(y))
    if fill is not None:
        cov = (rounded(mh).sum(-1)[:, :, None]
               * rounded(mw).sum(-1)[:, None, :])
        y = y + (1.0 - cov)[..., None] * fill.to(y.device, torch.float32)
    return y.contiguous()


def random_resized_crop_boxes(generator: torch.Generator, n: int,
                              in_hw: tuple[int, int],
                              area_range=(0.08, 1.0),
                              aspect_range=(3 / 4, 4 / 3)) -> torch.Tensor:
    """Inception-style crop boxes [N, 4] = (y0, x0, h, w), on the
    generator's device: area and log-aspect drawn once and the box
    clamped to the image (no rejection loop)."""
    h, w = in_hw
    u = torch.rand((4, n), generator=generator, device=generator.device)
    area = (area_range[0] + (area_range[1] - area_range[0]) * u[0]) \
        * float(h * w)
    lo, hi = math.log(aspect_range[0]), math.log(aspect_range[1])
    aspect = torch.exp(lo + (hi - lo) * u[1])
    ch = torch.sqrt(area / aspect)
    cw = ch * aspect
    ch = torch.clamp(ch, max=float(h))
    cw = torch.clamp(cw, max=float(w))
    y0 = u[2] * (h - ch)
    x0 = u[3] * (w - cw)
    return torch.stack([y0, x0, ch, cw], dim=1)


def center_crop_boxes(n: int, in_hw: tuple[int, int],
                      crop_fraction: float = 0.875,
                      device=None) -> torch.Tensor:
    """The same centred square box [N, 4] for every image."""
    h, w = in_hw
    side = crop_fraction * min(h, w)
    box = torch.tensor([(h - side) / 2.0, (w - side) / 2.0, side, side],
                       dtype=torch.float32, device=device)
    return box[None, :].expand(n, 4)


def pad_crop_boxes(generator: torch.Generator, n: int,
                   in_hw: tuple[int, int], pad: int) -> torch.Tensor:
    """CIFAR-style pad-then-crop as boxes [N, 4] = (y0, x0, h, w) float32
    over the unpadded image, with integer offsets y0, x0 in [-pad, pad],
    on the generator's device."""
    h, w = in_hw
    boxes = torch.empty((n, 4), device=generator.device)
    boxes[:, :2] = torch.randint(-pad, pad + 1, (n, 2), generator=generator,
                                 device=generator.device)
    boxes[:, 2] = float(h)  # scalar fills: no host-to-device copy
    boxes[:, 3] = float(w)
    return boxes


def sample_geometry(generator: torch.Generator, n: int,
                    hw: tuple[int, int], cfg: AugmentConfig
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(boxes [N, 4], flip [N] bool) for the configured crop mode
    (random-resized when ``cfg.area_range`` is set, else pad-crop, whose
    ``cfg.pad == 0`` is the whole-frame box), drawn on the generator's
    device (no host sync).  ``cfg.flip`` False gives no flips."""
    _check_train_mode(cfg)
    if cfg.area_range is not None:
        boxes = random_resized_crop_boxes(generator, n, hw, cfg.area_range,
                                          cfg.aspect_range)
    else:
        boxes = pad_crop_boxes(generator, n, hw, cfg.pad)
    flip = torch.rand(n, generator=generator, device=generator.device) < 0.5
    if not cfg.flip:
        flip = torch.zeros_like(flip)
    return boxes, flip


def _resized(images_u8, boxes, flip, cfg, mean_std, clamp, policy=None,
             jitter=None):
    mean, std = mean_std or stats(cfg, images_u8.device)
    x = batched_crop_resize(images_u8, boxes, tuple(cfg.out_hw), flip,
                            clamp=clamp, interp_dtype=cfg.interp_dtype
                            ) * (1.0 / 255.0)
    x = color_jitter(x, jitter)
    if policy is not None:
        x = apply_policy(x, cfg, policy)
    return normalize(x, mean, std).to(_DTYPES[cfg.out_dtype])


def augment_train(images_u8: torch.Tensor, boxes: torch.Tensor,
                  flip: torch.Tensor, cfg: AugmentConfig,
                  mean_std=None, policy=None, jitter=None
                  ) -> torch.Tensor:
    """[N, H, W, C] uint8 + sampled (boxes, flip) and, when the config
    sets them, the ``jitter`` factors of :func:`config_jitter` and the
    RandAugment or AutoAugment ``policy`` draws of :func:`sample_policy`
    -> [N, OH, OW, C] in ``cfg.out_dtype``, normalized: one pass of the
    pad_crop_u8 kernel in the pad-crop mode at the input's size without
    jitter or a policy; :func:`batched_crop_resize`, the jitter, the
    policy and the normalize otherwise.  ``mean_std``: the (mean, std) of
    :func:`stats`, made once."""
    n, h, w, _ = images_u8.shape
    _check_train_mode(cfg)
    has_policy = cfg.randaugment is not None or cfg.autoaugment is not None
    if has_policy and policy is None:
        raise ValueError("RandAugment / AutoAugment need the policy draws "
                         "of sample_policy")
    has_jitter = bool(cfg.brightness or cfg.contrast or cfg.saturation
                      or cfg.hue)
    if has_jitter and jitter is None:
        raise ValueError("colour jitter needs the factors of config_jitter")
    if cfg.area_range is not None or tuple(cfg.out_hw) != (h, w) \
            or has_policy or has_jitter:
        # zero padding outside the frame only in the pad-crop mode
        clamp = cfg.area_range is not None or cfg.pad == 0
        return _resized(images_u8, boxes, flip, cfg, mean_std, clamp,
                        policy, jitter if has_jitter else None)
    mean, std = mean_std or stats(cfg, images_u8.device)
    offsets = boxes[:, :2].to(torch.int32)
    return pad_crop_flip_normalize(images_u8, offsets, flip, mean, std,
                                   pad=cfg.pad,
                                   out_dtype=_DTYPES[cfg.out_dtype])


def augment_eval(images_u8: torch.Tensor, cfg: AugmentConfig,
                 mean_std=None, crop_fraction: float = 0.875
                 ) -> torch.Tensor:
    """Eval input: at the model's size one pass of the normalize_u8
    kernel; otherwise the centre crop (``crop_fraction`` of the shorter
    side) resized to ``cfg.out_hw``."""
    n, h, w, _ = images_u8.shape
    if (h, w) != tuple(cfg.out_hw):
        boxes = center_crop_boxes(n, (h, w), crop_fraction,
                                  images_u8.device)
        return _resized(images_u8, boxes, None, cfg, mean_std, True)
    mean, std = mean_std or stats(cfg, images_u8.device)
    return normalize_u8(images_u8, mean, std, _DTYPES[cfg.out_dtype])


def _nearest_index(start: torch.Tensor, extent: torch.Tensor,
                   in_size: int, out_size: int,
                   flip: torch.Tensor | None = None, clamp: bool = True
                   ) -> torch.Tensor:
    """[N, out_size] int64 source index of each output index (nearest,
    half-pixel, reversed where ``flip``), as the one-hot rows of JAX's
    ``_nearest_axis_matrix``: the coordinate rounded half to even
    (``jnp.round`` and ``torch.round`` both do), clamped to the frame, or
    -1 outside it when not ``clamp``."""
    n, dev = start.shape[0], start.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    frac = ((i + 0.5) / out_size)[None, :].expand(n, out_size)
    if flip is not None:
        frac = torch.where(flip[:, None], 1.0 - frac, frac)
    src = torch.round(start[:, None] + frac * extent[:, None] - 0.5)
    if clamp:
        src = torch.clamp(src, 0.0, in_size - 1.0)
    inside = (src >= 0) & (src <= in_size - 1)
    return torch.where(inside, src, torch.full_like(src, -1.0)).long()


def batched_crop_nearest(masks: torch.Tensor, boxes: torch.Tensor,
                         out_hw: tuple[int, int],
                         flip: torch.Tensor | None = None,
                         clamp: bool = True) -> torch.Tensor:
    """Nearest crop + resize (+ flip) of int label masks [N, H, W] with the
    boxes of the paired image transform; labels are gathered, so every
    value (the ignore label too) survives exactly.  With ``clamp=False``
    (the pad-crop geometry) a pixel outside the frame is the ignore label,
    255: the padding carries no ground truth."""
    n, h, w = masks.shape
    oh, ow = out_hw
    boxes = boxes.float()
    rows = _nearest_index(boxes[:, 0], boxes[:, 2], h, oh, clamp=clamp)
    cols = _nearest_index(boxes[:, 1], boxes[:, 3], w, ow, flip,
                          clamp=clamp)
    img = torch.arange(n, device=masks.device)[:, None, None]
    out = masks[img, rows.clamp(min=0)[:, :, None],
                cols.clamp(min=0)[:, None, :]]
    if not clamp:
        inside = (rows[:, :, None] >= 0) & (cols[:, None, :] >= 0)
        out = torch.where(inside, out, torch.full_like(out, 255))
    return out


def augment_train_pair(images_u8: torch.Tensor, masks: torch.Tensor,
                       boxes: torch.Tensor, flip: torch.Tensor,
                       cfg: AugmentConfig, mean_std=None, jitter=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Segmentation's train chain: the geometry of :func:`sample_geometry`
    applied to the image (bilinear, then x / 255, the colour ``jitter`` of
    :func:`config_jitter` and the normalize) and to the mask (nearest, the
    labels kept).  ``cfg.area_range`` is the crop's area relative to the
    frame (DeepLab's 0.5-2 scaling), the box clamped to the frame."""
    # zero padding (and the ignore label) outside the frame only in the
    # pad-crop mode
    clamp = cfg.area_range is not None or cfg.pad == 0
    has_jitter = bool(cfg.brightness or cfg.contrast or cfg.saturation
                      or cfg.hue)
    if has_jitter and jitter is None:
        raise ValueError("colour jitter needs the factors of config_jitter")
    x = _resized(images_u8, boxes, flip, cfg, mean_std, clamp,
                 jitter=jitter if has_jitter else None)
    y = batched_crop_nearest(masks, boxes, tuple(cfg.out_hw), flip,
                             clamp=clamp)
    return x, y


def augment_eval_pair(images_u8: torch.Tensor, masks: torch.Tensor | None,
                      cfg: AugmentConfig, mean_std=None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Segmentation's eval chain: the whole frame resized to ``cfg.out_hw``
    (no crop: mIoU is scored against the whole mask), the image bilinear
    and the mask nearest.  The resize runs even at the frame's own size,
    as in JAX; ``masks`` None transforms the image alone."""
    n, h, w, _ = images_u8.shape
    boxes = torch.zeros((n, 4), device=images_u8.device)
    boxes[:, 2] = float(h)
    boxes[:, 3] = float(w)
    x = _resized(images_u8, boxes, None, cfg, mean_std, True)
    if masks is None:
        return x, None
    return x, batched_crop_nearest(masks, boxes, tuple(cfg.out_hw))


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD
              ) -> torch.Tensor:
    """(x - mean) / std on [0, 1] floats, as plain ops (the kernels fold
    it into their one pass)."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
