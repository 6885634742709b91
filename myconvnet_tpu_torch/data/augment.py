"""On-device augmentation: sampled geometry, applied by the CUDA kernels.

Port of the parts of ``myconvnet_tpu/data/augment.py`` the CIFAR recipe
uses: ``AugmentConfig`` (``:36-73``), ``pad_crop_boxes`` (``:191-203``),
``_sample_geometry`` (``:329-347``), ``augment_train`` (``:350-388``),
``augment_eval`` (``:391-402``) and ``normalize`` (``:320-324``).

Sampling is split from applying.  :func:`sample_geometry` draws the
integer crop offsets and the flips from a ``torch.Generator`` on the
device (threefry and torch's generators give different numbers, so tests
inject JAX's draws into the application instead).  The application is a
kernel: :func:`augment_train` in the pad-crop mode is exactly
``pad_crop_flip_normalize`` (integer boxes, zero fill outside the frame,
crop then flip), and :func:`augment_eval` at the model's size is exactly
``normalize_u8``.

The modes this recipe does not use (random-resized crop, resize, colour
jitter, RandAugment, AutoAugment) raise ``NotImplementedError``: they come
with the ResNet-50 training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from myconvnet_tpu_torch.ops.kernels import pad_crop_flip_normalize
from myconvnet_tpu_torch.ops.kernels.normalize_u8 import normalize_u8

# ImageNet statistics (the reference pipeline's per-channel normalize)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_LATER = "comes with the ResNet-50 training slice of the port"
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


def _check_train_mode(cfg: AugmentConfig, hw: tuple[int, int]) -> None:
    if cfg.area_range is not None:
        raise NotImplementedError(f"random-resized crop {_LATER}")
    if tuple(cfg.out_hw) != tuple(hw):
        raise NotImplementedError(f"resizing {hw} to {cfg.out_hw} {_LATER}")
    if cfg.brightness or cfg.contrast or cfg.saturation or cfg.hue:
        raise NotImplementedError(f"colour jitter {_LATER}")
    if cfg.randaugment is not None or cfg.autoaugment is not None:
        raise NotImplementedError(f"RandAugment / AutoAugment {_LATER}")


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
    """(boxes [N, 4], flip [N] bool) for the pad-crop mode, drawn on the
    generator's device (no host sync).  ``cfg.pad == 0`` gives the
    whole-frame box; ``cfg.flip`` False gives no flips."""
    _check_train_mode(cfg, hw)
    boxes = pad_crop_boxes(generator, n, hw, cfg.pad)
    flip = torch.rand(n, generator=generator, device=generator.device) < 0.5
    if not cfg.flip:
        flip = torch.zeros_like(flip)
    return boxes, flip


def augment_train(images_u8: torch.Tensor, boxes: torch.Tensor,
                  flip: torch.Tensor, cfg: AugmentConfig,
                  mean_std=None) -> torch.Tensor:
    """[N, H, W, C] uint8 + sampled (boxes, flip) -> [N, H, W, C] in
    ``cfg.out_dtype``, normalized: one pass of the pad_crop_u8 kernel.
    ``mean_std``: the (mean, std) of :func:`stats`, made once."""
    n, h, w, _ = images_u8.shape
    _check_train_mode(cfg, (h, w))
    mean, std = mean_std or stats(cfg, images_u8.device)
    offsets = boxes[:, :2].to(torch.int32)
    return pad_crop_flip_normalize(images_u8, offsets, flip, mean, std,
                                   pad=cfg.pad,
                                   out_dtype=_DTYPES[cfg.out_dtype])


def augment_eval(images_u8: torch.Tensor, cfg: AugmentConfig,
                 mean_std=None) -> torch.Tensor:
    """Eval input at the model's size: one pass of the normalize_u8
    kernel.  The centre-crop-and-resize branch raises."""
    n, h, w, _ = images_u8.shape
    if (h, w) != tuple(cfg.out_hw):
        raise NotImplementedError(f"eval resize {(h, w)} -> {cfg.out_hw} "
                                  f"{_LATER}")
    mean, std = mean_std or stats(cfg, images_u8.device)
    return normalize_u8(images_u8, mean, std, _DTYPES[cfg.out_dtype])


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD
              ) -> torch.Tensor:
    """(x - mean) / std on [0, 1] floats, as plain ops (the kernels fold
    it into their one pass)."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
