"""Segmentation inference protocols: multi-scale + flip, sliding window.

Port of ``myconvnet_tpu/eval/seg_inference.py``: ``multiscale_logits``
(``:27-56``) averages the per-pixel softmax over input scales and the
horizontal mirror, each scale's logits resized back to the base grid by
``ops/resize.resize_bilinear`` (float32 matmuls); ``sliding_window_logits``
(``:59-97``) tiles frames larger than the model's crop with overlapping
windows, flush with the far edge (``_tile_starts``, ``:100-105``), and
averages the overlaps uniformly.  Both run on the images' device.
:func:`predict_segmentation` is the multi-scale branch of
``ConvNet.predict_segmentation`` (``models/base.py:480-538``) over any
eval forward: raw frames / 255, normalized, then the scales.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from myconvnet_tpu_torch.ops.resize import resize_bilinear


def multiscale_logits(forward: Callable[[torch.Tensor], torch.Tensor],
                      images: torch.Tensor, *,
                      scales: Sequence[float] = (0.75, 1.0, 1.25),
                      flip: bool = True) -> torch.Tensor:
    """log of the averaged softmax at the base resolution [N, H, W, C].

    forward: x [N, h, w, C_in] -> logits [N, h', w', C] (any output
    stride).  images: [N, H, W, C_in] float at the base resolution."""
    n, h, w, _ = images.shape
    acc, count = None, 0
    for s in scales:
        sh, sw = max(int(round(h * s)), 1), max(int(round(w * s)), 1)
        x = resize_bilinear(images, (sh, sw)) if (sh, sw) != (h, w) \
            else images
        for mirrored in ((False, True) if flip else (False,)):
            logits = forward(x.flip(2) if mirrored else x)
            if mirrored:  # un-mirror the prediction
                logits = logits.flip(2)
            logits = logits.float()
            if tuple(logits.shape[1:3]) != (h, w):
                logits = resize_bilinear(logits, (h, w))
            p = torch.softmax(logits, dim=-1)
            acc = p if acc is None else acc + p
            count += 1
    return torch.log(acc / count + 1e-12)


def sliding_window_logits(forward: Callable[[torch.Tensor], torch.Tensor],
                          images: torch.Tensor, tile_hw: tuple[int, int],
                          *, overlap: float = 1.0 / 3.0) -> torch.Tensor:
    """Tile a batch [N, H, W, C], run ``forward`` a tile, average the
    overlaps: float32 logits [N, H, W, num_classes] on the images'
    device."""
    n, h, w, _ = images.shape
    th, tw = min(tile_hw[0], h), min(tile_hw[1], w)
    stride_h = max(int(th * (1.0 - overlap)), 1)
    stride_w = max(int(tw * (1.0 - overlap)), 1)
    out = None
    weight = torch.zeros((1, h, w, 1), device=images.device)
    for y0 in _tile_starts(h, th, stride_h):
        for x0 in _tile_starts(w, tw, stride_w):
            logits = forward(images[:, y0:y0 + th, x0:x0 + tw]).float()
            if tuple(logits.shape[1:3]) != (th, tw):
                logits = resize_bilinear(logits, (th, tw))
            if out is None:
                out = torch.zeros((n, h, w, logits.shape[-1]),
                                  device=images.device)
            out[:, y0:y0 + th, x0:x0 + tw] += logits
            weight[:, y0:y0 + th, x0:x0 + tw] += 1.0
    return out / weight


def normalize_frames(images: torch.Tensor, mean, std) -> torch.Tensor:
    """Raw frames [N, H, W, C] (uint8, or floats in [0, 255]) / 255,
    normalized by the recipe's per-channel ``mean`` and ``std``: the
    input of :func:`multiscale_logits` in :func:`predict_segmentation`."""
    x = images.float() * (1.0 / 255.0)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def predict_segmentation(forward: Callable[[torch.Tensor], torch.Tensor],
                         images: torch.Tensor, mean, std, *,
                         scales: Sequence[float] = (1.0,),
                         flip: bool = False) -> torch.Tensor:
    """int64 class map [N, H, W] of raw frames [N, H, W, C]:
    probabilities averaged over ``scales`` (and mirrors when ``flip``)."""
    return multiscale_logits(forward, normalize_frames(images, mean, std),
                             scales=scales, flip=flip).argmax(-1)


def _tile_starts(size: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, size) fully; the last tile is flush."""
    starts = list(range(0, max(size - tile, 0) + 1, stride))
    if starts[-1] + tile < size:
        starts.append(size - tile)
    return starts
