"""PASCAL VOC segmentation: the seeded synthetic pairs (the VOCdevkit
reader comes later).

Port of the segmentation half of ``myconvnet_tpu/subsets/voc.py``
(``:26-85``), numpy only (the JAX module imports ``data/pipeline.py``,
which imports ``jax``).  ``synthetic_subset`` draws from
``numpy.random.RandomState(seed)`` in the same order, so both packages see
the same uint8 images and int32 masks: three rectangles of random classes
on a background, with noise.  Reading a VOCdevkit corpus needs the native
loader (ROADMAP A8) and raises here; the detection half is ROADMAP A17.
"""

from __future__ import annotations

import numpy as np

from myconvnet_tpu_torch.data.pipeline import ArraySource

NUM_CLASSES = 21
IGNORE_LABEL = 255
RAW_HW = (512, 512)
IMAGE_HW = (513, 513)  # the canonical DeepLab crop


class PairArraySource(ArraySource):
    """images uint8 [N, H, W, 3] + masks int32 [N, H, W]."""


def synthetic_subset(n: int = 64, raw_hw: tuple[int, int] = (96, 96),
                     seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Fake segmentation pairs: random rectangles of random classes on a
    background, so mIoU is learnable."""
    rng = np.random.RandomState(seed)
    h, w = raw_hw
    imgs = np.zeros((n, h, w, 3), np.float32)
    masks = np.zeros((n, h, w), np.int32)
    for i in range(n):
        for _ in range(3):
            c = rng.randint(1, NUM_CLASSES)
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            hh, ww = rng.randint(h // 8, h // 2), rng.randint(w // 8, w // 2)
            color = np.asarray([c / NUM_CLASSES, (c % 5) / 5.0,
                                (c % 7) / 7.0])
            imgs[i, y0:y0 + hh, x0:x0 + ww] = color
            masks[i, y0:y0 + hh, x0:x0 + ww] = c
        imgs[i] += rng.rand(h, w, 3) * 0.15
    return (np.clip(imgs, 0, 1) * 255).astype(np.uint8), masks


def make_source(data_dir: str | None, split: str = "train",
                synthetic: bool = False, synthetic_n: int = 64,
                raw_hw: tuple[int, int] = RAW_HW) -> PairArraySource:
    """The train (seed 0) or val (seed 1) synthetic pairs: 96 x 96 when
    ``synthetic`` (the JAX recipes always pass it for a synthetic run),
    else at ``raw_hw``."""
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        small = (96, 96) if synthetic else tuple(raw_hw)
        return PairArraySource(*synthetic_subset(synthetic_n, small, seed))
    raise NotImplementedError(
        f"reading the VOCdevkit corpus under {data_dir!r} needs the native "
        "loader (ROADMAP A8); pass --synthetic")
