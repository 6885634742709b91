"""PASCAL VOC segmentation: the VOCdevkit reader and the seeded synthetic
pairs.

Port of the segmentation half of ``myconvnet_tpu/subsets/voc.py``
(``:26-85``).  The layout, under ``data_dir/VOC2012``,
``data_dir/VOCdevkit/VOC2012`` or ``data_dir`` itself::

    JPEGImages/*.jpg
    SegmentationClass/*.png          (palette masks; 255 = ignore)
    ImageSets/Segmentation/{train,val}.txt

``make_source`` decodes a split with ``data.pipeline.FileSource``, the
masks at ``raw_hw`` with the image's geometry (the host library's raw
palette indices where it has PNG).  ``synthetic_subset`` draws from
``numpy.random.RandomState(seed)`` in the same order, so both packages see
the same uint8 images and int32 masks: three rectangles of random classes
on a background, with noise.  The detection half is ROADMAP A17.
"""

from __future__ import annotations

import os

import numpy as np

from myconvnet_tpu_torch.data.pipeline import ArraySource, FileSource

NUM_CLASSES = 21
IGNORE_LABEL = 255
# the 20 foreground classes (``voc.py:90-97``); segmentation ids are
# 0-based with 0 = background
DET_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor")
SEG_CLASS_NAMES = ("background", *DET_CLASS_NAMES)
RAW_HW = (512, 512)
IMAGE_HW = (513, 513)  # the canonical DeepLab crop


def read_subset(data_dir: str, split: str = "train"
                ) -> tuple[list[str], list[str]]:
    """(image paths, mask paths) of the ids in the split's list."""
    for sub in ("VOC2012", "VOCdevkit/VOC2012", "."):
        root = os.path.normpath(os.path.join(data_dir, sub))
        lst = os.path.join(root, "ImageSets", "Segmentation", f"{split}.txt")
        if os.path.exists(lst):
            break
    else:
        raise FileNotFoundError(
            f"no VOC ImageSets/Segmentation/{split}.txt under {data_dir!r}")
    with open(lst) as f:
        ids = [line.strip() for line in f if line.strip()]
    imgs = [os.path.join(root, "JPEGImages", f"{i}.jpg") for i in ids]
    masks = [os.path.join(root, "SegmentationClass", f"{i}.png")
             for i in ids]
    return imgs, masks


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
                raw_hw: tuple[int, int] = RAW_HW, workers: int = 8):
    """The train (seed 0) or val (seed 1) synthetic pairs (96 x 96 when
    ``synthetic``, as the JAX recipes always pass it for a synthetic run,
    else at ``raw_hw``), or the split's files decoded at ``raw_hw`` by
    ``workers`` threads."""
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        small = (96, 96) if synthetic else tuple(raw_hw)
        return PairArraySource(*synthetic_subset(synthetic_n, small, seed))
    imgs, masks = read_subset(data_dir, split)
    return FileSource(imgs, masks, tuple(raw_hw), workers=workers,
                      mask_hw=tuple(raw_hw))
