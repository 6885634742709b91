"""ImageNet layout: a class-per-directory reader and the seeded synthetic
split.

Port of ``myconvnet_tpu/subsets/imagenet.py:19-62``.  The layout::

    data_dir/train/<class_name>/*.JPEG
    data_dir/val/<class_name>/*.JPEG

``read_subset`` lists the same paths, labels and class names as JAX's;
``make_source`` decodes them with ``data.pipeline.FileSource`` at
``raw_hw`` (the host library's libjpeg path where it has JPEG).
``synthetic_subset`` draws from ``numpy.random.RandomState(seed)`` in the
same order, so both packages see the same uint8 images at the raw
host-decode size and the same labels.
"""

from __future__ import annotations

import os

import numpy as np

from myconvnet_tpu_torch.data.pipeline import ArraySource, FileSource

NUM_CLASSES = 1000
RAW_HW = (256, 256)   # fixed host-decode size; the device crops to 224
IMAGE_HW = (224, 224)

_EXTS = (".jpeg", ".jpg", ".png")


def read_subset(data_dir: str, split: str = "train"
                ) -> tuple[list[str], np.ndarray, list[str]]:
    """(paths, int32 labels, sorted class names) of ``data_dir/split``."""
    root = os.path.join(data_dir, split)
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no {split!r} directory under {data_dir!r}")
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(_EXTS):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return paths, np.asarray(labels, np.int32), classes


def synthetic_subset(n: int = 256, num_classes: int = NUM_CLASSES,
                     raw_hw: tuple[int, int] = RAW_HW, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Fake uint8 batches [n, *raw_hw, 3] and int32 labels."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, *raw_hw, 3), dtype=np.uint8)
    labels = rng.randint(0, num_classes, n).astype(np.int32)
    return imgs, labels


def make_source(data_dir: str | None, split: str = "train",
                synthetic: bool = False, synthetic_n: int = 256,
                raw_hw: tuple[int, int] = RAW_HW, workers: int = 8):
    """The train (seed 0) or val (seed 1) synthetic split, or the files of
    ``data_dir/split`` decoded at ``raw_hw`` by ``workers`` threads."""
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        return ArraySource(*synthetic_subset(synthetic_n, NUM_CLASSES,
                                             tuple(raw_hw), seed))
    paths, labels, _ = read_subset(data_dir, split)
    return FileSource(paths, labels, tuple(raw_hw), workers=workers)
