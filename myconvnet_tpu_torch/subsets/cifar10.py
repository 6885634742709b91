"""CIFAR-10: the pickle reader and the seeded synthetic split.

Port of ``myconvnet_tpu/subsets/cifar10.py:25-84``, numpy only (the JAX
module imports ``data/pipeline.py``, which imports ``jax``).
``synthetic_subset`` draws from ``numpy.random.RandomState(seed)`` in the
same order, so both packages see the same arrays.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from myconvnet_tpu_torch.data.pipeline import ArraySource

NUM_CLASSES = 10
IMAGE_HW = (32, 32)
MEAN = (0.4914, 0.4822, 0.4465)
STD = (0.2470, 0.2435, 0.2616)


def _load_batch(path: str) -> tuple[np.ndarray, np.ndarray]:
    # the corpus's own pickle format: read only files from the data dir
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    imgs = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(imgs), np.asarray(d[b"labels"], np.int32)


def read_subset(data_dir: str, split: str = "train"
                ) -> tuple[np.ndarray, np.ndarray]:
    """(images uint8 [N,32,32,3], labels int32 [N]) from the
    ``cifar-10-batches-py`` layout: five train batches, one test batch."""
    base = os.path.join(data_dir, "cifar-10-batches-py")
    root = base if os.path.isdir(base) else data_dir
    names = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    imgs, labels = [], []
    for name in names:
        p = os.path.join(root, name)
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"CIFAR-10 batch {p!r} not found; pass synthetic=True or "
                "place cifar-10-batches-py under the data dir")
        i, lab = _load_batch(p)
        imgs.append(i)
        labels.append(lab)
    return np.concatenate(imgs), np.concatenate(labels)


def synthetic_subset(n: int = 512, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic fake CIFAR-10: class-dependent coloured gradients plus
    noise, so a real model can fit it."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, NUM_CLASSES, n).astype(np.int32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
    imgs = np.empty((n, 32, 32, 3), np.float32)
    for c in range(NUM_CLASSES):
        mask = labels == c
        k = int(mask.sum())
        if not k:
            continue
        angle = 2 * np.pi * c / NUM_CLASSES
        grad = np.cos(angle) * xx + np.sin(angle) * yy
        base = np.asarray([(c % 3) / 2.0, ((c // 3) % 3) / 2.0,
                           ((c // 9) % 3) / 2.0], np.float32)
        img = grad[None, :, :, None] * 0.5 + base[None, None, None, :] * 0.5
        imgs[mask] = img + rng.rand(k, 32, 32, 3).astype(np.float32) * 0.25
    imgs = np.clip(imgs, 0, 1)
    return (imgs * 255).astype(np.uint8), labels


def make_source(data_dir: str | None, split: str = "train",
                synthetic: bool = False, synthetic_n: int = 512
                ) -> ArraySource:
    """The train (seed 0) or test (seed 1) synthetic split, or the files."""
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        return ArraySource(*synthetic_subset(synthetic_n, seed))
    return ArraySource(*read_subset(data_dir, split))
