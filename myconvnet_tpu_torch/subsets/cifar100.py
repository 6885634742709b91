"""CIFAR-100: the pickle reader and the seeded synthetic split.

Port of ``myconvnet_tpu/subsets/cifar100.py:15-80``, numpy only.  The JAX
module cannot be imported here: it imports ``data/pipeline.py``, which
imports ``jax``.  The arrays are the same: ``synthetic_subset`` draws from
``numpy.random.RandomState(seed)`` in the same order.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from myconvnet_tpu_torch.data.pipeline import ArraySource

NUM_CLASSES = 100
NUM_COARSE_CLASSES = 20
IMAGE_HW = (32, 32)
MEAN = (0.5071, 0.4866, 0.4409)
STD = (0.2673, 0.2564, 0.2762)


def _load(path: str, label_key: bytes) -> tuple[np.ndarray, np.ndarray]:
    # the corpus's own pickle format: read only files from the data dir
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    imgs = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(imgs), np.asarray(d[label_key], np.int32)


def read_subset(data_dir: str, split: str = "train", *,
                coarse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(images uint8 [N,32,32,3], labels int32 [N]); ``coarse`` selects
    the 20 superclass labels."""
    base = os.path.join(data_dir, "cifar-100-python")
    root = base if os.path.isdir(base) else data_dir
    name = "train" if split == "train" else "test"
    p = os.path.join(root, name)
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"CIFAR-100 file {p!r} not found; pass synthetic=True or "
            "place cifar-100-python under the data dir")
    key = b"coarse_labels" if coarse else b"fine_labels"
    return _load(p, key)


def synthetic_subset(n: int = 512, seed: int = 0, *,
                     num_classes: int = NUM_CLASSES
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic fake CIFAR-100: 100 class-dependent gradients plus
    noise, so a real model can fit it."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
    imgs = np.empty((n, 32, 32, 3), np.float32)
    for c in np.unique(labels):
        mask = labels == c
        k = int(mask.sum())
        angle = 2 * np.pi * c / num_classes
        freq = 1.0 + (c % 5)
        grad = np.cos(freq * (np.cos(angle) * xx + np.sin(angle) * yy)
                      * np.pi)
        base = np.asarray([(c % 4) / 3.0, ((c // 4) % 5) / 4.0,
                           ((c // 20) % 5) / 4.0], np.float32)
        img = grad[None, :, :, None] * 0.4 + base[None, None, None, :] * 0.6
        imgs[mask] = img + rng.rand(k, 32, 32, 3).astype(np.float32) * 0.2
    imgs = np.clip(imgs, 0, 1)
    return (imgs * 255).astype(np.uint8), labels


def make_source(data_dir: str | None, split: str = "train",
                synthetic: bool = False, synthetic_n: int = 512,
                coarse: bool = False) -> ArraySource:
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        nc = NUM_COARSE_CLASSES if coarse else NUM_CLASSES
        return ArraySource(*synthetic_subset(synthetic_n, seed,
                                             num_classes=nc))
    return ArraySource(*read_subset(data_dir, split, coarse=coarse))
