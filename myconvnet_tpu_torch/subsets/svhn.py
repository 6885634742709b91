"""SVHN cropped digits: the ``.mat`` reader and the seeded synthetic split.

Port of ``myconvnet_tpu/subsets/svhn.py:15-72``, numpy and scipy only (the
JAX module imports ``data/pipeline.py``, which imports ``jax``).  The files
are ``train_32x32.mat`` and ``test_32x32.mat``: ``X`` [32, 32, 3, N] and
``y`` [N, 1], where label 10 is the digit 0.  ``synthetic_subset`` draws
from ``numpy.random.RandomState(seed)`` in the same order as JAX's.
"""

from __future__ import annotations

import os

import numpy as np

from myconvnet_tpu_torch.data.pipeline import ArraySource

NUM_CLASSES = 10
IMAGE_HW = (32, 32)
MEAN = (0.4377, 0.4438, 0.4728)
STD = (0.1980, 0.2010, 0.1970)

_FILES = {"train": "train_32x32.mat", "test": "test_32x32.mat"}


def read_subset(data_dir: str, split: str = "train"
                ) -> tuple[np.ndarray, np.ndarray]:
    """(images uint8 [N,32,32,3], labels int32 [N], the digit 0 as class
    0); "val" reads the test file."""
    from scipy.io import loadmat

    if split == "val":
        split = "test"
    if split not in _FILES:
        raise ValueError(f"unknown SVHN split {split!r}; valid: "
                         f"{sorted(_FILES)}")
    path = os.path.join(data_dir, _FILES[split])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SVHN file {path!r} not found; pass synthetic=True or place "
            "the *_32x32.mat files under the data dir")
    mat = loadmat(path)
    imgs = np.ascontiguousarray(mat["X"].transpose(3, 0, 1, 2))
    labels = mat["y"].reshape(-1).astype(np.int32) % 10  # 10 -> 0
    return imgs, labels


def synthetic_subset(n: int = 512, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Fake SVHN: a bright vertical bar a class (its position keyed by the
    class) on a noisy background."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, NUM_CLASSES, n).astype(np.int32)
    imgs = rng.rand(n, 32, 32, 3).astype(np.float32) * 0.3 + 0.3
    for c in range(NUM_CLASSES):
        mask = labels == c
        x0 = 4 + 2 * c
        imgs[mask, 6:26, x0:x0 + 4] = 0.9
        imgs[mask, 6:26, x0 + 1:x0 + 3, c % 3] = 0.2
    return (np.clip(imgs, 0, 1) * 255).astype(np.uint8), labels


def make_source(data_dir: str | None, split: str = "train",
                synthetic: bool = False, synthetic_n: int = 512
                ) -> ArraySource:
    """The train (seed 0) or test (seed 1) synthetic split, or the files."""
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        return ArraySource(*synthetic_subset(synthetic_n, seed))
    return ArraySource(*read_subset(data_dir, split))
