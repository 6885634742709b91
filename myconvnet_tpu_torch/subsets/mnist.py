"""MNIST and Fashion-MNIST: the IDX reader and the seeded synthetic split.

Port of ``myconvnet_tpu/subsets/mnist.py:17-97``, numpy only (the JAX
module imports ``data/pipeline.py``, which imports ``jax``).  Both corpora
ship as IDX files (``train-images-idx3-ubyte[.gz]`` and so on), one reader
serves both, and the gray images are repeated into 3 channels, so every
classifier takes them as NHWC RGB.  ``synthetic_subset`` draws from
``numpy.random.RandomState(seed)`` in the same order as JAX's.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from myconvnet_tpu_torch.data.pipeline import ArraySource

NUM_CLASSES = 10
IMAGE_HW = (28, 28)
MEAN = (0.1307,) * 3
STD = (0.3081,) * 3

FASHION_CLASS_NAMES = ["t-shirt/top", "trouser", "pullover", "dress",
                       "coat", "sandal", "shirt", "sneaker", "bag",
                       "ankle boot"]

_FILES = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
          "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}


def _open_idx(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    """The IDX container: magic [0, 0, dtype, ndim], the dims (big-endian
    uint32), then the uint8 payload."""
    with _open_idx(path) as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0 or dtype_code != 0x08:
            raise ValueError(f"unsupported IDX header in {path!r}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def read_subset(data_dir: str, split: str = "train"
                ) -> tuple[np.ndarray, np.ndarray]:
    """(images uint8 [N,28,28,3], labels int32 [N]) of an MNIST or
    Fashion-MNIST directory."""
    img_name, lbl_name = _FILES["train" if split == "train" else "test"]
    img_path = os.path.join(data_dir, img_name)
    if not (os.path.exists(img_path) or os.path.exists(img_path + ".gz")):
        raise FileNotFoundError(
            f"IDX file {img_path!r}(.gz) not found; pass synthetic=True "
            "or place the MNIST/Fashion-MNIST files under the data dir")
    imgs = read_idx(img_path)
    labels = read_idx(os.path.join(data_dir, lbl_name))
    rgb = np.repeat(imgs[..., None], 3, axis=-1)
    return np.ascontiguousarray(rgb), labels.astype(np.int32)


def synthetic_subset(n: int = 512, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic fake MNIST: a bright blob a class at a position keyed
    by the class, on noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, NUM_CLASSES, n).astype(np.int32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    imgs = np.empty((n, 28, 28), np.float32)
    for c in range(NUM_CLASSES):
        mask = labels == c
        k = int(mask.sum())
        if not k:
            continue
        cy = 7 + 14 * ((c % 5) / 4.0)
        cx = 7 + 14 * ((c // 5) / 1.0) * 0.5
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
        imgs[mask] = blob[None] + rng.rand(k, 28, 28) * 0.2
    imgs = np.clip(imgs, 0, 1)
    rgb = np.repeat(((imgs * 255).astype(np.uint8))[..., None], 3, -1)
    return rgb, labels


def make_source(data_dir: str | None, split: str = "train",
                synthetic: bool = False, synthetic_n: int = 512
                ) -> ArraySource:
    """The train (seed 0) or test (seed 1) synthetic split, or the files;
    the recipe layer attaches Fashion-MNIST's class names."""
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        return ArraySource(*synthetic_subset(synthetic_n, seed))
    return ArraySource(*read_subset(data_dir, split))
