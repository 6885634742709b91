"""ImageNet layout: the seeded synthetic split (the JPEG reader comes later).

Port of ``myconvnet_tpu/subsets/imagenet.py:19-62``, numpy only (the JAX
module imports ``data/pipeline.py``, which imports ``jax``).
``synthetic_subset`` draws from ``numpy.random.RandomState(seed)`` in the
same order, so both packages see the same uint8 images at the raw
host-decode size and the same labels.  Reading a class-per-directory JPEG
corpus needs a native decoder (ROADMAP A8) and raises here.
"""

from __future__ import annotations

import numpy as np

from myconvnet_tpu_torch.data.pipeline import ArraySource

NUM_CLASSES = 1000
RAW_HW = (256, 256)   # fixed host-decode size; the device crops to 224
IMAGE_HW = (224, 224)


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
                raw_hw: tuple[int, int] = RAW_HW) -> ArraySource:
    """The train (seed 0) or val (seed 1) synthetic split."""
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        return ArraySource(*synthetic_subset(synthetic_n, NUM_CLASSES,
                                             tuple(raw_hw), seed))
    raise NotImplementedError(
        f"reading the JPEG corpus under {data_dir!r} needs the native "
        "loader (ROADMAP A8); pass --synthetic")
