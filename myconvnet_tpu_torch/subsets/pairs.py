"""Paired images for pix2pix (BASELINE config #5b): the seeded synthetic
pairs (the file reader comes later).

Port of ``myconvnet_tpu/subsets/pairs.py`` (``PairArraySource:101``,
``synthetic_subset:113``, ``make_source:128``), numpy only.
``synthetic_subset`` draws from ``numpy.random.RandomState(seed)`` in the
same order, so both packages see the same uint8 arrays: coloured
rectangles on gray as the input, its colour inversion as the target.
Reading pairs from disk (``PairFileSource:31``, combined or two-directory
layouts) decodes JPEGs with Pillow and raises here (ROADMAP A8).
"""

from __future__ import annotations

import numpy as np

RAW_HW = (256, 256)


class PairArraySource:
    """In-memory (input, target) uint8 pairs [N, H, W, 3]."""

    def __init__(self, a: np.ndarray, b: np.ndarray):
        if len(a) != len(b):
            raise ValueError(f"{len(a)} inputs but {len(b)} targets")
        self.a, self.b = a, b

    def __len__(self):
        return len(self.a)

    def get_batch(self, idx) -> tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(idx, np.int64)
        return (np.ascontiguousarray(self.a[idx]),
                np.ascontiguousarray(self.b[idx]))


def synthetic_subset(n: int = 64, raw_hw=(64, 64), seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """input = coloured rectangles on gray; target = 255 - input."""
    rng = np.random.RandomState(seed)
    h, w = raw_hw
    a = np.full((n, h, w, 3), 128, np.uint8)
    for i in range(n):
        for _ in range(3):
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            hh, ww = rng.randint(h // 8, h // 2), rng.randint(w // 8, w // 2)
            a[i, y0:y0 + hh, x0:x0 + ww] = rng.randint(0, 256, 3)
    return a, 255 - a


def make_source(data_dir, split: str = "train", synthetic: bool = False,
                synthetic_n: int = 64, raw_hw=RAW_HW) -> PairArraySource:
    """The train (seed 0) or val (seed 1) synthetic pairs at ``raw_hw``."""
    if synthetic or data_dir is None:
        return PairArraySource(*synthetic_subset(
            synthetic_n, tuple(raw_hw), 0 if split == "train" else 1))
    raise NotImplementedError(
        f"reading image pairs under {data_dir!r} decodes JPEGs with Pillow "
        "(PairFileSource, ROADMAP A8); pass --synthetic")
