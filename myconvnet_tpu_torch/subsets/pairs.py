"""Paired images for pix2pix (BASELINE config #5b): the file reader and the
seeded synthetic pairs.

Port of ``myconvnet_tpu/subsets/pairs.py:26-134``.  Two layouts on disk:

* combined: one image an example, input | target side by side, under
  ``data_dir/{split}/`` (the original pix2pix datasets), split down the
  middle after a bilinear resize to (2W, H);
* two directories: ``data_dir/A/{split}/`` and ``data_dir/B/{split}/``,
  paired by file name.

``PairFileSource`` decodes both with Pillow (BILINEAR to ``raw_hw``), as
JAX does.  The unpaired reading of the two-directory layout (``paired=
False``, CycleGAN) is refused by name (ROADMAP A17).  ``synthetic_subset``
draws from ``numpy.random.RandomState(seed)`` in the same order, so both
packages see the same uint8 arrays: coloured rectangles on gray as the
input, its colour inversion as the target.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from myconvnet_tpu_torch.data.pipeline import pil_image

RAW_HW = (256, 256)

_EXTS = (".jpg", ".jpeg", ".png")


def _list_images(d: str) -> list[str]:
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith(_EXTS))


class PairFileSource:
    """(input, target) uint8 pairs [B, *raw_hw, 3] decoded by a pool of
    ``workers`` threads: ``items`` are paths (``combined``) or (a, b)
    path pairs."""

    def __init__(self, items, raw_hw=RAW_HW, combined: bool = True,
                 workers: int = 8):
        self.items = list(items)
        self.raw_hw = tuple(raw_hw)
        self.combined = combined
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self):
        return len(self.items)

    def close(self) -> None:
        """Stop the decode pool's threads."""
        self._pool.shutdown(wait=True)

    def _load(self, item) -> tuple[np.ndarray, np.ndarray]:
        th, tw = self.raw_hw
        if self.combined:
            image = pil_image("PairFileSource", item)
            img = image.open(item).convert("RGB")
            arr = np.asarray(img.resize((2 * tw, th), image.BILINEAR),
                             np.uint8)
            return arr[:, :tw], arr[:, tw:]
        pa, pb = item
        image = pil_image("PairFileSource", pa)
        a = image.open(pa).convert("RGB").resize((tw, th), image.BILINEAR)
        b = image.open(pb).convert("RGB").resize((tw, th), image.BILINEAR)
        return np.asarray(a, np.uint8), np.asarray(b, np.uint8)

    def get_batch(self, idx) -> tuple[np.ndarray, np.ndarray]:
        pairs = list(self._pool.map(lambda i: self._load(self.items[i]),
                                    idx))
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))


def read_subset(data_dir: str, split: str = "train", paired: bool = True):
    """(items, combined): the two-directory layout's name-matched (a, b)
    pairs where ``data_dir/A/{split}`` and ``data_dir/B/{split}`` exist,
    else the combined images of ``data_dir/{split}``."""
    if not paired:
        raise ValueError("unpaired A/B reading (paired=False, CycleGAN) is "
                         "not ported (ROADMAP A17)")
    two_a = os.path.join(data_dir, "A", split)
    two_b = os.path.join(data_dir, "B", split)
    if os.path.isdir(two_a) and os.path.isdir(two_b):
        b_by_name = {os.path.basename(p): p for p in _list_images(two_b)}
        items = [(a, b_by_name[os.path.basename(a)])
                 for a in _list_images(two_a)
                 if os.path.basename(a) in b_by_name]
        if not items:
            raise FileNotFoundError(
                f"no matching A/B pairs under {data_dir!r}")
        return items, False
    comb = os.path.join(data_dir, split)
    if os.path.isdir(comb):
        items = _list_images(comb)
        if items:
            return items, True
    raise FileNotFoundError(
        f"no pix2pix layout under {data_dir!r} (need A/{split}+B/{split} "
        f"or {split}/ of combined images)")


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
                synthetic_n: int = 64, raw_hw=RAW_HW, workers: int = 8,
                paired: bool = True):
    """The train (seed 0) or val (seed 1) synthetic pairs at ``raw_hw``, or
    the split's files decoded at ``raw_hw`` by ``workers`` threads."""
    if synthetic or data_dir is None:
        return PairArraySource(*synthetic_subset(
            synthetic_n, tuple(raw_hw), 0 if split == "train" else 1))
    items, combined = read_subset(data_dir, split, paired=paired)
    return PairFileSource(items, raw_hw, combined, workers)
