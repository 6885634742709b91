"""Depth corpus reading and the synthetic fogged scenes.

Port of ``myconvnet_tpu/subsets/depth.py`` (numpy and Pillow only).  Real
layout (the NYU-Depth-v2 / KITTI-eigen export convention):

    data_dir/{train,val}/rgb/<stem>.{png,jpg}     colour frames
    data_dir/{train,val}/depth/<stem>.png         16-bit depth PNGs

A depth PNG holds scaled integers (NYU: millimetres, ``depth_scale``
1000; KITTI: 256ths of a metre), read by Pillow as its ``I;16`` image and
divided by ``depth_scale`` into metres; 0 marks a pixel with no return,
which the loss and the evaluator mask.  Pairing is by file stem: a frame
without its depth twin raises.  RGB resizes bilinearly to ``hw``, depth
nearest (Pillow, as the JAX reader does).

``synthetic_depth_scenes`` renders boxes over a receding floor, shaded by
depth-dependent fog, from one ``np.random.RandomState`` stream in the JAX
package's order of draws, so the arrays equal its arrays bit for bit.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from myconvnet_tpu_torch.data.pipeline import pil_image

DEFAULT_HW = (96, 128)
DEFAULT_DEPTH_SCALE = 1000.0     # NYU's millimetres
DEFAULT_MAX_DEPTH = 10.0


def read_subset(data_dir: str, split: str = "train"):
    """-> (rgb_paths, depth_paths), paired by file stem."""
    root = os.path.join(data_dir, split)
    rgb_dir = os.path.join(root, "rgb")
    depth_dir = os.path.join(root, "depth")
    if not os.path.isdir(rgb_dir) or not os.path.isdir(depth_dir):
        raise FileNotFoundError(
            f"expected {root!r} to hold rgb/ and depth/ directories")
    depth_by_stem = {os.path.splitext(f)[0]: os.path.join(depth_dir, f)
                     for f in os.listdir(depth_dir)
                     if f.lower().endswith(".png")}
    rgb_paths, depth_paths = [], []
    for f in sorted(os.listdir(rgb_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        d = depth_by_stem.get(stem)
        if d is None:
            raise FileNotFoundError(
                f"rgb frame {f!r} has no depth/{stem}.png twin")
        rgb_paths.append(os.path.join(rgb_dir, f))
        depth_paths.append(d)
    if not rgb_paths:
        raise FileNotFoundError(f"no rgb frames under {rgb_dir!r}")
    return rgb_paths, depth_paths


class DepthPairSource:
    """get_batch(idx) -> ([B, H, W, 3] uint8, [B, H, W, 1] float32
    metres)."""

    def __init__(self, rgb_paths, depth_paths,
                 hw: tuple[int, int] = DEFAULT_HW,
                 depth_scale: float = DEFAULT_DEPTH_SCALE,
                 workers: int = 8):
        if len(rgb_paths) != len(depth_paths):
            raise ValueError(f"{len(rgb_paths)} frames but "
                             f"{len(depth_paths)} depth maps")
        self.rgb_paths = list(rgb_paths)
        self.depth_paths = list(depth_paths)
        self.hw = tuple(hw)
        self.depth_scale = float(depth_scale)
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self):
        return len(self.rgb_paths)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def _load(self, i: int):
        image = pil_image("DepthPairSource", self.rgb_paths[i])
        h, w = self.hw
        rgb = image.open(self.rgb_paths[i]).convert("RGB")
        rgb = np.asarray(rgb.resize((w, h), image.BILINEAR), np.uint8)
        d_img = image.open(self.depth_paths[i])
        d = np.asarray(d_img.resize((w, h), image.NEAREST))
        return rgb, (d.astype(np.float32) / self.depth_scale)[..., None]

    def get_batch(self, indices):
        out = list(self._pool.map(self._load, indices))
        return (np.stack([r for r, _ in out]),
                np.stack([d for _, d in out]))


def synthetic_depth_scenes(n: int = 256, hw: tuple[int, int] = DEFAULT_HW,
                           max_depth: float = DEFAULT_MAX_DEPTH,
                           n_boxes: int = 4, seed: int = 0,
                           invalid_frac: float = 0.02,
                           noise: float = 6.0):
    """n scenes -> ([n, H, W, 3] uint8, [n, H, W, 1] float32 metres): a
    floor from ``max_depth`` at the top row to 1.5 m at the bottom,
    fronto-parallel boxes (the nearest wins), colours attenuated by
    ``exp(-z / (max_depth / 2))``, and ``invalid_frac`` of the pixels
    zeroed (no return)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    imgs = np.empty((n, h, w, 3), np.uint8)
    depths = np.empty((n, h, w, 1), np.float32)
    ramp = np.linspace(max_depth, 1.5, h, dtype=np.float32)[:, None]
    for i in range(n):
        z = np.broadcast_to(ramp, (h, w)).copy()
        base = rng.uniform(100, 255, 3).astype(np.float32)
        color = np.broadcast_to(base, (h, w, 3)).copy()
        for _ in range(rng.randint(1, n_boxes + 1)):
            bz = rng.uniform(1.0, max_depth * 0.9)
            scale = np.clip(2.0 / bz, 0.15, 0.9)   # nearer is bigger
            bh = max(2, int(h * scale * rng.uniform(0.5, 1.0)))
            bw = max(2, int(w * scale * rng.uniform(0.3, 0.8)))
            y0 = rng.randint(0, max(h - bh, 1))
            x0 = rng.randint(0, max(w - bw, 1))
            region = z[y0:y0 + bh, x0:x0 + bw]
            front = region > bz
            region[front] = bz
            c = rng.uniform(100, 255, 3).astype(np.float32)
            color[y0:y0 + bh, x0:x0 + bw][front] = c
        fog = np.exp(-z / (max_depth / 2.0))[..., None]
        img = color * fog
        img = img + rng.normal(0.0, noise, img.shape)
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        if invalid_frac > 0:
            drop = rng.rand(h, w) < invalid_frac
            z = np.where(drop, 0.0, z)
        depths[i] = z[..., None]
    return imgs, depths


class ArrayDepthSource:
    """In-memory rgb/depth pairs (the synthetic split)."""

    def __init__(self, imgs: np.ndarray, depths: np.ndarray):
        if len(imgs) != len(depths):
            raise ValueError(f"{len(imgs)} frames but {len(depths)} depth "
                             "maps")
        self.imgs = imgs
        self.depths = depths

    def __len__(self):
        return len(self.imgs)

    def get_batch(self, indices):
        return self.imgs[indices], self.depths[indices]


def make_source(data_dir: str | None, split: str = "train",
                synthetic: bool = False, synthetic_n: int = 256,
                hw: tuple[int, int] = DEFAULT_HW,
                depth_scale: float = DEFAULT_DEPTH_SCALE,
                max_depth: float = DEFAULT_MAX_DEPTH, workers: int = 8):
    """The split's source: rendered (seed 0 train, 1 otherwise) without a
    ``data_dir``, else the file pairs."""
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        return ArrayDepthSource(*synthetic_depth_scenes(
            synthetic_n, hw, max_depth=max_depth, seed=seed))
    rgb, dep = read_subset(data_dir, split)
    return DepthPairSource(rgb, dep, hw, depth_scale, workers)
