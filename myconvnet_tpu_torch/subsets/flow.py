"""Optical-flow corpus reading and the synthetic moving-rectangles scenes.

Port of ``myconvnet_tpu/subsets/flow.py`` (numpy and Pillow only).  Real
layout (the FlyingChairs release convention):

    data_dir/{train,val}/<stem>_img1.ppm   first frames
    data_dir/{train,val}/<stem>_img2.ppm   second frames
    data_dir/{train,val}/<stem>_flow.flo   Middlebury .flo ground truth

(.png/.jpg frames are accepted too.)  A ``.flo`` file is the magic float32
202021.25, int32 width, int32 height, then H*W*2 little-endian float32
(u, v) pairs; values >= 1e9 mark unknown flow and load as NaN, which the
loss and the evaluator mask.

Frames cross to the device as one ``[N, H, W, 6]`` uint8 tensor (both
frames channel-stacked); the flow is ``[N, H, W, 2]`` float32 in pixels.
No resizing: flow vectors are bound to the resolution, so a frame of
another size than the configured one raises.

``synthetic_flow_scenes`` renders textured moving rectangles over a
translating textured background from one ``np.random.RandomState`` stream,
in the JAX package's order of draws, so the arrays equal its arrays bit
for bit.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DEFAULT_HW = (96, 128)
_FLO_MAGIC = 202021.25
_UNKNOWN_THRESH = 1e9


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> ``[H, W, 2]`` f32 (unknown -> NaN)."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path!r}: bad .flo magic {magic!r}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(h * w * 2 * 4), "<f4")
        if data.size != h * w * 2:
            raise ValueError(f"{path!r}: truncated .flo payload")
    flow = data.reshape(h, w, 2).astype(np.float32)
    return np.where(np.abs(flow) >= _UNKNOWN_THRESH, np.nan, flow)


def write_flo(path: str, flow: np.ndarray) -> str:
    """``[H, W, 2]`` f32 -> Middlebury .flo (NaN -> the unknown
    sentinel).  The inverse of :func:`read_flo` — prep/export tool."""
    h, w, c = flow.shape
    assert c == 2, flow.shape
    out = np.where(np.isnan(flow), 1e10, flow).astype("<f4")
    with open(path, "wb") as f:
        f.write(struct.pack("<f", _FLO_MAGIC))
        f.write(struct.pack("<ii", w, h))
        f.write(out.tobytes())
    return path


def read_subset(data_dir: str, split: str = "train"):
    """-> (img1_paths, img2_paths, flo_paths) by shared stem."""
    root = os.path.join(data_dir, split)
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no split directory {root!r}")
    exts = (".ppm", ".png", ".jpg", ".jpeg")
    by_stem: dict[str, dict] = {}
    for f in sorted(os.listdir(root)):
        base, ext = os.path.splitext(f)
        p = os.path.join(root, f)
        if ext == ".flo" and base.endswith("_flow"):
            by_stem.setdefault(base[:-5], {})["flow"] = p
        elif ext.lower() in exts and base.endswith("_img1"):
            by_stem.setdefault(base[:-5], {})["img1"] = p
        elif ext.lower() in exts and base.endswith("_img2"):
            by_stem.setdefault(base[:-5], {})["img2"] = p
    i1, i2, fl = [], [], []
    for stem in sorted(by_stem):
        rec = by_stem[stem]
        if set(rec) != {"img1", "img2", "flow"}:
            missing = {"img1", "img2", "flow"} - set(rec)
            raise FileNotFoundError(
                f"sample {stem!r} under {root!r} is missing {missing}")
        i1.append(rec["img1"])
        i2.append(rec["img2"])
        fl.append(rec["flow"])
    if not i1:
        raise FileNotFoundError(f"no *_img1/_img2/_flow triples under "
                                f"{root!r}")
    return i1, i2, fl


class FlowTripleSource:
    """get_batch(idx) -> ([B, H, W, 6] uint8, [B, H, W, 2] f32)."""

    def __init__(self, img1, img2, flo, hw: tuple[int, int] = DEFAULT_HW,
                 workers: int = 8):
        assert len(img1) == len(img2) == len(flo)
        self.img1, self.img2, self.flo = (list(img1), list(img2),
                                          list(flo))
        self.hw = tuple(hw)
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self):
        return len(self.img1)

    def _load(self, i: int):
        from PIL import Image
        a = np.asarray(Image.open(self.img1[i]).convert("RGB"), np.uint8)
        b = np.asarray(Image.open(self.img2[i]).convert("RGB"), np.uint8)
        fl = read_flo(self.flo[i])
        if a.shape[:2] != self.hw or fl.shape[:2] != self.hw:
            raise ValueError(
                f"sample {self.img1[i]!r} is {a.shape[:2]}, configured "
                f"input_hw is {self.hw}: flow vectors are resolution-"
                "bound; crop/scale the corpus offline (scaling frames "
                "must scale u/v identically)")
        return np.concatenate([a, b], axis=-1), fl

    def get_batch(self, indices):
        out = list(self._pool.map(self._load, indices))
        return (np.stack([p for p, _ in out]),
                np.stack([f for _, f in out]))


def _texture(rng, h, w, scale: int = 4):
    """Random texture with ~``scale``-pixel structure: flow is
    unrecoverable from flat color, and the structure scale must be
    finer than the motion range or correlation peaks go ambiguous
    (measured: 8-px texture caps a d=4 matcher near EPE 2; 4-px
    texture lets it resolve sub-pixel)."""
    base = rng.uniform(40, 215, (h // scale + 2, w // scale + 2, 3))
    idx_y = np.arange(h) / float(scale)
    idx_x = np.arange(w) / float(scale)
    y0 = idx_y.astype(int)
    x0 = idx_x.astype(int)
    fy = (idx_y - y0)[:, None, None]
    fx = (idx_x - x0)[None, :, None]
    tl = base[y0][:, x0]
    tr = base[y0][:, x0 + 1]
    bl = base[y0 + 1][:, x0]
    br = base[y0 + 1][:, x0 + 1]
    return ((1 - fy) * ((1 - fx) * tl + fx * tr)
            + fy * ((1 - fx) * bl + fx * br))


def synthetic_flow_scenes(n: int = 256, hw: tuple[int, int] = DEFAULT_HW,
                          max_motion: int = 8, n_boxes: int = 3,
                          seed: int = 0, noise: float = 4.0):
    """Render n scenes -> ([n, H, W, 6] uint8, [n, H, W, 2] f32).

    Integer per-layer translations keep the ground truth exact (no
    resampling blur); motions are uniform in [-max_motion,
    max_motion] per axis.
    """
    rng = np.random.RandomState(seed)
    h, w = hw
    m = int(max_motion)
    pairs = np.empty((n, h, w, 6), np.uint8)
    flows = np.empty((n, h, w, 2), np.float32)
    for i in range(n):
        # background: big texture sheet, crop shifted for frame 2
        sheet = _texture(rng, h + 2 * m, w + 2 * m)
        bu, bv = rng.randint(-m, m + 1, 2)
        f1 = sheet[m:m + h, m:m + w].copy()
        f2 = sheet[m - bv:m - bv + h, m - bu:m - bu + w].copy()
        flow = np.empty((h, w, 2), np.float32)
        flow[..., 0] = bu
        flow[..., 1] = bv
        for _ in range(rng.randint(1, n_boxes + 1)):
            bh = rng.randint(h // 6, h // 2)
            bw = rng.randint(w // 6, w // 2)
            y0 = rng.randint(0, h - bh)
            x0 = rng.randint(0, w - bw)
            ou, ov = rng.randint(-m, m + 1, 2)
            tex = _texture(rng, bh, bw)
            f1[y0:y0 + bh, x0:x0 + bw] = tex
            flow[y0:y0 + bh, x0:x0 + bw, 0] = ou
            flow[y0:y0 + bh, x0:x0 + bw, 1] = ov
            # paste at the shifted location in frame 2 (clipped)
            y2, x2 = y0 + ov, x0 + ou
            ys, xs = max(y2, 0), max(x2, 0)
            ye, xe = min(y2 + bh, h), min(x2 + bw, w)
            if ye > ys and xe > xs:
                f2[ys:ye, xs:xe] = tex[ys - y2:ye - y2, xs - x2:xe - x2]
        both = np.concatenate([f1, f2], axis=-1)
        both = both + rng.normal(0.0, noise, both.shape)
        pairs[i] = np.clip(both, 0, 255).astype(np.uint8)
        flows[i] = flow
    return pairs, flows


class ArrayFlowSource:
    """In-memory pairs/flows (synthetic fallback / tests)."""

    def __init__(self, pairs: np.ndarray, flows: np.ndarray):
        assert len(pairs) == len(flows)
        self.pairs = pairs
        self.flows = flows

    def __len__(self):
        return len(self.pairs)

    def get_batch(self, indices):
        return self.pairs[indices], self.flows[indices]


def make_source(data_dir: str | None, split: str = "train",
                synthetic: bool = False, synthetic_n: int = 256,
                hw: tuple[int, int] = DEFAULT_HW,
                max_motion: int = 8, workers: int = 8):
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        pairs, flows = synthetic_flow_scenes(
            synthetic_n, hw, max_motion=max_motion, seed=seed)
        return ArrayFlowSource(pairs, flows)
    i1, i2, fl = read_subset(data_dir, split)
    return FlowTripleSource(i1, i2, fl, hw, workers)
