"""PASCAL VOC segmentation: the VOCdevkit reader and the seeded synthetic
pairs.

Port of the segmentation half of ``myconvnet_tpu/subsets/voc.py``
(``:26-85``).  The layout, under ``data_dir/VOC2012``,
``data_dir/VOCdevkit/VOC2012`` or ``data_dir`` itself::

    JPEGImages/*.jpg
    SegmentationClass/*.png          (palette masks; 255 = ignore)
    ImageSets/Segmentation/{train,val}.txt

``make_source`` decodes a split with ``data.pipeline.FileSource``, the
masks at ``raw_hw`` with the image's geometry (the host library's raw
palette indices where it has PNG).  ``synthetic_subset`` draws from
``numpy.random.RandomState(seed)`` in the same order, so both packages see
the same uint8 images and int32 masks: three rectangles of random classes
on a background, with noise.

The detection half (``voc.py:102-282``): ``Annotations/*.xml`` read with
the stdlib's ``xml.etree`` into normalized xyxy boxes and 1-based labels
(a ``difficult`` object dropped for training, kept as the ignore mark
``-(class_id + 1)`` for evaluation), padded to ``max_boxes`` rows with
label -1 (:func:`pad_annotations`); images warp-resized to ``raw_hw``
(normalized boxes survive a full-frame warp).  The synthetic triplets draw
from ``numpy.random.RandomState(seed)`` in JAX's order.  The instance and
panoptic sources (``:284-529``) are ROADMAP A17c(iii).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from myconvnet_tpu_torch.data.pipeline import (ArraySource, FileSource,
                                              decode_image_warp)

NUM_CLASSES = 21
IGNORE_LABEL = 255
# the 20 foreground classes (``voc.py:90-97``); segmentation ids are
# 0-based with 0 = background
DET_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor")
SEG_CLASS_NAMES = ("background", *DET_CLASS_NAMES)
RAW_HW = (512, 512)
IMAGE_HW = (513, 513)  # the canonical DeepLab crop


def read_subset(data_dir: str, split: str = "train"
                ) -> tuple[list[str], list[str]]:
    """(image paths, mask paths) of the ids in the split's list."""
    for sub in ("VOC2012", "VOCdevkit/VOC2012", "."):
        root = os.path.normpath(os.path.join(data_dir, sub))
        lst = os.path.join(root, "ImageSets", "Segmentation", f"{split}.txt")
        if os.path.exists(lst):
            break
    else:
        raise FileNotFoundError(
            f"no VOC ImageSets/Segmentation/{split}.txt under {data_dir!r}")
    with open(lst) as f:
        ids = [line.strip() for line in f if line.strip()]
    imgs = [os.path.join(root, "JPEGImages", f"{i}.jpg") for i in ids]
    masks = [os.path.join(root, "SegmentationClass", f"{i}.png")
             for i in ids]
    return imgs, masks


class PairArraySource(ArraySource):
    """images uint8 [N, H, W, 3] + masks int32 [N, H, W]."""


def synthetic_subset(n: int = 64, raw_hw: tuple[int, int] = (96, 96),
                     seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Fake segmentation pairs: random rectangles of random classes on a
    background, so mIoU is learnable."""
    rng = np.random.RandomState(seed)
    h, w = raw_hw
    imgs = np.zeros((n, h, w, 3), np.float32)
    masks = np.zeros((n, h, w), np.int32)
    for i in range(n):
        for _ in range(3):
            c = rng.randint(1, NUM_CLASSES)
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            hh, ww = rng.randint(h // 8, h // 2), rng.randint(w // 8, w // 2)
            color = np.asarray([c / NUM_CLASSES, (c % 5) / 5.0,
                                (c % 7) / 7.0])
            imgs[i, y0:y0 + hh, x0:x0 + ww] = color
            masks[i, y0:y0 + hh, x0:x0 + ww] = c
        imgs[i] += rng.rand(h, w, 3) * 0.15
    return (np.clip(imgs, 0, 1) * 255).astype(np.uint8), masks


def make_source(data_dir: str | None, split: str = "train",
                synthetic: bool = False, synthetic_n: int = 64,
                raw_hw: tuple[int, int] = RAW_HW, workers: int = 8):
    """The train (seed 0) or val (seed 1) synthetic pairs (96 x 96 when
    ``synthetic``, as the JAX recipes always pass it for a synthetic run,
    else at ``raw_hw``), or the split's files decoded at ``raw_hw`` by
    ``workers`` threads."""
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        small = (96, 96) if synthetic else tuple(raw_hw)
        return PairArraySource(*synthetic_subset(synthetic_n, small, seed))
    imgs, masks = read_subset(data_dir, split)
    return FileSource(imgs, masks, tuple(raw_hw), workers=workers,
                      mask_hw=tuple(raw_hw))


# ------------------------------------------------------------- detection

DET_NUM_CLASSES = 21   # 20 foreground + background id 0
DET_IMAGE_HW = (300, 300)   # the SSD300 input
MAX_BOXES = 64   # >= VOC2012's densest image (56 objects)


def _parse_voc_xml(path: str, keep_difficult: bool | str = False
                   ) -> tuple[np.ndarray, np.ndarray]:
    """One Annotations/*.xml -> (boxes [m, 4] normalized xyxy float32,
    labels [m] int32 in 1..20); VOC's pixel coordinates are 1-based.
    ``keep_difficult``: False drops ``difficult`` objects, True keeps
    them, "mark" keeps them as ``-(class_id + 1)``."""
    import xml.etree.ElementTree as ET
    root = ET.parse(path).getroot()
    size = root.find("size")
    w = float(size.findtext("width"))
    h = float(size.findtext("height"))
    name_to_id = {n: i + 1 for i, n in enumerate(DET_CLASS_NAMES)}
    boxes, labels = [], []
    for obj in root.iter("object"):
        difficult = (obj.findtext("difficult") or "0").strip() == "1"
        if difficult and not keep_difficult:
            continue
        name = (obj.findtext("name") or "").strip()
        if name not in name_to_id:
            continue
        bb = obj.find("bndbox")
        boxes.append([(float(bb.findtext("xmin")) - 1.0) / w,
                      (float(bb.findtext("ymin")) - 1.0) / h,
                      (float(bb.findtext("xmax")) - 1.0) / w,
                      (float(bb.findtext("ymax")) - 1.0) / h])
        cid = name_to_id[name]
        labels.append(-(cid + 1) if difficult and keep_difficult == "mark"
                      else cid)
    boxes = np.clip(np.asarray(boxes, np.float32).reshape(-1, 4), 0.0, 1.0)
    return boxes, np.asarray(labels, np.int32)


def read_detection_subset(data_dir: str, split: str = "train",
                          keep_difficult: bool | str = False
                          ) -> tuple[list[str], list[tuple]]:
    """(image paths, unpadded (boxes, labels) per image) of
    ``ImageSets/Main/{split}.txt``."""
    for sub in ("VOC2012", "VOCdevkit/VOC2012", "VOC2007",
                "VOCdevkit/VOC2007", "."):
        root = os.path.normpath(os.path.join(data_dir, sub))
        lst = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
        if os.path.exists(lst):
            break
    else:
        raise FileNotFoundError(
            f"no VOC ImageSets/Main/{split}.txt under {data_dir!r}")
    with open(lst) as f:
        ids = [line.split()[0] for line in f if line.strip()]
    imgs = [os.path.join(root, "JPEGImages", f"{i}.jpg") for i in ids]
    annos = [_parse_voc_xml(os.path.join(root, "Annotations", f"{i}.xml"),
                            keep_difficult) for i in ids]
    return imgs, annos


def pad_annotations(annos: list[tuple], max_boxes: int = MAX_BOXES
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(boxes [N, M, 4] float32, labels [N, M] int32, -1 padding); an
    image with more than ``max_boxes`` objects keeps the largest."""
    n = len(annos)
    out_b = np.zeros((n, max_boxes, 4), np.float32)
    out_l = np.full((n, max_boxes), -1, np.int32)
    for i, (b, lab) in enumerate(annos):
        if len(b) > max_boxes:
            area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            keep = np.argsort(-area)[:max_boxes]
            b, lab = b[keep], lab[keep]
        out_b[i, :len(b)] = b
        out_l[i, :len(lab)] = lab
    return out_b, out_l


class DetectionArraySource:
    """In-memory triplets: images uint8 [N, H, W, 3], boxes [N, M, 4],
    labels [N, M] (-1 padding)."""

    class_names = DET_CLASS_NAMES

    def __init__(self, images: np.ndarray, boxes: np.ndarray,
                 labels: np.ndarray):
        if not len(images) == len(boxes) == len(labels):
            raise ValueError("images, boxes and labels differ in length")
        self.images = images
        self.boxes = boxes
        self.labels = labels

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx: np.ndarray):
        idx = np.asarray(idx)
        return self.images[idx], self.boxes[idx], self.labels[idx]


class DetectionFileSource:
    """Files warp-resized to ``raw_hw`` by a pool of ``workers`` threads;
    the targets padded once, here."""

    class_names = DET_CLASS_NAMES

    def __init__(self, paths: list[str], annos: list[tuple],
                 raw_hw: tuple[int, int] = DET_IMAGE_HW,
                 max_boxes: int = MAX_BOXES, workers: int = 8):
        self.paths = list(paths)
        self.raw_hw = tuple(raw_hw)
        self.boxes, self.labels = pad_annotations(annos, max_boxes)
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self):
        return len(self.paths)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def get_batch(self, idx: np.ndarray):
        idx = np.asarray(idx)
        imgs = list(self._pool.map(
            lambda i: decode_image_warp(self.paths[i], self.raw_hw), idx))
        return np.stack(imgs), self.boxes[idx], self.labels[idx]


def synthetic_detection_subset(n: int = 64,
                               raw_hw: tuple[int, int] = DET_IMAGE_HW,
                               seed: int = 0, max_boxes: int = 8):
    """(images uint8, boxes, labels): 1-3 class-coloured rectangles an
    image on a noisy background."""
    rng = np.random.RandomState(seed)
    h, w = raw_hw
    imgs = rng.rand(n, h, w, 3).astype(np.float32) * 0.15
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.full((n, max_boxes), -1, np.int32)
    for i in range(n):
        for k in range(rng.randint(1, 4)):
            c = rng.randint(1, DET_NUM_CLASSES)
            bw = rng.uniform(0.2, 0.5)
            bh = rng.uniform(0.2, 0.5)
            x1 = rng.uniform(0.0, 1.0 - bw)
            y1 = rng.uniform(0.0, 1.0 - bh)
            color = np.asarray([c / DET_NUM_CLASSES, (c % 5) / 5.0,
                                (c % 7) / 7.0])
            ys, xs = int(y1 * h), int(x1 * w)
            ye, xe = int((y1 + bh) * h), int((x1 + bw) * w)
            imgs[i, ys:ye, xs:xe] = color
            boxes[i, k] = (x1, y1, x1 + bw, y1 + bh)
            labels[i, k] = c
    return (np.clip(imgs, 0, 1) * 255).astype(np.uint8), boxes, labels


def make_detection_source(data_dir: str | None, split: str = "train",
                          synthetic: bool = False, synthetic_n: int = 64,
                          raw_hw: tuple[int, int] = DET_IMAGE_HW,
                          max_boxes: int = MAX_BOXES, workers: int = 8,
                          keep_difficult: bool | str | None = None):
    """The split's detection source; ``keep_difficult`` defaults to the
    VOC protocol: dropped for a train split, marked for any other."""
    if keep_difficult is None:
        keep_difficult = False if split.startswith("train") else "mark"
    if synthetic or data_dir is None:
        seed = 0 if split == "train" else 1
        return DetectionArraySource(*synthetic_detection_subset(
            synthetic_n, tuple(raw_hw), seed, min(max_boxes, 8)))
    imgs, annos = read_detection_subset(data_dir, split, keep_difficult)
    return DetectionFileSource(imgs, annos, tuple(raw_hw), max_boxes,
                               workers)
