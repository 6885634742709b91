"""Input pipeline: host batching + prefetched host-to-device copies.

Port of ``myconvnet_tpu/data/pipeline.py``: the host decode geometry
(``cover_resize_center_crop``, ``decode_image``, ``decode_image_native``,
``decode_image_warp``, ``:34-99``), ``ArraySource`` (``:101-121``, batches
assembled by the host library's threaded gather), ``FileSource``
(``:124-216``: image files decoded by a worker pool, JPEG batches by the
host library's threaded libjpeg path, masks by libpng's raw palette
indices), ``batch_indices`` (``:251-267``, the same numpy RNG and order),
``pk_batch_indices`` (``:269-298``, the metric recipes' identity-balanced
batches, the same numpy RNG and draws), the ``Prefetcher``
(``:318-388``) and ``DataSet.train_iter``/``eval_iter`` (``:390-474``,
with ``pk=(P, K)`` and its checks, ``:440-452``).  Batches leave the
host as uint8 (4x fewer bytes than float32); augmentation runs on the
device, in the train step.  Pillow is imported where an image is decoded,
never at import.

Where the JAX prefetcher calls ``jax.device_put`` on a background thread,
this one gathers the batch into pinned host memory and copies it with
``non_blocking=True`` on a side CUDA stream, then records an event; the
consumer makes its current stream wait on that event, so the step never
reads a batch before its copy lands, and the copy of batch k+1 overlaps
the step on batch k.  For the CPU device it hands over the host tensors.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from myconvnet_tpu_torch.data.augment import AugmentConfig


def pil_image(what: str, path):
    """``PIL.Image``, or an ImportError that names ``path`` and what
    needed to decode it (nothing substitutes another resampler)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what} needs Pillow to decode {path!s}") from e
    return Image


def cover_resize_center_crop(img, raw_hw: tuple[int, int]) -> np.ndarray:
    """Scale a PIL image so it covers ``raw_hw``, center-crop the overhang
    -> [raw_h, raw_w, 3] uint8: the geometry of the host decode stage (the
    host library's libjpeg path does the same in C)."""
    from PIL import Image   # ``img`` is a PIL image: Pillow is here
    w, h = img.size
    th, tw = raw_hw
    scale = max(th / h, tw / w)
    img = img.resize((max(tw, int(round(w * scale))),
                      max(th, int(round(h * scale)))), Image.BILINEAR)
    arr = np.asarray(img, np.uint8)
    y0 = (arr.shape[0] - th) // 2
    x0 = (arr.shape[1] - tw) // 2
    return arr[y0:y0 + th, x0:x0 + tw]


def decode_image(path: str, raw_hw: tuple[int, int]) -> np.ndarray:
    """Decode + cover-resize one image file to [raw_h, raw_w, 3] uint8."""
    image = pil_image("decode_image", path)
    return cover_resize_center_crop(image.open(path).convert("RGB"), raw_hw)


def decode_image_native(path: str, raw_hw: tuple[int, int],
                        frac_yx: tuple[float, float] = (0.5, 0.5)
                        ) -> np.ndarray:
    """Decode + crop ``raw_hw`` at the file's own resolution (no
    resampling), the window at ``frac_yx`` of the slack ((0.5, 0.5): the
    center); an image smaller than ``raw_hw`` on an axis is cover-resized
    instead (upscaled; nothing is cut)."""
    image = pil_image("decode_image_native", path)
    img = image.open(path).convert("RGB")
    w, h = img.size
    th, tw = raw_hw
    if h < th or w < tw:
        return cover_resize_center_crop(img, raw_hw)
    y0 = int(round(frac_yx[0] * (h - th)))
    x0 = int(round(frac_yx[1] * (w - tw)))
    return np.asarray(img.crop((x0, y0, x0 + tw, y0 + th)), np.uint8)


def decode_image_warp(path: str, raw_hw: tuple[int, int]) -> np.ndarray:
    """Decode + plain (aspect-warping) bilinear resize to [raw_h, raw_w, 3]
    uint8: normalized box coordinates survive it unchanged."""
    image = pil_image("decode_image_warp", path)
    th, tw = raw_hw
    img = image.open(path).convert("RGB").resize((tw, th), image.BILINEAR)
    return np.asarray(img, np.uint8)


class ArraySource:
    """In-memory images + labels (CIFAR-scale corpora); a uint8 pool's
    batches are gathered by the host library's threaded memcpy (the same
    bytes as numpy's indexing)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} "
                             "labels")
        self.images = images
        self.labels = labels

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        from myconvnet_tpu_torch.data import native_loader
        idx = np.asarray(idx, np.int64)
        return native_loader.gather_batch(self.images, idx), self.labels[idx]


class FileSource:
    """Image files decoded by a pool of ``workers`` threads to uint8 at
    ``raw_hw``.  ``labels``: int class ids, or paths of segmentation masks
    (decoded at ``mask_hw`` with the image's geometry).  ``decode_mode``
    "cover" (cover-resize + center crop) or "native_crop" (a crop at the
    file's own resolution: the center, or with ``rand_crop`` a window drawn
    from ``RandomState(seed)`` on the calling thread).  A batch of JPEGs
    without masks in "cover" mode decodes in the host library (threaded
    libjpeg) where it has JPEG; everything else goes through Pillow."""

    def __init__(self, paths: Sequence[str], labels: Sequence,
                 raw_hw: tuple[int, int], workers: int = 8,
                 mask_hw: tuple[int, int] | None = None,
                 decode_mode: str = "cover",
                 rand_crop: bool = False, seed: int = 0):
        if decode_mode not in ("cover", "native_crop"):
            raise ValueError(f"decode_mode {decode_mode!r}; valid: "
                             "['cover', 'native_crop']")
        if len(paths) != len(labels):
            raise ValueError(f"{len(paths)} images but {len(labels)} "
                             "labels")
        self.paths = list(paths)
        self.labels = list(labels)
        self.raw_hw = tuple(raw_hw)
        self.mask_hw = tuple(mask_hw) if mask_hw is not None else None
        self.decode_mode = decode_mode
        self.rand_crop = rand_crop
        # the crop fractions are drawn on the calling thread: the pool's
        # workers would share this state, and RandomState is not
        # thread-safe
        self._crop_rng = np.random.RandomState(seed)
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def __len__(self):
        return len(self.paths)

    def close(self) -> None:
        """Stop the decode pool's threads."""
        self._pool.shutdown(wait=True)

    def _decode_mask(self, path: str) -> np.ndarray:
        """A label mask at ``mask_hw`` with the image's cover-resize +
        center-crop geometry, nearest sampling (labels stay exact).  A PNG
        decodes to its raw palette indices in the host library where it
        has PNG; the resize is Pillow's NEAREST either way."""
        image = pil_image("FileSource's mask decode", path)
        img = None
        if path.lower().endswith(".png"):
            from myconvnet_tpu_torch.data import native_loader
            if native_loader.native_png_available():
                with open(path, "rb") as f:
                    raw = native_loader.decode_png(f.read(), "raw")
                if raw is not None:
                    img = image.fromarray(raw)   # 2-D uint8: mode "L"
        if img is None:
            img = image.open(path)
        w, h = img.size
        th, tw = self.mask_hw
        scale = max(th / h, tw / w)
        img = img.resize((max(tw, int(round(w * scale))),
                          max(th, int(round(h * scale)))), image.NEAREST)
        arr = np.asarray(img, np.int32)
        y0 = (arr.shape[0] - th) // 2
        x0 = (arr.shape[1] - tw) // 2
        return arr[y0:y0 + th, x0:x0 + tw]

    def _int_labels(self, idx) -> np.ndarray:
        return np.asarray([self.labels[i] for i in idx], np.int32)

    def get_batch(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(images uint8 [B, *raw_hw, 3], labels int32 [B] or masks int32
        [B, *mask_hw])."""
        paths = [self.paths[i] for i in idx]
        if self.decode_mode == "native_crop":
            if self.rand_crop:
                fracs = self._crop_rng.uniform(size=(len(paths), 2))
            else:
                fracs = np.full((len(paths), 2), 0.5)
            imgs = list(self._pool.map(
                lambda pf: decode_image_native(pf[0], self.raw_hw,
                                               tuple(pf[1])),
                zip(paths, fracs)))
            return np.stack(imgs), self._int_labels(idx)
        if self.mask_hw is None and paths and all(
                p.lower().endswith((".jpg", ".jpeg")) for p in paths):
            from myconvnet_tpu_torch.data import native_loader
            if native_loader.native_jpeg_available():
                # the files are read on the pool, decoded in the host
                # library's threads
                blobs = list(self._pool.map(_read_bytes, paths))
                return (native_loader.decode_jpeg_batch(blobs, self.raw_hw),
                        self._int_labels(idx))
        imgs = list(self._pool.map(
            lambda p: decode_image(p, self.raw_hw), paths))
        if self.mask_hw is not None:
            masks = list(self._pool.map(
                lambda i: self._decode_mask(self.labels[i]), idx))
            return np.stack(imgs), np.stack(masks)
        return np.stack(imgs), self._int_labels(idx)


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def batch_indices(n: int, batch_size: int, *, shuffle: bool, seed: int,
                  drop_remainder: bool = True,
                  epochs: int | None = None) -> Iterator[np.ndarray]:
    """Yield index batches; reshuffles every epoch (tf.data .shuffle)."""
    if drop_remainder and n < batch_size:
        raise ValueError(
            f"batch_size {batch_size} exceeds dataset size {n} with "
            "drop_remainder: no batch would ever be yielded")
    rng = np.random.RandomState(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_remainder else n
        for i in range(0, end, batch_size):
            yield order[i:i + batch_size]
        epoch += 1


def pk_batch_indices(labels: np.ndarray, p: int, k: int, *, seed: int,
                     epochs: int | None = None) -> Iterator[np.ndarray]:
    """P x K identity-balanced batches: each batch is ``p`` distinct
    classes x ``k`` examples a class, so every anchor of batch-hard
    triplet mining has k - 1 positives and (p - 1) k negatives.  An epoch
    is one shuffled pass over the class list; a class with fewer than
    ``k`` examples is drawn with replacement."""
    labels = np.asarray(labels).reshape(-1)
    classes = np.unique(labels)
    if len(classes) < p:
        raise ValueError(f"pk sampler needs >= {p} classes, corpus has "
                         f"{len(classes)}")
    by_class = {c: np.flatnonzero(labels == c) for c in classes}
    rng = np.random.RandomState(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(classes)
        for i in range(0, len(order) - p + 1, p):
            picks = [rng.choice(by_class[c], k,
                                replace=len(by_class[c]) < k)
                     for c in order[i:i + p]]
            yield np.concatenate(picks)
        epoch += 1


class Prefetcher:
    """Stages up to ``depth`` batches on ``device`` ahead of consumption,
    from a background thread; yields (images, labels) device tensors."""

    def __init__(self, host_iter: Iterable, device: torch.device,
                 depth: int = 2):
        self._iter = iter(host_iter)
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._device) if self._cuda
                        else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: BaseException | None = None
        self._stop = False
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, batch):
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
        if not self._cuda:
            return host, None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            staged = [t.pin_memory().to(self._device, non_blocking=True)
                      for t in host]
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _worker(self):
        try:
            for batch in self._iter:
                if self._stop:
                    return
                staged = self._stage(batch)
                while not self._stop:
                    try:
                        self._q.put(staged, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop:
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            if not self._stop:
                self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in tensors:
                # allocated on the side stream, freed after use on this one
                t.record_stream(stream)
        return tuple(tensors)

    def close(self) -> None:
        """Release the worker thread (it may be blocked on a full queue
        behind an infinite iterator).  Safe to call more than once."""
        if self._closed:
            return
        self._closed = True
        self._stop = True
        try:  # drain so a put()-blocked worker sees the stop flag
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class DataSet:
    """Source + augmentation config + batch iterators; ``pk=(P, K)``
    makes the train batches identity-balanced (:func:`pk_batch_indices`)."""

    def __init__(self, source, augment: AugmentConfig | None = None,
                 seed: int = 0, pk: tuple[int, int] | None = None):
        self.source = source
        self.augment = augment or AugmentConfig()
        self.seed = seed
        self.pk = tuple(pk) if pk is not None else None

    def __len__(self):
        return len(self.source)

    def _host_batches(self, batch_size, *, shuffle, epochs, drop_remainder):
        for idx in batch_indices(len(self.source), batch_size,
                                 shuffle=shuffle, seed=self.seed,
                                 drop_remainder=drop_remainder,
                                 epochs=epochs):
            yield self.source.get_batch(idx)

    def train_iter(self, batch_size: int, device: torch.device, *,
                   epochs: int | None = None,
                   prefetch: int = 2) -> Iterator:
        """Infinite (or epochs-bounded) shuffled uint8 batches on
        ``device``.  Augmentation happens in the train step, not here."""
        if self.pk is not None:
            p, k = self.pk
            if p * k != batch_size:
                raise ValueError(f"pk={self.pk} batches are {p * k} "
                                 f"examples but batch_size={batch_size}")
            labels = getattr(self.source, "labels", None)
            if labels is None:
                raise ValueError("pk sampling needs a source with "
                                 ".labels (ArraySource/FileSource)")
            host = (self.source.get_batch(idx) for idx in
                    pk_batch_indices(np.asarray(labels), p, k,
                                     seed=self.seed, epochs=epochs))
        else:
            host = self._host_batches(batch_size, shuffle=True,
                                      epochs=epochs, drop_remainder=True)
        return Prefetcher(host, device, depth=prefetch)

    def eval_iter(self, batch_size: int, device: torch.device, *,
                  prefetch: int = 2,
                  drop_remainder: bool = False) -> Iterator:
        """Deterministic full-epoch batches; the tail batch is short when
        the split does not divide (the trainer counts every example)."""
        host = self._host_batches(batch_size, shuffle=False, epochs=1,
                                  drop_remainder=drop_remainder)
        return Prefetcher(host, device, depth=prefetch)
