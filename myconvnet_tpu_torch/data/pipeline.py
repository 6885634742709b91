"""Input pipeline: host batching + prefetched host-to-device copies.

Port of the parts of ``myconvnet_tpu/data/pipeline.py`` the CIFAR recipe
uses: ``ArraySource`` (``:101-122``), ``batch_indices`` (``:251-267``, the
same numpy RNG and order), the ``Prefetcher`` (``:318-388``) and
``DataSet.train_iter``/``eval_iter`` (``:390-474``).  Batches leave the
host as uint8 (4x fewer bytes than float32); augmentation runs on the
device, in the train step.

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
from typing import Iterable, Iterator

import numpy as np
import torch

from myconvnet_tpu_torch.data.augment import AugmentConfig


class ArraySource:
    """In-memory images + labels (CIFAR-scale corpora)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} "
                             "labels")
        self.images = images
        self.labels = labels

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(idx, np.int64)
        return np.ascontiguousarray(self.images[idx]), self.labels[idx]


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
    """Source + augmentation config + batch iterators."""

    def __init__(self, source, augment: AugmentConfig | None = None,
                 seed: int = 0):
        self.source = source
        self.augment = augment or AugmentConfig()
        self.seed = seed

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
        host = self._host_batches(batch_size, shuffle=True, epochs=epochs,
                                  drop_remainder=True)
        return Prefetcher(host, device, depth=prefetch)

    def eval_iter(self, batch_size: int, device: torch.device, *,
                  prefetch: int = 2,
                  drop_remainder: bool = False) -> Iterator:
        """Deterministic full-epoch batches; the tail batch is short when
        the split does not divide (the trainer counts every example)."""
        host = self._host_batches(batch_size, shuffle=False, epochs=1,
                                  drop_remainder=drop_remainder)
        return Prefetcher(host, device, depth=prefetch)
