"""Metric logging: console lines, a JSONL stream and an optional
TensorBoard writer.

Port of ``myconvnet_tpu/utils/logging.py:18-75``: one ``[step N]
key=value ...`` line per call, one JSON record per call in
``<log_dir>/<name>.jsonl``, and image artifacts (``log_image``) under
``<log_dir>/images/``.  With ``tensorboard=True`` the scalars and images
also go to ``torch.utils.tensorboard.SummaryWriter`` under
``<log_dir>/tb``; where no writer imports (no ``tensorboard`` package)
:func:`_make_tb_writer` gives None and the run logs without it, as the JAX
logger does, saying so once.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricLogger:
    def __init__(self, log_dir: str | None = None, name: str = "train",
                 stdout: bool = True, tensorboard: bool = False):
        self.stdout = stdout
        self._dir = log_dir
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
            if tensorboard:
                self._tb = _make_tb_writer(os.path.join(log_dir, "tb"))
                if self._tb is None:
                    print("tensorboard: no writer could be made (the "
                          "tensorboard package does not import); logging "
                          "to the console and the JSONL stream only",
                          flush=True)

    def log(self, step: int, metrics: dict[str, Any]) -> None:
        clean = {k: (float(v) if hasattr(v, "__float__") else v)
                 for k, v in metrics.items()}
        if self.stdout:
            parts = " ".join(f"{k}={v:.5g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in clean.items())
            print(f"[step {step}] {parts}", flush=True)
        if self._jsonl:
            rec = {"step": step, "time": time.time(), **clean}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                if isinstance(v, float):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()

    def log_image(self, step: int, tag: str, image) -> str | None:
        """Write ``image`` (uint8 HWC or HW) as
        ``<log_dir>/images/<tag>_<step>.png``; nothing without a log
        dir.  Mirrored to TensorBoard where a writer is attached."""
        if self._tb is not None:
            import numpy as np
            img = np.asarray(image)
            self._tb.add_image(tag, img if img.ndim == 3 else img[..., None],
                               step, dataformats="HWC")
        if not self._dir:
            return None
        from myconvnet_tpu_torch.utils.images import save_png
        return save_png(os.path.join(self._dir, "images",
                                     f"{tag}_{step:08d}.png"), image)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def _make_tb_writer(path: str):
    """A ``SummaryWriter`` at ``path``, or None where none imports."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(path)
