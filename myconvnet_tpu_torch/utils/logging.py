"""Metric logging: console lines plus a JSONL stream.

Port of ``myconvnet_tpu/utils/logging.MetricLogger`` without the optional
TensorBoard writer: one ``[step N] key=value ...`` line per call, one
JSON record per call in ``<log_dir>/<name>.jsonl``, and image artifacts
(``log_image``) under ``<log_dir>/images/``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricLogger:
    def __init__(self, log_dir: str | None = None, name: str = "train",
                 stdout: bool = True):
        self.stdout = stdout
        self._dir = log_dir
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{name}.jsonl"), "a")

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

    def log_image(self, step: int, tag: str, image) -> str | None:
        """Write ``image`` (uint8 HWC or HW) as
        ``<log_dir>/images/<tag>_<step>.png``; nothing without a log
        dir."""
        if not self._dir:
            return None
        from myconvnet_tpu_torch.utils.images import save_png
        return save_png(os.path.join(self._dir, "images",
                                     f"{tag}_{step:08d}.png"), image)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
