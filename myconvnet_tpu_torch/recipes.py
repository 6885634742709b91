"""Recipe configs (``configs/*.py``) read without the JAX package.

Port of ``myconvnet_tpu/recipes/common.load_config`` and of the mean/std
resolution in ``serving_http.build_route`` (``:134-145``): a recipe's
``augment`` block may set ``mean``/``std``, and otherwise the ImageNet
statistics of ``data/augment.AugmentConfig`` apply.
"""

from __future__ import annotations

import importlib.util
import json

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def load_config(path: str) -> dict:
    """A recipe: a .py module exposing ``config``, or the .json dump that
    ``train.py`` writes next to its checkpoints."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    spec = importlib.util.spec_from_file_location("_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return dict(mod.config)


def normalization(cfg: dict | None, channels: int = 3
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(mean, std) float32 [channels] that the served model expects."""
    aug = (cfg or {}).get("augment") or {}
    mean = np.asarray(aug.get("mean", IMAGENET_MEAN), np.float32)
    std = np.asarray(aug.get("std", IMAGENET_STD), np.float32)
    if mean.ndim and mean.shape[0] != channels:
        mean = np.full((channels,), float(mean.mean()), np.float32)
        std = np.full((channels,), float(std.mean()), np.float32)
    return mean, std
