"""Warm starts from weight files.

Port of ``myconvnet_tpu/models/pretrained.py:24`` ``load_npz_weights``:
a flat ``scope::name`` ``.npz`` (this framework's own layout, HWIO conv
weights) into a JAX-layout parameter tree, a subset restore with a shape
check.  The torch-file importers (``import_torch_resnet_file``) read a
downloaded ``.pth`` and are not ported.
"""

from __future__ import annotations

import numpy as np


def load_npz_weights(path: str, params: dict) -> dict:
    """``params`` ({scope: {name: array}}) with every entry that ``path``
    holds as ``scope::name`` replaced; other keys of the file are
    ignored, a shape that differs raises."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    out = {k: dict(v) for k, v in params.items()}
    for key, arr in flat.items():
        scope, _, name = key.rpartition("::")
        if scope in out and name in out[scope]:
            want = out[scope][name].shape
            if tuple(arr.shape) != tuple(want):
                raise ValueError(f"{key}: shape {arr.shape} != {want}")
            out[scope][name] = arr
    return out
