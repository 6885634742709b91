"""Warm starts from weight files.

Port of ``myconvnet_tpu/models/pretrained.py``: ``load_npz_weights``
(``:24``), a flat ``scope::name`` ``.npz`` (this framework's own layout,
HWIO conv weights) into a JAX-layout parameter tree, a subset restore
with a shape check; and ``import_torch_resnet`` / ``import_torch_resnet_file``
(``:47-128``), a torchvision-layout ResNet ``state_dict`` (``conv1``,
``bn1``, ``layer<i>.<b>.conv<j>``/``bn<j>``, ``downsample.0``/``.1``,
``fc``) mapped onto the JAX-layout trees by the port's own copy of the
name map: OIHW -> HWIO convs, running statistics -> BN moving statistics,
``fc`` -> ``logits`` (transposed).  ``prefix`` relocates the target
scopes (``"backbone/"`` for DeepLabv3+'s encoder).  The file is read with
``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

from typing import Any, Mapping

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


def import_torch_resnet(state_dict: Mapping[str, Any], params: dict,
                        state: dict, depth: int = 50,
                        load_head: bool = True, prefix: str = ""
                        ) -> tuple[dict, dict]:
    """New (params, state) with a torchvision-style ResNet ``state_dict``
    (tensors or numpy arrays) mapped in; a conv of another shape raises.
    ``logits`` takes ``fc`` only with ``load_head`` and a matching
    shape."""
    from myconvnet_tpu_torch.models.resnet import STAGE_BLOCKS

    def arr(key):
        v = state_dict[key]
        return v if isinstance(v, np.ndarray) else v.detach().cpu().numpy()

    new_p = {k: dict(v) for k, v in params.items()}
    new_s = {k: dict(v) for k, v in state.items()}

    def put_conv(scope, key):
        w = np.transpose(arr(key), (2, 3, 1, 0))      # OIHW -> HWIO
        want = new_p[scope]["w"].shape
        if tuple(w.shape) != tuple(want):
            raise ValueError(f"{scope}: {w.shape} != {want}")
        new_p[scope]["w"] = w.astype(np.float32)

    def put_bn(scope, key):
        new_p[scope]["gamma"] = arr(f"{key}.weight").astype(np.float32)
        new_p[scope]["beta"] = arr(f"{key}.bias").astype(np.float32)
        new_s[scope]["moving_mean"] = arr(
            f"{key}.running_mean").astype(np.float32)
        new_s[scope]["moving_var"] = arr(
            f"{key}.running_var").astype(np.float32)

    put_conv(f"{prefix}stem/conv", "conv1.weight")
    put_bn(f"{prefix}stem/bn", "bn1")
    letters = ("a", "b", "c") if depth >= 50 else ("a", "b")
    for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        for b in range(n_blocks):
            t_pre = f"layer{stage + 1}.{b}"
            scope = f"{prefix}stage{stage + 1}/block{b + 1}"
            for j, letter in enumerate(letters):
                put_conv(f"{scope}/conv_{letter}", f"{t_pre}.conv{j + 1}.weight")
                put_bn(f"{scope}/bn_{letter}", f"{t_pre}.bn{j + 1}")
            if f"{t_pre}.downsample.0.weight" in state_dict:
                put_conv(f"{scope}/conv_proj", f"{t_pre}.downsample.0.weight")
                put_bn(f"{scope}/bn_proj", f"{t_pre}.downsample.1")
    head = f"{prefix}logits"
    if load_head and "fc.weight" in state_dict and head in new_p:
        w = np.transpose(arr("fc.weight"), (1, 0))
        if tuple(w.shape) == tuple(new_p[head]["w"].shape):
            new_p[head]["w"] = w.astype(np.float32)
            new_p[head]["b"] = arr("fc.bias").astype(np.float32)
    return new_p, new_s


def import_torch_resnet_file(path: str, params: dict, state: dict,
                             depth: int = 50, load_head: bool = True,
                             prefix: str = "") -> tuple[dict, dict]:
    """:func:`import_torch_resnet` of a ``.pt``/``.pth`` file (a
    ``state_dict``, or a module saved whole)."""
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return import_torch_resnet(sd, params, state, depth, load_head,
                               prefix=prefix)
