"""Checkpoints of the full training state in the JAX package's npz format.

Port of ``myconvnet_tpu/ckpt/checkpoint.py:39-194``, with
``best_checkpoint``, ``average_checkpoints`` and ``checkpoint_step``.  A checkpoint is one
``ckpt-<step>.npz`` with flattened ``path::name`` keys plus a JSON sidecar,
written to a temporary file and renamed into place.  The state is a dict
of numpy trees in the JAX layout (``TrainState._asdict()`` of the trainer):

    params::<scope>::<name>        (HWIO conv weights, [in, out] dense)
    model_state::<scope>::<name>   (BN moving statistics)
    opt_state::<scope>::<name>     (momentum buffers, same layout)
    step, rng

so ``weights.load_jax_checkpoint`` reads a checkpoint of either package.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings
from typing import Any

import numpy as np

SEP = "::"


def flatten(state: dict[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> {"a::b::c": array}."""
    flat = {}
    for key, value in state.items():
        if isinstance(value, dict):
            flat.update(flatten(value, f"{prefix}{key}{SEP}"))
        else:
            flat[prefix + key] = np.asarray(value)
    return flat


def save_checkpoint(directory: str, step: int, state: dict[str, Any], *,
                    keep: int = 3, metric: float | None = None,
                    is_best: bool = False) -> str:
    """Atomically write ``ckpt-{step}.npz`` (+ a ``best.npz`` copy when
    ``is_best``); prunes to the newest ``keep`` checkpoints."""
    os.makedirs(directory, exist_ok=True)
    flat = flatten(state)
    path = os.path.join(directory, f"ckpt-{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    meta = {"step": int(step), "metric": metric, "keys": sorted(flat)}
    with open(os.path.join(directory, f"ckpt-{step}.json"), "w") as f:
        json.dump(meta, f)
    if is_best:
        _link_or_copy(path, os.path.join(directory, "best.npz"))
        with open(os.path.join(directory, "best.json"), "w") as f:
            json.dump(meta, f)
    _prune(directory, keep)
    return path


def _link_or_copy(src: str, dst: str) -> None:
    """``dst`` becomes ``src``'s contents: a hard link (no second write of
    a checkpoint that may be gigabytes; a later checkpoint written to
    ``src``'s name replaces that name, not the linked file), or a copy
    where the file system has no links; atomic either way."""
    tmp = dst + ".tmp"
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def _prune(directory: str, keep: int) -> None:
    steps = all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(directory, f"ckpt-{s}{ext}"))
            except FileNotFoundError:
                pass


def all_steps(directory: str) -> list[int]:
    steps = []
    try:
        names = os.listdir(directory)
    except (FileNotFoundError, NotADirectoryError):
        return []
    for n in names:
        if n.startswith("ckpt-") and n.endswith(".npz"):
            try:
                steps.append(int(n[len("ckpt-"):-len(".npz")]))
            except ValueError:
                pass
    return sorted(steps)


def latest_checkpoint(directory: str) -> str | None:
    steps = all_steps(directory)
    if not steps:
        return None
    return os.path.join(directory, f"ckpt-{steps[-1]}.npz")


def best_checkpoint(directory: str) -> str | None:
    """``best.npz`` of a run directory, or None."""
    p = os.path.join(directory, "best.npz")
    return p if os.path.exists(p) else None


def checkpoint_step(path: str) -> int:
    """The step of ``ckpt-<step>.npz``, or of ``best.npz`` (its
    sidecar)."""
    base = os.path.basename(path)
    if base == "best.npz":
        with open(os.path.join(os.path.dirname(path), "best.json")) as f:
            return int(json.load(f)["step"])
    return int(base[len("ckpt-"):-len(".npz")])


def restore_checkpoint(path: str, target: dict[str, Any]) -> dict[str, Any]:
    """Restore into the structure of ``target`` (nested dicts of arrays,
    e.g. the freshly built state).  Shapes are validated; a mismatch names
    the entry.  ``path`` may be a directory (its newest checkpoint)."""
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoints in {path!r}")
        path = found
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    flat_target = flatten(target)
    missing = sorted(set(flat_target) - set(saved))
    if missing:
        raise ValueError(f"checkpoint {path!r} missing keys: {missing[:5]}"
                         f"{'...' if len(missing) > 5 else ''}")
    unused = sorted(set(saved) - set(flat_target))
    if unused:
        # loud, not fatal: usually an architecture changed under the file
        warnings.warn(
            f"checkpoint {path!r} carries {len(unused)} entries the target "
            f"has no slot for (e.g. {unused[:3]}); they are ignored",
            stacklevel=2)

    def fill(tree, prefix=""):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = fill(value, f"{prefix}{key}{SEP}")
                continue
            arr = saved[prefix + key]
            if arr.shape != np.shape(value):
                raise ValueError(f"shape mismatch for {prefix + key!r}: "
                                 f"checkpoint {arr.shape} vs target "
                                 f"{np.shape(value)}")
            out[key] = arr.astype(np.asarray(value).dtype)
        return out
    return fill(target)


def _unflatten_like(tree: dict, flat: dict, prefix: str = "") -> dict:
    return {key: (_unflatten_like(value, flat, f"{prefix}{key}{SEP}")
                  if isinstance(value, dict) else flat[prefix + key])
            for key, value in tree.items()}


def average_checkpoints(directory: str, target: dict[str, Any], *,
                        n_last: int = 0,
                        subtree: str = "params") -> dict[str, Any]:
    """The newest checkpoint of ``directory`` with its ``subtree`` leaves
    replaced by their float64 mean over the last ``n_last`` checkpoints
    (0: all of them; 1: the newest as it is), cast to each leaf's dtype;
    everything else (optimizer state, step, rng) is the newest's."""
    steps = all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory!r}")
    use = steps[-n_last:] if n_last and n_last >= 1 else steps
    newest = restore_checkpoint(
        os.path.join(directory, f"ckpt-{use[-1]}.npz"), target)
    if len(use) == 1:
        return newest
    prefix = subtree + SEP
    acc: dict[str, np.ndarray] = {}
    for s in use:
        with np.load(os.path.join(directory, f"ckpt-{s}.npz")) as data:
            for k in data.files:
                if k.startswith(prefix):
                    acc[k] = acc.get(k, 0.0) + data[k].astype(np.float64)
    flat = flatten(newest)
    for k, v in acc.items():
        flat[k] = (v / len(use)).astype(flat[k].dtype)
    return _unflatten_like(newest, flat)
