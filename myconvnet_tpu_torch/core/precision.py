"""Precision policy: the dtype convolutions and matmuls compute in.

Port of ``myconvnet_tpu/core/precision.py``.  Parameters, BN statistics
and the returned logits are float32 under both policies; ``FULL``
computes in float32, ``BF16`` in bfloat16 with float32 accumulation.

JAX's ``FULL`` asks XLA for ``Precision.HIGHEST``.  cuDNN runs float32
convolutions in TF32 unless told otherwise, so :func:`apply_backend_flags`
turns TF32 off under ``FULL`` (and leaves the flags alone under ``BF16``,
whose convolutions take bf16 inputs anyway).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.float32


FULL = Policy()
BF16 = Policy(compute_dtype=torch.bfloat16)


def get_policy(name: str) -> Policy:
    table = {"f32": FULL, "float32": FULL, "bf16": BF16, "bfloat16": BF16}
    try:
        return table[name]
    except KeyError as e:
        raise ValueError(f"unknown precision policy {name!r}") from e


def apply_backend_flags(policy: Policy) -> None:
    """Under FULL, make float32 convs and matmuls true float32 on the card
    (the counterpart of JAX's ``Precision.HIGHEST``)."""
    if policy.compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
