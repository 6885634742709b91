"""Multi-head attention: the plain einsum path and the flash kernels.

Port of ``myconvnet_tpu/ops/attention.py:34-72``.  Two exact
implementations of the same math:

* :func:`attention_reference`: einsum attention in float32 (scores,
  softmax, the product with V), output cast to q's dtype.  It writes the
  [B, H, L, L] probabilities, which attention dropout needs.
* :func:`~myconvnet_tpu_torch.ops.kernels.flash_attention.flash_attention`:
  the hand-written kernels, which never write a score.

:func:`multi_head_attention` takes the kernels for CUDA tensors in bf16
with no attention dropout, at every sequence length, and the reference
otherwise (CPU tensors, float32 inputs, or dropout > 0, which needs the
probabilities).  The JAX package takes its Pallas kernel only on a TPU at
L >= 256, a threshold measured there; on the card the einsum path writes
B * H * L^2 float32 scores per pass (477 MB per layer for ViT-B/16 at
L = 197 and a batch of 256), which the kernels do not.  ``use_flash``
overrides the rule, as in JAX.  Softmax statistics are float32 on both
paths.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch.ops.kernels.flash_attention import flash_attention


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float | None = None,
                        dropout_rate: float = 0.0,
                        dropout_mask: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Einsum attention.  q, k, v: [B, H, L, D] -> [B, H, L, D].

    ``dropout_mask`` ([B, H, L, L] bool, True = keep) is required when
    ``dropout_rate`` > 0."""
    d = q.shape[-1]
    if scale is None:
        scale = float(d) ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        if dropout_mask is None:
            raise ValueError("dropout_rate > 0 requires dropout_mask")
        keep = 1.0 - dropout_rate
        p = torch.where(dropout_mask, p / keep, torch.zeros_like(p))
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float | None = None,
                         dropout_rate: float = 0.0,
                         dropout_mask: torch.Tensor | None = None,
                         use_flash: bool | None = None) -> torch.Tensor:
    """Dispatching MHA: the flash kernels for bf16 CUDA tensors without
    dropout, the einsum path otherwise."""
    if use_flash is None:
        use_flash = (q.device.type == "cuda" and q.dtype == torch.bfloat16
                     and dropout_rate == 0.0)
    if use_flash and dropout_rate > 0.0:
        raise ValueError("flash attention does not support attention-"
                         "probability dropout; use the reference path")
    if use_flash:
        return flash_attention(q, k, v, scale=scale)
    return attention_reference(q, k, v, scale=scale,
                               dropout_rate=dropout_rate,
                               dropout_mask=dropout_mask)
