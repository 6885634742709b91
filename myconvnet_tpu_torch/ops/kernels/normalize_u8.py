"""uint8 images to normalized floats: (x / 255 - mean) / std in one pass.

Port of ``myconvnet_tpu/ops/pallas/normalize_u8.py`` (``normalize_u8`` at
``:34``).  The CUDA kernel is ``csrc/normalize_u8.cu``: one read of the
uint8 batch and one write of float32 or bf16, 16 bytes of input per thread
when the tensors allow; it is bound by HBM bytes on the H100.  As in the
Pallas kernel (``normalize_u8.py:44-45``), ``1 / (255 * std)`` and
``-mean / std`` are folded into a per-channel (scale, shift), so each
element is one multiply and one add; the kernel folds them itself, with
the plain version's float32 roundings, so a call is one launch.

It is the eval input of the CIFAR recipe: ``data.augment.augment_eval``
when the batch is already at the model's size.

On a CPU tensor the wrapper runs :func:`normalize_u8_reference`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch.ops.kernels import _build

_ENTRY = {torch.float32: "mcn_normalize_u8_f32",
          torch.bfloat16: "mcn_normalize_u8_bf16"}


def device_stats(mean, std, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) as contiguous float32 tensors on ``device`` (no copy
    when they are already)."""
    return tuple(torch.as_tensor(v, dtype=torch.float32,
                                 device=device).contiguous()
                 for v in (mean, std))


def scale_shift(mean, std, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 (1 / (255 * std), -mean / std) on ``device``."""
    mean, std = device_stats(mean, std, device)
    return 1.0 / (255.0 * std), -mean / std


def normalize_u8_reference(images: torch.Tensor, mean, std,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain PyTorch version: ``x * scale + shift`` in float32."""
    scale, shift = scale_shift(mean, std, images.device)
    return (images.float() * scale + shift).to(out_dtype)


def normalize_u8(images: torch.Tensor, mean, std,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[N, H, W, C] uint8 -> [N, H, W, C] ``out_dtype`` (float32 or bf16).

    ``mean``/``std``: per-channel, length C.  Pass float32 tensors on the
    images' device on a hot path: a Python sequence costs a host-to-device
    copy per call, and such a copy from pageable memory syncs the stream.
    """
    if images.dim() != 4 or images.dtype != torch.uint8:
        raise TypeError(f"normalize_u8 takes uint8 [N, H, W, C], not "
                        f"{images.dtype} {tuple(images.shape)}")
    c = images.shape[-1]
    if len(mean) != c or len(std) != c:
        raise ValueError(f"mean/std have {len(mean)}/{len(std)} entries "
                         f"for {c} channels")
    if out_dtype not in _ENTRY:
        raise TypeError(f"normalize_u8 writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if images.device.type == "cpu":
        return normalize_u8_reference(images, mean, std, out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"no normalize_u8 kernel for device {images.device}")
    if not images.is_contiguous():
        raise ValueError("normalize_u8 kernel needs a contiguous tensor")
    mean, std = device_stats(mean, std, images.device)
    y = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    entry = _ENTRY[out_dtype]
    code = getattr(_build.library(), entry)(
        images.data_ptr(), mean.data_ptr(), std.data_ptr(), y.data_ptr(),
        images.numel(), c,
        torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(entry, code)
    normalize_u8.launches += 1
    return y


normalize_u8.launches = 0
