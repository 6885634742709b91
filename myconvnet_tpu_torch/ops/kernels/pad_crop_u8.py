"""CIFAR-style training input: integer pad-crop, h-flip, normalize, fused.

Port of ``myconvnet_tpu/ops/pallas/pad_crop_u8.py``
(``pad_crop_flip_normalize`` at ``:68``).  The CUDA kernel is
``csrc/pad_crop_u8.cu``: one thread per output element reads its source
pixel (or 0 outside the frame) and writes the normalized value; one read
of the uint8 batch and one write of float32 or bf16, bound by HBM bytes.
The TPU kernel flips with a permutation matmul; the CUDA kernel reverses
the column index.

Per image n with offsets (sy, sx) and flip f, for output pixel (r, q):
the source is (r + sy, q' + sx) with q' = W - 1 - q when f, else q (crop
first, then flip, as ``pad_crop_u8.py:42-58``); a source outside the frame
reads 0 before normalizing.  That is ``data/augment.augment_train``'s
pad-crop mode exactly (integer boxes from ``pad_crop_boxes``,
``clamp=False``).

On a CPU tensor the wrapper runs :func:`pad_crop_reference`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from myconvnet_tpu_torch.ops.kernels import _build
from myconvnet_tpu_torch.ops.kernels.normalize_u8 import (device_stats,
                                                          scale_shift)

_ENTRY = {torch.float32: "mcn_pad_crop_u8_f32",
          torch.bfloat16: "mcn_pad_crop_u8_bf16"}


def _check(images, offsets, flip, mean, std, out_dtype):
    if images.dim() != 4 or images.dtype != torch.uint8:
        raise TypeError(f"pad_crop_flip_normalize takes uint8 [N, H, W, C], "
                        f"not {images.dtype} {tuple(images.shape)}")
    n, _, _, c = images.shape
    if tuple(offsets.shape) != (n, 2) or tuple(flip.shape) != (n,):
        raise ValueError(f"offsets {tuple(offsets.shape)} / flip "
                         f"{tuple(flip.shape)} do not fit {n} images")
    if offsets.dtype.is_floating_point:
        raise TypeError("offsets are integer pixel shifts")
    if len(mean) != c or len(std) != c:
        raise ValueError(f"mean/std have {len(mean)}/{len(std)} entries "
                         f"for {c} channels")
    if out_dtype not in _ENTRY:
        raise TypeError(f"pad_crop_flip_normalize writes float32 or "
                        f"bfloat16, not {out_dtype}")


def pad_crop_reference(images: torch.Tensor, offsets: torch.Tensor,
                       flip: torch.Tensor, mean, std, *, pad: int = 4,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain PyTorch version: zero-pad by ``pad``, gather each image's
    window, flip, then ``x * scale + shift`` in float32.  Offsets must lie
    in [-pad, pad]."""
    n, h, w, _ = images.shape
    dev = images.device
    padded = F.pad(images.float(), (0, 0, pad, pad, pad, pad))
    rows = torch.arange(h, device=dev) + pad + offsets[:, :1].long()
    cols = torch.arange(w, device=dev).expand(n, w)
    cols = torch.where(flip.bool()[:, None], w - 1 - cols, cols)
    cols = cols + pad + offsets[:, 1:].long()
    idx = torch.arange(n, device=dev)[:, None, None]
    crop = padded[idx, rows[:, :, None], cols[:, None, :]]
    scale, shift = scale_shift(mean, std, dev)
    return (crop * scale + shift).to(out_dtype)


def pad_crop_flip_normalize(images: torch.Tensor, offsets: torch.Tensor,
                            flip: torch.Tensor, mean, std, *, pad: int = 4,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """[N, H, W, C] uint8 -> [N, H, W, C] ``out_dtype`` (float32 or bf16).

    offsets: [N, 2] integer (row, column) shifts in [-pad, pad]; flip: [N]
    bool or integer; both stay on the device (no host sync).  ``mean``/
    ``std`` as in ``normalize_u8`` (device tensors on a hot path).  The
    kernel reads 0 outside the frame for any offset; ``pad`` bounds the
    offsets the plain version takes.
    """
    _check(images, offsets, flip, mean, std, out_dtype)
    if images.device.type == "cpu":
        return pad_crop_reference(images, offsets, flip, mean, std, pad=pad,
                                  out_dtype=out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"no pad_crop_u8 kernel for device {images.device}")
    if not images.is_contiguous():
        raise ValueError("pad_crop_u8 kernel needs a contiguous tensor")
    dev = images.device
    n, h, w, c = images.shape
    offsets = offsets.to(device=dev, dtype=torch.int32).contiguous()
    flip = flip.to(device=dev, dtype=torch.bool).contiguous()
    mean, std = device_stats(mean, std, dev)
    y = torch.empty(images.shape, dtype=out_dtype, device=dev)
    entry = _ENTRY[out_dtype]
    code = getattr(_build.library(), entry)(
        images.data_ptr(), offsets.data_ptr(), flip.data_ptr(),
        mean.data_ptr(), std.data_ptr(), y.data_ptr(), n, h, w, c,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(entry, code)
    pad_crop_flip_normalize.launches += 1
    return y


pad_crop_flip_normalize.launches = 0
