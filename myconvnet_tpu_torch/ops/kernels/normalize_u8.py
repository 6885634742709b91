"""uint8 images to normalized floats: (x / 255 - mean) / std in one pass.

Port of ``myconvnet_tpu/ops/pallas/normalize_u8.py`` (``normalize_u8`` at
``:34``).  The CUDA kernel is ``csrc/normalize_u8.cu``: one read of the
uint8 batch and one write of float32 or bf16, bound by HBM bytes on the
H100.  As in the Pallas kernel (``normalize_u8.py:44-45``), ``1 / (255 *
std)`` and ``-mean / std`` are folded into a per-channel (scale, shift), so
each element is one multiply and one add.  A thread's step is the
elements of one 16-byte store (a warp writes 512 contiguous bytes);
:func:`plan` sizes a one-wave grid whose threads each keep one channel
phase for life (their lanes' scale and shift in registers, no index
arithmetic per step) and four loads in flight; the kernel issues its
first loads before it folds mean and std, with the plain version's
float32 roundings, so a call is one launch and the fold is off the
critical path.  A card test holds the planner's assumptions against
:func:`kernel_facts`.

It is the eval input of the CIFAR recipe: ``data.augment.augment_eval``
when the batch is already at the model's size.

On a CPU tensor the wrapper runs :func:`normalize_u8_reference`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from myconvnet_tpu_torch.ops.kernels import _build

_ENTRY = {torch.float32: "mcn_normalize_u8_f32",
          torch.bfloat16: "mcn_normalize_u8_bf16"}
PATHS = {"scalar": 0, "vector": 1}

# What the planner assumes of the card (an H100 SXM) and of the kernel;
# the card test holds them against kernel_facts()
SMS = 132
THREADS = 256     # threads a block (the kernel's kThreads)
BLOCKS_SM = 4     # blocks an SM holds (the kernel's launch bounds)
UNROLL = 4        # loads in flight a thread
MAX_C = 4096
# input bytes a thread below a wave: fewer, larger blocks finish a small
# batch sooner (the CIFAR eval batch: 96 blocks rather than 384 at a step
# a thread; fashion_mnist_smallnet's: 25; PERF.md, section 6)
BYTES_THREAD = 16


def plan(total: int, c: int, dtype: torch.dtype, aligned: bool = True
         ) -> dict:
    """The launch of ``total`` uint8 elements of C channels to ``dtype``
    (float32 or bfloat16); ``aligned``: the images' base is aligned to a
    step's bytes.  A step of a thread is the elements of one 16-byte store
    (4 float32, 8 bf16; path "vector"), or one element (path "scalar", for
    a misaligned base); ``period``: the steps after which a step's first
    channel repeats (C / gcd(C, elements a step)); ``threads`` and
    ``blocks``: at most one wave, BYTES_THREAD input bytes a thread below
    it, and at least ``period`` threads in all, so thread g keeps the
    channel phase of step g for every step it takes (its steps are g + i
    S, S a multiple of ``period``)."""
    step = 16 // torch.empty((), dtype=dtype).element_size() \
        if aligned else 1
    nvec = total // step
    period = c // math.gcd(c, step)
    blocks = max(-(-period // THREADS),
                 min(SMS * BLOCKS_SM, -(-total // (THREADS * BYTES_THREAD))),
                 1)
    return dict(path="vector" if aligned else "scalar", step=step,
                nvec=nvec, period=period, threads=THREADS, blocks=blocks)


@functools.lru_cache(maxsize=256)
def _launch_plan(total, c, dtype, aligned) -> tuple[int, int, int]:
    """(path code, threads, blocks) of :func:`plan`, cached: the wrapper
    asks for it at every launch."""
    p = plan(total, c, dtype, aligned)
    return PATHS[p["path"]], p["threads"], p["blocks"]


def kernel_facts() -> dict:
    """SMs of the card, blocks of THREADS an SM holds of the vector-path
    kernel (f32 and bf16 out), its threads a block and loads in flight a
    thread.  Needs the card (the library is built there)."""
    out = (ctypes.c_int * 5)()
    _build.check("mcn_normalize_u8_facts",
                 _build.library().mcn_normalize_u8_facts(
                     ctypes.cast(out, ctypes.c_void_p)))
    return dict(sms=out[0], blocks_per_sm_f32=out[1],
                blocks_per_sm_bf16=out[2], threads=out[3], unroll=out[4])


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
    if c > MAX_C:
        raise ValueError(f"normalize_u8 kernel takes at most {MAX_C} "
                         f"channels, not {c}")
    mean, std = device_stats(mean, std, images.device)
    y = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    entry = _ENTRY[out_dtype]
    step = 16 // y.element_size()
    path, threads, blocks = _launch_plan(images.numel(), c, out_dtype,
                                         images.data_ptr() % step == 0)
    code = getattr(_build.library(), entry)(
        images.data_ptr(), mean.data_ptr(), std.data_ptr(), y.data_ptr(),
        images.numel(), c, path, threads, blocks,
        torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(entry, code)
    normalize_u8.launches += 1
    return y


normalize_u8.launches = 0
