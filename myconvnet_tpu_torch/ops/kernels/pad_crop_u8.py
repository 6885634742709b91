"""CIFAR-style training input: integer pad-crop, h-flip, normalize, fused.

Port of ``myconvnet_tpu/ops/pallas/pad_crop_u8.py``
(``pad_crop_flip_normalize`` at ``:68``).  The CUDA kernel is
``csrc/pad_crop_u8.cu``: one read of the uint8 batch and one write of
float32 or bf16, bound by HBM bytes.  A block takes bands of output rows
of one image (:func:`plan`: a whole image where it is small, as CIFAR's 3
KB are; one wave of blocks walking the bands at large shapes), stages the
band's source rows (one contiguous span, since output row r reads row r +
sy) in shared memory, and writes the band's contiguous output span with
16-byte stores, each thread at a fixed column position whose shifted,
flipped source offsets, scales and shifts it works out once a band.  The
TPU kernel flips with a permutation matmul; the CUDA kernel reverses the
column index.

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

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from myconvnet_tpu_torch.ops.kernels import _build
from myconvnet_tpu_torch.ops.kernels.normalize_u8 import (device_stats,
                                                          scale_shift)

_ENTRY = {torch.float32: "mcn_pad_crop_u8_f32",
          torch.bfloat16: "mcn_pad_crop_u8_bf16"}
MODES = {"copy": 0, "direct": 1}

# What the planner assumes of the card (an H100 SXM) and of the kernel;
# the card test holds them against kernel_facts()
SMS = 132
THREADS = 256          # threads a block, about
MAX_THREADS = 512      # the kernel's launch bounds
WARPS_SM = 32          # warps an SM holds at <= 64 registers a thread
MAX_BLOCKS_SM = 32
SMEM_BLOCK = 227 * 1024
SMEM_SM = 228 * 1024   # an SM's shared memory, 1 KB of it kept a block
MAX_C = 4096
WHOLE_BYTES = 16 * 1024  # an image up to this size is one band
# else bands of about this many source bytes: 16 rows of 224 x 3 were the
# fastest of 4-48 at [256, 224, 224, 3] (PERF.md, section 6)
BAND_BYTES = 11 * 1024
MIN_FILL = 0.9           # the last round of bands at least this full


def _band_smem(rows: int, wc: int, c: int, mode: str, buffers: int = 1
               ) -> int:
    """Shared memory a block: the [C] (scale, shift) table and ``buffers``
    buffers of a band's source rows, each with 16 bytes of slack for their
    alignment (16-byte multiples)."""
    table = -(-8 * c // 16) * 16
    stage = 0 if mode == "direct" else -(-(rows * wc + 16) // 16) * 16
    return table + buffers * stage


def _blocks_sm(threads: int, smem: int) -> int:
    """Blocks an SM holds: its warps (registers) and shared memory."""
    return min(MAX_BLOCKS_SM, max(1, WARPS_SM // -(-threads // 32)),
               SMEM_SM // (smem + 1024))


def plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
         mode: str | None = None) -> dict:
    """The launch of [n, h, w, c] uint8 -> ``dtype`` (float32 or bfloat16).

    ``vec``: outputs a 16-byte store; ``period``: stores before an item's
    column position repeats (W C / gcd(W C, vec)), ``rpp`` rows later;
    ``threads``: the multiple of ``period`` nearest THREADS where one fits
    in MAX_THREADS, so each thread keeps one position; ``rows``: rows a band
    (``h``: whole images, staged before the offsets are read), ``bands`` an
    image and ``items`` = n bands; ``smem`` a block (two band buffers when
    blocks walk several bands); ``blocks``: at most one wave and no more
    than the items.  Bands are sized to about BAND_BYTES of source, at
    least SMS items, and a last round of bands at least MIN_FILL full.
    ``mode``: "copy" (16-byte cp.async staging) or "direct" (no staging),
    None to let the planner pick: "direct" only for rows wider than half a
    block's shared memory.  The wrapper takes the planner's pick; a probe
    or test forces a mode by replacing ``_launch_plan`` with
    :func:`launch_args` of a plan at that mode."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    wc = w * c
    g = math.gcd(wc, vec)
    period, rpp = wc // g, vec // g
    if period <= MAX_THREADS:   # the multiple of the period nearest THREADS
        threads = min(range(period, MAX_THREADS + 1, period),
                      key=lambda t: (abs(t - THREADS), -t))
    else:
        threads = THREADS
    if _band_smem(1, wc, c, "copy", 2) > SMEM_BLOCK:
        mode = "direct"
    mode = mode or "copy"

    def fit(rows):
        bands = -(-h // rows)
        items = n * bands
        smem = _band_smem(rows, wc, c, mode)
        wave = SMS * _blocks_sm(threads, smem)
        if items > wave:   # blocks walk bands: a second buffer
            smem = _band_smem(rows, wc, c, mode, 2)
            wave = SMS * _blocks_sm(threads, smem)
        # the share of the last round's blocks that have a band
        rounds = -(-items // wave)
        fill = items / (rounds * min(items, wave)) if items else 1.0
        return dict(rows=rows, bands=bands, items=items, smem=smem,
                    wave=wave, fill=fill)

    if h * wc <= WHOLE_BYTES and mode != "direct":
        best = fit(h)
    else:
        room = (SMEM_BLOCK - _band_smem(0, wc, c, "copy", 2)) // 2 // wc
        cap = h if mode == "direct" else max(1, min(h, room))
        first = max(-(-h // max(1, BAND_BYTES // wc)),
                    -(-SMS // max(n, 1)), -(-h // cap))
        best = None
        for bands in range(min(first, h), min(h, 4 * first) + 1):
            f = fit(-(-h // bands))
            if best is None or f["fill"] > best["fill"]:
                best = f
            if f["fill"] >= MIN_FILL:
                best = f
                break
    blocks = max(1, min(best["items"], best["wave"]))
    return dict(mode=mode, vec=vec, period=period, rpp=rpp,
                threads=threads, blocks=blocks,
                **{k: best[k] for k in ("rows", "bands", "items", "smem")})


def launch_args(p: dict) -> tuple[int, ...]:
    """(rows, mode code, threads, blocks, smem): the kernel's launch
    arguments of a :func:`plan`."""
    return p["rows"], MODES[p["mode"]], p["threads"], p["blocks"], p["smem"]


@functools.lru_cache(maxsize=256)
def _launch_plan(n, h, w, c, dtype) -> tuple[int, ...]:
    """:func:`launch_args` of :func:`plan`, cached: the wrapper asks for
    it at every launch."""
    return launch_args(plan(n, h, w, c, dtype))


def kernel_facts(mode: str, threads: int, smem: int) -> dict:
    """SMs of the card, blocks an SM holds of the f32 and the bf16 kernel
    of ``mode`` ("copy" or "direct") at ``threads`` and ``smem`` bytes a
    block, and the most threads a block may have.  Needs the card."""
    out = (ctypes.c_int * 4)()
    _build.check("mcn_pad_crop_u8_facts",
                 _build.library().mcn_pad_crop_u8_facts(
                     MODES[mode], threads, smem,
                     ctypes.cast(out, ctypes.c_void_p)))
    return dict(sms=out[0], blocks_per_sm_f32=out[1],
                blocks_per_sm_bf16=out[2], max_threads=out[3])


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
    if c > MAX_C or 3 * h * w * c >= 2 ** 30:
        raise ValueError(f"pad_crop_u8 kernel takes images of at most "
                         f"{MAX_C} channels and 2^30 / 3 bytes, not "
                         f"{tuple(images.shape)}")
    offsets = offsets.to(device=dev, dtype=torch.int32).contiguous()
    flip = flip.to(device=dev, dtype=torch.bool).contiguous()
    mean, std = device_stats(mean, std, dev)
    y = torch.empty(images.shape, dtype=out_dtype, device=dev)
    entry = _ENTRY[out_dtype]
    rows, mcode, threads, blocks, smem = _launch_plan(n, h, w, c,
                                                      out_dtype)
    code = getattr(_build.library(), entry)(
        images.data_ptr(), offsets.data_ptr(), flip.data_ptr(),
        mean.data_ptr(), std.data_ptr(), y.data_ptr(), n, h, w, c, rows,
        mcode, threads, blocks, smem,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(entry, code)
    pad_crop_flip_normalize.launches += 1
    return y


pad_crop_flip_normalize.launches = 0
