"""Correlation (cost) volume of two feature maps, forward and backward.

Port of ``myconvnet_tpu/ops/pallas/correlation.py``
(``pallas_correlation_volume`` ``:67``, the Pallas call at ``:87``, body
``_corr_fwd_kernel`` ``:43-60``); the CUDA kernels are
``csrc/correlation.cu``.

    out[n, y, x, dy * (2d + 1) + dx] =
        (1 / C) * sum_c f1[n, y, x, c] * f2[n, y + dy - d, x + dx - d, c]

with zeros for taps outside the frame.  f1 and f2 are float32 or bf16
[N, H, W, C]; products and sums are float32 (a bf16 product is exact in
float32), and the volume is float32 [N, H, W, (2d + 1)^2], written in NHWC
directly (the Pallas kernel writes [N, K, H, W] and transposes).

The Pallas kernel is forward-only and the JAX package differentiates the
XLA op; the port trains through the kernel, so it has a backward: two
gather-form kernels (no atomics, so the result does not depend on the
run),

    d_f1[n, y, x, c] = (1 / C) sum_k g[n, y, x, k] f2[n, y+dy-d, x+dx-d, c]
    d_f2[n, y, x, c] = (1 / C) sum_k g[n, y-dy+d, x-dx+d, k]
                                     f1[n, y-dy+d, x-dx+d, c]

with g float32 and the gradients rounded once to the inputs' dtype.

bf16 inputs with C <= 256 take the tensor-core kernels (``csrc/
correlation.cu``, design there): each output row x 64 pixels is one
banded matrix product a displacement row, on wgmma; :func:`plan` (below)
picks the segment of the other map a block stages (narrow maps take short
ones), the rows a block, the ring of segments in shared memory and
whether TMA or the producer's copies stage them (C % 8 != 0 or a
misaligned base), and the CPU tests hold it; :func:`kernel_facts` asks the
built kernel for what the planner copies.  Float32 inputs, and bf16 with C
> 256, take the CUDA-core kernels: no recipe gives them float32, and their
float32 tolerance (2^-18) is below what bf16 tensor-core products can
meet.

The channel mean divides the sum by C, as ``jnp.mean`` in the XLA op
(``ops/correlation.py:49``) does; the Pallas body multiplies by the
reciprocal (``:59``), one float32 ulp away.  :func:`correlation_reference`
and the kernels both divide.

The forward kernel is the custom op ``mcn::correlation_fwd`` (``_ops``):
its CUDA implementation is :func:`launch_fwd_cuda`, its CPU implementation
:func:`correlation_reference`.  :func:`correlation_fwd` calls it on CPU
tensors and while ``torch.export`` traces, and launches directly on CUDA
tensors otherwise (``_ops.direct``); without autograd :func:`correlation`
calls :func:`correlation_fwd` alone, and ``_Correlation``'s forward calls
it too.  The backward kernels stay direct launches.

On a CPU tensor the wrappers run the plain version (and its autograd); on a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from myconvnet_tpu_torch.ops.kernels import _build, _ops

MAX_DISPLACEMENT = 4    # the recipes' window; the kernels' D_MAX
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MODES = {"fwd": 0, "bwd_f1": 1, "bwd_f2": 2}

# What the planner assumes of the card (an H100 SXM) and of the
# tensor-core kernels (csrc/correlation.cu's TcLayout); the card tests hold
# them against kernel_facts()
SMS = 132                 # streaming multiprocessors
SMEM_MAX = 232_448        # shared memory a block may ask for (227 KB)
SMEM_PER_SM = 233_472     # shared memory an SM gives its blocks (228 KB)
SMEM_RESERVED = 1_024     # the runtime's share of it for each block
TILE = 64                 # output pixels of a block's row (wgmma's rows)
# segment pixels (at least min(64, W) + 2d): the forward's a wgmma width,
# the backward's whole k-steps of 16
SEG_ROWS = {"fwd": (16, 40, 72), "bwd_f1": (16, 48, 80),
            "bwd_f2": (16, 48, 80)}
OUT_STRIDE = 89           # floats between the forward's output-tile rows
MAX_TC_CHANNELS = 256     # four 64-channel panels
TY = (4, 2, 1)            # output rows a block the planner tries
# the aux ring's slots: the forward's f1 rows and d_f1's gradient rows come
# one an output row, d_f2's gradient pieces one a pair (deeper rings ran no
# faster on an H100, four f1 rows slower)
AUX_SLOTS = {"fwd": 2, "bwd_f1": 2, "bwd_f2": 4}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def seg_rows(mode: str, w: int, d: int) -> int:
    """Pixels of a segment: the fewest of SEG_ROWS[mode] that hold a tile's
    min(64, W) pixels and their 2d neighbours."""
    return next(s for s in SEG_ROWS[mode] if s >= min(TILE, w) + 2 * d)


def panel_channels(c: int, path: str) -> int:
    """Channels of a shared-memory panel: 32 (64-byte rows) where C <= 32
    comes by TMA, else 64."""
    return 32 if path == "tma" and c <= 32 else 64


def smem_bytes(mode: str, c: int, d: int, seg: int, slots: int,
               aux_slots: int, pw: int = 64) -> int:
    """Shared memory a block of ``mode`` asks for: ``slots`` segments of
    ``seg`` pixels of the other feature map in panels of ``pw`` channels,
    ``aux_slots`` of the aux ring (the forward's f1 rows, d_f1's gradient
    rows, d_f2's gradient pieces), the forward's output tile (64 rows of
    OUT_STRIDE floats), the mbarriers and 1024 bytes to align the base."""
    kc, nd = -(-c // pw), 2 * d + 1
    k = nd * nd
    seg = kc * seg * pw * 2
    aux = {"fwd": kc * TILE * pw * 2,
           "bwd_f1": _round_up(TILE * k * 4, 1024),
           "bwd_f2": _round_up(max(SEG_ROWS[mode]) * nd * 4, 1024)}[mode]
    out = TILE * OUT_STRIDE * 4 if mode == "fwd" else 0
    return (slots * seg + aux_slots * aux + out + 16 * (slots + aux_slots)
            + 1024)


def max_blocks(mode: str, kc: int) -> int:
    """Blocks an SM the kernel's launch bounds give registers for (its
    kMinBlocks): three of the forward, of d_f1 and d_f2 three, two or one
    as their KC x 32 accumulators allow."""
    if mode == "fwd" or kc == 1:
        return 3
    return 2 if kc <= 3 else 1


def blocks_per_sm(mode: str, c: int, smem: int) -> int:
    """Blocks of ``smem`` bytes an SM holds, at most :func:`max_blocks`."""
    return min(max_blocks(mode, -(-c // 64)),
               SMEM_PER_SM // (smem + SMEM_RESERVED))


def _tensor_cores(dtype, c: int) -> bool:
    """Whether the tensor-core kernels take the maps (bf16, C <= 256)."""
    return dtype == torch.bfloat16 and c <= MAX_TC_CHANNELS


def wave_fill(blocks: int, per_wave: int) -> float:
    """The share of the card's block slots a grid of ``blocks`` keeps
    busy, over the waves it takes."""
    return blocks / (-(-blocks // per_wave) * per_wave)


def plan(mode: str, shape, d: int, dtype=torch.bfloat16,
         aligned: bool = True) -> dict:
    """The launch plan of kernel ``mode`` ("fwd", "bwd_f1", "bwd_f2") at
    feature maps ``shape`` = [N, H, W, C] of ``dtype``, window d.

    ``path``: "tma" (bf16, C % 8 == 0, 16-byte aligned bases), "staged"
    (bf16, the same kernel with plain loads) or "cuda_cores" (float32, or C
    over 256).  For the first two, the ring of segments in shared memory:
    with ``reuse`` each feature row is loaded once into nd + 2 or nd + 1
    ``slots``, else a row is loaded for every displacement row into 4, 3 or
    2 slots (beside AUX_SLOTS[mode] ``aux_slots``); of the rings that fit,
    the one whose blocks an SM holds the most of (``blocks_per_sm``: blocks
    hide each other's wgmma and load latency, which one warpgroup cannot),
    then reuse, then the most slots.  ``seg``: :func:`seg_rows`; ``pw``:
    :func:`panel_channels`.  ``ty`` output rows a block: the most of TY
    whose grid fills its last wave of blocks (:func:`wave_fill`) within
    0.02 of the best of them (fewer rows a block only to fill the card:
    on an H100 more rows a block ran faster where the waves filled alike,
    up to 4); ``blocks`` and ``smem``."""
    n, h, w, c = shape
    if not _tensor_cores(dtype, c):
        return dict(path="cuda_cores")
    path = "tma" if c % 8 == 0 and aligned else "staged"
    nd, seg, pw = 2 * d + 1, seg_rows(mode, w, d), panel_channels(c, path)
    aux_slots = AUX_SLOTS[mode]
    rings = [(blocks_per_sm(mode, c, smem_bytes(mode, c, d, seg, s, aux_slots,
                                                pw)), r, s)
             for r, s in ((True, nd + 2), (True, nd + 1), (False, 4),
                          (False, 3), (False, 2))
             if smem_bytes(mode, c, d, seg, s, aux_slots, pw) <= SMEM_MAX]
    bps, reuse, slots = max(rings)
    tiles_x = -(-w // TILE)
    fill = {t: wave_fill(n * -(-h // t) * tiles_x, SMS * bps) for t in TY}
    ty = next(t for t in TY if fill[t] >= max(fill.values()) - 0.02)
    return dict(path=path, seg=seg, pw=pw, reuse=reuse, slots=slots,
                aux_slots=aux_slots, ty=ty, blocks_per_sm=bps,
                blocks=n * -(-h // ty) * tiles_x,
                smem=smem_bytes(mode, c, d, seg, slots, aux_slots, pw))


@functools.lru_cache(maxsize=1024)
def _launch_plan(mode, shape, d, aligned):
    p = plan(mode, shape, d, torch.bfloat16, aligned)
    return (p["seg"], p["pw"], p["ty"], p["slots"], p["aux_slots"],
            int(p["reuse"]), int(p["path"] == "tma"))


def kernel_facts(mode: str, c: int, d: int, seg: int, pw: int, slots: int,
                 aux_slots: int) -> dict:
    """What the built tensor-core kernels give for the planner's copies:
    the shared memory a block of ``mode`` asks for at (c, d, seg, pw,
    slots, aux_slots), the largest C, the threads a block, and of the current
    card the shared memory a block may use, the SMs and the blocks of that
    launch an SM holds.  Needs the card."""
    out = (ctypes.c_int * 6)()
    _build.check("mcn_correlation_tc_facts",
                 _build.library().mcn_correlation_tc_facts(
                     MODES[mode], c, d, seg, pw, slots, aux_slots,
                     ctypes.cast(out, ctypes.c_void_p)))
    return dict(smem=out[0], max_channels=out[1], threads=out[2],
                smem_max=out[3], sms=out[4], blocks_per_sm=out[5])


def _launch_tc(mode, a, seg, g, dst, d):
    """One launch of the tensor-core kernel ``mode`` (bf16 features)."""
    n, h, w, c = seg.shape
    aligned = seg.data_ptr() % 16 == 0 and (a is None
                                            or a.data_ptr() % 16 == 0)
    seg_px, pw, ty, slots, aux_slots, reuse, tma = _launch_plan(
        mode, (n, h, w, c), d, aligned)
    code = _build.library().mcn_correlation_tc(
        MODES[mode], a.data_ptr() if a is not None else None,
        seg.data_ptr(), g.data_ptr() if g is not None else None,
        dst.data_ptr(), n, h, w, c, d, seg_px, pw, ty, slots, aux_slots,
        reuse, tma, torch.cuda.current_stream(seg.device).cuda_stream)
    _build.check("mcn_correlation_tc", code)


def correlation_reference(f1: torch.Tensor, f2: torch.Tensor,
                          max_displacement: int = 4) -> torch.Tensor:
    """Plain PyTorch version (``myconvnet_tpu/ops/correlation.py:39-50``):
    the (2d + 1)^2 slices of the zero-padded f2, product, channel mean,
    stack; differentiable by autograd."""
    d = int(max_displacement)
    a, b = f1.float(), f2.float()
    n, h, w, c = a.shape
    bp = F.pad(b, (0, 0, d, d, d, d))
    out = [(a * bp[:, dy:dy + h, dx:dx + w]).sum(-1) / c
           for dy in range(2 * d + 1) for dx in range(2 * d + 1)]
    return torch.stack(out, dim=-1)


def correlation_bwd_reference(g: torch.Tensor, f1: torch.Tensor,
                              f2: torch.Tensor, max_displacement: int = 4
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(d_f1, d_f2) in the inputs' dtype: autograd of the plain version."""
    with torch.enable_grad():
        a = f1.detach().requires_grad_()
        b = f2.detach().requires_grad_()
        out = correlation_reference(a, b, max_displacement)
        return torch.autograd.grad(out, (a, b), g.float())


def _check(f1, f2, d):
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"feature maps must be [N, H, W, C] of one shape, "
                         f"got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.dtype != f2.dtype or f1.dtype not in _SUFFIX:
        raise TypeError(f"feature maps must both be float32 or bfloat16, "
                        f"got {f1.dtype} and {f2.dtype}")
    if f1.device != f2.device:
        raise ValueError(f"feature maps on {f1.device} and {f2.device}")
    if d < 0:
        raise ValueError(f"max_displacement must be >= 0, got {d}")


def _on_card(t: torch.Tensor, d: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no correlation kernel for device {t.device}")
    if d > MAX_DISPLACEMENT:
        raise ValueError(f"the correlation kernel takes max_displacement "
                         f"<= {MAX_DISPLACEMENT}, got {d}")
    if t.shape[0] > 65535 or t.shape[1] > 65535:
        raise ValueError(f"the correlation kernel takes N, H <= 65535, got "
                         f"{tuple(t.shape)}")


def launch_fwd_cuda(f1: torch.Tensor, f2: torch.Tensor,
                    max_displacement: int = 4) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors (the op's CUDA
    implementation); counts it in ``correlation_fwd.launches``."""
    d = int(max_displacement)
    _check(f1, f2, d)
    _on_card(f1, d)
    f1, f2 = f1.contiguous(), f2.contiguous()
    n, h, w, c = f1.shape
    out = torch.empty((n, h, w, (2 * d + 1) ** 2), dtype=torch.float32,
                      device=f1.device)
    if _tensor_cores(f1.dtype, c):
        _launch_tc("fwd", f1, f2, None, out, d)
    else:
        entry = f"mcn_correlation_fwd_{_SUFFIX[f1.dtype]}"
        code = getattr(_build.library(), entry)(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, h, w, c, d,
            torch.cuda.current_stream(f1.device).cuda_stream)
        _build.check(entry, code)
    correlation_fwd.launches += 1
    return out


@torch.library.custom_op("mcn::correlation_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd_op(f1: torch.Tensor, f2: torch.Tensor, d: int) -> torch.Tensor:
    return correlation_reference(f1, f2, d)


@_fwd_op.register_kernel("cuda")
def _fwd_op_cuda(f1, f2, d):
    return launch_fwd_cuda(f1, f2, d)


@_fwd_op.register_fake
def _fwd_op_fake(f1, f2, d):
    return f1.new_empty((*f1.shape[:3], (2 * d + 1) ** 2),
                        dtype=torch.float32)


_FWD_OP = torch.ops.mcn.correlation_fwd.default


def correlation_fwd(f1: torch.Tensor, f2: torch.Tensor,
                    max_displacement: int = 4) -> torch.Tensor:
    """[N, H, W, C] x [N, H, W, C] -> float32 [N, H, W, (2d + 1)^2]; no
    autograd (see :func:`correlation`)."""
    d = int(max_displacement)
    _check(f1, f2, d)
    if _ops.direct(f1):
        return launch_fwd_cuda(f1, f2, d)
    if f1.device.type == "cpu" and _ops.autograd_on_cpu(f1, f2):
        return correlation_reference(f1, f2, d)
    if f1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no correlation kernel for device {f1.device}")
    return _FWD_OP(f1, f2, d)


correlation_fwd.launches = 0


def _bwd(g, other, d, for_f2, counter):
    g, other = g.float().contiguous(), other.contiguous()
    n, h, w, c = other.shape
    if tuple(g.shape) != (n, h, w, (2 * d + 1) ** 2):
        raise ValueError(f"gradient {tuple(g.shape)} does not fit features "
                         f"{tuple(other.shape)} at max_displacement {d}")
    if g.device != other.device:
        raise ValueError(f"gradient on {g.device}, features on "
                         f"{other.device}")
    _on_card(other, d)
    out = torch.empty_like(other)
    if _tensor_cores(other.dtype, c):
        _launch_tc("bwd_f2" if for_f2 else "bwd_f1", None, other, g, out, d)
    else:
        entry = f"mcn_correlation_bwd_{_SUFFIX[other.dtype]}"
        code = getattr(_build.library(), entry)(
            g.data_ptr(), other.data_ptr(), out.data_ptr(), n, h, w, c, d,
            int(for_f2), torch.cuda.current_stream(other.device).cuda_stream)
        _build.check(entry, code)
    counter.launches += 1
    return out


def correlation_bwd_f1(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                       max_displacement: int = 4) -> torch.Tensor:
    """d_f1 from the volume's gradient g (float32) and f2, in f1's dtype."""
    d = int(max_displacement)
    _check(f1, f2, d)
    if f2.device.type == "cpu":
        return correlation_bwd_reference(g, f1, f2, d)[0]
    return _bwd(g, f2, d, False, correlation_bwd_f1)


correlation_bwd_f1.launches = 0


def correlation_bwd_f2(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                       max_displacement: int = 4) -> torch.Tensor:
    """d_f2 from the volume's gradient g (float32) and f1, in f2's dtype."""
    d = int(max_displacement)
    _check(f1, f2, d)
    if f1.device.type == "cpu":
        return correlation_bwd_reference(g, f1, f2, d)[1]
    return _bwd(g, f1, d, True, correlation_bwd_f2)


correlation_bwd_f2.launches = 0


class _Correlation(torch.autograd.Function):
    """The forward kernel with the two backward kernels; saves f1 and f2."""

    @staticmethod
    def forward(ctx, f1, f2, d):
        ctx.save_for_backward(f1, f2)
        ctx.d = d
        return correlation_fwd(f1, f2, d)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        d1 = correlation_bwd_f1(g, f1, f2, ctx.d) \
            if ctx.needs_input_grad[0] else None
        d2 = correlation_bwd_f2(g, f1, f2, ctx.d) \
            if ctx.needs_input_grad[1] else None
        return d1, d2, None


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """The differentiable volume: the plain version under autograd for CPU
    tensors, the three kernels for CUDA tensors; without autograd (no grad
    mode, or no input that requires grad) the forward op alone."""
    d = int(max_displacement)
    _check(f1, f2, d)
    if not (torch.is_grad_enabled()
            and (f1.requires_grad or f2.requires_grad)):
        return correlation_fwd(f1, f2, d)
    if f1.device.type == "cpu":
        return correlation_reference(f1, f2, d)
    return _Correlation.apply(f1, f2, d)
