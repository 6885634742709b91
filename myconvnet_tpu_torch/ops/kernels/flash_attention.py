"""Exact attention in flash form: forward, dQ and dK/dV kernels.

Port of ``myconvnet_tpu/ops/pallas/flash_attention.py`` (``flash_attention``
at ``:193``; the forward kernel's ``pallas_call`` in ``_fwd`` at ``:108``,
the dQ and dK/dV kernels' in ``_bwd`` at ``:153`` and ``:161``, the
``custom_vjp`` at ``:173-190``).  The CUDA kernels are
``csrc/flash_attention.cu`` (design and bound in its header).  All three
run wgmma products (bf16 in, float32 accumulate) fed by TMA from tensor
maps over the strided operands: a producer warp streams 64-row tiles of
one side through a ring of stages for one or two consumer warpgroups,
each owning a 64-row tile of the other side, and the results leave by a
TMA store.  The forward keeps an online softmax over 64-key tiles; the
backward has no atomics (dQ loops over key tiles, dK/dV over query
tiles), so two runs give the same bits.

:func:`flash_attention` is differentiable through :class:`FlashAttention`
(the ``custom_vjp``): the forward saves the float32 logsumexp, the backward
recomputes P and uses D = rowsum(dO * O), which the dQ kernel computes and
hands to the dK/dV kernel.  On a CPU tensor each of the three wrappers runs
its plain PyTorch version (the Pallas kernels' math in float32, cast to the
inputs' dtype); on a CUDA tensor it launches its kernel or raises.  The
kernels take bf16 q, k and v of one shape [B, H, L, D] with D a multiple of
16 up to 128; they read them through their strides (the head dim
contiguous), so views of a packed qkv projection cost no copy.  The
forward's output is a [B, H, L, D] view of a [B, L, H, D] buffer, the
layout the output projection reads.

The forward kernel is the custom op ``mcn::flash_attention_fwd``
(``_ops``): its CUDA implementation is :func:`launch_fwd_cuda`, its CPU
implementation :func:`flash_fwd_reference` copied into the kernel's output
layouts (``o`` that view, ``lse`` rows of a [B, H, Lpad] buffer), which its
fake implementation gives too.  :func:`flash_attention_fwd` calls it on
CPU tensors and while ``torch.export`` traces, and launches directly on
CUDA tensors otherwise (``_ops.direct``).  Without autograd,
:func:`flash_attention` calls :func:`flash_attention_fwd` alone;
:class:`FlashAttention`'s forward calls it too.  The backward kernels stay
direct launches.
"""

from __future__ import annotations

import ctypes

import torch

from myconvnet_tpu_torch.ops.kernels import _build, _ops

TILE = 64  # rows of a kernel tile; lse and D are padded to a multiple
# operand order of the strides array the C entry points read
_VIEWS = ("q", "k", "v", "o", "do", "dq", "dk", "dv")


def _check(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"expected [B, H, L, D], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shape mismatch: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} (cross-length "
                         "attention unsupported)")


def _scale(q, scale):
    return float(q.shape[-1]) ** -0.5 if scale is None else float(scale)


# ------------------------------------------------------------ plain versions


def _scores(q, k, scale):
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale


def flash_fwd_reference(q, k, v, scale=None):
    """(out in q's dtype, lse float32 [B, H, L]), as ``_fwd_kernel``."""
    _check(q, k, v)
    s = _scores(q, k, _scale(q, scale))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_reference(q, k, v, scale=None):
    """Plain attention: einsum in float32, softmax, einsum, cast."""
    return flash_fwd_reference(q, k, v, scale)[0]


def flash_dq_reference(q, k, v, o, do, lse, scale=None):
    """(dq in q's dtype, D = rowsum(dO * O) float32 [B, H, L]), as
    ``_dq_kernel`` with D computed beside it."""
    _check(q, k, v)
    scale = _scale(q, scale)
    dl = (do.float() * o.float()).sum(-1)
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - dl[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype), dl


def flash_dkv_reference(q, k, v, do, lse, dl, scale=None):
    """(dk, dv) in k's and v's dtypes, as ``_dkv_kernel``."""
    _check(q, k, v)
    scale = _scale(q, scale)
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - dl[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels


def _cuda_checks(name, tensors):
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {q.device}")
    for t in tensors:
        if t.device != q.device or t.shape != q.shape:
            raise ValueError(f"{name} kernel takes tensors of q's shape "
                             f"{tuple(q.shape)} on {q.device}, not "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bf16 q, k, v (and dO), "
                            f"not {t.dtype}; float32 goes to the reference "
                            "path")
    d = q.shape[-1]
    if d % 16 or not 0 < d <= 128:
        raise ValueError(f"{name} kernel takes a head dim that is a "
                         f"multiple of 16 up to 128, not {d}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{name} kernel takes B * H <= 65535")


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can read it in place (head dim contiguous,
    16-byte rows), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _bhld_buffer(like: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """A [B, H, L, D] view of a new [B, L, H, D] buffer."""
    b, h, l, d = like.shape
    return like.new_empty((b, l, h, d), dtype=dtype).permute(0, 2, 1, 3)


def _rows(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A float32 [B, H, L] tensor as the kernels read it: rows of a
    [B * H, Lpad] buffer.  The wrappers' own outputs already are; others
    (the plain versions') are copied in, zero-padded."""
    b, h, l, _ = like.shape
    if tuple(t.shape) != (b, h, l) or t.device != like.device:
        raise ValueError(f"lse and D must be [B, H, L] = {(b, h, l)} on "
                         f"{like.device}, not {tuple(t.shape)} on {t.device}")
    lpad = -(-l // TILE) * TILE
    if (t.dtype == torch.float32 and t.stride() == (h * lpad, lpad, 1)
            and t.storage_offset() == 0):
        return t
    buf = torch.zeros((b, h, lpad), dtype=torch.float32, device=t.device)
    buf[..., :l] = t
    return buf[..., :l]


def _new_rows(like: torch.Tensor) -> torch.Tensor:
    b, h, l, _ = like.shape
    lpad = -(-l // TILE) * TILE
    return like.new_empty((b, h, lpad), dtype=torch.float32)[..., :l]


def _strides(**views) -> ctypes.Array:
    arr = (ctypes.c_longlong * (3 * len(_VIEWS)))()
    for i, name in enumerate(_VIEWS):
        t = views.get(name)
        if t is not None:
            arr[3 * i:3 * i + 3] = list(t.stride()[:3])
    return arr


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_fwd_cuda(q, k, v, scale=None):
    """One launch of the forward kernel on CUDA tensors (the op's CUDA
    implementation); counts it in ``flash_attention_fwd.launches``."""
    _check(q, k, v)
    _cuda_checks("flash_attention forward", (q, k, v))
    q, k, v = map(_operand, (q, k, v))
    b, h, l, d = q.shape
    out, lse = _bhld_buffer(q), _new_rows(q)
    code = _build.library().mcn_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _strides(q=q, k=k, v=v, o=out), b, h, l, d,
        _scale(q, scale), _stream(q))
    _build.check("mcn_flash_fwd", code)
    flash_attention_fwd.launches += 1
    return out, lse


@torch.library.custom_op("mcn::flash_attention_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    o, lse = flash_fwd_reference(q, k, v, scale)
    out, rows = _bhld_buffer(q, q.dtype), _new_rows(q)
    out.copy_(o)
    rows.copy_(lse)
    return out, rows


@_fwd_op.register_kernel("cuda")
def _fwd_op_cuda(q, k, v, scale):
    return launch_fwd_cuda(q, k, v, scale)


@_fwd_op.register_fake
def _fwd_op_fake(q, k, v, scale):
    return _bhld_buffer(q, q.dtype), _new_rows(q)


_FWD_OP = torch.ops.mcn.flash_attention_fwd.default


def flash_attention_fwd(q, k, v, scale=None):
    """(out [B, H, L, D] in q's dtype, lse float32 [B, H, L]): the forward
    kernel on CUDA tensors, :func:`flash_fwd_reference` on CPU ones."""
    _check(q, k, v)
    if _ops.direct(q):
        return launch_fwd_cuda(q, k, v, scale)
    if q.device.type == "cpu" and _ops.autograd_on_cpu(q, k, v):
        return flash_fwd_reference(q, k, v, scale)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash_attention forward kernel for device "
                         f"{q.device}")
    return _FWD_OP(q, k, v, _scale(q, scale))


def flash_attention_dq(q, k, v, o, do, lse, scale=None):
    """(dq in q's dtype, D = rowsum(dO * O) float32 [B, H, L]): the dQ
    kernel on CUDA tensors, :func:`flash_dq_reference` on CPU ones."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, o, do, lse, scale)
    _cuda_checks("flash_attention dQ", (q, k, v, o, do))
    q, k, v, o, do = map(_operand, (q, k, v, o, do))
    lse = _rows(lse, q)
    b, h, l, d = q.shape
    dq, dl = _bhld_buffer(q), _new_rows(q)
    code = _build.library().mcn_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dl.data_ptr(), dq.data_ptr(),
        _strides(q=q, k=k, v=v, o=o, do=do, dq=dq), b, h, l, d,
        _scale(q, scale), _stream(q))
    _build.check("mcn_flash_bwd_dq", code)
    flash_attention_dq.launches += 1
    return dq, dl


def flash_attention_dkv(q, k, v, do, lse, dl, scale=None):
    """(dk, dv): the dK/dV kernel on CUDA tensors,
    :func:`flash_dkv_reference` on CPU ones."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, dl, scale)
    _cuda_checks("flash_attention dK/dV", (q, k, v, do))
    q, k, v, do = map(_operand, (q, k, v, do))
    lse, dl = _rows(lse, q), _rows(dl, q)
    b, h, l, d = q.shape
    dk, dv = _bhld_buffer(k), _bhld_buffer(v)
    code = _build.library().mcn_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dl.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q=q, k=k, v=v, do=do, dk=dk, dv=dv), b, h, l, d,
        _scale(q, scale), _stream(q))
    _build.check("mcn_flash_bwd_dkv", code)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """The ``custom_vjp``: the forward kernel saves (q, k, v, out, lse);
    the backward runs the dQ kernel (which also gives D) and then the
    dK/dV kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dl = flash_attention_dq(q, k, v, out, do, lse, ctx.scale)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, dl, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """Exact fused attention.  q, k, v: [B, H, L, D] -> [B, H, L, D] in
    q's dtype; ``scale`` defaults to 1/sqrt(D).  Differentiable; without
    autograd (no grad mode, or no input that requires grad) the forward
    op alone, which an exported program keeps as one node."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, _scale(q, scale))
    return flash_attention_fwd(q, k, v, scale)[0]
