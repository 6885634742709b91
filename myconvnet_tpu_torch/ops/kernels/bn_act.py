"""Fused inference BN / scale-shift + activation: y = act(x * a + b).

Port of ``myconvnet_tpu/ops/pallas/bn_act.py`` (``fused_scale_shift_act``
at ``:48`` and ``bn_inference_fused`` at ``:84``).  The CUDA kernel is
``csrc/bn_act.cu``: one read of x and one write of y, bound by HBM bytes.
In ResNet-50's eval forward it is the bias + ReLU epilogue of the seven
convs that stay in cuDNN and are followed by a ReLU (the stem conv; conv_a
and the stride-2 conv_b of the first block of stages 2-4), or the BN + ReLU
there when BN is not folded; most of those sites move a few microseconds
of bytes, so a launch's fixed cost is most of their time.  :func:`plan`
sizes the grid to at most one wave, with threads a block and blocks chosen
so that the grid's stride in vectors is a multiple of C / VEC: each thread
then keeps one group of VEC channels, loads its scale and shift once, and
does no index arithmetic in its loop (four 16-byte loads in flight a
thread).  A card test holds the planner's assumptions against
:func:`kernel_facts`.

The kernel is the custom op ``mcn::bn_act`` (``_ops``): its CUDA
implementation is :func:`launch_cuda`, its CPU implementation
:func:`scale_shift_act_reference`.  On a CPU tensor the wrapper runs the
plain version through the op; on a CUDA tensor it launches the kernel
directly (through the op only while ``torch.export`` traces) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from myconvnet_tpu_torch.ops.batch_norm import bn_scale_shift
from myconvnet_tpu_torch.ops.kernels import _build, _ops

ACTS = {"none": 0, "relu": 1, "relu6": 2, "leaky_relu": 3}
_ENTRY = {torch.float32: "mcn_scale_shift_act_f32",
          torch.bfloat16: "mcn_scale_shift_act_bf16"}
PATHS = {"scalar": 0, "vector": 1, "group": 2}

# What the planner assumes of the card (an H100 SXM) and of the kernel;
# the card test holds them against kernel_facts()
SMS = 132
THREADS = 256        # threads a block, about
MAX_THREADS = 1024   # the most a block may have
THREADS_SM = 1024    # threads of the wave on an SM: its loads in flight
                     # (4 x 16 bytes a thread), not more threads, keep HBM
                     # busy, and the kernel holds at least this many


def plan(rows: int, c: int, dtype: torch.dtype, aligned: bool = True
         ) -> dict:
    """The launch of [rows, c] ``dtype`` (float32 or bfloat16); ``aligned``:
    x's base is 16-byte aligned.  ``path``: "group" (a fixed channel group
    of ``vec`` channels a thread, the rule), "vector" (a channel index a
    16-byte vector: C / vec is above the most threads a block may have,
    so no grid's stride is a multiple of it) or "scalar" (C not a multiple
    of vec, or a misaligned base); ``threads`` a block and ``blocks``, at
    most one wave and no more than the work."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    total = rows * c
    if c % vec or not aligned:
        path, threads, work, group = "scalar", THREADS, total, None
    else:
        group, work = c // vec, total // vec
        if group <= MAX_THREADS:
            path, threads = "group", group * max(1, THREADS // group)
        else:
            path, threads, group = "vector", THREADS, None
    blocks = max(1, min(SMS * max(1, THREADS_SM // threads),
                        -(-work // threads)))
    return dict(path=path, threads=threads, blocks=blocks, vec=vec,
                group=group)


@functools.lru_cache(maxsize=256)
def _launch_plan(rows, c, dtype, aligned) -> tuple[int, int, int]:
    """(path code, threads, blocks) of :func:`plan`, cached: the wrapper
    asks for it at every launch."""
    p = plan(rows, c, dtype, aligned)
    return PATHS[p["path"]], p["threads"], p["blocks"]


def kernel_facts() -> dict:
    """SMs of the card, blocks of 256 threads an SM holds of the channel
    group kernel (f32 and bf16), and the loads in flight a thread.  Needs
    the card (the library is built there)."""
    out = (ctypes.c_int * 4)()
    _build.check("mcn_scale_shift_act_facts",
                 _build.library().mcn_scale_shift_act_facts(
                     ctypes.cast(out, ctypes.c_void_p)))
    return dict(sms=out[0], blocks_per_sm_f32=out[1],
                blocks_per_sm_bf16=out[2], unroll=out[3])


def scale_shift_act_reference(x: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor, act: str = "relu"
                              ) -> torch.Tensor:
    """Plain PyTorch version: float32 math, cast back to x's dtype."""
    y = x.float() * a.float() + b.float()
    if act == "relu":
        y = torch.relu(y)
    elif act == "relu6":
        y = torch.clamp(y, 0.0, 6.0)
    elif act == "leaky_relu":
        y = torch.where(y >= 0.0, y, 0.2 * y)
    elif act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return y.to(x.dtype)


def _check(x, a, b, act):
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    c = x.shape[-1]
    if a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)} do not "
                         f"match {c} channels")


def launch_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                act: str = "relu") -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (the op's CUDA
    implementation); counts it in ``fused_scale_shift_act.launches``."""
    _check(x, a, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"no bn_act kernel for device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"bn_act kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bn_act kernel needs a contiguous [..., C] tensor")
    c = x.shape[-1]
    a = a.to(device=x.device, dtype=torch.float32).contiguous()
    b = b.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    entry = _ENTRY[x.dtype]
    rows = x.numel() // c if c else 0
    path, threads, blocks = _launch_plan(rows, c, x.dtype,
                                         x.data_ptr() % 16 == 0)
    code = getattr(_build.library(), entry)(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), rows, c,
        ACTS[act], path, threads, blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(entry, code)
    fused_scale_shift_act.launches += 1
    return y


@torch.library.custom_op("mcn::bn_act", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        act: str) -> torch.Tensor:
    return scale_shift_act_reference(x, a, b, act)


@_op.register_kernel("cuda")
def _op_cuda(x, a, b, act):
    return launch_cuda(x, a, b, act)


@_op.register_fake
def _op_fake(x, a, b, act):
    return torch.empty_like(x)


_OP = torch.ops.mcn.bn_act.default


def fused_scale_shift_act(x: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, act: str = "relu"
                          ) -> torch.Tensor:
    """y = act(x * a + b) over the last axis.  x: [..., C] float32 or
    bfloat16; a, b: [C] (used as float32)."""
    _check(x, a, b, act)
    if _ops.direct(x):
        return launch_cuda(x, a, b, act)
    if x.device.type == "cpu" and _ops.autograd_on_cpu(x, a, b):
        return scale_shift_act_reference(x, a, b, act)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bn_act kernel for device {x.device}")
    return _OP(x, a, b, act)


fused_scale_shift_act.launches = 0


def bn_inference_fused(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, mean: torch.Tensor,
                       var: torch.Tensor, eps: float = 1e-3,
                       act: str = "none") -> torch.Tensor:
    """Inference BN + activation as one pass of the kernel above."""
    a, b = bn_scale_shift(gamma, beta, mean, var, eps)
    return fused_scale_shift_act(x, a, b, act)
