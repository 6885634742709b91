"""The bottleneck pair conv1x1 -> BN -> ReLU -> conv3x3 -> BN -> ReLU.

Port of ``myconvnet_tpu/ops/pallas/conv_pair.py``
(``conv1x1_conv3x3_bn_relu`` at ``:101``).  The CUDA kernel is
``csrc/conv_pair.cu`` (design and bound in its head comment): one
thread-block cluster per image and TH x TW output tile; each block of the
cluster computes a slice of the 1x1 result for the tile plus a one-pixel
halo into shared memory as bf16, the blocks swap slices through
distributed shared memory, and each runs the 3x3 for its slice of the
output channels as nine shifted GEMMs.  Both GEMMs are wgmma (bf16 in,
float32 accumulate) fed by TMA through a ring of stages: the x halo tile
through a tensor map whose zero fill gives the SAME padding, and w1 and
w3 tiles through maps the library encodes once per weight.  The
[N, H, W, Cm] intermediate never goes to device memory; the unfused pair
writes and re-reads it.

BN is the inference form: per-channel float32 scale and bias (a folded BN
has scale 1 and the conv's bias).  The 3x3 uses SAME (zero) padding of
the intermediate after BN1 + ReLU, and the intermediate is rounded to
bf16, as in the Pallas kernel (``conv_pair.py:73-74, :85-93, :149``).

The kernel is the custom op ``mcn::conv_pair`` (``_ops``): its CUDA
implementation is :func:`launch_cuda` at the planner's geometry, its CPU
implementation :func:`conv_pair_reference`.  On a CPU tensor the wrapper
runs the plain version through the op; on a CUDA tensor it launches the
kernel directly (through the op only while ``torch.export`` traces, and
never with a ``tile`` override, the plan sweep's) or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from myconvnet_tpu_torch.ops.kernels import _build, _ops

MAX_CM = 512  # keeps the intermediate's tile within shared memory


def supports(cin: int, cm: int, cout: int) -> bool:
    """Channel counts the kernel takes: Cin streamed 64 at a time, Cm a
    multiple of 32 (padded to 64 in shared memory), Cout a multiple of 16
    (16-byte stores of a cluster rank's slice), Cm <= 512 so a tile of the
    intermediate fits in shared memory (227 KB)."""
    return (cin > 0 and cin % 64 == 0 and 0 < cm <= MAX_CM and cm % 32 == 0
            and cout > 0 and cout % 16 == 0)


def plan(n: int, h: int, w: int, cin: int, cm: int, cout: int,
         tile: tuple[int, int, int] | None = None) -> dict:
    """The kernel's launch plan on the current card: output tile TH x TW,
    CS blocks per tile (a thread-block cluster), shared memory per block,
    the stages of its TMA ring, the 64x64 accumulator tiles a pass of each
    phase covers, and how many clusters of CS blocks the card runs at once
    (a grid of more runs in waves).  The planner lives in csrc/conv_pair.cu,
    next to the layout it sizes.  ``tile`` = (TH, TW, CS) gives the same
    for that geometry instead of the planner's; raises if the kernel
    cannot run it."""
    th, tw, cs = tile or (0, 0, 0)
    out = (ctypes.c_int * 8)()
    _build.check("mcn_conv_pair_plan", _build.library().mcn_conv_pair_plan(
        n, h, w, cin, cm, cout, th, tw, cs,
        ctypes.cast(out, ctypes.c_void_p)))
    return dict(th=out[0], tw=out[1], cs=out[2], smem=out[3],
                stages=out[4], pass1_tiles=out[5], pass2_tiles=out[6],
                clusters_at_once=out[7])


def _check_shapes(x, w1, scale1, bias1, w3, scale3, bias3):
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, Cin], got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w1.dim() != 4 or tuple(w1.shape[:3]) != (1, 1, cin):
        raise ValueError(f"w1 {tuple(w1.shape)} is not [1, 1, {cin}, Cm]")
    cm = w1.shape[-1]
    if w3.dim() != 4 or tuple(w3.shape[:3]) != (3, 3, cm):
        raise ValueError(f"w3 {tuple(w3.shape)} is not [3, 3, {cm}, Cout]")
    cout = w3.shape[-1]
    for name, v, c in (("scale1", scale1, cm), ("bias1", bias1, cm),
                       ("scale3", scale3, cout), ("bias3", bias3, cout)):
        if tuple(v.shape) != (c,):
            raise ValueError(f"{name} {tuple(v.shape)} is not [{c}]")
    return cin, cm, cout


def conv_pair_reference(x, w1, scale1, bias1, w3, scale3, bias3):
    """Plain PyTorch version with the kernel's rounding points: bf16
    inputs, float32 accumulation and epilogues, a bf16 intermediate and a
    bf16 output.  Float32 convolutions of bf16 values are exact products
    summed in float32 (with TF32 off on the card)."""
    _check_shapes(x, w1, scale1, bias1, w3, scale3, bias3)

    def conv(v, w, pad):
        return F.conv2d(v.float(), w.to(torch.bfloat16).float()
                        .permute(3, 2, 0, 1), padding=pad)

    def epilogue(v, s, b):
        return torch.relu(v * s.float()[:, None, None]
                          + b.float()[:, None, None]).to(torch.bfloat16)

    xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    mid = epilogue(conv(xc, w1, 0), scale1, bias1)
    out = epilogue(conv(mid, w3, 1), scale3, bias3)
    return out.permute(0, 2, 3, 1).contiguous()


def launch_cuda(x: torch.Tensor, w1: torch.Tensor, scale1: torch.Tensor,
                bias1: torch.Tensor, w3: torch.Tensor, scale3: torch.Tensor,
                bias3: torch.Tensor,
                tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (the op's CUDA
    implementation, and the ``tile`` override's path); counts it in
    ``conv1x1_conv3x3_bn_relu.launches``."""
    cin, cm, cout = _check_shapes(x, w1, scale1, bias1, w3, scale3, bias3)
    if x.device.type != "cuda":
        raise ValueError(f"no conv_pair kernel for device {x.device}")
    for name, t in (("x", x), ("w1", w1), ("w3", w3)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv_pair kernel takes bf16 {name}, "
                            f"not {t.dtype}")
    if not supports(cin, cm, cout):
        raise ValueError(f"conv_pair kernel does not take channels "
                         f"{cin}->{cm}->{cout}")
    if not x.is_contiguous():
        raise ValueError("conv_pair kernel needs a contiguous NHWC x")
    n, h, w, _ = x.shape
    dev = x.device
    w1k = w1.permute(3, 0, 1, 2).contiguous()
    w3k = w3.permute(3, 0, 1, 2).contiguous()
    vecs = [v.to(device=dev, dtype=torch.float32).contiguous()
            for v in (scale1, bias1, scale3, bias3)]
    y = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=dev)
    ptrs = [x.data_ptr(), w1k.data_ptr(), vecs[0].data_ptr(),
            vecs[1].data_ptr(), w3k.data_ptr(), vecs[2].data_ptr(),
            vecs[3].data_ptr(), y.data_ptr()]
    if any(p % 32 for p in ptrs):
        raise ValueError("conv_pair kernel needs 32-byte aligned tensors")
    code = _build.library().mcn_conv_pair(
        *ptrs, n, h, w, cin, cm, cout, *(tile or (0, 0, 0)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("mcn_conv_pair", code)
    conv1x1_conv3x3_bn_relu.launches += 1
    return y


@torch.library.custom_op("mcn::conv_pair", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, w1: torch.Tensor, scale1: torch.Tensor,
        bias1: torch.Tensor, w3: torch.Tensor, scale3: torch.Tensor,
        bias3: torch.Tensor) -> torch.Tensor:
    return conv_pair_reference(x, w1, scale1, bias1, w3, scale3, bias3)


@_op.register_kernel("cuda")
def _op_cuda(x, w1, scale1, bias1, w3, scale3, bias3):
    return launch_cuda(x, w1, scale1, bias1, w3, scale3, bias3)


@_op.register_fake
def _op_fake(x, w1, scale1, bias1, w3, scale3, bias3):
    return x.new_empty((*x.shape[:3], w3.shape[-1]), dtype=torch.bfloat16)


_OP = torch.ops.mcn.conv_pair.default


def conv1x1_conv3x3_bn_relu(x: torch.Tensor, w1: torch.Tensor,
                            scale1: torch.Tensor, bias1: torch.Tensor,
                            w3: torch.Tensor, scale3: torch.Tensor,
                            bias3: torch.Tensor,
                            tile: tuple[int, int, int] | None = None
                            ) -> torch.Tensor:
    """y = relu(bn3(conv3x3(relu(bn1(conv1x1(x, w1))), w3))), NHWC bf16.

    x: [N, H, W, Cin] bf16; w1: [1, 1, Cin, Cm] and w3: [3, 3, Cm, Cout]
    (HWIO) bf16; scales and biases: per-channel float32.  The weights are
    handed to the kernel as OIHW channels_last ([Cm, Cin] and
    [Cout, 3, 3, Cm]), which costs no copy for ``nn.Conv`` weights.
    ``tile`` = (TH, TW, CS) launches that geometry instead of the planner's
    (to measure plans against each other); the plain version ignores it.
    Every geometry sums each output in the same order, so an image gives
    the same bits whatever tile, cluster or batch it is launched with.
    """
    args = (x, w1, scale1, bias1, w3, scale3, bias3)
    _check_shapes(*args)
    if x.device.type == "cpu" and _ops.autograd_on_cpu(*args):
        return conv_pair_reference(*args)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv_pair kernel for device {x.device}")
    if _ops.direct(x) or (tile is not None and x.device.type == "cuda"):
        return launch_cuda(*args, tile=tile)
    return _OP(*args)


conv1x1_conv3x3_bn_relu.launches = 0
