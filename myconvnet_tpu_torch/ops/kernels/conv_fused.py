"""3x3 stride-1 SAME conv -> BN apply -> ReLU as one implicit-GEMM kernel.

Port of ``myconvnet_tpu/ops/pallas/conv_fused.py`` (``conv3x3_bn_relu`` at
``:82``).  The CUDA kernel is ``csrc/conv_fused.cu`` (design and bound in
its head comment): each block owns 64 output pixels (a box of G images x
TH x TW) x 64 output channels and streams K = taps x C through a ring of
shared-memory stages, one tap x 64 input channels each, brought by TMA
(whose zero fill is the SAME padding) and multiplied by wgmma with float32
accumulators; the ``relu(acc * scale + bias)`` epilogue runs on the
float32 sum before the single bf16 store.  Taps that read only padding
(the off-centre rows at H = 1, columns at W = 1) are skipped.  At the
small maps a thread-block cluster of ``split`` blocks shares one output
tile, each taking an equal run of its stages, and the ranks add their
partial sums through distributed shared memory.

:func:`plan` (below) picks the tile and the split; the CPU tests hold it.

In ResNet-18/34's eval forward it is conv_a -> bn_a -> ReLU of every
stride-1 basic block, with the BN's (scale, shift) or a folded bias as the
epilogue.  The Pallas function's ``images_per_block`` (a TPU tiling knob)
is dropped: the CUDA kernel tiles by pixels over the whole batch.

The kernel is the custom op ``mcn::conv_fused`` (``_ops``): its CUDA
implementation is :func:`launch_cuda`, its CPU implementation
:func:`conv3x3_bn_relu_reference`.  On a CPU tensor the wrapper runs the
plain version through the op; on a CUDA tensor it launches the kernel
directly (through the op only while ``torch.export`` traces) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from myconvnet_tpu_torch.ops.kernels import _build, _ops


# What the planner assumes of the card (an H100 SXM) and of the kernel;
# the card tests hold these against kernel_facts()
SMS = 132                 # streaming multiprocessors
SMEM_PER_SM = 233_472     # shared memory an SM gives its blocks (228 KB)
SMEM_RESERVED = 1_024     # the runtime's share of it for each block
STAGES = 4                # the kernel's ring (kStages in conv_fused.cu)
BLOCK_SMEM = 1_024 + STAGES * 2 * 64 * 128 + 2 * STAGES * 8  # its kSmem
BLOCKS_PER_SM = SMEM_PER_SM // (BLOCK_SMEM + SMEM_RESERVED)   # 3
ONE_WAVE = SMS * BLOCKS_PER_SM  # blocks the card runs at once (396)
WANT = SMS * 7 // 8       # blocks the planner asks for before it splits K
SPLITS = (1, 2, 4, 8)     # cluster sizes (8 is the portable maximum)
TILE_PIXELS = 64          # output pixels of a block (a wgmma's 64 rows)
KC = 64                   # input channels of a stage


def supports(c: int) -> bool:
    """Input channel counts the kernel takes: rows of 16-byte vectors."""
    return c > 0 and c % 8 == 0


def stages(h: int, w: int, c: int) -> int:
    """The (tap, 64-channel chunk) stages of K: taps that read only
    padding for every pixel are skipped (3 taps along an axis longer than
    1, else the centre one)."""
    return (3 if h > 1 else 1) * (3 if w > 1 else 1) * -(-c // KC)


def tile(n: int, h: int, w: int) -> tuple[int, int, int]:
    """(G, TH, TW): the block's box of output pixels, G * TH * TW <= 64.
    Whole images where a map has 64 pixels or fewer (as many as fit, at
    most N), else the TH x TW window of one image that needs the fewest
    tiles, the wider of equals."""
    if h * w <= TILE_PIXELS:
        return max(1, min(TILE_PIXELS // (h * w), n)), h, w
    best = None
    for tw in range(1, min(w, TILE_PIXELS) + 1):
        th = min(h, TILE_PIXELS // tw)
        key = (-(-h // th) * -(-w // tw), -tw)
        if best is None or key < best[0]:
            best = (key, th, tw)
    return 1, best[1], best[2]


def plan(n: int, h: int, w: int, c: int, cout: int,
         split: int | None = None) -> dict:
    """The kernel's launch plan: the output tile (G, TH, TW), the output
    tiles of the grid, the stages of K, the split (cluster size) and the
    blocks.  The split is the smallest of 1, 2, 4 and 8 that divides the
    stage count and gives the grid WANT blocks (7/8 of the SMs), within
    one wave (ONE_WAVE blocks); where none does, the largest such one.
    ``split`` forces a split instead (a divisor of the stage count among
    SPLITS; ValueError otherwise)."""
    g, th, tw = tile(n, h, w)
    tiles = (-(-n // g) * -(-h // th) * -(-w // tw) * -(-cout // 64))
    k = stages(h, w, c)
    fits = [s for s in SPLITS if k % s == 0
            and (s == 1 or tiles * s <= ONE_WAVE)]
    if split is None:
        split = next((s for s in fits if tiles * s >= WANT), fits[-1])
    elif split not in SPLITS or k % split:
        raise ValueError(f"split {split} is not one of {SPLITS} dividing "
                         f"the {k} stages of K at {(n, h, w, c, cout)}")
    return dict(g=g, th=th, tw=tw, tiles=tiles, stages=k, split=split,
                blocks=tiles * split)


@functools.lru_cache(maxsize=1024)
def _launch_plan(n: int, h: int, w: int, c: int, cout: int,
                 split: int | None) -> tuple[int, int, int, int]:
    """(G, TH, TW, split) of :func:`plan`, cached: the wrapper asks for
    it at every launch."""
    p = plan(n, h, w, c, cout, split)
    return p["g"], p["th"], p["tw"], p["split"]


def kernel_facts() -> dict:
    """What the built kernel and the current card give for the planner's
    assumptions (``BLOCK_SMEM``, ``STAGES``, ``BLOCKS_PER_SM``, ``SMS``),
    and the clusters of each split the card holds at once.  Needs the
    card."""
    out = (ctypes.c_int * 7)()
    _build.check("mcn_conv3x3_bn_relu_facts",
                 _build.library().mcn_conv3x3_bn_relu_facts(
                     ctypes.cast(out, ctypes.c_void_p)))
    return dict(smem=out[0], stages=out[1], blocks_per_sm=out[2],
                sms=out[3], clusters_at_once={2: out[4], 4: out[5],
                                              8: out[6]})


def _check_shapes(x, w3, scale, bias):
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if w3.dim() != 4 or tuple(w3.shape[:3]) != (3, 3, c):
        raise ValueError(f"w3 {tuple(w3.shape)} is not [3, 3, {c}, Cout]")
    cout = w3.shape[-1]
    for name, v in (("scale", scale), ("bias", bias)):
        if tuple(v.shape) != (cout,):
            raise ValueError(f"{name} {tuple(v.shape)} is not [{cout}]")
    return c, cout


def conv3x3_bn_relu_reference(x, w3, scale, bias):
    """Plain PyTorch version with the kernel's rounding points: bf16
    inputs, a float32 sum (float32 convolutions of bf16 values are exact
    products summed in float32, with TF32 off on the card), the epilogue
    in float32 and one bf16 rounding."""
    _check_shapes(x, w3, scale, bias)
    y = F.conv2d(x.to(torch.bfloat16).float().permute(0, 3, 1, 2),
                 w3.to(torch.bfloat16).float().permute(3, 2, 0, 1),
                 padding=1)
    y = torch.relu(y * scale.float()[:, None, None]
                   + bias.float()[:, None, None])
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def launch_cuda(x: torch.Tensor, w3: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, split: int | None = None
                ) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (the op's CUDA
    implementation); counts it in ``conv3x3_bn_relu.launches``."""
    c, cout = _check_shapes(x, w3, scale, bias)
    n, h, w, _ = x.shape
    g, th, tw, split = _launch_plan(n, h, w, c, cout, split)
    if x.device.type != "cuda":
        raise ValueError(f"no conv_fused kernel for device {x.device}")
    for name, t in (("x", x), ("w3", w3)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv_fused kernel takes bf16 {name}, not "
                            f"{t.dtype}")
    if not supports(c):
        raise ValueError(f"conv_fused kernel takes C % 8 == 0, not C = {c}")
    if not x.is_contiguous():
        raise ValueError("conv_fused kernel needs a contiguous NHWC x")
    dev = x.device
    wk = w3.permute(3, 0, 1, 2).contiguous()
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=dev)
    if x.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("conv_fused kernel needs 16-byte aligned x and w3")
    code = _build.library().mcn_conv3x3_bn_relu(
        x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), n, h, w, c, cout, g, th, tw, split,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("mcn_conv3x3_bn_relu", code)
    conv3x3_bn_relu.launches += 1
    return y


@torch.library.custom_op("mcn::conv_fused", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, w3: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor, split: int | None) -> torch.Tensor:
    return conv3x3_bn_relu_reference(x, w3, scale, bias)


@_op.register_kernel("cuda")
def _op_cuda(x, w3, scale, bias, split):
    return launch_cuda(x, w3, scale, bias, split)


@_op.register_fake
def _op_fake(x, w3, scale, bias, split):
    return x.new_empty((*x.shape[:3], w3.shape[-1]), dtype=torch.bfloat16)


_OP = torch.ops.mcn.conv_fused.default


def conv3x3_bn_relu(x: torch.Tensor, w3: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *,
                    split: int | None = None) -> torch.Tensor:
    """y = relu(conv3x3_same(x, w3) * scale + bias), NHWC bf16.

    x: [N, H, W, C] bf16; w3: [3, 3, C, Cout] (HWIO) bf16; scale, bias:
    [Cout] float32.  The weight goes to the kernel as OIHW channels_last
    ([Cout, 3, 3, C]), which costs no copy for an ``nn.Conv`` weight.
    ``split`` forces the planner's split of K (see :func:`plan`).
    """
    c, cout = _check_shapes(x, w3, scale, bias)
    n, h, w, _ = x.shape
    _launch_plan(n, h, w, c, cout, split)   # a bad split raises here
    if _ops.direct(x):
        return launch_cuda(x, w3, scale, bias, split)
    if x.device.type == "cpu" and _ops.autograd_on_cpu(x, w3, scale, bias):
        return conv3x3_bn_relu_reference(x, w3, scale, bias)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv_fused kernel for device {x.device}")
    return _OP(x, w3, scale, bias, split)


conv3x3_bn_relu.launches = 0
