"""One RandAugment layer of elementwise ops, one op chosen per image.

Port of ``myconvnet_tpu/ops/pallas/randaugment_ew.py``: ``PALLAS_POOL``
(``:35-36``), ``_image_stats`` (``:95-105``) and ``apply_layer`` (``:109``,
the Pallas kernel at ``:119``).  The CUDA kernels are
``csrc/randaugment_ew.cu``.  They read each image's op index and signed
magnitude from device memory (no host sync) and run only that op, where
the XLA where-fold (``data/randaugment.py``) runs every op of the pool on
every image, and they compute the per-image statistics that autocontrast
(per-channel min and max) and contrast (the gray mean) need themselves,
where JAX computes them in an XLA pass before its kernel.  Bound by HBM
bytes: one read and one write of x.

Two paths, which :func:`plan` picks (a card test holds its copies of the
kernel's constants against :func:`kernel_facts`):

* ``"one_pass"``: a thread-block cluster of k blocks an image (k the
  smallest of 1, 2, 4, 8 whose slice of whole pixels fits the shared
  memory that leaves two blocks an SM; 8 at 224 x 224 x 3).  Each block
  brings its slice into shared memory by bulk copies, the blocks of an
  image whose op needs statistics reduce them over the cluster's shared
  memory, and each block writes its slice once.  One kernel a layer.
* ``"two_pass"``: for images too large for a cluster, or whose slices
  cannot be 16-byte aligned: a statistics kernel (its blocks of images
  whose op needs none exit at once) writes partials a block to a scratch
  buffer, and the apply kernel combines them in a fixed order and
  streams the image.

``apply_layer(..., path=...)`` forces either path.  The gray mean is the
mean of the per-pixel lumas (JAX's formula): each luma rounded to float32
as :func:`gray` rounds it, summed in float64, divided by H * W in float64
and rounded once, so the order of the sum does not reach the result and
every op stays bit-exact between the kernels and :func:`image_stats`.

The op formulas are the Pallas branches (``randaugment_ew.py:50-91``);
:func:`apply_layer_reference` writes them as a ``torch.where`` chain with
the same float32 roundings, and the kernels round each product and sum on
their own (no FMA contraction) to match it.

On a CPU tensor :func:`apply_layer` runs :func:`apply_layer_reference`;
on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from myconvnet_tpu_torch.ops.kernels import _build

# op order is the kernel's switch order (csrc/randaugment_ew.cu)
PALLAS_POOL = ("identity", "autocontrast", "invert", "posterize",
               "solarize", "solarize_add", "contrast", "brightness")

_ENTRY = "mcn_randaugment_ew_f32"
PATHS = {"one_pass": 0, "two_pass": 1}

# What the planner assumes of the card (an H100 SXM) and of the kernels;
# the card tests hold the kernel's constants against kernel_facts()
SMEM_SM = 233_472         # shared memory of an SM (228 KB)
SMEM_RESERVED = 1_024     # the system's share of each block
MIN_BLOCKS_SM = 2         # one pass: blocks an SM holds at once, at least
CLUSTERS = (1, 2, 4, 8)   # one pass: blocks a cluster (an image)
THREADS = 256             # every kernel
HEADER_BYTES = 640        # one pass: shared memory before the slice
STATS_PIXELS = 2048       # two passes: pixels a statistics block
RECORD_BYTES = 48         # two passes: a statistics block's partial
MAX_APPLY_BLOCKS = 64     # two passes: apply blocks an image
CHANNELS = (1, 3, 4)      # the channel counts gray() takes


def plan(shape, aligned: bool = True, path: str | None = None) -> dict:
    """The launch plan for float32 ``shape`` = [N, H, W, C]; ``aligned``:
    x's base is 16-byte aligned.  ``"one_pass"`` (the rule where it fits):
    ``k`` blocks a cluster, each owning ``slice`` floats of its image
    (whole pixels, a multiple of 4; the last block the rest), ``smem``
    bytes a block.  ``"two_pass"``: ``stats_blocks`` and ``apply_blocks``
    an image, ``vec`` (float4 loads), ``scratch_bytes`` of partials.
    ``path`` forces a path; a one-pass plan that cannot exist raises."""
    n, h, w, c = shape
    if c not in CHANNELS:
        raise ValueError(f"randaugment_ew takes {CHANNELS} channels, not {c}")
    if path not in (None, *PATHS):
        raise ValueError(f"path is one of {tuple(PATHS)}, not {path!r}")
    per_image = h * w * c
    one = None
    if aligned and per_image % 4 == 0 and per_image > 0:
        unit = math.lcm(4, c)           # floats: whole pixels and float4s
        room = SMEM_SM // MIN_BLOCKS_SM - SMEM_RESERVED - HEADER_BYTES
        for k in CLUSTERS:
            s = -(-per_image // (unit * k)) * unit
            if 4 * s <= room and per_image - (k - 1) * s > 0:
                one = dict(path="one_pass", k=k, slice=s,
                           smem=HEADER_BYTES + 4 * s)
                break
    if path == "one_pass" and one is None:
        raise ValueError(f"no one-pass plan for {tuple(shape)} (aligned="
                         f"{aligned}): an image needs whole-pixel slices "
                         f"of 16 bytes within {len(CLUSTERS)} clusters' "
                         "shared memory")
    if path != "two_pass" and one is not None:
        return one
    vec = aligned and per_image % 4 == 0
    work = per_image // 4 if vec else per_image
    stats_blocks = max(1, -(-(h * w) // STATS_PIXELS))
    return dict(path="two_pass", stats_blocks=stats_blocks,
                apply_blocks=max(1, min(MAX_APPLY_BLOCKS,
                                        -(-work // THREADS))),
                vec=vec, scratch_bytes=n * stats_blocks * RECORD_BYTES)


@functools.lru_cache(maxsize=256)
def _launch_plan(shape, aligned, path) -> tuple[int, int, int, int]:
    """(path code, p0, p1, scratch bytes) of :func:`plan` for the C entry
    point, cached: the wrapper asks for it at every launch."""
    p = plan(shape, aligned, path)
    if p["path"] == "one_pass":
        return PATHS["one_pass"], p["k"], p["slice"], 0
    return (PATHS["two_pass"], p["stats_blocks"], p["apply_blocks"],
            p["scratch_bytes"])


def kernel_facts(c: int, k: int, smem: int) -> dict:
    """The built kernel's constants that the planner copies, and for a
    cluster of ``k`` blocks of ``smem`` bytes at ``c`` channels the
    blocks an SM and the clusters the card hold at once.  Needs the card
    (the library is built there)."""
    out = (ctypes.c_int * 7)()
    _build.check("mcn_randaugment_ew_facts",
                 _build.library().mcn_randaugment_ew_facts(
                     c, k, smem, ctypes.cast(out, ctypes.c_void_p)))
    return dict(threads=out[0], header_bytes=out[1], stats_pixels=out[2],
                record_bytes=out[3], max_apply_blocks=out[4],
                blocks_per_sm=out[5], clusters=out[6])


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b with IEEE division on every device: ATen's CUDA divide
    multiplies by the reciprocal when the divisor is a Python number,
    which can move a result by an ulp (and a floor after it by a whole
    step); a 0-dim tensor on a's device is divided by."""
    return a / a.new_full((), b)


def gray(x: torch.Tensor) -> torch.Tensor:
    """[..., C] -> [...] luma 0.299 R + 0.587 G + 0.114 B, summed in that
    order in float32 (JAX's ``sum(x * coef, -1)``).  One channel is R, G
    and B at once (JAX broadcasts the three weights over it); of four
    (RGBA) the alpha is left out."""
    c = x.shape[-1]
    if c not in CHANNELS:
        raise ValueError(f"gray takes 1, 3 or 4 channels, not {c}")
    xf = x.float()
    r, g, b = (xf[..., 0],) * 3 if c == 1 else (xf[..., 0], xf[..., 1],
                                                  xf[..., 2])
    return r * 0.299 + g * 0.587 + b * 0.114


def image_stats(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, 2 + 2C] float32 rows: [0 (the magnitude's
    place), gray mean, lo_0..lo_{C-1}, hi_0..hi_{C-1}].  The gray mean is
    JAX's mean of the lumas: each luma rounded to float32, summed in
    float64, divided by H * W in float64 (IEEE, :func:`true_div`) and
    rounded once, so no order of the sum moves it (the kernels sum in
    another)."""
    n, h, w, c = x.shape
    xf = x.float()
    lo, hi = torch.aminmax(xf.reshape(n, -1, c), dim=1)
    lumas = gray(xf).double().sum(dim=(1, 2))
    gray_mean = true_div(lumas, float(h * w)).float()
    return torch.cat([torch.zeros_like(gray_mean)[:, None],
                      gray_mean[:, None], lo, hi], dim=1)


def _check(x, op_idx, signed_mag):
    if x.dim() != 4 or x.dtype != torch.float32:
        raise TypeError(f"apply_layer takes float32 [N, H, W, C], not "
                        f"{x.dtype} {tuple(x.shape)}")
    n = x.shape[0]
    if tuple(op_idx.shape) != (n,) or tuple(signed_mag.shape) != (n,):
        raise ValueError(f"op_idx {tuple(op_idx.shape)} / signed_mag "
                         f"{tuple(signed_mag.shape)} do not fit {n} images")
    if op_idx.dtype.is_floating_point:
        raise TypeError("op_idx indexes PALLAS_POOL: an integer tensor")


def _clip(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, 0.0, 1.0)


# The pool's elementwise formulas, as the Pallas branches write them
# (``randaugment_ew.py:53-87``); ``m`` is the signed magnitude [N, 1, 1, 1].
# data/randaugment.py's XLA ops are the same formulas.

def autocontrast(x, lo, hi):
    """Stretch each channel's [lo, hi] to [0, 1]; a flat channel stays."""
    scale = 1.0 / torch.clamp(hi - lo, min=1e-5)
    return torch.where(hi > lo, _clip((x - lo) * scale), x)


def posterize(x, m):
    """Keep floor(8 - 4 |m|) bits."""
    levels = torch.exp2(torch.floor(8.0 - m.abs() * 4.0))
    step = 256.0 / levels
    return _clip(true_div(torch.floor(x * 255.0 / step) * step, 255.0))


def solarize(x, m):
    """Invert the values at or above 1 - |m|."""
    return torch.where(x < 1.0 - m.abs(), x, 1.0 - x)


def solarize_add(x, m):
    """Add |m| * 110 / 255 below 0.5."""
    return torch.where(x < 0.5, _clip(x + m.abs() * (110.0 / 255.0)), x)


def contrast(x, m, gray_mean):
    """Scale the distance from the gray mean by 1 + 0.9 m."""
    return _clip(gray_mean + (x - gray_mean) * (1.0 + 0.9 * m))


def brightness(x, m):
    """Scale by 1 + 0.9 m (PIL's blend with black)."""
    return _clip(x * (1.0 + 0.9 * m))


def apply_layer_reference(x: torch.Tensor, op_idx: torch.Tensor,
                          signed_mag: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: every op of the pool on the whole batch,
    ``torch.where`` keeping the one each image drew."""
    c = x.shape[-1]
    params = image_stats(x)
    m = signed_mag.float()[:, None, None, None]
    lo = params[:, None, None, 2:2 + c]
    hi = params[:, None, None, 2 + c:]
    branches = (
        lambda: x,
        lambda: autocontrast(x, lo, hi),
        lambda: 1.0 - x,
        lambda: posterize(x, m),
        lambda: solarize(x, m),
        lambda: solarize_add(x, m),
        lambda: contrast(x, m, params[:, 1, None, None, None]),
        lambda: brightness(x, m))
    op = op_idx[:, None, None, None]
    out = x
    for k, branch in enumerate(branches):
        out = torch.where(op == k, branch(), out)
    return out


def apply_layer(x: torch.Tensor, op_idx: torch.Tensor,
                signed_mag: torch.Tensor, *,
                path: str | None = None) -> torch.Tensor:
    """One RandAugment layer over PALLAS_POOL: x [N, H, W, C] float32 in
    [0, 1], op_idx [N] integer into PALLAS_POOL, signed_mag [N] in
    [-1, 1]; both on the device (no host sync; int64 and float32 are
    read as they are).  ``path``: "one_pass" or "two_pass" forces the
    kernels' path (:func:`plan`), which the CPU ignores."""
    _check(x, op_idx, signed_mag)
    if x.device.type == "cpu":
        return apply_layer_reference(x, op_idx, signed_mag)
    if x.device.type != "cuda":
        raise ValueError(f"no randaugment_ew kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("randaugment_ew kernel needs a contiguous tensor")
    n, h, w, c = x.shape
    if n > 65535:  # the two-pass grids have a row of blocks an image
        raise ValueError(f"randaugment_ew kernel takes up to 65535 images "
                         f"a launch, not {n}")
    code, p0, p1, scratch_bytes = _launch_plan(
        (n, h, w, c), x.data_ptr() % 16 == 0, path)
    op_idx = op_idx.to(device=x.device, dtype=torch.int64).contiguous()
    signed_mag = signed_mag.to(device=x.device,
                               dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8,
                          device=x.device) if scratch_bytes else None
    err = _build.library().mcn_randaugment_ew_f32(
        x.data_ptr(), op_idx.data_ptr(), signed_mag.data_ptr(),
        y.data_ptr(), n, h * w, c, code, p0, p1,
        scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(_ENTRY, err)
    apply_layer.launches += 1
    return y


apply_layer.launches = 0
