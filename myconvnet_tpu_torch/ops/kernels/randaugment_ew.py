"""One RandAugment layer of elementwise ops, one op chosen per image.

Port of ``myconvnet_tpu/ops/pallas/randaugment_ew.py``: ``PALLAS_POOL``
(``:35-36``), ``_image_stats`` (``:95-105``) and ``apply_layer`` (``:109``,
the Pallas kernel at ``:119``).  The CUDA kernel is
``csrc/randaugment_ew.cu``: each block reads its image's op index and
signed magnitude from device memory (no host sync) and runs only that op
over its share of the image, one read and one write per element in 16-byte
vectors, where the XLA where-fold (``data/randaugment.py``) runs every op
of the pool on every image.  Bound by HBM bytes.

The per-image statistics that contrast and autocontrast need (gray mean,
per-channel min and max) are computed, as in JAX, outside the kernel: by
two torch reductions in :func:`image_stats`, two more reads of the batch
before the kernel's pass.

The op formulas are the Pallas branches (``randaugment_ew.py:50-91``);
:func:`apply_layer_reference` writes them as a ``torch.where`` chain with
the same float32 roundings, and the kernel rounds each product and sum on
its own (no FMA contraction) to match it.

On a CPU tensor :func:`apply_layer` runs :func:`apply_layer_reference`;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch.ops.kernels import _build

# op order is the kernel's switch order (csrc/randaugment_ew.cu)
PALLAS_POOL = ("identity", "autocontrast", "invert", "posterize",
               "solarize", "solarize_add", "contrast", "brightness")

_ENTRY = "mcn_randaugment_ew_f32"


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b in float32 with IEEE division on every device: ATen's CUDA
    divide multiplies by the reciprocal when the divisor is a Python
    number, which can move a result by an ulp (and a floor after it by a
    whole step); a 0-dim tensor on a's device is divided by."""
    return a / a.new_full((), b)


def gray(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> [...] luma 0.299 R + 0.587 G + 0.114 B, summed in
    that order in float32 (JAX's ``sum(x * coef, -1)``)."""
    if x.shape[-1] != 3:
        raise ValueError(f"gray takes RGB images, not {x.shape[-1]} "
                         "channels")
    xf = x.float()
    return xf[..., 0] * 0.299 + xf[..., 1] * 0.587 + xf[..., 2] * 0.114


def image_stats(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, 2 + 2C] float32 rows: [0 (the magnitude's
    place), gray mean, lo_0..lo_{C-1}, hi_0..hi_{C-1}].  Two reads of x:
    one ``aminmax`` and one per-channel mean, whose luma is the gray mean
    (JAX takes the mean of the luma: equal up to float32 rounding)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, c)
    lo, hi = torch.aminmax(xf, dim=1)
    gray_mean = gray(xf.mean(dim=1))
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
                signed_mag: torch.Tensor) -> torch.Tensor:
    """One RandAugment layer over PALLAS_POOL: x [N, H, W, C] float32 in
    [0, 1], op_idx [N] integer into PALLAS_POOL, signed_mag [N] in
    [-1, 1]; both on the device (no host sync)."""
    _check(x, op_idx, signed_mag)
    if x.device.type == "cpu":
        return apply_layer_reference(x, op_idx, signed_mag)
    if x.device.type != "cuda":
        raise ValueError(f"no randaugment_ew kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("randaugment_ew kernel needs a contiguous tensor")
    if x.shape[0] > 65535:  # one grid row of blocks per image
        raise ValueError(f"randaugment_ew kernel takes up to 65535 images "
                         f"a launch, not {x.shape[0]}")
    params = image_stats(x)
    params[:, 0] = signed_mag.to(x.device, torch.float32)
    y = launch(x, op_idx.to(device=x.device, dtype=torch.int32), params)
    apply_layer.launches += 1
    return y


apply_layer.launches = 0


def launch(x: torch.Tensor, op_idx: torch.Tensor,
           params: torch.Tensor) -> torch.Tensor:
    """The kernel alone on CUDA tensors: x as :func:`apply_layer` takes
    it, op_idx [N] int32 and the [N, 2 + 2C] float32 rows of
    :func:`image_stats` with the signed magnitude in column 0
    (:func:`apply_layer` makes both and counts the launch)."""
    n, h, w, c = x.shape
    if op_idx.dtype != torch.int32 or params.dtype != torch.float32 \
            or tuple(op_idx.shape) != (n,) \
            or tuple(params.shape) != (n, 2 + 2 * c):
        raise ValueError(f"launch takes op_idx [{n}] int32 and params "
                         f"[{n}, {2 + 2 * c}] float32")
    op_idx, params = op_idx.contiguous(), params.contiguous()
    y = torch.empty_like(x)
    code = _build.library().mcn_randaugment_ew_f32(
        x.data_ptr(), op_idx.data_ptr(), params.data_ptr(), y.data_ptr(),
        n, h * w * c, c, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(_ENTRY, code)
    return y
