"""Per-image bilinear shears, and rotation as three of them.

Port of ``myconvnet_tpu/ops/pallas/affine.py``: ``shear_rows`` (``:92``,
the Pallas kernel at ``:127``), ``_centered`` (``:137-141``), ``shear_x``,
``shear_y`` and ``rotate`` (``:144-179``).  The CUDA kernel is
``csrc/affine.cu``.

For image n with slope s and offset t, a shear along the columns (axis 2)
is

    out[n, y, x] = in[n, y, x + s * y + t]

bilinear between the two source pixels floor(shift) and floor(shift) + 1,
with ``fill`` standing in for a source outside the frame; a shear along
the rows (axis 1) is the same with the roles of y and x swapped, so
``shear_y`` needs no transpose.  The arithmetic is the Pallas kernel's
(``affine.py:59-87``), rounded as it rounds:

    shift = s * line + t;  base = floor(shift);  frac = shift - base
    w0 = (1 - frac) * v0;  w1 = frac * v1       (v: source inside the frame)
    out = (x[base] * w0 + x[base + 1] * w1) + (1 - (w0 + w1)) * fill

The last term does not vanish exactly when both sources are in the frame.
The Pallas body sweeps bounded lane rolls over 32-row blocks because
Mosaic has no vector gather; the CUDA kernel needs no bound on the slope
(``max_abs_slope`` is accepted so that call sites read as JAX's).  It
moves one read and one write of the batch: bound by HBM bytes.  Its three
paths (``csrc/affine.cu``) are chosen by :func:`plan` here, which the CPU
tests hold, and whose copies of the kernel's constants a card test holds
against :func:`kernel_facts`:

* rows (axis 2): a block owns a chunk of whole rows, brought into
  shared memory by one bulk copy (``"fast"``) or by plain loads where a
  row is not a multiple of 16 bytes or the base is not 16-byte aligned
  (``"staged"``);
* columns (axis 1): a block owns TX columns x 64 output rows and brings
  the 96 source rows they need as one TMA box (``"fast"``) or by plain
  loads (``"staged"``); a strip whose slope needs more rows reads from
  device memory;
* ``"direct"``: one block an output row, reading both taps from device
  memory, for rows too long for shared memory and strips wider than a TMA
  box allows.

On a CPU tensor :func:`shear_rows` runs :func:`shear_reference` (a
gather); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from myconvnet_tpu_torch.ops.kernels import _build

_ENTRY = "mcn_shear_f32"
PATHS = {"direct": 0, "staged": 1, "fast": 2}

# What the planner assumes of the card (an H100 SXM) and of the kernel;
# the card tests hold the kernel's constants against kernel_facts()
SMEM_MAX = 232_448        # shared memory a block may ask for (227 KB)
CHUNK_BYTES = 22_528      # row path: bytes of a block's rows, about
ROW_THREADS = 256         # row path: threads a block, at most
TILE_ROWS = 64            # column path: output rows of a strip
BOX_ROWS = 96             # column path: source rows of its box
MAX_BOX = 256             # TMA: elements of a box along one dimension
COL_THREADS = 256         # column path: threads a block, about


def plan(shape, axis: int, aligned: bool = True) -> dict:
    """The kernel's launch plan for float32 ``shape`` = [N, H, W, C]
    sheared along ``axis``; ``aligned``: the input's base is 16-byte
    aligned.  ``path`` is "fast" (bulk copy or TMA), "staged" (plain
    loads into the same shared buffers) or "direct"; ``smem`` the bytes a
    block asks for.  Axis 2: ``rows`` a block, the grid's ``blocks`` and
    ``threads`` a block.  Axis 1: ``tx`` columns a strip and ``threads`` a
    block."""
    n, h, w, c = shape
    wc = w * c
    if axis == 2:
        row_bytes = 4 * wc
        rb = max(1, min(n * h, CHUNK_BYTES // row_bytes))
        smem = rb * row_bytes + 16
        if smem > SMEM_MAX:
            return dict(path="direct", smem=0)
        fast = wc % 4 == 0 and aligned
        groups = wc // 4 if fast else wc   # float4 groups (or floats) a row
        return dict(path="fast" if fast else "staged", rows=rb,
                    blocks=-(-(n * h) // rb),
                    threads=groups * (ROW_THREADS // groups)
                    if groups <= ROW_THREADS else ROW_THREADS, smem=smem)
    fast = wc % 4 == 0 and aligned and 4 * c <= MAX_BOX
    if fast:
        tx = min(32, MAX_BOX // c // 4 * 4)
    elif c <= MAX_BOX:
        tx = min(32, MAX_BOX // c)
    else:
        return dict(path="direct", smem=0)
    txc = tx * c
    groups = txc // 4 if fast else txc
    return dict(path="fast" if fast else "staged", tx=tx,
                threads=groups * max(1, COL_THREADS // groups),
                smem=BOX_ROWS * txc * 4 + 16)


@functools.lru_cache(maxsize=256)
def _launch_plan(shape, axis, aligned) -> tuple[int, int, int]:
    """(path code, p0, p1) of :func:`plan` for the C entry point, cached:
    the wrapper asks for it at every launch."""
    p = plan(shape, axis, aligned)
    if p["path"] == "direct":
        return 0, 0, 0
    if axis == 2:
        return PATHS[p["path"]], p["rows"], 0
    return PATHS[p["path"]], p["tx"], p["threads"]


def kernel_facts() -> dict:
    """The built kernel's constants that the planner copies (strip rows,
    box rows, the box limit, the row path's chunk bytes and threads).
    Needs the card (the library is built there)."""
    out = (ctypes.c_int * 5)()
    _build.check("mcn_shear_facts", _build.library().mcn_shear_facts(
        ctypes.cast(out, ctypes.c_void_p)))
    return dict(tile_rows=out[0], box_rows=out[1], max_box=out[2],
                chunk_bytes=out[3], row_threads=out[4])


def _check(x, slope, offset, axis):
    if x.dim() != 4 or x.dtype != torch.float32:
        raise TypeError(f"shear_rows takes float32 [N, H, W, C], not "
                        f"{x.dtype} {tuple(x.shape)}")
    n = x.shape[0]
    if tuple(slope.shape) != (n,) or tuple(offset.shape) != (n,):
        raise ValueError(f"slope {tuple(slope.shape)} / offset "
                         f"{tuple(offset.shape)} do not fit {n} images")
    if axis not in (1, 2):
        raise ValueError(f"axis is 2 (shear rows) or 1 (shear columns), "
                         f"not {axis}")


def shear_reference(x: torch.Tensor, slope: torch.Tensor,
                    offset: torch.Tensor, *, fill: float = 0.5,
                    axis: int = 2) -> torch.Tensor:
    """Plain PyTorch version: the two source pixels of every output pixel
    by ``torch.gather``, blended with the kernel's roundings."""
    if axis == 1:
        x = x.transpose(1, 2)   # shear columns as rows of the transpose
    n, lines, size, c = x.shape
    dev = x.device
    line = torch.arange(lines, dtype=torch.float32, device=dev)
    shift = slope.float()[:, None] * line + offset.float()[:, None]
    base = torch.floor(shift)
    frac = (shift - base)[:, :, None]                       # [N, lines, 1]
    # clamped so that a huge shift stays an integer outside the frame
    b0 = base.clamp(-size - 1, size).long()[:, :, None]
    q0 = torch.arange(size, device=dev) + b0                # [N, lines, size]
    q1 = q0 + 1
    w0 = (1.0 - frac) * ((q0 >= 0) & (q0 < size))
    w1 = frac * ((q1 >= 0) & (q1 < size))

    def tap(q):
        idx = q.clamp(0, size - 1)[..., None].expand(n, lines, size, c)
        return torch.gather(x, 2, idx)

    acc = tap(q0) * w0[..., None] + tap(q1) * w1[..., None]
    out = acc + ((1.0 - (w0 + w1)) * fill)[..., None]
    return out.transpose(1, 2).contiguous() if axis == 1 else out


def shear_rows(x: torch.Tensor, slope: torch.Tensor, offset: torch.Tensor,
               *, max_abs_slope: float | None = None, fill: float = 0.5,
               axis: int = 2) -> torch.Tensor:
    """[N, H, W, C] float32 -> the same shape: ``out[n, y, x] = in[n, y,
    x + slope[n] * y + offset[n]]`` (axis 2), or ``in[n, y + slope[n] * x
    + offset[n], x]`` (axis 1), bilinear, ``fill`` outside the frame.
    slope/offset: [N] float32 (pixels), on the device (no host sync)."""
    del max_abs_slope  # every path takes any slope
    _check(x, slope, offset, axis)
    if x.device.type == "cpu":
        return shear_reference(x, slope, offset, fill=fill, axis=axis)
    if x.device.type != "cuda":
        raise ValueError(f"no shear kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("shear kernel needs a contiguous tensor")
    dev = x.device
    n, h, w, c = x.shape
    slope = slope.to(device=dev, dtype=torch.float32).contiguous()
    offset = offset.to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    path, p0, p1 = _launch_plan((n, h, w, c), axis,
                                x.data_ptr() % 16 == 0)
    code = _build.library().mcn_shear_f32(
        x.data_ptr(), slope.data_ptr(), offset.data_ptr(), y.data_ptr(),
        n, h, w, c, axis, float(fill), path, p0, p1,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(_ENTRY, code)
    shear_rows.launches += 1
    return y


shear_rows.launches = 0


def _centered(slope: torch.Tensor, size_along: int) -> torch.Tensor:
    """The offset that keeps the shear centred: shift = slope * (y - cy)
    as slope * y + offset."""
    return -slope * ((size_along - 1) / 2.0)


def shear_x(x: torch.Tensor, slope: torch.Tensor, *,
            max_abs_slope: float | None = None,
            fill: float = 0.5) -> torch.Tensor:
    """Horizontal shear about the image centre (PIL AFFINE
    ``(1, s, 0, 0, 1, 0)`` up to centring)."""
    return shear_rows(x, slope, _centered(slope, x.shape[1]),
                      max_abs_slope=max_abs_slope, fill=fill, axis=2)


def shear_y(x: torch.Tensor, slope: torch.Tensor, *,
            max_abs_slope: float | None = None,
            fill: float = 0.5) -> torch.Tensor:
    """Vertical shear about the image centre: the kernel along the rows,
    where JAX shears the transposed image (``affine.py:153-159``)."""
    return shear_rows(x, slope, _centered(slope, x.shape[2]),
                      max_abs_slope=max_abs_slope, fill=fill, axis=1)


def rotate(x: torch.Tensor, radians: torch.Tensor, *,
           max_abs_radians: float, fill: float = 0.5) -> torch.Tensor:
    """Rotate about the centre (counter-clockwise, PIL convention) as the
    three shears ShX(tan(a / 2)) . ShY(-sin(a)) . ShX(tan(a / 2)), so the
    result is JAX's, not a single-resample rotation; three launches."""
    if max_abs_radians >= math.pi / 2:
        raise ValueError("3-shear rotation needs |angle| < 90 degrees")
    a = torch.tan(radians / 2.0)
    b = -torch.sin(radians)
    max_a = math.tan(max_abs_radians / 2.0)
    max_b = math.sin(max_abs_radians)
    x = shear_x(x, a, max_abs_slope=max_a, fill=fill)
    x = shear_y(x, b, max_abs_slope=max_b, fill=fill)
    return shear_x(x, a, max_abs_slope=max_a, fill=fill)
