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
launches of one gather-form kernel (no atomics, so the result does not
depend on the run),

    d_f1[n, y, x, c] = (1 / C) sum_k g[n, y, x, k] f2[n, y+dy-d, x+dx-d, c]
    d_f2[n, y, x, c] = (1 / C) sum_k g[n, y-dy+d, x-dx+d, k]
                                     f1[n, y-dy+d, x-dx+d, c]

with g float32 and the gradients rounded once to the inputs' dtype.

The channel mean divides the sum by C, as ``jnp.mean`` in the XLA op
(``ops/correlation.py:49``) does; the Pallas body multiplies by the
reciprocal (``:59``), one float32 ulp away.  :func:`correlation_reference`
and the kernels both divide.

On a CPU tensor the wrappers run the plain version (and its autograd); on a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from myconvnet_tpu_torch.ops.kernels import _build

MAX_DISPLACEMENT = 4    # the recipes' window; the kernels' D_MAX
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def correlation_fwd(f1: torch.Tensor, f2: torch.Tensor,
                    max_displacement: int = 4) -> torch.Tensor:
    """[N, H, W, C] x [N, H, W, C] -> float32 [N, H, W, (2d + 1)^2]; no
    autograd (see :func:`correlation`)."""
    d = int(max_displacement)
    _check(f1, f2, d)
    if f1.device.type == "cpu":
        return correlation_reference(f1, f2, d)
    _on_card(f1, d)
    f1, f2 = f1.contiguous(), f2.contiguous()
    n, h, w, c = f1.shape
    out = torch.empty((n, h, w, (2 * d + 1) ** 2), dtype=torch.float32,
                      device=f1.device)
    entry = f"mcn_correlation_fwd_{_SUFFIX[f1.dtype]}"
    code = getattr(_build.library(), entry)(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, h, w, c, d,
        torch.cuda.current_stream(f1.device).cuda_stream)
    _build.check(entry, code)
    correlation_fwd.launches += 1
    return out


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
    tensors, the three kernels for CUDA tensors."""
    d = int(max_displacement)
    _check(f1, f2, d)
    if f1.device.type == "cpu":
        return correlation_reference(f1, f2, d)
    return _Correlation.apply(f1, f2, d)
