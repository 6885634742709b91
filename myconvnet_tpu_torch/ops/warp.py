"""Backward warping by a flow field.

Port of ``myconvnet_tpu/ops/warp.py``: ``out[n, y, x] = img[n, y + v(y, x),
x + u(y, x)]`` with bilinear interpolation and edge-clamped sampling.
Plain PyTorch (the JAX package has no Pallas kernel here):

* :func:`warp_bilinear`: one ``torch.gather`` per bilinear corner over the
  flattened H*W plane; unbounded displacement;
* :func:`warp_bounded`: gather-free for ``|flow| <= d``: a sum over the
  static (2d + 1)^2 integer displacements of an edge-padded slice times
  the weight ``relu(1 - |u - dx|) * relu(1 - |v - dy|)``.

Gradients at ties.  At zero flow the sample positions of the border rows
and columns sit exactly on 0 and W - 1, where ``jnp.clip`` (a ``minimum``
of a ``maximum``) hands HALF of the gradient to the clipped value at each
tie, while ``torch.clamp`` passes all of it.  :func:`_clip` reproduces
JAX's rule, so the gradient with respect to the flow equals JAX's there
too.  The bounded warp's weight ``relu(1 - |t|)`` meets two more ties at
integer flows: ``jnp.maximum`` splits the gradient at ``|t| = 1``
(:func:`_maximum0`), and ``jnp.abs`` has the gradient +1 at ``t = 0``,
where torch's is 0 (:func:`abs_jax`).
"""

from __future__ import annotations

import torch


def _split_flow(flow: torch.Tensor):
    if flow.shape[-1] != 2:
        raise ValueError(f"flow must be [..., 2] (u, v), got "
                         f"{tuple(flow.shape)}")
    f = flow.float()
    return f[..., 0], f[..., 1]


class _ClipTies(torch.autograd.Function):
    """clamp(x, lo, hi) whose gradient is 1 inside, 0 outside and 0.5 at
    x == lo and at x == hi, as ``jnp.clip``'s."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        tie = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    if lo == hi:   # a one-pixel axis: max then min tie at once, 0.25
        return _ClipTies.apply(_ClipTies.apply(x, lo, float("inf")),
                               -float("inf"), hi)
    return _ClipTies.apply(x, lo, hi)


def _maximum0(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with gradient 0.5 at x == 0, as ``jnp.maximum``'s."""
    return _ClipTies.apply(x, 0.0, float("inf"))


class _AbsJax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with gradient +1 at x == 0, as ``jnp.abs``'s (torch: 0)."""
    return _AbsJax.apply(x)


def warp_bilinear(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``[N,H,W,C] x [N,H,W,2] -> [N,H,W,C]`` backward warp.

    Samples ``img`` at ``(x + u, y + v)`` bilinearly with coordinates
    clamped to the frame (edge replication).  Interpolation runs in
    float32; the output keeps ``img``'s dtype."""
    if img.shape[:3] != flow.shape[:3]:
        raise ValueError(f"img {tuple(img.shape)} and flow "
                         f"{tuple(flow.shape)} disagree on [N, H, W]")
    n, h, w, c = img.shape
    u, v = _split_flow(flow)
    dev = img.device
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + u
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + v
    xx = _clip(xx, 0.0, w - 1.0)
    yy = _clip(yy, 0.0, h - 1.0)
    x0 = torch.floor(xx).detach()
    y0 = torch.floor(yy).detach()
    wx = (xx - x0)[..., None]
    wy = (yy - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)

    flat = img.float().reshape(n, h * w, c)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(n, h * w, 1).expand(n, h * w, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    out = ((1 - wy) * ((1 - wx) * tap(y0, x0) + wx * tap(y0, x1))
           + wy * ((1 - wx) * tap(y1, x0) + wx * tap(y1, x1)))
    return out.to(img.dtype)


def warp_bounded(img: torch.Tensor, flow: torch.Tensor, *,
                 max_displacement: int = 4) -> torch.Tensor:
    """Gather-free bounded backward warp: equals :func:`warp_bilinear`
    wherever ``|flow| <= max_displacement`` component-wise (the flow is
    clamped to that box first)."""
    if img.shape[:3] != flow.shape[:3]:
        raise ValueError(f"img {tuple(img.shape)} and flow "
                         f"{tuple(flow.shape)} disagree on [N, H, W]")
    d = int(max_displacement)
    if d < 0:
        raise ValueError(f"max_displacement must be >= 0, got {d}")
    n, h, w, c = img.shape
    u, v = _split_flow(flow)
    u = _clip(u, -float(d), float(d))
    v = _clip(v, -float(d), float(d))
    # edge padding = the clamp semantics of warp_bilinear at borders
    x = img.float()
    if d:
        x = torch.cat([x[:, :1].expand(n, d, w, c), x,
                       x[:, -1:].expand(n, d, w, c)], dim=1)
        x = torch.cat([x[:, :, :1].expand(n, h + 2 * d, d, c), x,
                       x[:, :, -1:].expand(n, h + 2 * d, d, c)], dim=2)
    out = torch.zeros((n, h, w, c), dtype=torch.float32, device=img.device)
    for dy in range(-d, d + 1):
        wy = _maximum0(1.0 - abs_jax(v - dy))
        for dx in range(-d, d + 1):
            wgt = wy * _maximum0(1.0 - abs_jax(u - dx))
            out = out + wgt[..., None] * x[:, dy + d:dy + d + h,
                                           dx + d:dx + d + w]
    return out.to(img.dtype)
