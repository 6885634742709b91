"""Optical-flow models: FlowNetS, FlowNetC, PWC-Net and two tiny variants.

Port of ``myconvnet_tpu/models/flow.py``.  Each model maps a
channel-stacked frame pair ``[N, H, W, 6]`` to a flow ``[N, H, W, 2]`` in
full-resolution pixels (float32); the coarse-to-fine nets (``multiscale =
True``) return the per-level list of flows in train mode, for
``train/losses.py:multiscale_epe_loss``.  All flows are in full-resolution
pixels at every level: the warp divides by 2^level, and resizing a flow
does not rescale it.

Module names equal the JAX scopes (``pyr.conv1a``, ``trunk.conv1``,
``est6.conv1``, ``est6.flow``, ``context.conv3``, ``up5.conv``, ``fuse``,
``flow``), so ``weights.from_jax`` maps a JAX tree by name; a scope the JAX
model shares between the two frames (``pyr``, ``trunk``) is one module
called twice.  Every conv has a bias; the flow heads start at zero
(weight and bias), so a fresh model predicts exactly zero flow, and every
gradient upstream of a head is exactly zero at that point.

Every cost volume goes through ``ops/correlation.correlation_volume``: the
CUDA kernels for CUDA tensors (five launches a PWC-Net forward, one a
FlowNetC forward, and as many of each backward kernel), the plain version
on the CPU.  The volume is float32 whatever the features' dtype; it passes
the leaky ReLU in float32 and is cast back to the features' dtype.
"""

from __future__ import annotations

import torch
from torch import nn as tnn

from myconvnet_tpu_torch import nn
from myconvnet_tpu_torch.core import init
from myconvnet_tpu_torch.ops.correlation import correlation_volume
from myconvnet_tpu_torch.ops.resize import resize_bilinear, \
    upsample2x_nearest
from myconvnet_tpu_torch.ops.warp import warp_bilinear, warp_bounded


def _lrelu(x):
    return nn.leaky_relu(x, 0.1)


def _conv(cin, cout, k, s=1, dilation=1):
    return nn.Conv(cin, cout, k, stride=s, dilation=dilation, bias=True)


def _flow_head(cin):
    """3x3 conv to (u, v), zero-initialised."""
    return nn.Conv(cin, 2, 3, bias=True, w_init=init.zeros)


def _check_pair(x, stride):
    if x.shape[-1] != 6:
        raise ValueError("flow models take channel-stacked frame "
                         f"pairs [N,H,W,6], got {tuple(x.shape)}")
    if x.shape[1] % stride or x.shape[2] % stride:
        raise ValueError(f"input_hw must be divisible by {stride} "
                         f"(the encoder's total stride), got "
                         f"({x.shape[1]}, {x.shape[2]})")


def _warp_fn(backend: str, md: int):
    return {"gather": warp_bilinear,
            "bounded": lambda f, fl: warp_bounded(
                f, fl, max_displacement=md)}[backend]


class _UpBlock(tnn.Module):
    """2x nearest upsample, conv, concat with the skip."""

    def __init__(self, cin, ch):
        super().__init__()
        self.conv = _conv(cin, ch, 3)

    def forward(self, x, skip):
        x = _lrelu(self.conv(upsample2x_nearest(x)))
        return torch.cat([x, skip.to(x.dtype)], dim=-1)


def _add_refine(m: tnn.Module, w: int) -> None:
    """The FlowNets' shared refinement, 1/64 -> 1/4: ``up5`` .. ``up2``,
    ``fuse`` and ``flow``, registered on the model itself (the JAX scopes
    are flat)."""
    m.up5 = _UpBlock(16 * w, 8 * w)      # + c5_1 (8w) -> 16w
    m.up4 = _UpBlock(16 * w, 4 * w)      # + c4_1 (8w) -> 12w
    m.up3 = _UpBlock(12 * w, 2 * w)      # + c3 (4w) -> 6w
    m.up2 = _UpBlock(6 * w, w)           # + c2 (2w) -> 3w
    m.fuse = _conv(3 * w, w, 3)
    m.flow = _flow_head(w)


def _refine(m, c2, c3, c41, c51, c61):
    """The refinement's forward, then bilinear x4 to full resolution."""
    h = m.up5(c61, c51)                                # 1/32
    h = m.up4(h, c41)                                  # 1/16
    h = m.up3(h, c3)                                   # 1/8
    h = m.up2(h, c2)                                   # 1/4
    h = _lrelu(m.fuse(h))
    flow4 = m.flow(h).float()                          # 1/4 res
    _, hh, ww, _ = flow4.shape
    return resize_bilinear(flow4, (4 * hh, 4 * ww))


def _add_tail(m: tnn.Module, cin: int, w: int) -> None:
    """conv3_1 .. conv6_1 of the FlowNets and their refinement."""
    m.conv3_1 = _conv(cin, 4 * w, 3)
    m.conv4 = _conv(4 * w, 8 * w, 3, 2)                # 1/16
    m.conv4_1 = _conv(8 * w, 8 * w, 3)
    m.conv5 = _conv(8 * w, 8 * w, 3, 2)                # 1/32
    m.conv5_1 = _conv(8 * w, 8 * w, 3)
    m.conv6 = _conv(8 * w, 16 * w, 3, 2)               # 1/64
    m.conv6_1 = _conv(16 * w, 16 * w, 3)
    _add_refine(m, w)


def _tail(m, c2, h):
    c3 = _lrelu(m.conv3_1(h))
    c4 = _lrelu(m.conv4_1(_lrelu(m.conv4(c3))))
    c5 = _lrelu(m.conv5_1(_lrelu(m.conv5(c4))))
    c6 = _lrelu(m.conv6_1(_lrelu(m.conv6(c5))))
    return _refine(m, c2, c3, c4, c5, c6)


class FlowNetS(tnn.Module):
    """FlowNetSimple (Dosovitskiy et al., 2015); ``width`` scales every
    stage (64 = the paper's 64/128/256/512/512/1024)."""

    def __init__(self, num_classes: int = 0, *, width: int = 64):
        super().__init__()
        del num_classes
        w = width
        self.conv1 = _conv(6, w, 7, 2)                 # 1/2
        self.conv2 = _conv(w, 2 * w, 5, 2)             # 1/4
        self.conv3 = _conv(2 * w, 4 * w, 5, 2)         # 1/8
        _add_tail(self, 4 * w, w)

    def forward(self, x):
        _check_pair(x, 64)
        c2 = _lrelu(self.conv2(_lrelu(self.conv1(x))))
        return _tail(self, c2, _lrelu(self.conv3(c2)))


class _Trunk(tnn.Module):
    def __init__(self, w):
        super().__init__()
        self.conv1 = _conv(3, w, 7, 2)                 # 1/2
        self.conv2 = _conv(w, 2 * w, 5, 2)             # 1/4
        self.conv3 = _conv(2 * w, 4 * w, 5, 2)         # 1/8

    def forward(self, f):
        c2 = _lrelu(self.conv2(_lrelu(self.conv1(f))))
        return c2, _lrelu(self.conv3(c2))


class FlowNetC(tnn.Module):
    """FlowNetCorr: a shared two-stream trunk to 1/8, the cost volume
    (d = 4 -> 81 channels) and a 1x1 redirect of stream one, then the
    tail and refinement of FlowNetS."""

    def __init__(self, num_classes: int = 0, *, width: int = 64,
                 max_displacement: int = 4):
        super().__init__()
        del num_classes
        w, self.md = width, max_displacement
        self.trunk = _Trunk(w)
        self.conv_redir = _conv(4 * w, w // 2, 1)
        _add_tail(self, (2 * self.md + 1) ** 2 + w // 2, w)

    def forward(self, x):
        _check_pair(x, 64)
        c2a, c3a = self.trunk(x[..., :3])
        _, c3b = self.trunk(x[..., 3:])
        corr = _lrelu(correlation_volume(c3a, c3b,
                                         max_displacement=self.md))
        redir = _lrelu(self.conv_redir(c3a))
        h = torch.cat([corr.to(redir.dtype), redir], dim=-1)
        return _tail(self, c2a, h)


class _Estimator(tnn.Module):
    """Flow estimator; ``dense`` is the paper's released variant (each
    conv sees every earlier activation)."""

    def __init__(self, cin, widths, dense=True):
        super().__init__()
        self.dense, self.n = dense, len(widths)
        for i, ch in enumerate(widths):
            setattr(self, f"conv{i + 1}", _conv(cin, ch, 3))
            cin = cin + ch if dense else ch
        self.flow = _flow_head(cin)
        self.out_channels = cin

    def forward(self, h):
        for i in range(self.n):
            out = _lrelu(getattr(self, f"conv{i + 1}")(h))
            h = torch.cat([out, h], dim=-1) if self.dense else out
        return h, self.flow(h).float()


class _Context(tnn.Module):
    """PWC-Net's dilated-conv refinement at the finest estimation level."""

    WIDTHS = (128, 128, 128, 96, 64, 32)
    RATES = (1, 2, 4, 8, 16, 1)

    def __init__(self, cin):
        super().__init__()
        for i, (ch, rate) in enumerate(zip(self.WIDTHS, self.RATES)):
            setattr(self, f"conv{i + 1}", _conv(cin, ch, 3, dilation=rate))
            cin = ch
        self.flow = _flow_head(cin)

    def forward(self, feat, flow):
        h = torch.cat([feat, flow.to(feat.dtype)], dim=-1)
        for i in range(len(self.WIDTHS)):
            h = _lrelu(getattr(self, f"conv{i + 1}")(h))
        return flow + self.flow(h).float()


class _Pyramid(tnn.Module):
    def __init__(self, widths):
        super().__init__()
        self.n, cin = len(widths), 3
        for li, ch in enumerate(widths, start=1):
            setattr(self, f"conv{li}a", _conv(cin, ch, 3, 2))
            setattr(self, f"conv{li}aa", _conv(ch, ch, 3))
            setattr(self, f"conv{li}b", _conv(ch, ch, 3))
            cin = ch

    def forward(self, f):
        feats = []
        for li in range(1, self.n + 1):
            for suffix in ("a", "aa", "b"):
                f = _lrelu(getattr(self, f"conv{li}{suffix}")(f))
            feats.append(f)
        return feats


class PWCNet(tnn.Module):
    """PWC-Net (Sun et al., 2018): a shared feature pyramid, then from the
    coarsest level down to level 2: warp frame 2's features by the
    upsampled coarser flow, correlate (d = md), estimate a residual flow;
    dilated-conv context refinement at 1/4 resolution, bilinear x4 out.
    In train mode returns the coarse-to-fine list of per-level flows."""

    multiscale = True
    EST_WIDTHS = (128, 128, 96, 64, 32)

    def __init__(self, num_classes: int = 0, *, md: int = 4,
                 pyramid: tuple = (16, 32, 64, 96, 128, 196),
                 warp_backend: str = "gather"):
        super().__init__()
        del num_classes
        self.md, self.widths = md, tuple(pyramid)
        self.warp = _warp_fn(warp_backend, md)
        self.pyr = _Pyramid(self.widths)
        k = (2 * md + 1) ** 2
        top = len(self.widths)
        for level in range(top, 1, -1):
            cin = k if level == top else k + self.widths[level - 1] + 2
            est = _Estimator(cin, self.EST_WIDTHS)
            setattr(self, f"est{level}", est)
        self.context = _Context(est.out_channels + 2)

    def forward(self, x):
        top = len(self.widths)
        _check_pair(x, 2 ** top)
        p1, p2 = self.pyr(x[..., :3]), self.pyr(x[..., 3:])
        flows, flow, feat = [], None, None
        for level in range(top, 1, -1):       # coarsest -> level 2
            f1, f2 = p1[level - 1], p2[level - 1]
            if flow is None:
                corr = _lrelu(correlation_volume(f1, f2,
                                                 max_displacement=self.md))
                h = corr.to(f1.dtype)
            else:
                up = resize_bilinear(flow, tuple(f1.shape[1:3]))
                warped = self.warp(f2, up / float(2 ** level))
                corr = _lrelu(correlation_volume(f1, warped,
                                                 max_displacement=self.md))
                h = torch.cat([corr.to(f1.dtype), f1, up.to(f1.dtype)],
                              dim=-1)
            feat, res = getattr(self, f"est{level}")(h)
            flow = res if flow is None else up + res
            flows.append(flow)
        flows[-1] = self.context(feat, flows[-1])
        if self.training:
            return flows
        _, hh, ww, _ = flows[-1].shape
        return resize_bilinear(flows[-1], (hh * 4, ww * 4))


class _TinyPyramid(tnn.Module):
    def __init__(self):
        super().__init__()
        self.enc1 = _conv(3, 16, 3, 2)                 # 1/2
        self.enc2 = _conv(16, 32, 3, 2)                # 1/4

    def forward(self, f):
        c1 = _lrelu(self.enc1(f))
        return c1, _lrelu(self.enc2(c1))


class TinyPWC(tnn.Module):
    """CPU smoke PWC-Net: a 2-level pyramid, a coarse estimate at 1/4, a
    warped residual estimate at 1/2, no context net; the bounded warp by
    default."""

    multiscale = True

    def __init__(self, num_classes: int = 0, *, md: int = 3,
                 warp_backend: str = "bounded"):
        super().__init__()
        del num_classes
        self.md = md
        self.warp = _warp_fn(warp_backend, md)
        k = (2 * md + 1) ** 2
        self.pyr = _TinyPyramid()
        self.est2 = _Estimator(k, (32, 32), dense=False)
        self.est1 = _Estimator(k + 16 + 2, (32, 16), dense=False)

    def forward(self, x):
        _check_pair(x, 4)
        c1a, c2a = self.pyr(x[..., :3])
        c1b, c2b = self.pyr(x[..., 3:])
        corr2 = _lrelu(correlation_volume(c2a, c2b,
                                          max_displacement=self.md))
        _, flow2 = self.est2(corr2.to(c2a.dtype))
        up = resize_bilinear(flow2, tuple(c1a.shape[1:3]))
        warped = self.warp(c1b, up / 2.0)
        corr1 = _lrelu(correlation_volume(c1a, warped,
                                          max_displacement=self.md))
        h = torch.cat([corr1.to(c1a.dtype), c1a, up.to(c1a.dtype)], dim=-1)
        _, res = self.est1(h)
        flow1 = up + res
        if self.training:
            return [flow2, flow1]
        _, hh, ww, _ = flow1.shape
        return resize_bilinear(flow1, (hh * 2, ww * 2))


class _TinyTrunk(tnn.Module):
    def __init__(self, w):
        super().__init__()
        self.enc1 = _conv(3, 2 * w, 3, 2)              # 1/2

    def forward(self, f):
        return _lrelu(self.enc1(f))


class TinyFlow(tnn.Module):
    """CPU smoke variant, a miniature FlowNetC: a shared one-level trunk,
    correlation at 1/2 resolution, a small decoder, a zero-init head."""

    def __init__(self, num_classes: int = 0, *, width: int = 8,
                 max_displacement: int = 4):
        super().__init__()
        del num_classes
        w, self.md = width, max_displacement
        self.trunk = _TinyTrunk(w)
        self.mid1 = _conv((2 * self.md + 1) ** 2 + 2 * w, 4 * w, 3)
        self.mid2 = _conv(4 * w, 4 * w, 3)
        self.fuse = _conv(4 * w, 2 * w, 3)
        self.flow = _flow_head(2 * w)

    def forward(self, x):
        _check_pair(x, 2)
        c1a, c1b = self.trunk(x[..., :3]), self.trunk(x[..., 3:])
        corr = _lrelu(correlation_volume(c1a, c1b,
                                         max_displacement=self.md))
        h = torch.cat([corr.to(c1a.dtype), c1a], dim=-1)
        h = _lrelu(self.mid2(_lrelu(self.mid1(h))))
        flow1 = self.flow(_lrelu(self.fuse(h))).float()
        _, hh, ww, _ = flow1.shape
        return resize_bilinear(flow1, (2 * hh, 2 * ww))


flownet_s, flownet_c, pwcnet = FlowNetS, FlowNetC, PWCNet
tinypwc, tinyflow = TinyPWC, TinyFlow
FLOW_MODELS = {"flownet_s": flownet_s, "flownet_c": flownet_c,
               "pwcnet": pwcnet, "tinypwc": tinypwc, "tinyflow": tinyflow}
