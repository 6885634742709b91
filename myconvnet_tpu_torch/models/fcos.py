"""FCOS and tinyfcos: anchor-free one-stage detection, NHWC.

Port of ``myconvnet_tpu/models/fcos.py``: the point specs (``:48-50``,
(map size, normalized stride) a level), ``fcos_points`` (``:53``: cell
centres, the (lo, hi] bands of each level's longest regression distance,
4x the level's stride, and the strides), the heads (``_fcos_heads``,
``:72``: RetinaNet's weight-tied ``SharedHead`` at one point a cell, a
``cls_head`` of C - 1 logits from the prior bias and a ``box_head`` of 4
raw distances and the centerness logit, then distances softplus(raw) * 4
* stride * ``scale{i}/s``, a float32 scalar a level, init 1), ``fcos``
(``:93``: ResNet-50, RetinaNet's ``FPN`` at 5 levels) and ``tinyfcos``
(``:114``: RetinaNet's :func:`tiny_trunk`).

Outputs (cls [B, L, C - 1], ctr [B, L], dists [B, L, 4]); the distances
are float32 whatever the heads' dtype (the float32 scale promotes them, as
in JAX).  softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``.

Eval mode: the backbone routes as the ResNet-50 eval forward (B5 13, B1
7) and each head layer's relu(conv3x3 + bias) is ``conv3x3_bn_relu`` (B4)
under bf16: 4 layers x 2 towers x 5 levels = 40 launches a forward at a
512 input, maps 64² to 4², as RetinaNet's heads.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch.models.resnet import ResNetBackbone
from myconvnet_tpu_torch.models.retinanet import (FPN, PRIOR_BIAS,
                                                  SharedHead, tiny_pyramid,
                                                  tiny_trunk)

FCOS512_SPEC = ((64, 1 / 64), (32, 1 / 32), (16, 1 / 16), (8, 1 / 8),
                (4, 1 / 4))
TINYFCOS_SPEC = ((16, 1 / 16), (8, 1 / 8), (4, 1 / 4))


def fcos_points(spec) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(points [L, 2] normalized xy, ranges [L, 2] (lo, hi] bands,
    strides [L]) of a point spec."""
    pts, ranges, strides = [], [], []
    prev_hi = 0.0
    for i, (fm, s) in enumerate(spec):
        c = (np.arange(fm, dtype=np.float32) + 0.5) * s
        xx, yy = np.meshgrid(c, c)
        hi = np.inf if i == len(spec) - 1 else 4.0 * s
        pts.append(np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1))
        ranges.append(np.tile([[prev_hi, hi]], (fm * fm, 1)))
        strides.append(np.full(fm * fm, s, np.float32))
        prev_hi = hi
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(ranges).astype(np.float32),
            np.concatenate(strides))


class Scale(nn.Module):
    """A level's learnable float32 scalar ``s`` (init 1)."""

    def __init__(self):
        super().__init__()
        self.s = nn.Parameter(torch.ones(()))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class _FCOSHeads(nn.Module):
    """``_fcos_heads`` over a trunk's pyramid."""

    def _heads(self, ch: int, num_classes: int, head_depth: int, spec):
        self.spec = spec
        self.cls_head = SharedHead(ch, num_classes - 1, head_depth, 1,
                                   PRIOR_BIAS)
        self.box_head = SharedHead(ch, 5, head_depth, 1)
        for i in range(len(spec)):
            self.add_module(f"scale{i + 1}", Scale())

    def _outputs(self, feats):
        sizes = tuple(f.shape[1] for f in feats)
        if sizes != tuple(s[0] for s in self.spec):
            raise ValueError(f"pyramid {sizes} != FCOS spec — input must be "
                             f"{self.input_side}x{self.input_side}")
        cls_out, ctr_out, dist_out = [], [], []
        for i, f in enumerate(feats):
            cls_out.append(self.cls_head(f))
            reg = self.box_head(f)
            raw, ctr = reg[..., :4], reg[..., 4]
            s = getattr(self, f"scale{i + 1}").s
            dist_out.append((_softplus(raw) * (4.0 * self.spec[i][1])).to(
                torch.promote_types(raw.dtype, s.dtype)) * s)
            ctr_out.append(ctr)
        return (torch.cat(cls_out, 1), torch.cat(ctr_out, 1),
                torch.cat(dist_out, 1))


class FCOS(_FCOSHeads):
    """``forward(x)``: x [B, 512, 512, 3] -> (cls [B, 5456, C - 1], ctr
    [B, 5456], dists [B, 5456, 4])."""
    input_side = 512

    def __init__(self, num_classes: int = 21, *, depth: int = 50,
                 fpn_channels: int = 256, head_depth: int = 4,
                 stem: str = "conv7"):
        super().__init__()
        self.backbone = ResNetBackbone(depth, stem=stem)
        _, c3, c4, c5 = self.backbone.stage_channels
        self.fpn = FPN(c3, c4, c5, fpn_channels)
        self._heads(fpn_channels, num_classes, head_depth, FCOS512_SPEC)

    def forward(self, x: torch.Tensor):
        _, c3, c4, c5 = self.backbone.stages(x)
        return self._outputs(self.fpn(c3, c4, c5))


class TinyFCOS(_FCOSHeads):
    """The CPU anchor-free detector: 128 x 128 input, levels 16, 8, 4, 336
    points, 2-layer towers."""
    input_side = 128

    def __init__(self, num_classes: int = 21, *, width: int = 32):
        super().__init__()
        self.backbone, self.fpn = tiny_trunk(width)
        self._heads(2 * width, num_classes, 2, TINYFCOS_SPEC)

    def forward(self, x: torch.Tensor):
        return self._outputs(tiny_pyramid(self.backbone, self.fpn, x))


def fcos(num_classes: int = 21, **kwargs) -> FCOS:
    return FCOS(num_classes, **kwargs)


def tinyfcos(num_classes: int = 21, **kwargs) -> TinyFCOS:
    return TinyFCOS(num_classes, **kwargs)


for _fn, _hw, _spec in ((fcos, (512, 512), FCOS512_SPEC),
                        (tinyfcos, (128, 128), TINYFCOS_SPEC)):
    _fn.input_hw, _fn.point_spec, _fn.family = _hw, _spec, "fcos"
