"""Inception-v3, NHWC.

Port of ``myconvnet_tpu/models/inception.py``.  Every conv is ``_cbr``
(``:17-24``): a conv without bias (square or a (1, n) / (n, 1) pair,
SAME or VALID, stride 1 or 2) -> BN (momentum 0.9, eps 1e-3) -> ReLU,
scopes ``<name>/conv`` and ``<name>/bn``.  The stem (``stem/conv1``-
``conv5`` with two 3x3/2 VALID max pools), three A modules
(``mixed_a1``-``mixed_a3``, pool projections 32, 64, 64), ``reduction_a``,
four B modules (``mixed_b1``-``mixed_b4``, the factorized 7x7 at 128, 160,
160, 192 channels), ``reduction_b``, two C modules, global average pool,
dropout 0.5 (site ``gap``, [N, 2048]) and the dense ``logits``.  The pool
branch (``_branch_pool``) is a 3x3 stride-1 SAME average pool that
divides by the window's elements inside the frame (``ops/pool``), then
the 1x1 ``pool_proj``.  Any input of at least 75 x 75 works (299 x 299 is
the canonical size): the VALID stem and reductions need it.

Eval routing (``models/blocks.py``): each ``_cbr`` whose conv is 3x3,
stride 1 and SAME (``stem/conv3``, the A modules' ``b3_2``/``b3_3``,
``reduction_a/r3d_2``, the C modules' ``b33_2``) is B4 on bf16
activations; every other one (1x1, 5x5, 1x7/7x1, 1x3/3x1, VALID and
stride-2 convs) a cuDNN conv + B1.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, draw_masks, \
    fuses
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, avg_pool,
                                    dropout, gap, max_pool)

MIN_INPUT = 75


class CBR(nn.Module):
    """``_cbr``: conv -> BN -> ReLU."""

    def __init__(self, cin: int, features: int, kernel, *, stride: int = 1,
                 padding: str = "SAME"):
        super().__init__()
        self.conv = Conv(cin, features, kernel, stride=stride,
                         padding=padding)
        self.bn = BatchNorm(features, eps=1e-3, momentum=0.9)
        self.fused = fuses(self.conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_relu(self.conv, self.bn, x, self.fused)


def _chain(mod: nn.Module, names, x: torch.Tensor) -> torch.Tensor:
    for name in names:
        x = getattr(mod, name)(x)
    return x


def _pool_branch(proj: CBR, x: torch.Tensor) -> torch.Tensor:
    return proj(avg_pool(x, 3, 1, "SAME"))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.b1x1 = CBR(cin, 64, 1)
        self.b5_1, self.b5_2 = CBR(cin, 48, 1), CBR(48, 64, 5)
        self.b3_1, self.b3_2 = CBR(cin, 64, 1), CBR(64, 96, 3)
        self.b3_3 = CBR(96, 96, 3)
        self.pool_proj = CBR(cin, pool_features, 1)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([self.b1x1(x), _chain(self, ("b5_1", "b5_2"), x),
                          _chain(self, ("b3_1", "b3_2", "b3_3"), x),
                          _pool_branch(self.pool_proj, x)], dim=-1)


class ReductionA(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.r3 = CBR(cin, 384, 3, stride=2, padding="VALID")
        self.r3d_1, self.r3d_2 = CBR(cin, 64, 1), CBR(64, 96, 3)
        self.r3d_3 = CBR(96, 96, 3, stride=2, padding="VALID")
        self.out_channels = 384 + 96 + cin

    def forward(self, x):
        return torch.cat([self.r3(x),
                          _chain(self, ("r3d_1", "r3d_2", "r3d_3"), x),
                          max_pool(x, 3, 2, "VALID")], dim=-1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.b1x1 = CBR(cin, 192, 1)
        self.b7_1, self.b7_2 = CBR(cin, c7, 1), CBR(c7, c7, (1, 7))
        self.b7_3 = CBR(c7, 192, (7, 1))
        self.b77_1, self.b77_2 = CBR(cin, c7, 1), CBR(c7, c7, (7, 1))
        self.b77_3, self.b77_4 = CBR(c7, c7, (1, 7)), CBR(c7, c7, (7, 1))
        self.b77_5 = CBR(c7, 192, (1, 7))
        self.pool_proj = CBR(cin, 192, 1)
        self.out_channels = 4 * 192

    def forward(self, x):
        return torch.cat([
            self.b1x1(x), _chain(self, ("b7_1", "b7_2", "b7_3"), x),
            _chain(self, ("b77_1", "b77_2", "b77_3", "b77_4", "b77_5"), x),
            _pool_branch(self.pool_proj, x)], dim=-1)


class ReductionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.r1 = CBR(cin, 192, 1)
        self.r2 = CBR(192, 320, 3, stride=2, padding="VALID")
        self.r7_1, self.r7_2 = CBR(cin, 192, 1), CBR(192, 192, (1, 7))
        self.r7_3 = CBR(192, 192, (7, 1))
        self.r7_4 = CBR(192, 192, 3, stride=2, padding="VALID")
        self.out_channels = 320 + 192 + cin

    def forward(self, x):
        return torch.cat([_chain(self, ("r1", "r2"), x),
                          _chain(self, ("r7_1", "r7_2", "r7_3", "r7_4"), x),
                          max_pool(x, 3, 2, "VALID")], dim=-1)


class InceptionC(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b1x1 = CBR(cin, 320, 1)
        self.b3_1 = CBR(cin, 384, 1)
        self.b3_2a, self.b3_2b = CBR(384, 384, (1, 3)), CBR(384, 384, (3, 1))
        self.b33_1, self.b33_2 = CBR(cin, 448, 1), CBR(448, 384, 3)
        self.b33_3a = CBR(384, 384, (1, 3))
        self.b33_3b = CBR(384, 384, (3, 1))
        self.pool_proj = CBR(cin, 192, 1)
        self.out_channels = 320 + 4 * 384 + 192

    def forward(self, x):
        b1 = self.b1x1(x)
        b2 = self.b3_1(x)
        b2 = torch.cat([self.b3_2a(b2), self.b3_2b(b2)], dim=-1)
        b3 = self.b33_2(self.b33_1(x))
        b3 = torch.cat([self.b33_3a(b3), self.b33_3b(b3)], dim=-1)
        return torch.cat([b1, b2, b3, _pool_branch(self.pool_proj, x)],
                         dim=-1)


class InceptionV3(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype, H and W at least 75 -> logits [N, num_classes] in the
    compute dtype."""

    def __init__(self, num_classes: int = 1000, *,
                 dropout_rate: float = 0.5, in_channels: int = 3):
        super().__init__()
        self.dropout_rate = dropout_rate
        st = self.stem = nn.Module()
        st.conv1 = CBR(in_channels, 32, 3, stride=2, padding="VALID")
        st.conv2 = CBR(32, 32, 3, padding="VALID")
        st.conv3 = CBR(32, 64, 3)
        st.conv4 = CBR(64, 80, 1, padding="VALID")
        st.conv5 = CBR(80, 192, 3, padding="VALID")
        self.mixed = []
        cin = 192
        for i, pf in enumerate((32, 64, 64)):
            cin = self._add(f"mixed_a{i + 1}", InceptionA(cin, pf))
        cin = self._add("reduction_a", ReductionA(cin))
        for i, c7 in enumerate((128, 160, 160, 192)):
            cin = self._add(f"mixed_b{i + 1}", InceptionB(cin, c7))
        cin = self._add("reduction_b", ReductionB(cin))
        for i in range(2):
            cin = self._add(f"mixed_c{i + 1}", InceptionC(cin))
        self.width = cin
        self.logits = Dense(cin, num_classes)

    def _add(self, name: str, module: nn.Module) -> int:
        self.add_module(name, module)
        self.mixed.append(module)
        return module.out_channels

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """The keep mask of the dropout before ``logits``."""
        return draw_masks({"gap": ((n, self.width), self.dropout_rate)},
                          generator)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The last module's map, before the pooling (JAX tags none of
        this model's maps ``features``, so it has no ``features``)."""
        if min(x.shape[1:3]) < MIN_INPUT:
            raise ValueError(f"Inception-v3 takes inputs of at least "
                             f"{MIN_INPUT} x {MIN_INPUT}, not "
                             f"{tuple(x.shape[1:3])}")
        st = self.stem
        x = st.conv3(st.conv2(st.conv1(x)))
        x = max_pool(x, 3, 2, "VALID")
        x = max_pool(st.conv5(st.conv4(x)), 3, 2, "VALID")
        for module in self.mixed:
            x = module(x)
        return x

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        h = dropout(gap(self.trunk(x)), self.dropout_rate,
                    train=self.training, generator=generator,
                    mask=None if masks is None else masks.get("gap"))
        return self.logits(h)


def inception_v3(num_classes: int = 1000, **kwargs) -> InceptionV3:
    return InceptionV3(num_classes, **kwargs)
