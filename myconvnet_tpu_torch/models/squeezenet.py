"""SqueezeNet 1.1 and AlexNet, NHWC.

Port of ``myconvnet_tpu/models/squeezenet.py`` and ``models/alexnet.py``.

* SqueezeNet 1.1: ``stem/conv`` (3x3/2, bias) -> ReLU, a 3x3/2 SAME max
  pool, the fire modules ``fire2``-``fire9`` (``FIRE_CFG``: ``squeeze``
  1x1 -> ReLU, then ``expand1x1`` and ``expand3x3`` over the squeezed map,
  each with bias -> ReLU, concatenated), a max pool after fire3 and fire5,
  dropout 0.5 over the map (site ``dropout``, [N, h, w, 512] at the
  model's ``input_hw``), the 1x1 ``classifier`` conv with bias -> ReLU
  and the global average pool in float32.
* AlexNet: five convs (11x11/4 SAME, 5x5, three 3x3; with ``use_bn`` no
  bias and a BN of JAX's defaults, momentum 0.99 and eps 1e-3, after
  each; without, a bias) -> ReLU, with 3x3/2 VALID max pools after the
  first, second and fifth; the classic head flattens the NHWC map
  (``fc1`` is sized by ``input_hw``) -> dropout -> ``fc1`` (4096) -> ReLU
  -> dropout -> ``fc2`` -> ReLU (sites ``flat`` and ``fc1``), the other
  head is global average pool -> dropout (site ``gap``); then the dense
  ``logits``.  Layers are auto-named at the root (``conv``, ``conv_1``
  ... and ``bn``, ``bn_1`` ...).

Eval routing (``models/blocks.py``): every conv (-> BN) -> ReLU goes
through :func:`blocks.conv_bn_relu`.  A 3x3 stride-1 SAME conv whose
input channels the kernel takes is ``conv3x3_bn_relu`` (B4) on bf16
activations, its bias (or its BN) as the epilogue at scale 1 (or the BN's
scale), as ``conv_epilogue(conv, None)`` gives RepVGG's deploy convs:
SqueezeNet's eight ``expand3x3`` and AlexNet's three 3x3s.  The others
(the stems, the 1x1 squeezes and expands, SqueezeNet's classifier,
AlexNet's 11x11 and 5x5) are a cuDNN conv without bias + B1.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, draw_masks, \
    fuses
from myconvnet_tpu_torch.models.smallnet import auto_name
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, Dense, dropout, gap,
                                    max_pool, relu)

# (squeeze, expand1x1, expand3x3) per fire module: SqueezeNet 1.1
FIRE_CFG = ((16, 64, 64), (16, 64, 64),
            (32, 128, 128), (32, 128, 128),
            (48, 192, 192), (48, 192, 192),
            (64, 256, 256), (64, 256, 256))


def _pool_same(h: int) -> int:
    return -(-h // 2)


class Fire(nn.Module):
    def __init__(self, cin: int, squeeze: int, e1: int, e3: int):
        super().__init__()
        self.squeeze = Conv(cin, squeeze, 1, bias=True)
        self.expand1x1 = Conv(squeeze, e1, 1, bias=True)
        self.expand3x3 = Conv(squeeze, e3, 3, bias=True)
        self.fused = fuses(self.expand3x3)
        self.out_channels = e1 + e3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = conv_bn_relu(self.squeeze, None, x)
        return torch.cat([conv_bn_relu(self.expand1x1, None, s),
                          conv_bn_relu(self.expand3x3, None, s,
                                       self.fused)], dim=-1)


class SqueezeNet(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> float32 logits [N, num_classes]."""

    def __init__(self, num_classes: int = 1000, *,
                 dropout_rate: float = 0.5,
                 input_hw: tuple[int, int] = (224, 224)):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.stem = nn.Module()
        self.stem.conv = Conv(3, 64, 3, stride=2, bias=True)
        h, w = (_pool_same(_pool_same(v)) for v in input_hw)
        cin, self.fires = 64, []
        for i, cfg in enumerate(FIRE_CFG):
            fire = Fire(cin, *cfg)
            self.add_module(f"fire{i + 2}", fire)
            self.fires.append(fire)
            cin = fire.out_channels
            if i in (1, 3):
                h, w = _pool_same(h), _pool_same(w)
        self.map_shape = (h, w, cin)
        self.classifier = Conv(cin, num_classes, 1, bias=True)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """The keep mask of the dropout over the last fire's map."""
        return draw_masks({"dropout": ((n, *self.map_shape),
                                       self.dropout_rate)}, generator)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The last fire module's map (JAX tags none of this model's maps
        ``features``, so it has no ``features``)."""
        x = max_pool(conv_bn_relu(self.stem.conv, None, x), 3, 2)
        for i, fire in enumerate(self.fires):
            x = fire(x)
            if i in (1, 3):
                x = max_pool(x, 3, 2)
        return x

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        x = dropout(self.trunk(x), self.dropout_rate,
                    train=self.training, generator=generator,
                    mask=None if masks is None else masks.get("dropout"))
        return gap(conv_bn_relu(self.classifier, None, x)).float()


# AlexNet's convs: (features, kernel, stride, pooled after)
ALEXNET_CONVS = ((64, 11, 4, True), (192, 5, 1, True), (384, 3, 1, False),
                 (256, 3, 1, False), (256, 3, 1, True))


def _pool_valid(h: int) -> int:
    return (h - 3) // 2 + 1


class AlexNet(nn.Module):
    """``forward(x, masks=None, generator=None)``: x [N, H, W, 3] in the
    compute dtype -> logits [N, num_classes] in the compute dtype."""

    def __init__(self, num_classes: int = 1000, *, use_bn: bool = True,
                 dropout_rate: float = 0.5, classic_head: bool = True,
                 input_hw: tuple[int, int] = (224, 224)):
        super().__init__()
        self.use_bn, self.dropout_rate = use_bn, dropout_rate
        self.classic_head = classic_head
        h, w = (-(-v // 4) for v in input_hw)   # the 11x11/4 SAME conv
        cin = 3
        for i, (f, k, s, pooled) in enumerate(ALEXNET_CONVS):
            self.add_module(auto_name("conv", i),
                            Conv(cin, f, k, stride=s, bias=not use_bn))
            if use_bn:
                self.add_module(auto_name("bn", i), BatchNorm(f))
            if pooled:
                h, w = _pool_valid(h), _pool_valid(w)
            cin = f
        self.fused = [fuses(self.conv_at(i))
                      for i in range(len(ALEXNET_CONVS))]
        self.width = cin
        if classic_head:
            self.flat_width = h * w * cin
            self.fc1 = Dense(self.flat_width, 4096)
            self.fc2 = Dense(4096, 4096)
            cin = 4096
        self.logits = Dense(cin, num_classes)

    def conv_at(self, i: int) -> Conv:
        return getattr(self, auto_name("conv", i))

    def bn_at(self, i: int) -> BatchNorm | None:
        return getattr(self, auto_name("bn", i)) if self.use_bn else None

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """Keep masks of the head's dropout sites, in forward order."""
        sites = ({"flat": ((n, self.flat_width), self.dropout_rate),
                  "fc1": ((n, 4096), self.dropout_rate)}
                 if self.classic_head
                 else {"gap": ((n, self.width), self.dropout_rate)})
        return draw_masks(sites, generator)

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        masks = masks or {}
        for i, (*_, pooled) in enumerate(ALEXNET_CONVS):
            x = conv_bn_relu(self.conv_at(i), self.bn_at(i), x,
                             self.fused[i])
            if pooled:
                x = max_pool(x, 3, 2, "VALID")

        def drop(v, site):
            return dropout(v, self.dropout_rate, train=self.training,
                           generator=generator, mask=masks.get(site))

        if self.classic_head:
            x = drop(x.reshape(x.shape[0], -1), "flat")
            x = relu(self.fc1(x))
            x = relu(self.fc2(drop(x, "fc1")))
        else:
            x = drop(gap(x), "gap")
        return self.logits(x)


def squeezenet(num_classes: int = 1000, **kwargs) -> SqueezeNet:
    return SqueezeNet(num_classes, **kwargs)


def alexnet(num_classes: int = 1000, **kwargs) -> AlexNet:
    return AlexNet(num_classes, **kwargs)
