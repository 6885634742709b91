"""RepVGG (Ding et al. 2021): structural re-parameterization.

Port of ``myconvnet_tpu/models/repvgg.py``.  The train form
(:class:`RepVGG`, ``repvgg.py:41-78``): each block sums a 3x3
``conv3``/``bn3`` (padding (1, 1) on each side, not SAME: at stride 2
SAME pads (0, 1) and would move the 3x3's centre off the 1x1's grid), a
1x1 ``conv1``/``bn1`` and, where the stride is 1 and the width stays, an
identity BN ``bnid``, then ReLU; stages of ``A_STAGES`` blocks at
``_widths(a, b)``, stride 2 at each stage's first block; gap, optional
dropout (the site ``head``), ``logits``.  The BNs take the layer defaults
(momentum 0.99, eps 1e-3).  Its eval forward is plain ops.

:func:`deploy_params` (``repvgg.py:91-125``) folds each block's three
branches into one 3x3 conv and bias, in float32 as JAX folds them (eps
1e-3): ``s = gamma * rsqrt(var + eps)``, ``w * s`` and ``beta - mean *
s`` a branch, the 1x1 added at the 3x3's centre, the identity as a 3x3
of the unit matrix at its centre.  Its tree feeds the deploy form
:class:`RepVGGDeploy` (``repvgg_deploy``, ``:128-142``; ``DEPLOY_FORWARDS``
by name): a plain stack of 3x3 conv + bias + ReLU.  Its eval routing
(``models/blocks.py``): the stride-1 blocks whose input channels B4
takes are ``conv3x3_bn_relu`` (B4) with scale 1 and the folded bias as
its epilogue on bf16 activations (17 of RepVGG-A0's 22), the stride-2
blocks a cuDNN conv and B1.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.models.blocks import conv_bn_relu, draw_masks, fuses
from myconvnet_tpu_torch.nn import BatchNorm, Conv, Dense, dropout, gap, relu

A_STAGES = (1, 2, 4, 14, 1)
PAD = ((1, 1), (1, 1))


def _widths(a: float, b: float):
    return (min(64, int(64 * a)), int(64 * a), int(128 * a),
            int(256 * a), int(512 * b))


def _blocks(a: float, b: float, stages):
    """(scope, cin, cout, stride) of each block, from 3 input channels."""
    out, cin = [], 3
    for si, (n_blocks, w) in enumerate(zip(stages, _widths(a, b))):
        for bi in range(n_blocks):
            out.append((f"stage{si}_block{bi}", cin, w, 2 if bi == 0 else 1))
            cin = w
    return out


class RepBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv3 = Conv(cin, cout, 3, stride=stride, padding=PAD)
        self.bn3 = BatchNorm(cout)
        self.conv1 = Conv(cin, cout, 1, stride=stride)
        self.bn1 = BatchNorm(cout)
        if stride == 1 and cin == cout:
            self.bnid = BatchNorm(cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn3(self.conv3(x)) + self.bn1(self.conv1(x))
        if hasattr(self, "bnid"):
            out = out + self.bnid(x)
        return relu(out)


class RepVGG(nn.Module):
    """The train form. ``forward(x, masks=None, generator=None)``: x
    [N, H, W, 3] in the compute dtype -> logits in the compute dtype."""

    def __init__(self, num_classes: int = 1000, *, a: float = 0.75,
                 b: float = 2.5, stages=A_STAGES,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.blocks = []
        for scope, cin, cout, stride in _blocks(a, b, stages):
            blk = RepBlock(cin, cout, stride)
            self.add_module(scope, blk)
            self.blocks.append(blk)
        self.head_width = cout
        self.logits = Dense(cout, num_classes)

    def sample_masks(self, n: int, generator: torch.Generator
                     ) -> dict[str, torch.Tensor]:
        """The keep mask of the head's dropout, where its rate is > 0."""
        return draw_masks({"head": ((n, self.head_width),
                                    self.dropout_rate)}, generator)

    def forward(self, x, masks=None, generator=None) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        x = gap(x)
        if self.dropout_rate:
            x = dropout(x, self.dropout_rate, train=self.training,
                        generator=generator,
                        mask=None if masks is None else masks.get("head"))
        return self.logits(x)


class RepVGGDeploy(nn.Module):
    """The deploy form: ``stage{s}_block{b}.conv`` (3x3, bias) -> ReLU,
    gap, ``logits``."""

    def __init__(self, num_classes: int = 1000, *, a: float = 0.75,
                 b: float = 2.5, stages=A_STAGES):
        super().__init__()
        self.convs, self.fused = [], []
        for scope, cin, cout, stride in _blocks(a, b, stages):
            blk = nn.Module()
            blk.conv = Conv(cin, cout, 3, stride=stride, padding=PAD,
                            bias=True)
            self.add_module(scope, blk)
            self.convs.append(blk.conv)
            self.fused.append(fuses(blk.conv))
        self.logits = Dense(cout, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, fused in zip(self.convs, self.fused):
            x = conv_bn_relu(conv, None, x, fused)
        return self.logits(gap(x))


def repvgg_a0(num_classes: int = 1000, **kwargs) -> RepVGG:
    return RepVGG(num_classes, **{"a": 0.75, "b": 2.5, **kwargs})


def repvgg_a1(num_classes: int = 1000, **kwargs) -> RepVGG:
    return RepVGG(num_classes, **{"a": 1.0, "b": 2.5, **kwargs})


def tinyrepvgg(num_classes: int = 1000, **kwargs) -> RepVGG:
    return RepVGG(num_classes, **{"a": 0.125, "b": 0.25,
                                  "stages": (1, 1, 2, 2, 1), **kwargs})


def repvgg_deploy(num_classes: int = 1000, **kwargs) -> RepVGGDeploy:
    return RepVGGDeploy(num_classes, **kwargs)


# name -> the deploy form of the train-time registry name
DEPLOY_FORWARDS = {
    "repvgg_a0": lambda n, **kw: RepVGGDeploy(n, **{"a": 0.75, "b": 2.5,
                                                    **kw}),
    "repvgg_a1": lambda n, **kw: RepVGGDeploy(n, **{"a": 1.0, "b": 2.5,
                                                    **kw}),
    "tinyrepvgg": lambda n, **kw: RepVGGDeploy(
        n, **{"a": 0.125, "b": 0.25, "stages": (1, 1, 2, 2, 1), **kw}),
}


def _fold_branch(w: torch.Tensor, bn: BatchNorm, eps: float):
    """conv(w) -> BN == conv(w', b'): each output channel scaled."""
    s = bn.gamma.float() * torch.rsqrt(bn.moving_var.float() + eps)
    return w * s, bn.beta.float() - bn.moving_mean.float() * s


@torch.no_grad()
def deploy_params(model: RepVGG, *, eps: float = 1e-3
                  ) -> dict[str, dict[str, torch.Tensor]]:
    """The train form's weights folded into the deploy form's, as a
    JAX-layout tree ``{"<block>/conv": {"w": [3, 3, cin, cout], "b":
    [cout]}, "logits": {"w", "b"}}`` of float32 tensors on the model's
    device (``weights.from_jax`` loads it into :class:`RepVGGDeploy`)."""
    out = {}
    for name, blk in model.named_children():
        if not isinstance(blk, RepBlock):
            continue
        if any(bn.folded for bn in (blk.bn3, blk.bn1)):
            raise ValueError(f"{name}: a folded BN has no branch to fold")
        w, bias = _fold_branch(blk.conv3.w.float(), blk.bn3, eps)
        w1, b1 = _fold_branch(blk.conv1.w.float(), blk.bn1, eps)
        w = w.clone()
        w[1:2, 1:2] += w1
        bias = bias + b1
        if hasattr(blk, "bnid"):
            cin = w.shape[2]
            wid = torch.zeros((3, 3, cin, cin), device=w.device)
            wid[1, 1] = torch.eye(cin, device=w.device)
            widf, bid = _fold_branch(wid, blk.bnid, eps)
            w = w + widf
            bias = bias + bid
        out[f"{name}/conv"] = {"w": w, "b": bias}
    out["logits"] = {"w": model.logits.weight.detach().float().t(),
                     "b": model.logits.bias.detach().float()}
    return out


def deploy_model(model: RepVGG, name: str, num_classes: int,
                 **kwargs) -> RepVGGDeploy:
    """:data:`DEPLOY_FORWARDS` ``[name]`` with :func:`deploy_params` of
    ``model`` loaded, on ``model``'s device, in eval mode."""
    from myconvnet_tpu_torch.weights import from_jax

    tree = {s: {k: v.cpu().numpy() for k, v in d.items()}
            for s, d in deploy_params(model).items()}
    dep = DEPLOY_FORWARDS[name](num_classes, **kwargs)
    from_jax(dep, tree, {})
    return dep.to(model.logits.weight.device).eval()
