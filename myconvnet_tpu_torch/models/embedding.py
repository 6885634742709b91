"""Embedding networks for metric learning.

Port of ``myconvnet_tpu/models/embedding.py``.  :class:`EmbeddingNet`
wraps any classifier of the registry as its ``backbone`` (JAX scope
``backbone``), built with ``num_classes=embed_dim`` so that its head gives
the raw embedding, which is L2-normalized in float32.  In train mode the
margin heads ("arcface", "cosface") return the float32 cosines
``emb @ l2_normalize(w, axis=0)`` against the class weights ``w`` [D, C]
(scope ``margin_head``; a plain ``torch.matmul``, as JAX computes it
outside any kernel); the margin itself is applied in the loss
(``train/metric_losses.py``).  In eval mode, and under the "triplet" head
(no class weights at all), the model returns the unit-norm embedding:
what retrieval, ``ConvNet.predict`` and the ``embed`` route consume.  The
backbone's own eval routing (``models/blocks.py``) is untouched, so its
B1, B4 and B5 sites run as in the classifier.
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch.core.init import glorot_uniform

HEADS = ("arcface", "cosface", "triplet")


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(sum(x²) + eps) along ``dim``, computed in float32 and
    returned in x's dtype."""
    xf = x.float()
    n = torch.sqrt(xf.square().sum(dim=dim, keepdim=True) + eps)
    return (xf / n).to(x.dtype)


class MarginHead(nn.Module):
    """The class-weight matrix ``w`` [embed_dim, classes], Glorot-uniform."""

    def __init__(self, embed_dim: int, num_classes: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(embed_dim, num_classes))

    def init_own_params(self, generator: torch.Generator) -> None:
        self.w.copy_(glorot_uniform()(tuple(self.w.shape), generator))


class EmbeddingNet(nn.Module):
    """``forward(x, masks=None)``: [N, H, W, 3] -> cosines [N, classes]
    (train mode, margin heads) or unit-norm embeddings [N, embed_dim]."""

    def __init__(self, num_classes: int = 1000, *, backbone: str = "resnet50",
                 embed_dim: int = 512, head: str = "arcface",
                 backbone_kwargs: dict | None = None,
                 input_hw: tuple[int, int] | None = None):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}; valid: {HEADS}")
        from myconvnet_tpu_torch import models  # the registry imports this
        self.head = head
        self.embed_dim = embed_dim
        self.backbone = models.get_model(backbone, embed_dim,
                                         input_hw=input_hw,
                                         **(backbone_kwargs or {}))
        if head != "triplet":
            self.margin_head = MarginHead(embed_dim, num_classes)
        if hasattr(self.backbone, "sample_masks"):
            self.sample_masks = self.backbone.sample_masks

    def embedding(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        """The unit-norm embedding (JAX's tag ``embedding``)."""
        raw = self.backbone(x) if masks is None else self.backbone(x, masks)
        return l2_normalize(raw)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The backbone's map tagged ``features`` (before its pooling)."""
        return self.backbone.features(x)

    def forward(self, x: torch.Tensor, masks=None) -> torch.Tensor:
        emb = self.embedding(x, masks)
        if self.head == "triplet" or not self.training:
            return emb
        return emb.float() @ l2_normalize(self.margin_head.w.float(), dim=0)


def embedding_net(num_classes: int = 1000, **kwargs) -> EmbeddingNet:
    return EmbeddingNet(num_classes, **kwargs)


def tinyembed(num_classes: int = 8, *, head: str = "arcface",
              embed_dim: int = 32, input_hw=None) -> EmbeddingNet:
    """The CPU-scale variant: a SmallNet trunk at width 8, 32-d."""
    return EmbeddingNet(num_classes, backbone="smallnet",
                        embed_dim=embed_dim, head=head,
                        backbone_kwargs={"width": 8}, input_hw=input_hw)
