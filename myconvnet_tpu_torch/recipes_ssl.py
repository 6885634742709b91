"""The self-supervised recipes (``task="ssl"``: ``configs/cifar10_mae.py``,
``configs/imagenet_mae_vit_b16.py``, ``configs/cifar10_simclr.py``,
``configs/imagenet_simclr_resnet50.py``) wired without the JAX package.

Port of ``myconvnet_tpu/recipes/representation.build_ssl`` (``:21-134``):

* ``ssl_kind="mae"``: an ``SSL_MODELS`` entry built at the view's size;
  its view is ``augment_train`` of the recipe's ``augment`` block.
* ``ssl_kind="simclr"``: any port classifier with a ``features`` method
  as the backbone (its 1-class head stays in the tree, unused, so that
  checkpoints cross with JAX's, where it is dead code), global average
  pooling where the features are 4-D, then ``projector/fc1`` (ReLU, width
  ``proj_hidden`` or the features') and ``projector/fc2`` (no bias) to
  ``proj_dim``.  Its view runs the augmentation on [0, 1] (mean 0, std
  1), turns an image gray with probability ``grayscale_prob``
  (``augment._rgb_to_gray``) and normalizes last, so that the grayscale
  sees real RGB.
* The probe's features: ``augment_eval`` (B2 at the model's size), then
  the eval-mode features forward.
* ``mesh=dict(data=None)`` (the MAE-B16 and ImageNet SimCLR recipes) is
  data-parallel over every device, which on one card is the plain step:
  accepted.  Any other mesh is refused by name (ROADMAP A16).
"""

from __future__ import annotations

import inspect

import torch
from torch import nn

from myconvnet_tpu_torch import models
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.core.precision import apply_backend_flags, \
    get_policy
from myconvnet_tpu_torch.data.augment import (_rgb_to_gray, augment_eval,
                                              augment_train, config_jitter,
                                              normalize, sample_geometry,
                                              sample_policy, stats)
from myconvnet_tpu_torch.data.pipeline import DataSet
from myconvnet_tpu_torch.nn import Dense, gap
from myconvnet_tpu_torch.recipes import make_augment, make_optimizer, \
    make_sources
from myconvnet_tpu_torch.train.ssl import KINDS, SSLTrainer, ViewFns


def check_mesh(cfg: dict) -> None:
    """Accept no mesh or ``dict(data=None)`` (every device on the data
    axis: one card's plain step); refuse any other by name."""
    mesh = cfg.get("mesh")
    if mesh is None or (isinstance(mesh, dict)
                        and mesh.get("data") is None
                        and int(mesh.get("model", 1)) == 1
                        and set(mesh) <= {"data", "model"}):
        return
    raise ValueError(f"recipe key 'mesh' = {mesh!r} is not ported (the "
                     "port runs on one device: only mesh=dict(data=None) "
                     "is accepted; ROADMAP A16)")


class Projector(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, out, bias=False)

    def forward(self, h):
        return self.fc2(torch.relu(self.fc1(h)))


class SimCLRNet(nn.Module):
    """A backbone's modules at the root (its scopes as the classifier's,
    as JAX runs the zoo model at the root scope) and ``projector``."""

    def __init__(self, backbone: nn.Module, feature_dim: int, proj_dim: int,
                 proj_hidden: int | None = None):
        super().__init__()
        for name, child in backbone.named_children():
            self.add_module(name, child)
        for name, p in backbone.named_parameters(recurse=False):
            self.register_parameter(name, p)
        object.__setattr__(self, "backbone", backbone)
        self.projector = Projector(feature_dim, proj_hidden or feature_dim,
                                   proj_dim)
        if hasattr(backbone, "sample_masks") and _takes_masks(backbone):
            self.sample_masks = backbone.sample_masks

    def train(self, mode: bool = True):
        super().train(mode)
        self.backbone.training = mode
        return self

    def forward(self, x, masks=None, features_only: bool = False):
        h = (self.backbone.features(x) if masks is None
             else self.backbone.features(x, masks))
        if h.dim() == 4:
            h = gap(h)
        return h if features_only else self.projector(h)


def _takes_masks(backbone: nn.Module) -> bool:
    return "masks" in inspect.signature(backbone.features).parameters


def simclr_model(cfg: dict, hw: tuple[int, int]) -> SimCLRNet:
    name = cfg["model"]
    backbone = models.get_model(name, 1, input_hw=hw,
                                **dict(cfg.get("model_kwargs", {})))
    if not hasattr(backbone, "features"):
        raise ValueError(f"model {name!r} has no 'features' (the JAX "
                         "backbone must tag one)")
    with torch.no_grad():   # the features' width, from a probe forward
        h = backbone.eval().features(torch.zeros(1, *hw, 3))
    return SimCLRNet(backbone, h.shape[-1], cfg.get("proj_dim", 128),
                     cfg.get("proj_hidden"))


def augment_views(aug, device, *, gray_prob: float | None = None) -> ViewFns:
    """``augment_train`` of ``aug`` as a view; with ``gray_prob`` (SimCLR)
    on [0, 1] with a random grayscale before the normalize."""
    mean_std = stats(aug, device)
    raw = aug if gray_prob is None else aug._replace(
        mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
    raw_stats = mean_std if gray_prob is None else stats(raw, device)

    def sample(generator, n, hw):
        boxes, flip = sample_geometry(generator, n, hw, aug)
        draws = (boxes, flip, sample_policy(generator, n, aug),
                 config_jitter(generator, n, aug))
        if gray_prob is None:
            return draws
        gray = torch.rand(n, generator=generator,
                          device=generator.device) < gray_prob
        return (*draws, gray)

    def apply(x_u8, draws):
        boxes, flip, policy, jitter = draws[:4]
        x = augment_train(x_u8, boxes, flip, raw, raw_stats, policy, jitter)
        if gray_prob is None:
            return x
        if gray_prob > 0.0:
            sel = draws[4].to(x.device).reshape(-1, 1, 1, 1)
            x = torch.where(sel, _rgb_to_gray(x), x)
        return normalize(x, aug.mean, aug.std).to(x.dtype)

    def eval_input(x_u8):
        return augment_eval(x_u8, aug, mean_std)

    return ViewFns(sample, apply, eval_input)


def build_ssl(cfg: dict, synthetic: bool = False, *,
              device: torch.device) -> tuple[SSLTrainer, DataSet, DataSet]:
    """(trainer, train set, val set) of a self-supervised recipe: the
    model from ``cfg["seed"]``, its optimizer, its view, the recipe's
    splits (the labels reach only the probe)."""
    check_mesh(cfg)
    kind = cfg.get("ssl_kind", "simclr")
    if kind not in KINDS:
        raise ValueError(f"unknown ssl_kind {kind!r}; valid: {list(KINDS)}")
    aug = make_augment(cfg.get("augment"))
    if aug is None:
        raise ValueError("ssl configs need an 'augment' entry (the view "
                         "distribution is the method)")
    hw = tuple(aug.out_hw)
    if kind == "mae":
        if cfg["model"] not in models.SSL_MODELS:
            raise ValueError(f"ssl_kind='mae' needs an SSL_MODELS entry; "
                             f"valid: {sorted(models.SSL_MODELS)}")
        model = models.SSL_MODELS[cfg["model"]](
            input_hw=hw, **dict(cfg.get("model_kwargs", {})))
        views = augment_views(aug, device)
    else:
        model = simclr_model(cfg, hw)
        views = augment_views(aug, device,
                              gray_prob=float(cfg.get("grayscale_prob",
                                                      0.2)))
    seed = cfg.get("seed", 0)
    init_model(model, torch.Generator().manual_seed(seed))
    policy = get_policy(cfg.get("precision", "f32"))
    apply_backend_flags(policy)
    model.to(device)
    trainer = SSLTrainer(kind, model, make_optimizer(model, cfg["optimizer"]),
                         views, device=device, policy=policy, seed=seed,
                         temperature=cfg.get("temperature", 0.5))
    train_src, val_src = make_sources(cfg, synthetic)
    return trainer, DataSet(train_src, seed=seed), DataSet(val_src)
