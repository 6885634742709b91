"""Recipe configs (``configs/*.py``) read and wired without the JAX package.

Port of ``myconvnet_tpu/recipes``: ``load_config`` and ``apply_overrides``
(``common.py``), ``make_optimizer`` (``common.py:68-121``: SGD, momentum,
Adam, AdamW with ``clip_norm``, wrapped by ``plateau``, ``freeze``,
``lookahead`` and ``ema_decay``), ``make_augment`` (``:124``),
``make_sources`` (``:131-163``: CIFAR-10 and CIFAR-100, SVHN, MNIST and
Fashion-MNIST, the synthetic ImageNet split at the recipe's ``raw_hw``,
and the flow corpus), ``apply_pretrained`` (``:247-275``, the ``.npz``
and torchvision ``.pth`` forms), and the ``ConvNet`` builders of ``registry.convnet_builder``
(``registry.py:21``): ``build_classifier`` (``vision.py:23-65``, with the
focal loss, random erasing and SAM), ``build_segmenter``
(``vision.py:68-106``, with the VOC source and the mIoU evaluator of
``common.py:200-202``), ``build_flow`` (``perception.py:284-398``),
``build_depth`` (``perception.py:201-281``: the DispNet on a ResNet-18, the
scale-invariant log loss, the paired flip and the RGB-only jitter, the Eigen
evaluator of ``common.py:178-183``) and ``build_metric``
(``vision.py:109-172``: an ``EMBEDDING_MODELS`` net with
the ArcFace, CosFace or batch-hard triplet loss, PK batches, and the
retrieval evaluator of ``common.py:194-196``).  A recipe with a
``pipeline`` block (GPipe, ``train.py:112-122``) is refused by name
(ROADMAP A16), since the port has no staged model to train it as JAX
does.
:func:`build_trainer` is the built net's trainer, as a fresh run starts
it.  Also the mean/std resolution of ``serving_http.build_route``
(``:134-145``): a recipe's ``augment`` block may set ``mean``/``std``, and
otherwise the ImageNet statistics of ``AugmentConfig`` apply.
"""

from __future__ import annotations

import ast
import functools
import importlib.util
import json
from typing import NamedTuple

import numpy as np
import torch

from myconvnet_tpu_torch import models
from myconvnet_tpu_torch.data.augment import (IMAGENET_MEAN, IMAGENET_STD,
                                              AugmentConfig, JitterDraws,
                                              color_jitter, sample_jitter)
from myconvnet_tpu_torch.data.mix import MixConfig
from myconvnet_tpu_torch.data.pipeline import DataSet
from myconvnet_tpu_torch.eval.evaluators import (AccuracyEvaluator,
                                                 Evaluator, MeanIoUEvaluator)
from myconvnet_tpu_torch.eval.flow import FlowEvaluator
from myconvnet_tpu_torch.eval.retrieval import RetrievalEvaluator
from myconvnet_tpu_torch.subsets import (cifar10, cifar100, imagenet, mnist,
                                         svhn, voc)
from myconvnet_tpu_torch.subsets import flow as flow_mod
from myconvnet_tpu_torch.train import optim
from myconvnet_tpu_torch.models.base import ConvNet
from myconvnet_tpu_torch.train.metric_losses import (arcface_loss,
                                                     batch_hard_triplet_loss,
                                                     cosface_loss)
from myconvnet_tpu_torch.train.losses import (ce_dice_loss, dice_loss,
                                              epe_loss, focal_loss,
                                              multiscale_epe_loss,
                                              pixel_cross_entropy,
                                              silog_loss,
                                              softmax_cross_entropy,
                                              unsupervised_flow_loss)
from myconvnet_tpu_torch.ops.kernels.normalize_u8 import normalize_u8
from myconvnet_tpu_torch.train.trainer import InputFns, Trainer
from myconvnet_tpu_torch.weights import param_views


def load_config(path: str) -> dict:
    """A recipe: a .py module exposing ``config``, or the .json dump that
    the train entry point writes next to its checkpoints."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    spec = importlib.util.spec_from_file_location("_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return dict(mod.config)


def apply_overrides(cfg: dict, pairs) -> dict:
    """``KEY=VALUE`` overrides (``--set``): values parse as Python
    literals, else stay strings; dotted keys reach nested dicts
    (``--set model_kwargs.width=8``)."""
    for pair in pairs or []:
        key, sep, raw = pair.partition("=")
        if not sep or not key:
            raise ValueError(f"--set wants KEY=VALUE, got {pair!r}")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        tgt = cfg
        parts = key.split(".")
        for seg in parts[:-1]:
            nxt = tgt.get(seg)
            if not isinstance(nxt, dict):
                nxt = tgt[seg] = {}
            tgt = nxt
        tgt[parts[-1]] = val
    return cfg


def normalization(cfg: dict | None, channels: int = 3
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(mean, std) float32 [channels] that the served model expects."""
    aug = (cfg or {}).get("augment") or {}
    mean = np.asarray(aug.get("mean", IMAGENET_MEAN), np.float32)
    std = np.asarray(aug.get("std", IMAGENET_STD), np.float32)
    if mean.ndim and mean.shape[0] != channels:
        mean = np.full((channels,), float(mean.mean()), np.float32)
        std = np.full((channels,), float(std.mean()), np.float32)
    return mean, std


def make_augment(aug_cfg: dict | None) -> AugmentConfig | None:
    if aug_cfg is None:
        return None
    return AugmentConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in aug_cfg.items()})


# The JAX ConvNet also reads remat, chain_steps and zero_sharding; they
# change how its step runs (rematerialisation, steps chained in one jit
# call, ZeRO sharding over a mesh), not one number it computes, so the
# port accepts and ignores them.


def make_optimizer(model: torch.nn.Module, opt_cfg: dict):
    """The recipe's optimizer over ``model``'s parameters (by JAX path),
    composed as ``recipes/common.py:68-121``: the base optimizer (its
    clip inside its step), then ``plateau``, ``freeze``, ``lookahead``
    and ``ema_decay`` outward; ``freeze`` also joins the base's
    weight-decay exclusion, so frozen leaves feed no decay into the
    moments."""
    opt_cfg = dict(opt_cfg)
    name = opt_cfg.pop("name")
    lr = opt_cfg.pop("lr")
    if isinstance(lr, dict):
        lr = optim.make_schedule(lr)
    if opt_cfg.pop("wd_exclude_norms", False):
        opt_cfg["weight_decay_exclude"] = optim.norm_and_bias_exclusion
    ema_decay = opt_cfg.pop("ema_decay", None)
    plateau = opt_cfg.pop("plateau", False)
    lookahead = opt_cfg.pop("lookahead", None)
    freeze = opt_cfg.pop("freeze", None)
    if freeze is not None:
        frozen = optim.as_frozen_predicate(freeze)
        prev = opt_cfg.get("weight_decay_exclude")

        def exclude(path, p, _prev=prev, _frozen=frozen):
            return _frozen(path, p) or (_prev is not None
                                        and _prev(path, p))

        opt_cfg["weight_decay_exclude"] = exclude
    opt = optim.make_optimizer(param_views(model), name, lr, **opt_cfg)
    if plateau:
        opt = optim.Plateau(opt)
    if freeze:
        opt = optim.Frozen(opt, freeze)
    if lookahead:
        # True: the paper's defaults; an int: the sync period; a dict:
        # the keyword arguments
        kw = (dict(lookahead) if isinstance(lookahead, dict) else {}
              if lookahead is True else dict(sync_period=int(lookahead)))
        opt = optim.Lookahead(opt, **kw)
    if ema_decay:
        opt = optim.Ema(opt, float(ema_decay))
    return opt


def optimizer_factory(opt_cfg: dict):
    """``model -> optimizer`` for :class:`ConvNet.build`: the recipe's
    optimizer, made over whatever model the net builds."""
    return functools.partial(make_optimizer, opt_cfg=opt_cfg)


def split_name(dataset: str, split: str) -> str:
    """The split a source reads: "val" is "test" for CIFAR, (Fashion-)MNIST
    and SVHN, whose corpora have no other held-out split
    (``common.py:143-146``)."""
    if split == "val" and (dataset.startswith("cifar")
                           or dataset.endswith("mnist")
                           or dataset == "svhn"):
        return "test"
    return split


def make_sources(cfg: dict, synthetic: bool, splits=("train", "val")):
    """One source per split (see :func:`split_name`); a Fashion-MNIST
    source carries its ``class_names``; ``synthetic_n`` sizes a rendered
    split (each subset's default otherwise).  The flow corpus at the recipe's
    ``input_hw`` (``synthetic_n`` scenes with motions up to
    ``max_motion`` when it is rendered)."""
    table = {"cifar10": cifar10, "cifar100": cifar100, "svhn": svhn,
             "mnist": mnist, "fashion_mnist": mnist, "imagenet": imagenet,
             "voc": voc, "flow": flow_mod}
    name = cfg["dataset"]
    if name not in table:
        raise ValueError(f"the port has datasets {sorted(table)}, not "
                         f"{name!r}")
    data_dir = cfg.get("data_dir")
    if name == "flow":
        return [flow_mod.make_source(
            data_dir, split, synthetic=synthetic or data_dir is None,
            synthetic_n=cfg.get("synthetic_n", 256),
            hw=tuple(cfg.get("input_hw", flow_mod.DEFAULT_HW)),
            max_motion=cfg.get("max_motion", 8)) for split in splits]
    kw = {}
    if name == "imagenet" and cfg.get("raw_hw") is not None:
        kw["raw_hw"] = tuple(cfg["raw_hw"])
    if cfg.get("synthetic_n") is not None:
        # the rendered split's size (the JAX recipes keep each module's
        # default): a batch larger than the default split needs it
        kw["synthetic_n"] = int(cfg["synthetic_n"])
    out = []
    for split in splits:
        src = table[name].make_source(
            data_dir, split_name(name, split),
            synthetic=synthetic or data_dir is None, **kw)
        if name == "fashion_mnist":
            src.class_names = mnist.FASHION_CLASS_NAMES
        out.append(src)
    return out


def build_evaluator(cfg: dict) -> Evaluator:
    task = cfg["task"]
    if task == "classification":
        return AccuracyEvaluator()
    if task == "flow":
        return FlowEvaluator(cfg.get("flow_metric", "epe"))
    if task == "segmentation":
        return MeanIoUEvaluator(cfg["num_classes"],
                                cfg.get("ignore_label", 255))
    if task == "metric":
        return RetrievalEvaluator(cfg.get("recall_k", 1))
    if task == "depth":
        from myconvnet_tpu_torch.eval.depth import DepthEvaluator
        return DepthEvaluator(
            metric=cfg.get("depth_metric", "absrel"),
            min_depth=cfg.get("eval_min_depth", 1e-3),
            max_depth=cfg.get("eval_max_depth", np.inf),
            median_scaling=cfg.get("median_scaling", False))
    if task == "detection":
        from myconvnet_tpu_torch.recipes_detection import \
            detection_evaluator
        return detection_evaluator(cfg)
    raise ValueError(f"the port has the classification, segmentation, "
                     f"flow, metric, depth and detection tasks' "
                     f"evaluators, not {task!r}'s")


def build_classifier(cfg: dict, synthetic: bool = False, *,
                     device: torch.device, ckpt_dir: str | None = None,
                     log_dir: str | None = None
                     ) -> tuple[ConvNet, DataSet, DataSet]:
    """(net, train set, val set) for a classification recipe
    (``vision.py:23-65``): the model from ``cfg["seed"]``, softmax CE
    with the recipe's label smoothing or the focal loss, its
    augmentation, MixUp/CutMix, random erasing and SAM."""
    smoothing = cfg.get("label_smoothing", 0.0)
    kind = cfg.get("cls_loss", "ce")
    if kind == "focal":
        if cfg.get("mix") is not None:
            raise ValueError("cls_loss='focal' needs integer labels; "
                             "remove the 'mix' (MixUp/CutMix) entry")
        if smoothing:
            raise ValueError("cls_loss='focal' does not support "
                             "label_smoothing; remove one of the two")
        gamma = cfg.get("focal_gamma", 2.0)

        def loss(logits, y):
            return focal_loss(logits, y, gamma=gamma)
    elif kind == "ce":
        def loss(logits, y):
            return softmax_cross_entropy(logits, y,
                                         label_smoothing=smoothing)
    else:
        raise ValueError(f"unknown cls_loss {kind!r}; valid: ['ce', "
                         "'focal']")
    augment = make_augment(cfg.get("augment"))
    mix = MixConfig(**cfg["mix"]) if cfg.get("mix") is not None else None
    net = ConvNet(functools.partial(models.get_model, cfg["model"],
                                    input_hw=cfg.get("input_hw")),
                  input_shape=(*cfg["input_hw"], 3),
                  num_classes=cfg["num_classes"],
                  precision=cfg.get("precision", "f32"), loss_fn=loss,
                  augment=augment, mix=mix,
                  erase_prob=cfg.get("erase_prob", 0.0),
                  sam_rho=cfg.get("sam_rho", 0.0), seed=cfg.get("seed", 0),
                  accum_steps=cfg.get("accum_steps", 1),
                  accum_dtype=cfg.get("accum_dtype", "float32"),
                  ckpt_dir=ckpt_dir, log_dir=log_dir,
                  log_every=cfg.get("log_every", 50), device=device,
                  **cfg.get("model_kwargs", {}))
    train_src, val_src = make_sources(cfg, synthetic)
    # the batch order's seed is DataSet's default 0, as in the JAX recipe
    return net, DataSet(train_src, augment), DataSet(val_src, augment)


# the recipe key ``seg_loss`` (vision.py:73-84)
SEG_LOSSES = {"ce": pixel_cross_entropy, "dice": dice_loss,
              "ce_dice": ce_dice_loss, "focal": focal_loss}
# ``spatial`` (image rows sharded over the mesh's model axis,
# vision.py:103) changes how the step runs, not what it computes, as
# remat, chain_steps and zero_sharding do: accepted and ignored


def build_segmenter(cfg: dict, synthetic: bool = False, *,
                    device: torch.device, ckpt_dir: str | None = None,
                    log_dir: str | None = None
                    ) -> tuple[ConvNet, DataSet, DataSet]:
    """(net, train set, val set) for a segmentation recipe: the
    :func:`segmenter_net` of its ``augment`` block, at 96 x 96 for a
    synthetic run (as JAX shrinks it), and its VOC splits."""
    aug = make_augment(cfg.get("augment"))
    if aug is None:
        raise ValueError(
            "segmentation configs need an 'augment' entry (out_hw sets "
            "the training crop/input resolution)")
    if synthetic or cfg.get("data_dir") is None:
        # the synthetic masks are small: the JAX recipe shrinks the
        # resolution (vision.py:89-92)
        aug = aug._replace(out_hw=(96, 96))
    net = segmenter_net(cfg, aug, device, ckpt_dir=ckpt_dir,
                        log_dir=log_dir)
    train_src, val_src = make_sources(cfg, synthetic)
    return net, DataSet(train_src), DataSet(val_src)


def segmenter_net(cfg: dict, aug: AugmentConfig, device: torch.device,
                  *, ckpt_dir: str | None = None,
                  log_dir: str | None = None) -> ConvNet:
    """A segmentation recipe's net for the paired input chain ``aug``
    (its ``out_hw`` the crop the model is built for): the recipe's
    ``seg_loss`` (per-pixel CE, Dice, CE + Dice or focal with
    ``focal_gamma``) with its ignore label."""
    kind = cfg.get("seg_loss", "ce")
    if kind not in SEG_LOSSES:
        raise ValueError(f"unknown seg_loss {kind!r}; valid: "
                         f"{sorted(SEG_LOSSES)}")
    ignore = cfg.get("ignore_label", 255)
    extra = ({"gamma": cfg.get("focal_gamma", 2.0)} if kind == "focal"
             else {})

    def loss(logits, y, _fn=SEG_LOSSES[kind]):
        return _fn(logits, y, ignore_label=ignore, **extra)

    return ConvNet(functools.partial(models.get_model, cfg["model"],
                                     input_hw=aug.out_hw),
                   input_shape=(*aug.out_hw, 3),
                   num_classes=cfg["num_classes"],
                   precision=cfg.get("precision", "f32"), loss_fn=loss,
                   augment=aug, paired_targets=True,
                   seed=cfg.get("seed", 0),
                   accum_steps=cfg.get("accum_steps", 1),
                   accum_dtype=cfg.get("accum_dtype", "float32"),
                   ckpt_dir=ckpt_dir, log_dir=log_dir,
                   log_every=cfg.get("log_every", 50), device=device,
                   **cfg.get("model_kwargs", {}))


def segmenter_trainer(cfg: dict, aug: AugmentConfig, device: torch.device,
                      *, ckpt_dir: str | None = None,
                      log_dir: str | None = None) -> Trainer:
    """The trainer of :func:`segmenter_net`, built with the recipe's
    optimizer and the mIoU evaluator (a run at a crop of its own)."""
    net = segmenter_net(cfg, aug, device, ckpt_dir=ckpt_dir,
                        log_dir=log_dir)
    net.build(optimizer_factory(cfg["optimizer"]))
    net.trainer.evaluator = build_evaluator(cfg)
    return net.trainer


class FlowDraws(NamedTuple):
    """One flow train step's draws: the paired flip [N] bool and the
    colour-jitter factors both frames share."""
    flip: torch.Tensor
    jitter: JitterDraws | None


def flow_input_fns(brightness: float, contrast: float, *,
                   unsupervised: bool = False, occlusion: bool = False
                   ) -> InputFns:
    """The flow recipes' input chain over ``[N, H, W, 6]`` uint8 frame
    pairs and ``[N, H, W, 2]`` pixel flows (``perception.py:313-344``):
    x / 255; a paired horizontal flip that mirrors both frames and the
    flow and negates u; the SAME jitter factors on both frames (brightness
    constancy is what the matching learns), then a clip to [0, 1].  The
    unsupervised objective's target is the augmented pair itself; with
    ``occlusion`` the swapped pairs are stacked below the forward pairs."""
    def norm(x_u8):
        return x_u8.float() / 255.0

    def sample(generator, n, hw=None):
        flip = torch.rand(n, generator=generator,
                          device=generator.device) < 0.5
        return FlowDraws(flip, sample_jitter(generator, n,
                                             brightness=brightness,
                                             contrast=contrast))

    def jitter(x, draws):
        f1 = color_jitter(x[..., :3], draws)
        f2 = color_jitter(x[..., 3:], draws)
        return torch.cat([f1, f2], dim=-1).clamp(0.0, 1.0)

    def train(x_u8, y, draws):
        x = norm(x_u8)
        flip = draws.flip.to(x.device).reshape(-1, 1, 1, 1)
        x = torch.where(flip, x.flip(2), x)
        xa = jitter(x, draws.jitter)
        if unsupervised:
            if occlusion:
                swapped = torch.cat([xa[..., 3:], xa[..., :3]], dim=-1)
                return torch.cat([xa, swapped], dim=0), xa
            return xa, xa
        y_f = torch.cat([-y[..., :1], y[..., 1:]], dim=-1)
        return xa, torch.where(flip, y_f.flip(2), y)

    return InputFns(sample, train, norm)


def flow_loss_fn(cfg: dict, multiscale: bool):
    """The recipe's loss: unsupervised photometric + smoothness, the
    multi-scale EPE of a coarse-to-fine net, or the plain EPE."""
    eps = cfg.get("epe_eps", 1e-3)
    unsup = bool(cfg.get("unsupervised", False))
    occ = bool(cfg.get("occlusion", False))
    if occ and not unsup:
        raise ValueError("occlusion=True is the bidirectional "
                         "unsupervised objective; set unsupervised=True")
    if unsup:
        return lambda pred, y: unsupervised_flow_loss(
            pred, y, smooth_weight=cfg.get("smooth_weight", 0.05),
            edge_sharpness=cfg.get("edge_sharpness", 50.0), eps=eps,
            occlusion=occ, occ_alpha1=cfg.get("occ_alpha1", 0.01),
            occ_alpha2=cfg.get("occ_alpha2", 0.5))
    if multiscale:
        ms_w = cfg.get("flow_loss_weights")
        return lambda pred, y: multiscale_epe_loss(pred, y, weights=ms_w,
                                                   eps=eps)
    return lambda pred, y: epe_loss(pred, y, eps=eps)


def build_flow(cfg: dict, synthetic: bool = False, *,
               device: torch.device, ckpt_dir: str | None = None,
               log_dir: str | None = None
               ) -> tuple[ConvNet, DataSet, DataSet]:
    """(net, train set, val set) for an optical-flow recipe
    (``perception.py:284-398``): the model from ``cfg["seed"]`` (zero
    flow heads), the recipe's input chain and loss, no accuracy
    metric."""
    name = cfg.get("model", "flownet_s")
    fn = models.FLOW_MODELS.get(name)
    if fn is None:
        raise ValueError(f"unknown flow model {name!r}; valid: "
                         f"{sorted(models.FLOW_MODELS)}")
    hw = tuple(cfg.get("input_hw", flow_mod.DEFAULT_HW))
    unsup = bool(cfg.get("unsupervised", False))
    loss = flow_loss_fn(cfg, getattr(fn, "multiscale", False))
    fns = flow_input_fns(float(cfg.get("aug_brightness", 0.2)),
                         float(cfg.get("aug_contrast", 0.2)),
                         unsupervised=unsup,
                         occlusion=bool(cfg.get("occlusion", False)))
    net = ConvNet(fn, input_shape=(*hw, 6), num_classes=0,
                  precision=cfg.get("precision", "f32"), loss_fn=loss,
                  input_fns=fns, accuracy_metric=False,
                  accum_steps=cfg.get("accum_steps", 1),
                  seed=cfg.get("seed", 0), ckpt_dir=ckpt_dir,
                  log_dir=log_dir, log_every=cfg.get("log_every", 50),
                  device=device, **dict(cfg.get("model_kwargs", {})))
    train_src, val_src = make_sources(cfg, synthetic)
    return (net, DataSet(train_src, seed=cfg.get("seed", 0)),
            DataSet(val_src))


class DepthDraws(NamedTuple):
    """One depth train step's draws: the paired flip [N] bool and the
    colour-jitter factors."""
    flip: torch.Tensor
    jitter: JitterDraws | None


def depth_input_fns(brightness: float, contrast: float) -> InputFns:
    """The depth recipe's input chain over uint8 frames and [N, H, W, 1]
    metres (``perception.py:234-251``): x / 255 (B2 at mean 0 and std 1,
    as the GAN steps rescale), a flip of frame and depth together, the
    jitter on the frame alone, a clip to [0, 1]; x / 255 alone in eval."""
    def unit(x_u8):
        c = x_u8.shape[-1]
        return normalize_u8(x_u8.contiguous(), [0.0] * c, [1.0] * c)

    def sample(generator, n, hw=None):
        flip = torch.rand(n, generator=generator,
                          device=generator.device) < 0.5
        return DepthDraws(flip, sample_jitter(generator, n,
                                              brightness=brightness,
                                              contrast=contrast))

    def train(x_u8, y, draws):
        x = unit(x_u8)
        flip = draws.flip.to(x.device).reshape(-1, 1, 1, 1)
        x = torch.where(flip, x.flip(2), x)
        y = torch.where(flip, y.flip(2), y)
        return color_jitter(x, draws.jitter).clamp(0.0, 1.0), y

    return InputFns(sample, train, unit)


def depth_model_kwargs(cfg: dict) -> dict:
    """The depth model's keywords: ``model_kwargs`` with the recipe's
    ``min_depth`` and ``max_depth`` (0.1 and 10 m by default)."""
    mkw = dict(cfg.get("model_kwargs", {}))
    mkw.setdefault("min_depth", float(cfg.get("min_depth", 0.1)))
    mkw.setdefault("max_depth", float(cfg.get("max_depth", 10.0)))
    return mkw


def build_depth(cfg: dict, synthetic: bool = False, *,
                device: torch.device, ckpt_dir: str | None = None,
                log_dir: str | None = None
                ) -> tuple[ConvNet, DataSet, DataSet]:
    """(net, train set, val set) of a monocular-depth recipe
    (``perception.py:201-281``): a ``DEPTH_MODELS`` net with the recipe's
    depth range, the scale-invariant log loss (``silog_lambda``), the
    flip + jitter chain, no accuracy metric; the depth pairs at
    ``input_hw``."""
    from myconvnet_tpu_torch.models.depth import DEPTH_MODELS
    from myconvnet_tpu_torch.subsets import depth as depth_mod
    name = cfg.get("model", "depth_unet")
    if name not in DEPTH_MODELS:
        raise ValueError(f"unknown depth model {name!r}; valid: "
                         f"{sorted(DEPTH_MODELS)}")
    hw = tuple(cfg.get("input_hw", depth_mod.DEFAULT_HW))
    max_depth = float(cfg.get("max_depth", depth_mod.DEFAULT_MAX_DEPTH))
    lam = float(cfg.get("silog_lambda", 0.5))
    net = ConvNet(DEPTH_MODELS[name], input_shape=(*hw, 3), num_classes=0,
                  precision=cfg.get("precision", "f32"),
                  loss_fn=lambda pred, y: silog_loss(pred, y, lam=lam),
                  input_fns=depth_input_fns(
                      float(cfg.get("aug_brightness", 0.2)),
                      float(cfg.get("aug_contrast", 0.2))),
                  accuracy_metric=False,
                  accum_steps=cfg.get("accum_steps", 1),
                  seed=cfg.get("seed", 0), ckpt_dir=ckpt_dir,
                  log_dir=log_dir, log_every=cfg.get("log_every", 50),
                  device=device, **depth_model_kwargs(cfg))

    def src(split):
        return depth_mod.make_source(
            cfg.get("data_dir"), split,
            synthetic=synthetic or cfg.get("data_dir") is None,
            synthetic_n=cfg.get("synthetic_n", 256), hw=hw,
            depth_scale=cfg.get("depth_scale",
                                depth_mod.DEFAULT_DEPTH_SCALE),
            max_depth=max_depth)

    return (net, DataSet(src("train"), seed=cfg.get("seed", 0)),
            DataSet(src("val")))


def metric_loss(cfg: dict, head: str):
    """The metric recipe's loss of its model's ``head``."""
    if head == "arcface":
        s, m = cfg.get("margin_s", 64.0), cfg.get("margin_m", 0.5)
        return lambda cos, y: arcface_loss(cos, y, s=s, m=m)
    if head == "cosface":
        s, m = cfg.get("margin_s", 30.0), cfg.get("margin_m", 0.35)
        return lambda cos, y: cosface_loss(cos, y, s=s, m=m)
    if head == "triplet":
        margin = cfg.get("triplet_margin", 0.3)
        soft = cfg.get("triplet_soft", False)
        return lambda emb, y: batch_hard_triplet_loss(emb, y, margin=margin,
                                                      soft=soft)
    raise ValueError(f"unknown metric_head {head!r}; valid: "
                     "['arcface', 'cosface', 'triplet']")


def build_metric(cfg: dict, synthetic: bool = False, *,
                 device: torch.device, ckpt_dir: str | None = None,
                 log_dir: str | None = None
                 ) -> tuple[ConvNet, DataSet, DataSet]:
    """(net, train set, val set) of a metric-learning recipe
    (``vision.py:109-172``): an ``EMBEDDING_MODELS`` net over a classifier
    backbone, the loss of its head, identity-balanced ``pk`` batches (the
    triplet head needs them, P and K at least 2), the accuracy metric
    unless the head is "triplet"; the labels are identity ids, so any
    classification corpus serves."""
    name = cfg.get("model", "embedding_net")
    if name not in models.EMBEDDING_MODELS:
        raise ValueError(f"unknown metric model {name!r}; valid: "
                         f"{sorted(models.EMBEDDING_MODELS)}")
    kwargs = dict(cfg.get("model_kwargs", {}))
    head = kwargs.get("head", "arcface")
    loss = metric_loss(cfg, head)
    pk = tuple(cfg["pk"]) if cfg.get("pk") else None
    if pk is not None and pk[0] * pk[1] != cfg["batch_size"]:
        raise ValueError(f"pk={pk} must multiply to batch_size="
                         f"{cfg['batch_size']}")
    if head == "triplet" and pk is None:
        raise ValueError(
            "triplet training needs identity-balanced batches: set "
            "pk=(P, K) with P*K == batch_size (batch-hard mining has "
            "no positives under uniform sampling of a large identity "
            "set)")
    if head == "triplet" and (pk[0] < 2 or pk[1] < 2):
        raise ValueError(
            f"pk={pk}: batch-hard triplet mining needs P >= 2 "
            "identities (else no negatives) and K >= 2 examples per "
            "identity (else no positives) — with either at 1 the "
            "loss is identically zero and training silently no-ops")
    augment = make_augment(cfg.get("augment"))
    net = ConvNet(functools.partial(models.EMBEDDING_MODELS[name],
                                    input_hw=tuple(cfg["input_hw"])),
                  input_shape=(*cfg["input_hw"], 3),
                  num_classes=cfg["num_classes"],
                  precision=cfg.get("precision", "f32"), loss_fn=loss,
                  augment=augment, sam_rho=cfg.get("sam_rho", 0.0),
                  accuracy_metric=head != "triplet",
                  seed=cfg.get("seed", 0),
                  accum_steps=cfg.get("accum_steps", 1),
                  accum_dtype=cfg.get("accum_dtype", "float32"),
                  ckpt_dir=ckpt_dir, log_dir=log_dir,
                  log_every=cfg.get("log_every", 50), device=device,
                  **kwargs)
    train_src, val_src = make_sources(cfg, synthetic)
    return (net, DataSet(train_src, augment, pk=pk),
            DataSet(val_src, augment))


TASKS = ("classification", "segmentation", "flow", "metric", "depth", "gan",
         "ssl", "semisup", "distill", "detection")
# the tasks that build a ConvNet (``recipes/registry.py:38-56``: the
# "convnet" rows); the others have step loops of their own
CONVNET_TASKS = ("classification", "segmentation", "flow", "metric",
                 "depth")


def convnet_builder(task: str):
    """The ``ConvNet`` builder of a task (``recipes/registry.py:21``):
    segmentation, flow, metric and depth have their own, every other task
    the classifier's."""
    return {"segmentation": build_segmenter, "flow": build_flow,
            "metric": build_metric, "depth": build_depth}.get(
        task, build_classifier)


def check_task(cfg: dict) -> str:
    task = cfg.get("task", "classification")
    if task not in TASKS:
        raise ValueError(f"the port has tasks {list(TASKS)}, not {task!r}")
    return task


def refuse_pipeline(cfg: dict) -> None:
    """ValueError for a recipe with a ``pipeline`` block: JAX trains it
    as a staged model over a GPipe mesh (``train.py:112-122``,
    ``train/pipeline_driver.py``), which the port does not have."""
    if cfg.get("pipeline"):
        raise ValueError(f"recipe key 'pipeline' = {cfg['pipeline']!r} is "
                         "not ported (ROADMAP A16: GPipe over a staged "
                         "model; the port trains on one device)")


def apply_pretrained(net: ConvNet, cfg: dict) -> None:
    """Warm-start the built ``net`` from the recipe's ``pretrained``
    block (``common.py:247-275``): ``dict(path="x.npz")``, a flat
    ``scope::name`` file read by ``models.pretrained.load_npz_weights``
    into the parameters (a subset restore), or ``dict(path="r50.pth",
    depth=50, prefix="", load_head=True)``, a torchvision ResNet
    ``state_dict`` mapped by ``import_torch_resnet_file`` onto the
    parameters and BN statistics.  A bare path, and the torch-file form
    on a model with no ResNet stem at ``prefix``, are refused by name."""
    from myconvnet_tpu_torch.models.pretrained import (
        import_torch_resnet_file, load_npz_weights)
    from myconvnet_tpu_torch.weights import from_jax, to_jax
    pcfg = cfg["pretrained"]
    if not isinstance(pcfg, dict) or "path" not in pcfg:
        raise ValueError(f"recipe key 'pretrained' = {pcfg!r}: it wants "
                         "dict(path=...), as recipes/common.py:247-261")
    path = str(pcfg["path"])
    model = net.trainer.model
    params, state = to_jax(model)
    if path.endswith(".npz"):
        from_jax(model, load_npz_weights(path, params), state)
    else:
        prefix = pcfg.get("prefix", "")
        if f"{prefix}stem/conv" not in params:
            raise ValueError(
                f"recipe key 'pretrained' path {path!r}: the torch-file "
                "form maps a torchvision ResNet onto a ResNet, and "
                f"{type(model).__name__} has no scope {prefix}stem/conv")
        from_jax(model, *import_torch_resnet_file(
            path, params, state, depth=int(pcfg.get("depth", 50)),
            load_head=bool(pcfg.get("load_head", True)), prefix=prefix))
    print(f"warm-started from {path}", flush=True)


def build_trainer(cfg: dict, synthetic: bool = False, **kwargs
                  ) -> tuple[Trainer, DataSet, DataSet]:
    """The recipe's (trainer, train set, val set) as a fresh run starts
    it: :func:`convnet_builder`'s net built with the recipe's optimizer,
    warm-started from ``pretrained``, with the recipe's evaluator."""
    task = check_task(cfg)
    if task not in CONVNET_TASKS:
        raise ValueError(f"{task} recipes build through "
                         f"recipes_{task}.build_{task}")
    refuse_pipeline(cfg)
    net, train_set, val_set = convnet_builder(task)(cfg, synthetic,
                                                    **kwargs)
    net.build(optimizer_factory(cfg["optimizer"]))
    if cfg.get("pretrained") is not None:
        apply_pretrained(net, cfg)
    net.trainer.evaluator = build_evaluator(cfg)
    return net.trainer, train_set, val_set
