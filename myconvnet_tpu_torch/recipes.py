"""Recipe configs (``configs/*.py``) read and wired without the JAX package.

Port of ``myconvnet_tpu/recipes``: ``load_config`` and ``apply_overrides``
(``common.py``), ``make_optimizer`` (``common.py:68-103``: SGD, momentum,
Adam, AdamW, with ``clip_norm``), ``make_augment`` (``:124``),
``make_sources`` (``:131-163``: CIFAR-10 and CIFAR-100, SVHN, MNIST and
Fashion-MNIST, the synthetic ImageNet split at the recipe's ``raw_hw``,
and the flow corpus) and, for classification,
``build_classifier`` (``vision.py:23-65``, with ``accum_steps`` and
``accum_dtype``), which here builds the trainer directly (the ``ConvNet``
wrapper of ``models/base.py`` comes later), and for optical flow
``build_flow`` (``perception.py:284-398``); :func:`build_trainer` picks by
``cfg["task"]``.
Also the mean/std resolution of ``serving_http.build_route``
(``:134-145``): a recipe's ``augment`` block may set ``mean``/``std``, and
otherwise the ImageNet statistics of ``AugmentConfig`` apply.
"""

from __future__ import annotations

import ast
import importlib.util
import json
from typing import NamedTuple

import numpy as np
import torch

from myconvnet_tpu_torch import models
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.core.precision import apply_backend_flags, \
    get_policy
from myconvnet_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD, \
    AugmentConfig, JitterDraws, color_jitter, sample_jitter
from myconvnet_tpu_torch.data.mix import MixConfig
from myconvnet_tpu_torch.data.pipeline import DataSet
from myconvnet_tpu_torch.eval.evaluators import AccuracyEvaluator, Evaluator
from myconvnet_tpu_torch.eval.flow import FlowEvaluator
from myconvnet_tpu_torch.subsets import cifar10, cifar100, imagenet, mnist, \
    svhn
from myconvnet_tpu_torch.subsets import flow as flow_mod
from myconvnet_tpu_torch.train import optim
from myconvnet_tpu_torch.train.losses import (epe_loss, multiscale_epe_loss,
                                              softmax_cross_entropy,
                                              unsupervised_flow_loss)
from myconvnet_tpu_torch.train.trainer import InputFns, Trainer
from myconvnet_tpu_torch.utils.logging import MetricLogger
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


# Keys the JAX builders read that the port has not ported: each changes
# what is trained, so a recipe that sets one to anything but its default
# (0, None or False) is refused by name rather than trained differently
UNPORTED_CLASSIFIER_KEYS = ("erase_prob", "sam_rho")
UNPORTED_OPTIMIZER_KEYS = ("ema_decay", "plateau", "lookahead", "freeze")
# The JAX ConvNet also reads remat, chain_steps and zero_sharding; they
# change how its step runs (rematerialisation, steps chained in one jit
# call, ZeRO sharding over a mesh), not one number it computes, so the
# port accepts and ignores them.


def make_optimizer(model: torch.nn.Module, opt_cfg: dict
                   ) -> optim.SGD | optim.Adam:
    """The recipe's optimizer over ``model``'s parameters (by JAX path)."""
    opt_cfg = dict(opt_cfg)
    for key in UNPORTED_OPTIMIZER_KEYS:
        value = opt_cfg.pop(key, None)
        if value:
            raise ValueError(f"optimizer key {key!r} = {value!r} is not "
                             "ported (the JAX package wraps the optimizer "
                             "with it, recipes/common.py:77-80)")
    name = opt_cfg.pop("name")
    lr = opt_cfg.pop("lr")
    if isinstance(lr, dict):
        lr = optim.make_schedule(lr)
    if opt_cfg.pop("wd_exclude_norms", False):
        opt_cfg["weight_decay_exclude"] = optim.norm_and_bias_exclusion
    named = [(path, p) for path, p, _ in param_views(model)]
    return optim.make_optimizer(named, name, lr, **opt_cfg)


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
             "flow": flow_mod}
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
    raise ValueError(f"the port has the classification and flow tasks, "
                     f"not {task!r}")


def build_classifier(cfg: dict, synthetic: bool = False, *,
                     device: torch.device, ckpt_dir: str | None = None,
                     log_dir: str | None = None
                     ) -> tuple[Trainer, DataSet, DataSet]:
    """(trainer, train set, val set) for a classification recipe: the
    model initialised from ``cfg["seed"]``, softmax CE with the recipe's
    label smoothing, its augmentation, MixUp/CutMix and optimizer."""
    if cfg.get("cls_loss", "ce") != "ce":
        raise ValueError(f"the port has cls_loss 'ce', not "
                         f"{cfg['cls_loss']!r}")
    for key in UNPORTED_CLASSIFIER_KEYS:
        if cfg.get(key):
            raise ValueError(f"recipe key {key!r} = {cfg[key]!r} is not "
                             "ported (the JAX ConvNet reads it, "
                             "recipes/vision.py:51-63)")
    seed = cfg.get("seed", 0)
    model = models.get_model(cfg["model"], cfg["num_classes"],
                             input_hw=cfg.get("input_hw"),
                             **cfg.get("model_kwargs", {}))
    init_model(model, torch.Generator().manual_seed(seed))
    smoothing = cfg.get("label_smoothing", 0.0)

    def loss(logits, y):
        return softmax_cross_entropy(logits, y, label_smoothing=smoothing)

    augment = make_augment(cfg.get("augment"))
    mix = MixConfig(**cfg["mix"]) if cfg.get("mix") is not None else None
    policy = get_policy(cfg.get("precision", "f32"))
    apply_backend_flags(policy)
    model.to(device)
    trainer = Trainer(model, make_optimizer(model, cfg["optimizer"]), loss,
                      device=device, policy=policy,
                      num_classes=cfg["num_classes"], augment=augment,
                      mix=mix, evaluator=build_evaluator(cfg), seed=seed,
                      ckpt_dir=ckpt_dir, log_every=cfg.get("log_every", 50),
                      logger=MetricLogger(log_dir),
                      accum_steps=cfg.get("accum_steps", 1),
                      accum_dtype=cfg.get("accum_dtype", "float32"))
    train_src, val_src = make_sources(cfg, synthetic)
    # the batch order's seed is DataSet's default 0, as in the JAX recipe
    return trainer, DataSet(train_src, augment), DataSet(val_src, augment)


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

    def sample(generator, n):
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
               ) -> tuple[Trainer, DataSet, DataSet]:
    """(trainer, train set, val set) for an optical-flow recipe: the model
    initialised from ``cfg["seed"]`` (zero flow heads), the recipe's input
    chain and loss, no accuracy metric, the AEPE (or Fl) evaluator, whose
    lower score is the better one."""
    name = cfg.get("model", "flownet_s")
    fn = models.FLOW_MODELS.get(name)
    if fn is None:
        raise ValueError(f"unknown flow model {name!r}; valid: "
                         f"{sorted(models.FLOW_MODELS)}")
    seed = cfg.get("seed", 0)
    model = fn(0, **dict(cfg.get("model_kwargs", {})))
    init_model(model, torch.Generator().manual_seed(seed))
    unsup = bool(cfg.get("unsupervised", False))
    loss = flow_loss_fn(cfg, getattr(fn, "multiscale", False))
    fns = flow_input_fns(float(cfg.get("aug_brightness", 0.2)),
                         float(cfg.get("aug_contrast", 0.2)),
                         unsupervised=unsup,
                         occlusion=bool(cfg.get("occlusion", False)))
    policy = get_policy(cfg.get("precision", "f32"))
    apply_backend_flags(policy)
    model.to(device)
    trainer = Trainer(model, make_optimizer(model, cfg["optimizer"]), loss,
                      device=device, policy=policy, num_classes=0,
                      evaluator=build_evaluator(cfg), seed=seed,
                      ckpt_dir=ckpt_dir, log_every=cfg.get("log_every", 50),
                      logger=MetricLogger(log_dir),
                      accum_steps=cfg.get("accum_steps", 1),
                      input_fns=fns, accuracy_metric=False)
    train_src, val_src = make_sources(cfg, synthetic)
    return (trainer, DataSet(train_src, seed=seed), DataSet(val_src))


def build_trainer(cfg: dict, synthetic: bool = False, **kwargs
                  ) -> tuple[Trainer, DataSet, DataSet]:
    """The recipe's (trainer, train set, val set), by ``cfg["task"]``.
    A ``pretrained`` block is refused: the JAX package warm-starts from it
    (``train.py:170-175``), and training from seed weights instead would
    be another run."""
    if cfg.get("pretrained") is not None:
        raise ValueError(f"recipe key 'pretrained' = {cfg['pretrained']!r} "
                         "is not ported (the JAX trainer warm-starts from "
                         "it, recipes/common.py:247-275)")
    by_task = {"classification": build_classifier, "flow": build_flow}
    task = cfg.get("task", "classification")
    if task not in by_task:
        raise ValueError(f"the port has tasks {sorted(by_task)}, not "
                         f"{task!r}")
    return by_task[task](cfg, synthetic, **kwargs)
