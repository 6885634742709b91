"""The knowledge-distillation recipe (``task="distill"``:
``configs/cifar10_distill_r18_smallnet.py``) wired without the JAX package.

Port of ``myconvnet_tpu/recipes/representation.build_distill``
(``:245-366``) with ``make_policy_net`` (``:229-242``): the student
(``model``, ``model_kwargs``) from ``cfg["seed"]`` and the teacher
(``distill.teacher``, ``distill.teacher_kwargs``) from seed + 1, both
registry classifiers under the recipe's precision; the teacher's weights
from exactly one of ``distill.ckpt`` (a classification run of either
package, a directory or a file), ``distill.npz`` (a flat ``scope::name``
file) or ``distill.torch`` (a torchvision ResNet file); none of them is
refused unless ``allow_random=True`` (an untrained teacher distills
noise), two or more are refused.  The view is ``augment_train`` of the
recipe's ``augment`` block (B3 in the pad-crop mode), the student scored
on ``augment_eval`` of it.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch import models
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.core.precision import apply_backend_flags, \
    get_policy
from myconvnet_tpu_torch.data.pipeline import DataSet
from myconvnet_tpu_torch.recipes import make_augment, make_optimizer, \
    make_sources
from myconvnet_tpu_torch.recipes_ssl import augment_views
from myconvnet_tpu_torch.train.distill import DistillTrainer

TEACHER_SOURCES = ("ckpt", "npz", "torch")


def policy_net(cfg: dict, name: str, kwargs: dict, seed: int,
               hw: tuple[int, int]) -> torch.nn.Module:
    """The registry classifier ``name`` for the recipe's classes at ``hw``,
    initialised from ``seed``."""
    model = models.get_model(name, cfg["num_classes"], input_hw=hw,
                             **dict(kwargs))
    return init_model(model, torch.Generator().manual_seed(seed))


def load_teacher(teacher: torch.nn.Module, dcfg: dict) -> None:
    """Load the teacher's weights from the one source ``dcfg`` names."""
    from myconvnet_tpu_torch import weights
    from myconvnet_tpu_torch.models.pretrained import (
        import_torch_resnet_file, load_npz_weights)

    src = [k for k in TEACHER_SOURCES if dcfg.get(k)]
    if len(src) > 1:
        raise ValueError(f"distill teacher weights over-specified: {src}")
    if not src:
        if not dcfg.get("allow_random"):
            raise ValueError(
                "distill= gives no teacher weights (ckpt=/npz=/torch=); a "
                "random teacher distills noise — pass allow_random=True "
                "only for smoke tests")
        return
    params, state = weights.to_jax(teacher)
    if src == ["ckpt"]:
        params, state = weights.load_jax_checkpoint(dcfg["ckpt"])
    elif src == ["npz"]:
        params = load_npz_weights(dcfg["npz"], params)
    else:
        tc = dict(dcfg["torch"])
        params, state = import_torch_resnet_file(
            tc["path"], params, state, depth=int(tc.get("depth", 50)),
            load_head=bool(tc.get("load_head", True)),
            prefix=tc.get("prefix", ""))
    weights.from_jax(teacher, params, state)


def build_distill(cfg: dict, synthetic: bool = False, *,
                  device: torch.device
                  ) -> tuple[DistillTrainer, DataSet, DataSet]:
    """(trainer, train set, val set) of a distillation recipe."""
    dcfg = dict(cfg.get("distill") or {})
    if "teacher" not in dcfg:
        raise ValueError("task='distill' needs distill=dict(teacher=...)")
    aug = make_augment(cfg["augment"])
    hw = tuple(aug.out_hw)
    seed = cfg.get("seed", 0)
    student = policy_net(cfg, cfg["model"], cfg.get("model_kwargs", {}),
                         seed, hw)
    teacher = policy_net(cfg, dcfg["teacher"],
                         dcfg.get("teacher_kwargs", {}), seed + 1, hw)
    load_teacher(teacher, dcfg)
    policy = get_policy(cfg.get("precision", "f32"))
    apply_backend_flags(policy)
    student.to(device)
    trainer = DistillTrainer(
        student, teacher, make_optimizer(student, cfg["optimizer"]),
        augment_views(aug, device), device=device, policy=policy, seed=seed,
        temperature=float(dcfg.get("temperature", 4.0)),
        alpha=float(dcfg.get("alpha", 0.9)))
    train_src, val_src = make_sources(cfg, synthetic)
    return trainer, DataSet(train_src, seed=seed), DataSet(val_src)
