"""The FixMatch recipe (``task="semisup"``: ``configs/cifar10_fixmatch.py``)
wired without the JAX package.

Port of ``myconvnet_tpu/recipes/representation.build_semisup``
(``:144-223``): the registry model from ``cfg["seed"]`` under the recipe's
precision; the weak view ``augment_train`` of the ``augment`` block (B3
in the pad-crop mode), the strong view the same block updated by
``augment_strong`` (RandAugment (2, 10) by default, which sends the batch
through the crop-resize matmuls and the policy's plain ops, as JAX's
order of operations has it: crop, flip, x / 255, the policy, the
normalize); the labeled split of ``labeled_per_class`` examples a class
(``train.semisup.labeled_subset``) from an in-memory corpus (any other
source is refused), batches of ``batch_size`` labeled beside ``mu`` x as
many unlabeled (the whole train split, seed + 1), zipped.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch import models
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.core.precision import apply_backend_flags, \
    get_policy
from myconvnet_tpu_torch.data.pipeline import ArraySource, DataSet
from myconvnet_tpu_torch.recipes import make_augment, make_optimizer, \
    make_sources
from myconvnet_tpu_torch.recipes_ssl import augment_views
from myconvnet_tpu_torch.train.semisup import FixMatchTrainer, \
    labeled_subset


def build_semisup(cfg: dict, synthetic: bool = False, *,
                  device: torch.device):
    """(trainer, batches, val set): ``batches()`` opens the zipped
    (x labeled, y labeled, x unlabeled) stream on ``device``."""
    weak = make_augment(cfg["augment"])
    strong = make_augment({**cfg["augment"],
                           **cfg.get("augment_strong",
                                     dict(randaugment=(2, 10)))})
    hw = tuple(weak.out_hw)
    seed = cfg.get("seed", 0)
    ncls = cfg["num_classes"]
    model = models.get_model(cfg["model"], ncls, input_hw=hw,
                             **dict(cfg.get("model_kwargs", {})))
    init_model(model, torch.Generator().manual_seed(seed))
    policy = get_policy(cfg.get("precision", "f32"))
    apply_backend_flags(policy)
    model.to(device)
    trainer = FixMatchTrainer(
        model, make_optimizer(model, cfg["optimizer"]),
        augment_views(weak, device), augment_views(strong, device),
        device=device, policy=policy, seed=seed,
        threshold=cfg.get("threshold", 0.95),
        lambda_u=cfg.get("lambda_u", 1.0),
        ema_decay=cfg.get("ema_decay", 0.999))

    train_src, val_src = make_sources(cfg, synthetic)
    if not isinstance(train_src, ArraySource):
        raise ValueError("semisup needs an in-memory corpus "
                         "(ArraySource) to draw the labeled split")
    x_lab, y_lab = labeled_subset(train_src.images, train_src.labels,
                                  cfg.get("labeled_per_class", 400), ncls,
                                  seed)
    lab_ds = DataSet(ArraySource(x_lab, y_lab), seed=seed)
    unlab_ds = DataSet(train_src, seed=seed + 1)
    mu = int(cfg.get("mu", 7))
    batch = cfg["batch_size"]

    def batches():
        li = lab_ds.train_iter(batch, device)
        ui = unlab_ds.train_iter(mu * batch, device)
        try:
            for (x_l, y_l), (x_u, _) in zip(li, ui):
                yield x_l, y_l, x_u
        finally:
            li.close()
            ui.close()

    return trainer, batches, DataSet(val_src)
