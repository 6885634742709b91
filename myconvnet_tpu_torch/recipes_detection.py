"""The one-stage detection recipes (``task="detection"``:
``configs/voc_ssd300.py``, ``configs/voc_retinanet.py``) wired without the
JAX package.

Port of the anchored one-stage path of
``myconvnet_tpu/recipes/detection.py``: ``make_detection_sources``
(``:20``, the VOC layout or the synthetic rectangles at the model's input
size), ``_detector_chain`` (``:375``: the model, its anchor grid, the head
convention, the post-process, the normalization), ``build_detector``
(``:115``: the model from ``cfg["seed"]``, the recipe's optimizer, the
SSD augmentation chain, the multibox or focal objective),
``make_detector_inference`` (``:458``, the export and serving chain: raw
[0, 1] frames, normalize, eval forward, post-process) and
``evaluate_detection`` (``:528``), with the evaluator of
``common.py:203-244`` (VOC mAP at ``map_iou``, or COCO's sweep with
``map_style="coco"``).  Refused by name, each with its ROADMAP item:
FCOS, the R-CNN family and the panoptic models
(``models.UNPORTED_DETECTORS``), the COCO corpus, and a ``pretrained``
VGG-16 trunk (the torchvision VGG import); a ``pretrained`` ResNet
backbone (``arch="resnet"``) is read by ``import_torch_resnet_file``
under ``backbone/``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from myconvnet_tpu_torch import models
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.core.precision import apply_backend_flags, \
    get_policy
from myconvnet_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from myconvnet_tpu_torch.data.pipeline import DataSet
from myconvnet_tpu_torch.ops.boxes import retina_anchors, ssd_anchors
from myconvnet_tpu_torch.recipes import make_optimizer
from myconvnet_tpu_torch.subsets import voc
from myconvnet_tpu_torch.train import detection as det_lib


class DetectorChain(NamedTuple):
    """What a detection recipe resolves to (``_detector_chain``)."""
    model_fn: object        # num_classes, **kwargs -> nn.Module
    anchors: np.ndarray     # [A, 4] normalized xyxy
    focal: bool             # sigmoid focal head (RetinaNet)
    post_kwargs: dict       # make_postprocess's keywords
    mean: tuple
    std: tuple
    hw: tuple[int, int]


def _model_fn(cfg: dict):
    name = cfg.get("model", "ssd300")
    if name in models.UNPORTED_DETECTORS:
        raise ValueError(f"detector {name!r} is not ported (ROADMAP "
                         f"{models.UNPORTED_DETECTORS[name]})")
    if name not in models.DETECTORS:
        raise ValueError(f"unknown detector {name!r}; the port has "
                         f"{sorted(models.DETECTORS)}")
    return models.DETECTORS[name]


def detector_chain(cfg: dict) -> DetectorChain:
    """The architecture, anchors, head and post-process of a recipe: one
    resolution for training, evaluation and export."""
    fn = _model_fn(cfg)
    focal = getattr(fn, "head", "softmax") == "sigmoid_focal"
    if getattr(fn, "anchor_kind", "ssd") == "retina":
        anchors = retina_anchors(fn.anchor_spec)
    else:
        anchors = ssd_anchors(fn.anchor_spec)
    post = dict(score_threshold=cfg.get("score_threshold", 0.05),
                iou_threshold=cfg.get("nms_iou", 0.45),
                max_detections=cfg.get("max_detections", 100),
                score_activation="sigmoid" if focal else "softmax",
                pre_nms_topk=cfg.get("pre_nms_topk", 1000))
    aug = cfg.get("augment") or {}
    return DetectorChain(fn, anchors, focal, post,
                         tuple(aug.get("mean", IMAGENET_MEAN)),
                         tuple(aug.get("std", IMAGENET_STD)),
                         tuple(cfg.get("input_hw", fn.input_hw)))


def make_detection_sources(cfg: dict, synthetic: bool,
                           splits=("train", "val")):
    """The VOC detection sources at ``input_hw`` (the rendered rectangles
    without a ``data_dir``, ``synthetic_n`` a split: the port's own key,
    64 as in JAX by default); a COCO recipe is refused by name."""
    if cfg["dataset"] == "coco":
        raise ValueError("detection dataset 'coco' is not ported "
                         "(subsets/coco.py, ROADMAP A17c(iii))")
    if cfg["dataset"] != "voc":
        raise ValueError(f"detection dataset {cfg['dataset']!r}; valid: "
                         "['voc']")
    data_dir = cfg.get("data_dir")
    hw = tuple(cfg.get("input_hw", voc.DET_IMAGE_HW))
    return [voc.make_detection_source(
        data_dir, split, synthetic=synthetic or data_dir is None,
        synthetic_n=cfg.get("synthetic_n", 64), raw_hw=hw,
        max_boxes=cfg.get("max_boxes", voc.MAX_BOXES)) for split in splits]


def det_augment(cfg: dict, mean, std) -> det_lib.DetAugment:
    """The recipe's ``augment`` block as a :class:`DetAugment`."""
    aug = cfg.get("augment") or {}
    d = det_lib.DetAugment._field_defaults
    return det_lib.DetAugment(
        hflip=aug.get("flip", aug.get("hflip", True)),
        mosaic_prob=aug.get("mosaic_prob", 0.0),
        expand_prob=aug.get("expand_prob", 0.0),
        expand_max=aug.get("expand_max", 4.0),
        iou_crop=aug.get("iou_crop", False),
        iou_menu=tuple(aug.get("iou_menu", d["iou_menu"])),
        crop_candidates=aug.get("crop_candidates", 8),
        scale_range=tuple(aug.get("scale_range", (0.3, 1.0))),
        aspect_range=tuple(aug.get("aspect_range", (0.5, 2.0))),
        brightness=aug.get("brightness", 0.0),
        contrast=aug.get("contrast", 0.0),
        saturation=aug.get("saturation", 0.0), hue=aug.get("hue", 0.0),
        mean=tuple(mean), std=tuple(std))


def detection_loss(cfg: dict, focal: bool):
    """``loss_fn(cls, loc, boxes, labels, anchors)`` of the recipe: the
    focal objective for a sigmoid head, SSD's multibox otherwise."""
    if focal:
        return functools.partial(
            det_lib.focal_det_loss, alpha=cfg.get("focal_alpha", 0.25),
            gamma=cfg.get("focal_gamma", 2.0),
            pos_threshold=cfg.get("match_iou", 0.5),
            neg_threshold=cfg.get("neg_iou", 0.4),
            loc_loss_kind=cfg.get("loc_loss", "smooth_l1"),
            giou_weight=cfg.get("giou_weight", 2.0))
    return functools.partial(det_lib.multibox_loss,
                             iou_threshold=cfg.get("match_iou", 0.5),
                             neg_pos_ratio=cfg.get("neg_pos_ratio", 3.0))


def detection_evaluator(cfg: dict):
    """VOC mAP at ``map_iou`` (0.5), or COCO's mAP@[.5:.95] with
    ``map_style="coco"``."""
    from myconvnet_tpu_torch.eval.detection import (COCOMeanAPEvaluator,
                                                    MeanAPEvaluator)
    _model_fn(cfg)
    if cfg.get("map_style", "voc") == "coco":
        return COCOMeanAPEvaluator(cfg["num_classes"])
    return MeanAPEvaluator(cfg["num_classes"],
                           iou_threshold=cfg.get("map_iou", 0.5))


def _warm_start(model: torch.nn.Module, cfg: dict) -> None:
    from myconvnet_tpu_torch.models.pretrained import \
        import_torch_resnet_file
    from myconvnet_tpu_torch.weights import from_jax, to_jax
    pcfg = dict(cfg["pretrained"])
    arch = pcfg.get("arch", "vgg16" if "ssd" in cfg.get("model", "ssd300")
                    else "resnet")
    if arch != "resnet":
        raise ValueError(f"recipe key 'pretrained' arch={arch!r} is not "
                         "ported (the torchvision VGG-16 import, "
                         "models/pretrained.import_torch_vgg16_file; "
                         "ROADMAP A17c)")
    params, state = to_jax(model)
    from_jax(model, *import_torch_resnet_file(
        pcfg["path"], params, state, depth=int(pcfg.get("depth", 50)),
        load_head=False, prefix=pcfg.get("prefix", "backbone/")))
    print(f"warm-started detector backbone from {pcfg['path']}",
          flush=True)


def build_detector(cfg: dict, synthetic: bool = False, *,
                   device: torch.device
                   ) -> tuple[det_lib.DetectionTrainer, DataSet, DataSet]:
    """(trainer, train set, val set) of a detection recipe."""
    chain = detector_chain(cfg)
    policy = get_policy(cfg.get("precision", "f32"))
    apply_backend_flags(policy)
    seed = cfg.get("seed", 0)
    model = chain.model_fn(cfg["num_classes"],
                           **dict(cfg.get("model_kwargs", {})))
    init_model(model, torch.Generator().manual_seed(seed))
    if cfg.get("pretrained"):
        _warm_start(model, cfg)
    model.to(device)
    anchors = torch.from_numpy(chain.anchors).to(device)
    trainer = det_lib.DetectionTrainer(
        model, make_optimizer(model, cfg["optimizer"]), anchors,
        detection_loss(cfg, chain.focal),
        det_lib.make_postprocess(anchors, cfg["num_classes"],
                                 **chain.post_kwargs),
        augment=det_augment(cfg, chain.mean, chain.std), mean=chain.mean,
        std=chain.std, device=device, policy=policy, seed=seed)
    train_src, val_src = make_detection_sources(
        dict(cfg, input_hw=chain.hw), synthetic)
    return trainer, DataSet(train_src, seed=seed), DataSet(val_src)


def make_detector_inference(cfg: dict, model: torch.nn.Module,
                            device: torch.device):
    """(fn, model): the export and serving chain of a restored detector,
    ``fn(x)`` on raw [0, 1] float32 frames [B, H, W, 3] -> (boxes, scores,
    labels, valid): the recipe's normalize, the eval forward in the
    policy's dtype, the post-process with the fixed-trip NMS (the form
    ``torch.export`` traces whole)."""
    from myconvnet_tpu_torch import serving
    chain = detector_chain(cfg)
    policy = get_policy(cfg.get("precision", "f32"))
    fn = serving.make_inference_fn(model, None, None, fold_bn=False,
                                   device=device, policy=policy)
    post = det_lib.make_postprocess(
        torch.from_numpy(chain.anchors).to(device), cfg["num_classes"],
        nms_method="sequential", **chain.post_kwargs)
    norm = serving.normalizer(chain.mean, chain.std, device)

    def detect(x):
        return post(*fn.model(norm(x).to(policy.compute_dtype)))

    return detect, fn.model


def evaluate_detection(trainer: det_lib.DetectionTrainer, val_set: DataSet,
                       batch_size: int, evaluator) -> float:
    """The val split's score: every batch predicted (the tail padded to
    the batch), the evaluator fed."""
    return trainer.evaluate(val_set.eval_iter(batch_size, trainer.device),
                            evaluator)
