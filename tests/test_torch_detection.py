"""The port's one-stage detection slice against the JAX package, on the
CPU.

The SSD augmentation chain at JAX's draws (windows of the zoom-out canvas
and the IoU-constrained crop, the mean-filled warp, the mosaic, jitter and
the box-aware flip), ``tinydet`` and ``tinyretina`` (scopes, the eval
forward, one train step of the recipe's chain), ``ssd300`` and
``retinanet`` at their full input size (batch 1), the post-process, the
VOC mAP and COCO evaluators, the VOC XML reader on Annotations written
here for the committed fixture images, and the recipe through the CPU
entry points: a tiny run's checkpoint read by both packages, ``test``
(mAP), ``test --export``, ``serve --artifact --detect`` and the
``detect`` route.

Tolerances: windows, boxes and labels of the augmentation within 1e-6,
images within 1e-5 (float32 warps summed in another order); float32 eval
outputs within 1e-4 of the largest; one step (batch 4, momentum at a
constant lr): the loss 1e-4 relative and each parameter's update within 1e-4
of its largest; the post-process's indices, labels and ``valid`` equal
JAX's, boxes and scores within 1e-6; the evaluators 1e-9; the reader exact;
the artifact's detections and the route's against JAX's artifact of the same
weights: the same valid detections, boxes and scores within 1e-4.
"""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu import serving as jserving
from myconvnet_tpu import serving_http as jhttp
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.eval import detection as jeval
from myconvnet_tpu.subsets import voc as jvoc
from myconvnet_tpu.train import detection as jdet
from myconvnet_tpu_torch import (models, recipes, recipes_detection, serve,
                                 serving, serving_http, weights)
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.data.augment import JitterDraws
from myconvnet_tpu_torch.eval import detection as teval
from myconvnet_tpu_torch.models import blocks, resnet
from myconvnet_tpu_torch.ops import boxes
from myconvnet_tpu_torch.subsets import voc as tvoc
from myconvnet_tpu_torch.train import detection as det

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD_CONFIG = os.path.join(ROOT, "configs", "voc_ssd300.py")
RETINA_CONFIG = os.path.join(ROOT, "configs", "voc_retinanet.py")
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_io", "voc")
CLASSES = 21
# case: (registry name, kwargs of both packages, input hw, weight seed)
TINY = {"tinydet": ("tinydet", dict(width=8), (96, 96), 0),
        "tinyretina": ("tinyretina", dict(width=8), (128, 128), 1)}
FULL_SIZE = {"ssd300": ("ssd300", {}, (300, 300), 2),
             "retinanet": ("retinanet", {}, (512, 512), 3)}
AUG = jdet.DetAugment(hflip=True, expand_prob=0.5, expand_max=4.0,
                      iou_crop=True, brightness=0.125, contrast=0.5,
                      saturation=0.5, hue=0.05,
                      mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
CONST_LR = dict(name="momentum", momentum_coef=0.9, weight_decay=5e-4,
                wd_exclude_norms=True, lr=0.01)


def _t(a):
    return torch.from_numpy(np.array(a))


def port_aug(cfg=AUG):
    return det.DetAugment(**cfg._asdict())


def jax_fn(name, kw):
    fn = jmodels.get_model(name)
    return transform(lambda x, train: fn(x, CLASSES, train=train, **kw))


def make_trees(name, kw, seed):
    model = models.DETECTORS[name](CLASSES, **kw)
    params, state = weights.random_jax_params(model, seed)
    rng = np.random.RandomState(60 + seed)
    for scope, p in params.items():
        if "b" in p:
            p["b"] = (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)
        if scope.endswith("cls_head/out"):
            p["b"] = p["b"] - 4.6
    return params, state


def targets(seed, b=4, m=6):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0.0, 0.6, (b, m, 2))
    wh = rng.uniform(0.15, 0.4, (b, m, 2))
    bx = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    lab = rng.randint(1, CLASSES, (b, m)).astype(np.int32)
    lab[:, -2:] = -1
    return bx, lab


def images_u8(seed, hw, b=4):
    return np.random.RandomState(seed).randint(0, 256, (b, *hw, 3)).astype(
        np.uint8)


def jax_draws(key, n, cfg=AUG, mosaic=False):
    """JAX's draws of ``augment_detection_batch(..., key, cfg)`` as the
    port's :class:`DetDraws`."""
    k_mos, k_geo, k_col, k_flip = jax.random.split(key, 4)
    mos = None
    if mosaic:
        k_c, k_p = jax.random.split(k_mos)
        mos = (_t(jax.random.uniform(k_c, (n, 2), minval=0.25,
                                     maxval=0.75)),
               _t(jax.random.bernoulli(k_p, cfg.mosaic_prob, (n,))))
    k_exp, k_r, k_off, k_opt, k_wh, k_xy = jax.random.split(k_geo, 6)
    k = cfg.crop_candidates
    window = det.WindowDraws(
        _t(jax.random.bernoulli(k_exp, cfg.expand_prob, (n,))),
        _t(jax.random.uniform(k_r, (n,), minval=1.0,
                              maxval=cfg.expand_max)),
        _t(jax.random.uniform(k_off, (n, 2))),
        _t(jax.random.randint(k_opt, (n,), 0, len(cfg.iou_menu) + 1)).long(),
        _t(jax.random.uniform(k_wh, (n, k, 2), minval=cfg.scale_range[0],
                              maxval=cfg.scale_range[1])),
        _t(jax.random.uniform(k_xy, (n, k, 2))))
    k_b, k_c, k_s, k_h = jax.random.split(k_col, 4)

    def u(key, lo, hi, shape=(n, 1, 1, 1)):
        return _t(jax.random.uniform(key, shape, minval=lo,
                                     maxval=hi)).reshape(n)

    jitter = JitterDraws(u(k_b, -cfg.brightness, cfg.brightness),
                         u(k_c, 1 - cfg.contrast, 1 + cfg.contrast),
                         u(k_s, 1 - cfg.saturation, 1 + cfg.saturation),
                         u(k_h, -cfg.hue, cfg.hue, (n, 1, 1)))
    flip = _t(jax.random.bernoulli(k_flip, 0.5, (n,)))
    return det.DetDraws(mos, window, jitter, flip)


# ------------------------------------------------------- augmentation


@pytest.mark.parametrize("seed", [0, 1])
def test_windows_match_jax(seed):
    bx, lab = targets(seed, 8)
    key = jax.random.PRNGKey(seed)
    _, k_geo, _, _ = jax.random.split(key, 4)
    want = np.asarray(jdet.sample_detection_windows(k_geo, bx, lab, AUG))
    draws = jax_draws(key, 8)
    got = det.sample_detection_windows(_t(bx), _t(lab), port_aug(),
                                       draws.window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert (want[:, 2] - want[:, 0] > 1.0).any()   # a zoom-out canvas


def test_window_warp_mosaic_and_flip_match_jax():
    bx, lab = targets(2)
    x = images_u8(3, (24, 32)).astype(np.float32) / 255.0
    window = np.asarray([[-0.5, -0.2, 1.5, 1.3], [0.1, 0.2, 0.7, 0.9],
                         [0.0, 0.0, 1.0, 1.0], [0.3, 0.1, 0.6, 0.5]],
                        np.float32)
    fill = (0.485, 0.456, 0.406)
    want = jdet.apply_detection_window(x, bx, lab, window, fill)
    got = det.apply_detection_window(_t(x), _t(bx), _t(lab), _t(window),
                                     fill)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    key = jax.random.PRNGKey(5)
    k_c, k_p = jax.random.split(key)
    want = jdet.mosaic_batch(key, x, bx, lab, 0.7)
    got = det.mosaic_batch(_t(x), _t(bx), _t(lab), _t(jax.random.uniform(
        k_c, (4, 2), minval=0.25, maxval=0.75)), _t(jax.random.bernoulli(
            k_p, 0.7, (4,))))
    for g, w, tol in zip(got, want, (1e-5, 1e-6, 0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    flip = np.asarray([True, False, True, False])
    got = det.hflip_batch(_t(x), _t(bx), _t(flip))
    assert torch.equal(got[0][0], _t(x[0]).flip(1))
    np.testing.assert_allclose(got[1][0, 0].numpy(), [
        1 - bx[0, 0, 2], bx[0, 0, 1], 1 - bx[0, 0, 0], bx[0, 0, 3]])


@pytest.mark.parametrize("mosaic", [False, True])
def test_augment_chain_matches_jax(mosaic):
    """``augment_detection_batch`` of uint8 images at JAX's draws: x / 255
    (B2), [mosaic], the window's warp, colour jitter, flip, normalize."""
    cfg = AUG._replace(mosaic_prob=0.6 if mosaic else 0.0)
    bx, lab = targets(4)
    x = images_u8(5, (32, 32))
    key = jax.random.PRNGKey(9)
    want = jdet.augment_detection_batch(jnp.asarray(x), bx, lab, key, cfg)
    got = det.augment_detection_batch(_t(x), _t(bx), _t(lab), port_aug(cfg),
                                      jax_draws(key, 4, cfg, mosaic))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    own = det.sample_draws(torch.Generator().manual_seed(0), 4096,
                           port_aug())
    assert abs(float(own.flip.float().mean()) - 0.5) < 0.03
    assert abs(float(own.window.expand.float().mean()) - 0.5) < 0.03
    assert int(own.window.opt.max()) == len(AUG.iou_menu)


# -------------------------------------------------------------- models


def check_scopes(name, kw, hw):
    jparams, jstate = jax.eval_shape(lambda: jax_fn(name, kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), False))
    p2, s2 = weights.to_jax(models.DETECTORS[name](CLASSES, **kw))
    assert set(p2) == set(jparams) and set(s2) == set(jstate)
    for tree, mine in ((jparams, p2), (jstate, s2)):
        for scope in tree:
            assert {n: v.shape for n, v in mine[scope].items()} == \
                {n: tuple(v.shape) for n, v in tree[scope].items()}, scope


def check_eval(name, kw, hw, seed, n=2):
    params, state = make_trees(name, kw, seed)
    x = np.random.RandomState(seed).randn(n, *hw, 3).astype(np.float32)
    fn = jax_fn(name, kw)

    def apply(p, s, v):
        with policy_scope(JFULL):
            return fn.apply(p, s, None, v, False)[0]

    want = jax.jit(apply)(params, state, jnp.asarray(x))
    model = weights.from_jax(models.DETECTORS[name](CLASSES, **kw), params,
                             state).eval()
    with torch.no_grad():
        got = model(_t(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("case", [*TINY, *FULL_SIZE])
def test_scopes_match_the_jax_init_tree(case):
    name, kw, hw, _ = {**TINY, **FULL_SIZE}[case]
    check_scopes(name, kw, hw)


@pytest.mark.parametrize("case", list(TINY))
def test_tiny_eval_matches_jax(case):
    check_eval(*TINY[case])


@pytest.mark.parametrize("case", list(FULL_SIZE))
def test_full_size_eval_matches_jax(case):
    """SSD300 at 300² and RetinaNet-R50 at 512², batch 1, float32."""
    check_eval(*FULL_SIZE[case], n=1)


def test_retinanet_heads_are_weight_tied_and_start_at_the_prior():
    model = models.DETECTORS["tinyretina"](CLASSES, width=8)
    from myconvnet_tpu_torch.core.init import init_model
    init_model(model, torch.Generator().manual_seed(0))
    assert torch.allclose(model.cls_head.out.bias,
                          torch.full_like(model.cls_head.out.bias, -4.59512))
    params, _ = weights.to_jax(model)
    assert sum(s.startswith("cls_head/") for s in params) == 2


def count_routes(model, x, monkeypatch):
    calls = {"b1": 0, "b4": 0, "b5": 0}

    def count(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(blocks, "fused_scale_shift_act",
                        count("b1", blocks.fused_scale_shift_act))
    monkeypatch.setattr(blocks, "conv3x3_bn_relu",
                        count("b4", blocks.conv3x3_bn_relu))
    monkeypatch.setattr(resnet, "conv1x1_conv3x3_bn_relu",
                        count("b5", resnet.conv1x1_conv3x3_bn_relu))
    with torch.no_grad():
        model.eval()(x)
    return calls


@pytest.mark.parametrize("name,hw,want", [
    ("ssd300", 300, {"b1": 11, "b4": 12, "b5": 0}),
    ("retinanet", 512, {"b1": 7, "b4": 40, "b5": 13})])
def test_eval_routing_at_full_width(name, hw, want, monkeypatch):
    """Under bf16: SSD300's 12 trunk convs with C_in % 8 == 0 through B4,
    its first conv, fc6, fc7 and the 8 extras through B1; RetinaNet's
    backbone as ResNet-50's (13 B5, 7 B1) and its heads' 4 layers x 2
    heads x 5 levels through B4 (scale 1, the bias its epilogue)."""
    model = models.DETECTORS[name](CLASSES)
    x = torch.zeros(1, hw, hw, 3, dtype=torch.bfloat16)
    assert count_routes(model, x, monkeypatch) == want


# ------------------------------------------------------ one train step


def _draws_of_step(state, cfg):
    key = jax.random.fold_in(jax.random.wrap_key_data(state.rng),
                             state.step)
    aug_key, _ = jax.random.split(key)
    return jax_draws(aug_key, 4, cfg)


def _flat(tree):
    return {f"{s}/{n}": np.array(v) for s, d in tree.items()
            for n, v in d.items()}


@pytest.mark.parametrize("case", list(TINY))
def test_one_recipe_step_matches_jax(case):
    """The recipe's step (the SSD augmentation at JAX's draws, the train
    forward, multibox or focal loss, momentum at a constant lr) from the
    same weights: the loss and each parameter's update."""
    name, kw, hw, seed = TINY[case]
    config = SSD_CONFIG if name == "tinydet" else RETINA_CONFIG
    cfg = recipes.apply_overrides(recipes.load_config(config), [
        f"model={name}", f"input_hw={list(hw)}", "precision=f32"])
    cfg["model_kwargs"], cfg["optimizer"] = dict(kw), dict(CONST_LR)
    params, state = make_trees(name, kw, seed)
    bx, lab = targets(seed + 10)
    x = images_u8(seed + 20, hw)
    jstate, step, _, _, _ = jrecipes.build_detector(cfg, synthetic=True)
    jstate = jstate._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        state=jax.tree_util.tree_map(jnp.asarray, state))
    jstate = jstate._replace(opt=jrecipes.make_optimizer(
        cfg["optimizer"]).init(jstate.params))
    new, jm = step(jstate, (jnp.asarray(x), jnp.asarray(bx),
                            jnp.asarray(lab)))
    want = {k: v - _flat(params)[k] for k, v in _flat(new.params).items()}
    aug = recipes_detection.det_augment(cfg, *recipes_detection.
                                        detector_chain(cfg)[4:6])
    draws = _draws_of_step(jstate, aug)

    def trainer():
        tr, _, _ = recipes_detection.build_detector(
            cfg, True, device=torch.device("cpu"))
        weights.from_jax(tr.model, params, state)
        return tr

    tr = trainer()
    before = _flat(weights.to_jax(tr.model)[0])
    metrics = tr.train_step(_t(x), _t(bx), _t(lab), draws)
    got = {k: v - before[k] for k, v in
           _flat(weights.to_jax(tr.model)[0]).items()}
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert int(metrics["n_pos"]) == int(jm["n_pos"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


# ------------------------------------------------------- post-process


@pytest.mark.parametrize("activation", ["softmax", "sigmoid"])
def test_postprocess_equals_jax(activation):
    """The same logits (bf16-rounded: ties in the scores) through both
    post-processes: the pre-NMS top 150 of 756 anchors, class-aware NMS;
    indices, labels and ``valid`` equal, boxes and scores 1e-6."""
    anchors = boxes.ssd_anchors(models.ssd.TINYDET_SPEC)
    rng = np.random.RandomState(1)
    k = CLASSES if activation == "softmax" else CLASSES - 1
    shift = 0.0 if activation == "softmax" else -3.0
    cls = torch.from_numpy(rng.randn(3, len(anchors), k).astype(
        np.float32) + shift).to(torch.bfloat16).float().numpy()
    loc = (rng.randn(3, len(anchors), 4) * 0.3).astype(np.float32)
    thr = 0.3 if activation == "softmax" else 0.4
    kw = dict(score_threshold=thr, iou_threshold=0.45, max_detections=100,
              score_activation=activation, pre_nms_topk=150)
    want = jax.jit(jdet.make_postprocess(jnp.asarray(anchors), CLASSES,
                                         **kw))(cls, loc)
    for method in ("jacobi", "sequential"):
        got = det.make_postprocess(_t(anchors), CLASSES, nms_method=method,
                                   **kw)(_t(cls), _t(loc))
        valid = np.asarray(want[3])
        np.testing.assert_array_equal(got[3].numpy(), valid)
        assert valid.any() and not valid.all()
        for g, w in zip(got[:3], want[:3]):
            g, w = g.numpy(), np.asarray(w)
            if method == "jacobi":   # the indices past valid agree too
                np.testing.assert_allclose(g, w, atol=1e-6)
            np.testing.assert_allclose(g[valid], w[valid], atol=1e-6)
        assert got[2].dtype == torch.int32


# --------------------------------------------------------- evaluators


def _dets(seed, b=5, d=12):
    rng = np.random.RandomState(seed)
    gtb, gtl = targets(seed, b, 5)
    gtl[0, 0] = -(gtl[0, 0] + 1)     # a difficult object
    boxes_ = np.concatenate([gtb + rng.randn(*gtb.shape).astype(
        np.float32) * 0.03, gtb[:, ::-1] + 0.1], 1)[:, :d]
    scores = rng.rand(b, boxes_.shape[1]).astype(np.float32)
    labels = np.concatenate([np.abs(gtl), rng.randint(
        1, CLASSES, gtl.shape)], 1).astype(np.int32)
    valid = rng.rand(b, boxes_.shape[1]) < 0.8
    return (boxes_, scores, labels, valid), (gtb, gtl)


@pytest.mark.parametrize("kind", ["voc", "voc_11point", "coco"])
def test_map_evaluators_match_jax(kind):
    if kind == "coco":
        mine, theirs = teval.COCOMeanAPEvaluator(CLASSES), \
            jeval.COCOMeanAPEvaluator(CLASSES)
    else:
        interp = "11point" if kind == "voc_11point" else "all"
        mine = teval.MeanAPEvaluator(CLASSES, interpolation=interp)
        theirs = jeval.MeanAPEvaluator(CLASSES, interpolation=interp)
    for seed in range(3):
        preds, tg = _dets(seed)
        mine.update(tuple(_t(p) for p in preds), tuple(_t(v) for v in tg))
        theirs.update(preds, tg)
    np.testing.assert_allclose(mine.score(), theirs.score(), rtol=1e-9)
    assert mine.score() > 0
    assert mine.per_class_ap().keys() == theirs.per_class_ap().keys()
    if kind == "coco":
        for t_, v in theirs.per_threshold().items():
            np.testing.assert_allclose(mine.per_threshold()[t_], v,
                                       rtol=1e-9)


# ----------------------------------------------------------- VOC files


def _annotations(root):
    """Annotations/*.xml for the fixture images, a box per class from
    its extent in SegmentationClass, the first object ``difficult``."""
    os.makedirs(os.path.join(root, "Annotations"))
    os.makedirs(os.path.join(root, "ImageSets", "Main"))
    ids = sorted(f[:-4] for f in os.listdir(os.path.join(
        FIXTURES, "SegmentationClass")))
    shutil.copytree(os.path.join(FIXTURES, "JPEGImages"),
                    os.path.join(root, "JPEGImages"))
    for i in ids:
        m = np.asarray(Image.open(os.path.join(FIXTURES,
                                               "SegmentationClass",
                                               f"{i}.png")))
        objs = []
        for c in sorted(set(np.unique(m)) - {0, 255}):
            ys, xs = np.nonzero(m == c)
            objs.append(
                f"<object><name>{tvoc.DET_CLASS_NAMES[c - 1]}</name>"
                f"<difficult>{int(not objs)}</difficult><bndbox>"
                f"<xmin>{xs.min() + 1}</xmin><ymin>{ys.min() + 1}</ymin>"
                f"<xmax>{xs.max() + 1}</xmax><ymax>{ys.max() + 1}</ymax>"
                "</bndbox></object>")
        with open(os.path.join(root, "Annotations", f"{i}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{m.shape[1]}</width>"
                    f"<height>{m.shape[0]}</height></size>"
                    f"{''.join(objs)}</annotation>")
    for split in ("train", "val"):
        with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")


def test_voc_xml_reader_and_sources_match_jax(tmp_path):
    _annotations(str(tmp_path))
    for keep in (False, True, "mark"):
        got = tvoc.read_detection_subset(str(tmp_path), "train", keep)
        want = jvoc.read_detection_subset(str(tmp_path), "train", keep)
        assert got[0] == want[0]
        for (gb, gl), (wb, wl) in zip(got[1], want[1]):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gl, wl)
    assert any((lab <= -2).any() for _, lab in tvoc.read_detection_subset(
        str(tmp_path), "val", "mark")[1])
    mine = tvoc.make_detection_source(str(tmp_path), "val",
                                      raw_hw=(96, 96), max_boxes=4)
    theirs = jvoc.make_detection_source(str(tmp_path), "val",
                                        raw_hw=(96, 96), max_boxes=4)
    for g, w in zip(mine.get_batch(np.arange(4)),
                    theirs.get_batch(np.arange(4))):
        np.testing.assert_array_equal(g, w)
    mine.close()
    for seed in (0, 1):
        for g, w in zip(tvoc.synthetic_detection_subset(6, (48, 64), seed),
                        jvoc.synthetic_detection_subset(6, (48, 64), seed)):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------- recipe, entry points


TINY_SETS = ["model=tinydet", "input_hw=[96,96]", "model_kwargs={'width':8}",
             "precision=f32"]


def _jax_entry(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_entry", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("det")
    out = str(tmp / "run")
    common = ["--config", SSD_CONFIG, "--synthetic", "--device", "cpu",
              *[a for kv in TINY_SETS for a in ("--set", kv)]]
    trainer = train_entry.main(common + ["--steps", "2", "--batch", "8",
                                         "--val_every", "2", "--set",
                                         "log_every=1", "--out", out])
    cfg = recipes.apply_overrides(recipes.load_config(SSD_CONFIG),
                                  TINY_SETS)
    port = str(tmp / "det.pt2")
    test_entry.main(common + ["--ckpt", out, "--export", port])
    return dict(tmp=tmp, out=out, common=common, trainer=trainer, cfg=cfg,
                port=port)


def test_train_and_test_entry_points_match_jax(run, monkeypatch, capsys):
    """``train.main`` 2 steps (val_mAP logged), ``test.main`` VOC and COCO
    mAP, against JAX's ``test.py`` on the port's checkpoint."""
    assert run["trainer"].step == 2
    with open(os.path.join(run["out"], "detection.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert any("val_mAP" in r for r in rows)
    for extra in ([], ["--coco"]):
        score, _ = test_entry.main(run["common"] + ["--ckpt", run["out"],
                                                    "--batch", "16",
                                                    *extra])
        mine = capsys.readouterr().out.splitlines()
        monkeypatch.setattr(sys, "argv", [
            "test.py", "--config", SSD_CONFIG, "--ckpt", run["out"],
            "--synthetic", "--batch", "16", *extra,
            *[a for kv in TINY_SETS for a in ("--set", kv)]])
        _jax_entry("test").main()
        theirs = capsys.readouterr().out.splitlines()
        head = theirs[-1] if not extra else theirs[-11]
        assert head.startswith("mAP")
        assert abs(float(head.split()[-1]) - score) <= 1e-4
        assert mine[-1].split(":")[0] == theirs[-1].split(":")[0]


@pytest.fixture(scope="module")
def jpath(run):
    """JAX's detection artifact (its ``export_detection``) of the run's
    checkpoint, restored by the JAX package."""
    from myconvnet_tpu.ckpt import checkpoint as jckpt
    jstate, _, predict, _, _ = jrecipes.build_detector(run["cfg"],
                                                       synthetic=True)
    jstate = type(jstate)(**jckpt.restore_checkpoint(run["out"],
                                                     jstate._asdict()))
    path = str(run["tmp"] / "det.hlo")
    jserving.export_detection(predict, jstate, np.zeros(
        (8, 96, 96, 3), np.float32), path)
    return path


def test_detect_artifact_matches_jax_and_its_program(run, jpath):
    """The artifact (``mcn::`` nodes, the fixed-trip NMS): bit for bit
    against its in-memory program, and JAX's artifact of the same weights
    gives the same valid detections."""
    meta = serving.artifact_meta(run["port"])
    assert meta["kind"] == "detect" and meta["input_shape"] == [8, 96, 96, 3]
    x = np.random.RandomState(3).rand(8, 96, 96, 3).astype(np.float32)
    got = serving.load_inference(run["port"], "cpu")(x)
    route = serving_http.build_route("d", "detect", run["cfg"],
                                     ckpt=run["out"], device="cpu")
    for a, b in zip(got, route.fn(torch.from_numpy(x))):
        assert torch.equal(a, b)
    want = [np.asarray(w) for w in jserving.load_inference(jpath)(x)]
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    v = want[3]
    assert v.any()
    np.testing.assert_array_equal(got[2].numpy()[v], want[2][v])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[v], w[v], atol=1e-4)


def test_serve_detect_and_the_route_match_jax(run, jpath, capsys,
                                              monkeypatch):
    images = str(run["tmp"] / "imgs")
    shutil.copytree(os.path.join(FIXTURES, "JPEGImages"), images)
    monkeypatch.setattr(sys, "argv", ["serve.py", "--artifact", jpath,
                                      "--detect", "--images", images,
                                      "--det_threshold", "0.05",
                                      "--config", SSD_CONFIG])
    _jax_entry("serve").main()
    want = capsys.readouterr().out.splitlines()
    rows = serve.main(["--artifact", run["port"], "--detect", "--images",
                       images, "--det_threshold", "0.05", "--config",
                       SSD_CONFIG, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(rows) == 4 and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.split(" [")[0].rsplit(" ", 1)[0] == \
            w.split(" [")[0].rsplit(" ", 1)[0]
    x = np.random.RandomState(4).rand(3, 96, 96, 3).astype(np.float32)
    body = json.dumps({"instances": x.tolist()}).encode()
    want = jhttp.ModelServer([jhttp.build_route(
        "d", "detect", jpath, config=SSD_CONFIG, threshold=0.05)]
    ).predict("d", body)["detections"]
    for route in (serving_http.artifact_route("d", "detect", run["port"],
                                              SSD_CONFIG, device="cpu",
                                              threshold=0.05),
                  serving_http.build_route("d", "detect", run["cfg"],
                                           ckpt=run["out"], device="cpu",
                                           threshold=0.05)):
        got = serving_http.ModelServer([route]).predict(
            "d", body)["detections"]
        assert len(got) == len(want) == 3
        for gi, wi in zip(got, want):
            assert [d["label"] for d in gi] == [d["label"] for d in wi]
            for gd, wd in zip(gi, wi):
                np.testing.assert_allclose(gd["box"], wd["box"], atol=1e-4)
                assert abs(gd["score"] - wd["score"]) <= 1e-4
    got = serving_http.ModelServer([serving_http.artifact_route(
        "d", "detect", run["port"], SSD_CONFIG, device="cpu")]).predict(
            "d", body, threshold=0.05)["detections"]
    assert [len(r) for r in got] == [len(r) for r in want]


@pytest.mark.parametrize("sets,match", [
    (["model=fcos"], "A17c\\(ii\\), FCOS"),
    (["model=faster_rcnn"], "A17c\\(ii\\)"),
    (["model=mask_rcnn"], "A17c\\(iii\\)"),
    (["dataset=coco"], "A17c\\(iii\\)"),
    (["pretrained={'path':'v.pth','arch':'vgg16'}"], "VGG-16")],
    ids=["fcos", "faster_rcnn", "mask_rcnn", "coco", "vgg_pretrained"])
def test_unported_detection_recipes_are_refused_by_name(sets, match):
    cfg = recipes.apply_overrides(recipes.load_config(SSD_CONFIG), sets)
    with pytest.raises(ValueError, match=match):
        recipes_detection.build_detector(cfg, True,
                                         device=torch.device("cpu"))


def test_export_int8_of_a_detector_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="--int8"):
        test_entry.main(["--config", SSD_CONFIG, "--ckpt", str(tmp_path),
                         "--device", "cpu", "--export",
                         str(tmp_path / "a.pt2"), "--int8"])


def test_detect_route_over_http_takes_a_threshold(run):
    """``POST /v1/models/<name>:predict?threshold=T`` over the stdlib
    server: the reply keeps the detections at or above T."""
    import threading
    import urllib.request
    route = serving_http.artifact_route("det", "detect", run["port"],
                                        SSD_CONFIG, device="cpu")
    httpd = serving_http.make_http_server(
        serving_http.ModelServer([route]), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    x = np.random.RandomState(5).rand(1, 96, 96, 3).astype(np.float32)
    body = json.dumps({"instances": x.tolist()}).encode()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}/v1/models/"
           "det:predict")
    try:
        replies = {}
        for thr in ("0.0", "0.3"):
            req = urllib.request.Request(f"{url}?threshold={thr}", body, {
                "Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                replies[thr] = json.loads(r.read())["detections"][0]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert len(replies["0.0"]) >= len(replies["0.3"])
    assert all(d["score"] >= 0.3 for d in replies["0.3"])
    assert replies["0.3"] == [d for d in replies["0.0"] if d["score"] >= 0.3]
