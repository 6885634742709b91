"""The port's FCOS and Faster R-CNN models and recipe steps against the JAX
package, on the CPU.

``tinyfcos`` and ``tinyfrcnn``: the scopes against the JAX init tree (and
``fcos`` and ``faster_rcnn`` at 512²), the float32 eval outputs (the RPN's
proposals included, and the second stage alone on JAX's own RoIs), one
float32 step of each recipe's chain at JAX's draws (the SSD augmentation,
the RPN sample's and the RoI sample's priorities), and the bf16 eval
routing of the full-width models at 512².

JAX initializes the RPN's objectness from N(0, 0.01): its scores all lie
within ulps of 0.5, and the two frameworks' float32 convs then order them
apart.  The trees here draw ``rpn/obj`` at 0.15 of He scale, and each test asserts
its discrete decisions a margin from their ties and thresholds: the top
scores at least 1e-6 apart, every IoU the NMS or a match compares 1e-5
from its threshold, FCOS's distances 1e-5 from 0 and from the band edges.

Tolerances: float32 eval outputs within 1e-4 of the largest; proposals,
sampled RoIs, labels and ``valid`` equal (boxes within 1e-5); the loss
within 1e-4 relative; the gradients with each ReLU's derivative taken
where JAX's pre-activation is positive
(``test_torch_seg_family.check_grads_with_kinks``): the tree within 1e-3
of its largest, each leaf within 5e-3 of its own.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.ops import boxes as jboxes
from myconvnet_tpu.train import detection as jdet
from myconvnet_tpu.train import fcos as jfcos
from myconvnet_tpu.train import rcnn as jrcnn
from myconvnet_tpu_torch import models, recipes, recipes_detection, weights
from myconvnet_tpu_torch.models import blocks, resnet
from myconvnet_tpu_torch.models.retinanet import tiny_pyramid
from myconvnet_tpu_torch.ops import roi
from myconvnet_tpu_torch.train import detection as det

from test_torch_detection import jax_draws
from test_torch_seg_family import check_grads_with_kinks, spy_relus

jrdet = importlib.import_module("myconvnet_tpu.recipes.detection")
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last."""
    torch.set_num_threads(1)


CLASSES = 21
HW = (128, 128)
CONFIGS = {"tinyfcos": "configs/voc_fcos.py",
           "tinyfrcnn": "configs/voc_faster_rcnn.py"}
# case: (kwargs of both packages, weight seed, input seed); tinyfrcnn at
# its own knobs cut so that the RPN's top candidates stand apart (the
# recipes' defaults run in test_torch_two_stage_cli)
TINY = {"tinyfcos": (dict(width=8), 0, 10),
        "tinyfrcnn": (dict(width=8, pre_topk=64, post_train=48,
                           post_eval=32, num_samples=32), 1, 11)}
# the RPN objectness weights' scale in the test trees: logits of about
# unit spread, whose sigmoids do not crowd at 1
RPN_OBJ_SCALE = 0.15
CONST_LR = dict(name="momentum", momentum_coef=0.9, weight_decay=1e-4,
                wd_exclude_norms=True, lr=0.01)


def _t(a):
    return torch.from_numpy(np.array(a))


def margin(values, thresholds):
    v = np.asarray(values, np.float64).reshape(-1)
    return min(np.abs(v - t).min() for t in thresholds)


def jax_fn(name, kw):
    fn = jmodels.get_model(name)
    return transform(lambda x, train, **det_kw: fn(
        x, CLASSES, train=train, **det_kw, **kw))


def make_trees(name, kw, seed):
    """Random JAX-layout trees: biases 0.1 N(0, 1), the classification
    head's at the prior, the RPN's objectness at RPN_OBJ_SCALE of He's."""
    model = models.DETECTORS[name](CLASSES, **kw)
    params, state = weights.random_jax_params(model, seed)
    rng = np.random.RandomState(60 + seed)
    for scope, p in params.items():
        if "b" in p:
            p["b"] = (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)
        if scope.endswith("cls_head/out"):
            p["b"] = p["b"] - 4.6
        if scope == "rpn/obj":
            p["w"] = p["w"] * np.float32(RPN_OBJ_SCALE)
    return params, state


def images(seed, b=2):
    return np.random.RandomState(seed).rand(b, *HW, 3).astype(np.float32)


def targets(seed, b=4, m=6):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0.0, 0.6, (b, m, 2))
    wh = rng.uniform(0.15, 0.4, (b, m, 2))
    bx = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    lab = rng.randint(1, CLASSES, (b, m)).astype(np.int32)
    lab[:, -2:] = -1
    return bx, lab


def check_rpn_margins(logits, loc, anchors, pre_topk):
    """Each image's top ``pre_topk`` RPN scores 1e-6 apart, and every IoU
    among their decoded boxes 1e-5 from the NMS's 0.7."""
    logits = np.asarray(logits, np.float64)
    dec = np.clip(np.asarray(jboxes.decode_boxes(
        np.asarray(loc), anchors[None], variances=(1.0, 1.0))), 0, 1)
    for i in range(len(logits)):
        order = np.argsort(-logits[i], kind="stable")[:pre_topk + 1]
        s = 1 / (1 + np.exp(-logits[i][order]))
        assert np.diff(s).max() < -1e-6
        top = dec[i][order[:pre_topk]]
        iou = np.asarray(jboxes.box_iou(top, top))
        assert margin(iou[np.triu_indices(pre_topk, 1)], [0.7]) > 1e-5


# ------------------------------------------------------------------ scopes


@pytest.mark.parametrize("name,kw,hw", [
    ("tinyfcos", dict(width=8), HW), ("tinyfrcnn", dict(width=8), HW),
    ("fcos", {}, (512, 512)), ("faster_rcnn", {}, (512, 512))])
def test_scopes_match_the_jax_init_tree(name, kw, hw):
    jparams, jstate = jax.eval_shape(lambda: jax_fn(name, kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), False))
    model = models.DETECTORS[name](CLASSES, **kw)
    p2, s2 = weights.to_jax(model)
    assert set(p2) == set(jparams) and set(s2) == set(jstate)
    for tree, mine in ((jparams, p2), (jstate, s2)):
        for scope in tree:
            assert {n: v.shape for n, v in mine[scope].items()} == \
                {n: tuple(v.shape) for n, v in tree[scope].items()}, scope
    if name.endswith("fcos"):
        assert p2["scale1"]["s"].shape == ()
        # a 0-d scale takes no weight decay under the recipe's exclusion
        opt = recipes.make_optimizer(model, dict(CONST_LR))
        assert not opt.opt.param_groups[1]["weight_decay"]
        assert any(p is model.scale1.s
                   for p in opt.opt.param_groups[1]["params"])
    else:
        assert p2["box_head/fc1"]["w"].shape[0] == (
            7 * 7 * 256 if name == "faster_rcnn" else 5 * 5 * 16)


# -------------------------------------------------------------------- eval


def jax_eval(name, kw, params, state, x):
    fn = jax_fn(name, kw)

    def apply(p, s, v):
        with policy_scope(JFULL):
            return fn.apply(p, s, None, v, False)[0]

    return jax.jit(apply)(params, state, jnp.asarray(x))


def close(got, want, rel=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rel,
                               atol=rel * np.abs(want).max())


def test_tinyfcos_eval_matches_jax():
    kw, seed, xseed = TINY["tinyfcos"]
    params, state = make_trees("tinyfcos", kw, seed)
    x = images(xseed)
    want = jax_eval("tinyfcos", kw, params, state, x)
    model = weights.from_jax(models.DETECTORS["tinyfcos"](CLASSES, **kw),
                             params, state).eval()
    with torch.no_grad():
        got = model(_t(x))
    assert [g.shape[1] for g in got] == [336] * 3
    for g, w in zip(got, want):
        close(g, w)
    # under bf16 the distances are float32, as the float32 scale makes
    # JAX's
    with torch.no_grad():
        got = model(_t(x).bfloat16())
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.float32


def test_tinyfrcnn_eval_matches_jax():
    """The RPN outputs, the 64 proposals (``valid`` equal, boxes within
    1e-5), the box head; and the second stage alone on JAX's RoIs."""
    kw, seed, xseed = TINY["tinyfrcnn"]
    params, state = make_trees("tinyfrcnn", kw, seed)
    x = images(xseed)
    want = jax_eval("tinyfrcnn", kw, params, state, x)
    model = weights.from_jax(models.DETECTORS["tinyfrcnn"](CLASSES, **kw),
                             params, state).eval()
    check_rpn_margins(want.rpn_logits, want.rpn_loc,
                      model.anchors.numpy(), model.pre_topk)
    with torch.no_grad():
        got = model(_t(x))
        feats = tiny_pyramid(model.backbone, model.fpn, _t(x))
        crops = roi.multilevel_roi_align(feats, _t(want.rois), 5,
                                         chunk=model.chunk)
        alone = model.box_head(crops)
    close(got.rpn_logits, want.rpn_logits)
    close(got.rpn_loc, want.rpn_loc)
    valid = np.asarray(want.roi_valid)
    np.testing.assert_array_equal(got.roi_valid.numpy(), valid)
    assert valid.any()
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois),
                               atol=1e-5)
    np.testing.assert_allclose(got.roi_scores.numpy(),
                               np.asarray(want.roi_scores), atol=1e-6)
    close(got.roi_cls, want.roi_cls)
    close(got.roi_reg, want.roi_reg)
    close(alone[0], want.roi_cls)
    close(alone[1], want.roi_reg)
    for f in ("roi_labels", "roi_pos", "roi_gt"):
        assert not getattr(got, f).any()


# -------------------------------------------------------- the recipe step


def step_keys(jstate, two_stage):
    key = jax.random.fold_in(jax.random.wrap_key_data(jstate.rng),
                             jstate.step)
    if two_stage:
        return jax.random.split(key, 3)
    aug, model_key = jax.random.split(key)
    return aug, None, model_key


def recipe(name, kw):
    cfg = recipes.apply_overrides(recipes.load_config(CONFIGS[name]), [
        f"model={name}", "input_hw=[128,128]", "precision=f32"])
    cfg["model_kwargs"] = dict(kw)
    cfg["optimizer"] = dict(CONST_LR, clip_norm=1.0) \
        if name == "tinyfcos" else dict(CONST_LR)
    return cfg


@pytest.mark.parametrize("name", list(TINY))
def test_recipe_step_matches_jax_f32(name, monkeypatch):
    """The recipe's chain at JAX's draws (the SSD augmentation; the RPN
    sample's priorities from its ``rpn`` key, the RoI sample's from the
    forward's ``fold_in(model, 1)``): the loss, its parts, the sampled
    RoIs and the gradients; then the port's whole step (FCOS's momentum
    with ``clip_norm``) against JAX's jitted recipe step."""
    kw, seed, xseed = TINY[name]
    two_stage = name == "tinyfrcnn"
    cfg = recipe(name, kw)
    params, state = make_trees(name, kw, seed)
    bx, lab = targets(xseed)
    x = np.random.RandomState(xseed + 1).randint(
        0, 256, (4, *HW, 3)).astype(np.uint8)
    jstate, jstep, _, _, _ = jrecipes.build_detector(cfg, synthetic=True)
    jstate = jstate._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        state=jax.tree_util.tree_map(jnp.asarray, state))
    jstate = jstate._replace(opt=jrecipes.make_optimizer(
        cfg["optimizer"]).init(jstate.params))
    net, grid, _, _, mean, std, _, _ = jrdet._detector_chain(cfg)
    aug = recipes_detection.det_augment(cfg, mean, std)
    jaug = jdet.DetAugment(**aug._asdict())
    aug_key, rpn_key, model_key = step_keys(jstate, two_stage)
    xa, ba, la = jdet.augment_detection_batch(jnp.asarray(x), bx, lab,
                                              aug_key, jaug)
    relus = spy_relus(monkeypatch)

    def objective(p):
        relus.clear()
        if two_stage:
            out, _ = net.apply(p, state, model_key, xa, CLASSES, train=True,
                               gt_boxes=ba, gt_labels=la)
            l_rpn, m_rpn = jrcnn.rpn_loss(
                rpn_key, out.rpn_logits, out.rpn_loc, ba, la, grid,
                num_samples=cfg["rpn_samples"], pos_iou=cfg["rpn_pos_iou"],
                neg_iou=cfg["rpn_neg_iou"])
            l_roi, m_roi = jrcnn.roi_head_loss(
                out.roi_cls, out.roi_reg, out.roi_labels, out.roi_targets,
                out.roi_pos, out.roi_valid)
            return l_rpn + l_roi, ({**m_rpn, **m_roi}, list(relus), out)
        out, _ = net.apply(p, state, model_key, xa, CLASSES, train=True)
        loss, m = jfcos.fcos_loss(*out, *grid, ba, la,
                                  alpha=cfg["focal_alpha"],
                                  gamma=cfg["focal_gamma"],
                                  reg_weight=cfg["reg_weight"])
        return loss, (m, list(relus), out)

    (jl, (jm, jzs, jout)), jgrads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    draws = jax_draws(aug_key, 4, aug)
    ba, la = np.asarray(ba), np.asarray(la)
    if two_stage:
        a = len(grid)
        rpn_rand = np.stack([np.asarray(jax.random.uniform(k, (a,)))
                             for k in jax.random.split(rpn_key, 4)])
        n = kw["post_train"] + ba.shape[1]
        roi_rand = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in
                             jax.random.split(jax.random.fold_in(
                                 model_key, 1), 4)])
        draws = det.RCNNDraws(draws, _t(rpn_rand), _t(roi_rand))
        # the margins of the step's decisions
        check_rpn_margins(jout.rpn_logits, jout.rpn_loc, np.asarray(grid),
                          kw["pre_topk"])
        iou = np.asarray(jax.vmap(lambda g: jboxes.box_iou(grid, g))(ba))
        assert margin(iou[np.broadcast_to(la[:, None] >= 0, iou.shape)],
                      [0.7, 0.3]) > 1e-5
        assert min(len(set(r)) for r in rpn_rand) == a
        assert min(len(set(r)) for r in roi_rand) == n
    else:
        pts = np.asarray(grid[0])
        d = np.concatenate([pts[:, None, :] - ba[:, None, :, :2],
                            ba[:, None, :, 2:] - pts[:, None, :]], -1)
        ok = np.broadcast_to((la >= 1)[:, None, :, None], d.shape)
        assert margin(d[ok], [0.0]) > 1e-5
        assert margin(d.max(-1)[ok[..., 0]], [4 / 16, 4 / 8]) > 1e-5
    seen = {}

    def step():
        tr, _, _ = recipes_detection.build_detector(
            cfg, True, device=torch.device("cpu"))
        weights.from_jax(tr.model, params, state)
        tr.optimizer.zero_grad()
        loss, m = tr.loss(_t(x), _t(bx), _t(lab), draws)
        loss.backward()
        seen.update(loss=float(loss.detach()), m=m, tr=tr)
        return tr.model

    kinks = check_grads_with_kinks(step, jgrads, jzs, monkeypatch,
                                   bound=5e-3, tree_bound=1e-3)
    np.testing.assert_allclose(seen["loss"], float(jl), rtol=1e-4)
    for k, v in jm.items():
        if k.endswith(("_pos", "n_pos")):
            assert int(seen["m"][k]) == int(v), k
        else:
            np.testing.assert_allclose(float(seen["m"][k]), float(v),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    if two_stage:
        assert int(jm["roi_pos"]) > 0 and int(jm["rpn_pos"]) > 0
    # the whole step: the optimizer's update from the same gradients
    if not kinks:
        new, _ = jstep(jstate, (jnp.asarray(x), jnp.asarray(bx),
                                jnp.asarray(lab)))
        tr = seen["tr"]
        before = weights.to_jax(tr.model)[0]
        tr.optimizer.step(tr.step)
        after = weights.to_jax(tr.model)[0]
        for scope, d in params.items():
            for k, v in d.items():
                want = np.asarray(new.params[scope][k]) - v
                got = after[scope][k] - before[scope][k]
                np.testing.assert_allclose(
                    got, want, rtol=5e-3,
                    atol=5e-3 * max(np.abs(want).max(), 1e-12),
                    err_msg=f"{scope}/{k}")


# -------------------------------------------------------------- routing


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
        out = model.eval()(x)
    return calls, out


@pytest.mark.parametrize("name,want", [
    ("fcos", {"b1": 7, "b4": 40, "b5": 13}),
    ("faster_rcnn", {"b1": 7, "b4": 4, "b5": 13})])
def test_eval_routing_at_full_width(name, want, monkeypatch):
    """Under bf16 at 512²: ResNet-50 as the classifier's eval forward (13
    B5, 7 B1); FCOS's towers' 4 layers x 2 x 5 levels and the RPN's conv at
    P3-P6 through B4 (scale 1, the bias the epilogue); the box head's
    products and the RoIAlign take none."""
    model = models.DETECTORS[name](CLASSES)
    x = torch.zeros(1, 512, 512, 3, dtype=torch.bfloat16)
    calls, out = count_routes(model, x, monkeypatch)
    assert calls == want
    if name == "faster_rcnn":
        assert out.rpn_logits.shape == (1, 16320)
        assert out.roi_cls.shape == (1, 300, CLASSES)
    else:
        assert out[0].shape == (1, 5456, CLASSES - 1)


def test_roi_chunk_moves_no_result():
    """``roi_chunk`` changes only how many RoIs a RoIAlign product takes."""
    kw, seed, xseed = TINY["tinyfrcnn"]
    params, state = make_trees("tinyfrcnn", kw, seed)
    x = _t(images(xseed))
    outs = []
    for chunk in (1, 64):
        model = weights.from_jax(models.DETECTORS["tinyfrcnn"](
            CLASSES, **kw), params, state).eval()
        model.chunk = chunk
        with torch.no_grad(), pytest.MonkeyPatch.context() as m:
            m.setattr(roi, "ROI_ALIGN_BYTES", 1)
            outs.append(model(x))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
