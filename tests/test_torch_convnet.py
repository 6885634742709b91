"""The port's ``ConvNet`` API against the JAX package's, on the CPU.

SmallNet at width 4 (16x16 inputs, 4 classes) and ResNet-18 at width 8
(32x32, 10 classes, the randomized trees of ``test_torch_train``), their
JAX weights loaded into the port through ``weights.from_jax``; a one-conv
net made through each package's subclass hook for the segmentation
protocols.  Tolerances: outputs at float32 within 1e-5 of the largest
|JAX output|; class maps, counts, scores, reports and checkpoint trees
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import nn as jnn
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.data.augment import AugmentConfig as JAug
from myconvnet_tpu.eval import evaluators as jev
from myconvnet_tpu.models.base import ConvNet as JConvNet
from myconvnet_tpu.train.ssl import export_encoder_npz
from myconvnet_tpu_torch import models, recipes, weights
from myconvnet_tpu_torch.ckpt import checkpoint as ckpt
from myconvnet_tpu_torch.data.augment import AugmentConfig
from myconvnet_tpu_torch.eval import evaluators as ev
from myconvnet_tpu_torch.models.base import ConvNet
from myconvnet_tpu_torch.nn import Conv
from myconvnet_tpu_torch.train.trainer import InputFns

from test_torch_train import (CLASSES, HW, WIDTH, _net, _np_tree,
                              _randomize, trees)  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


AUG = dict(out_hw=(16, 16), area_range=None, flip=False)


def _close(got, want, tol=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _smallnets(augment=AUG):
    """(JAX net, port net) of SmallNet at width 4 with the same weights,
    BN statistics randomized."""
    jnet = JConvNet(jmodels.smallnet, input_shape=(16, 16, 3),
                    num_classes=4, augment=JAug(**augment) if augment
                    else None, width=4, dropout_rate=0.0, seed=3)
    jnet.build()
    params, state = _randomize(jnet.state.params, jnet.state.model_state)
    jnet.state = jnet.state._replace(params=params, model_state=state)
    tnet = ConvNet(models.smallnet, input_shape=(16, 16, 3), num_classes=4,
                   augment=AugmentConfig(**augment) if augment else None,
                   width=4, dropout_rate=0.0, seed=3, device="cpu")
    weights.from_jax(tnet.trainer.model, params, state)
    return jnet, tnet


def _resnets(trees, **kw):
    params, state = trees
    jnet = _net(**kw)
    jnet.build()
    jnet.state = jnet.state._replace(params=params, model_state=state)
    tnet = ConvNet(models.resnet18, input_shape=(HW, HW, 3),
                   num_classes=CLASSES, width=WIDTH, device="cpu", **kw)
    weights.from_jax(tnet.trainer.model, params, state)
    return jnet, tnet


def _u8(n, hw, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, *hw, 3),
                                               dtype=np.uint8)


# -------------------------------------------------------------- predict


@pytest.mark.parametrize("tta,raw_hw,augment", [
    (None, (20, 20), AUG), ("flip", (20, 20), AUG),
    ("flip", (16, 16), AUG), ("ten_crop", (20, 20), AUG),
    ("ten_crop", (22, 18), AUG), ("flip", (16, 16), None)],
    ids=["plain", "flip_resized", "flip_at_size", "ten_crop",
         "ten_crop_oblong", "flip_float_inputs"])
def test_predict_matches_jax(tta, raw_hw, augment):
    """``predict`` plain and under TTA (log of the views' mean softmax)
    at float32: 1e-5 of max |JAX|.  The port runs a tail batch of 2 where
    JAX pads it."""
    jnet, tnet = _smallnets(augment)
    x = _u8(6, raw_hw, 1)
    if augment is None:
        x = (x.astype(np.float32) / 255.0 - 0.5)
    want = jnet.predict(x, batch_size=6, tta=tta)
    got = tnet.predict(x, batch_size=4, tta=tta)
    assert got.shape == want.shape == (6, 4) and got.dtype == np.float32
    _close(got, want, what=str(tta))
    if tta is not None:   # log-probabilities
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)


def test_tail_batch_logits_equal_the_full_batchs(trees):
    """Each image of a short tail batch (padded, as JAX pads it) gets the
    bits it gets inside a full batch, at another position."""
    _, tnet = _resnets(trees)
    x = np.random.RandomState(2).randn(7, HW, HW, 3).astype(np.float32)
    tail = tnet.predict(x, batch_size=5)[5:]
    inside = tnet.predict(x[2:], batch_size=5)[3:]
    np.testing.assert_array_equal(tail, inside)
    feats = tnet.features(x, batch_size=5)[5:]
    np.testing.assert_array_equal(feats, tnet.features(x[2:], 5)[3:])


def test_predict_refusals():
    _, tnet = _smallnets(None)
    x = np.zeros((1, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="augment config"):
        tnet.predict(x, tta="ten_crop")
    with pytest.raises(ValueError, match="unknown tta"):
        tnet.predict(x, tta="bogus")
    with pytest.raises(ValueError, match="'x8'"):
        tnet.predict(x, tta="x8")
    fns = InputFns(None, None, lambda v: v.float())
    flow = ConvNet(models.smallnet, input_shape=(16, 16, 3), width=4,
                   input_fns=fns, device="cpu")
    with pytest.raises(ValueError, match="augment_fns"):
        flow.predict(x, tta="flip")
    for kw, name in ((dict(augment_fns=(None, None, None)), "augment_fns"),
                     (dict(mesh=object()), "mesh"),
                     (dict(use_mesh=True), "mesh")):
        with pytest.raises(ValueError, match=name):
            ConvNet(models.smallnet, device="cpu", **kw)
    with pytest.raises(ValueError, match="model_fn"):
        ConvNet(device="cpu")


# ----------------------------------------------------- segmentation


class _JaxHead(JConvNet):
    def _forward(self, x, train):
        return jnn.conv(x, 5, 3, stride=2, name="head")


class _Head(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.head = Conv(3, 5, 3, stride=2, bias=True)

    def forward(self, x):
        return self.head(x)


class _PortHead(ConvNet):
    def _build_model(self):
        return _Head()


SEG_AUG = dict(out_hw=(24, 30), mean=(0.485, 0.456, 0.406),
               std=(0.229, 0.224, 0.225))


@pytest.mark.parametrize("kw", [dict(scales=(0.75, 1.0, 1.25), flip=True),
                                dict(scales=(1.0,), flip=False),
                                dict(tile_hw=(16, 16))],
                         ids=["multiscale_flip", "single", "sliding"])
def test_predict_segmentation_matches_jax(kw):
    """The subclass hooks (JAX ``_forward``, the port's ``_build_model``)
    and ``predict_segmentation``'s protocols on raw uint8 frames: the
    class maps equal JAX's."""
    jnet = _JaxHead(input_shape=(24, 30, 3), num_classes=5,
                    augment=JAug(**SEG_AUG), seed=1)
    jnet.build()
    tnet = _PortHead(input_shape=(24, 30, 3), num_classes=5,
                     augment=AugmentConfig(**SEG_AUG), device="cpu")
    rng = np.random.RandomState(3)
    params = {"head": {"w": (0.3 * rng.randn(3, 3, 3, 5)).astype(
        np.float32), "b": (0.1 * rng.randn(5)).astype(np.float32)}}
    jnet.state = jnet.state._replace(params=params)
    weights.from_jax(tnet.trainer.model, params, {})
    x = _u8(3, (24, 30), 4)
    want = jnet.predict_segmentation(x, batch_size=3, **kw)
    got = tnet.predict_segmentation(x, batch_size=2, **kw)
    assert got.shape == want.shape == (3, 24, 30)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- inspect


@pytest.mark.parametrize("which", ["smallnet", "resnet18"])
def test_features_match_jax(trees, which):
    """The map each JAX model tags ``features`` (before the pooling)."""
    jnet, tnet = _smallnets() if which == "smallnet" else _resnets(trees)
    shape = (5, *jnet.input_shape)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = jnet.features(x, batch_size=5)
    got = tnet.features(x, batch_size=3)
    assert got.shape == want.shape
    _close(got, want)
    with pytest.raises(ValueError, match="'relu1_1'"):
        tnet.features(x, tag="relu1_1")


@pytest.mark.parametrize("which", ["smallnet", "resnet18"])
def test_count_params_and_summary_rows_match_jax(trees, which):
    jnet, tnet = _smallnets() if which == "smallnet" else _resnets(trees)
    assert tnet.count_params() == jnet.count_params()
    jrows = [r for r in jnet.summary(print_fn=None).splitlines()
             if "GFLOPs" not in r]
    trows = [r for r in tnet.summary(print_fn=None).splitlines()
             if "GFLOPs" not in r]
    assert sorted(trows) == sorted(jrows)
    deep = tnet.summary(depth=2, print_fn=None)
    assert deep.splitlines()[2:-3] == [
        r for r in jnet.summary(depth=2, print_fn=None).splitlines()[2:-3]]


# FlopCounterMode counts two FLOPs a multiply-add of every tap of every
# convolution and matmul, SAME padding's taps included; XLA's CPU cost
# analysis counts only the taps that land inside the input, and adds the
# elementwise ops (BN, ReLU, pooling, residual adds).  On these small
# maps most taps of the late stages fall in the padding (ResNet-18's
# stage 4 is 1x1 at 32x32 input), so the port counts more: port / JAX
# measured 1.1640 for SmallNet at 16x16 and 1.4246 for ResNet-18 at 32x32.
FLOPS_OVER_JAX = {"smallnet": 1.1640, "resnet18": 1.4246}


def _mac_flops(model, x):
    """Two FLOPs a multiply-add of every conv tap and dense weight."""
    from myconvnet_tpu_torch.nn import Dense
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, Conv):
            total[0] += 2 * out.numel() * int(np.prod(mod.weight.shape[1:]))
        else:
            total[0] += 2 * out.numel() * mod.weight.shape[1]

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    with torch.no_grad():
        model.eval()(x)
    for h in hooks:
        h.remove()
    return total[0]


@pytest.mark.parametrize("which", ["smallnet", "resnet18"])
def test_forward_flops_counts_every_tap(trees, which):
    jnet, tnet = _smallnets() if which == "smallnet" else _resnets(trees)
    got = tnet.forward_flops()
    x = torch.zeros(1, *tnet.input_shape)
    assert got == _mac_flops(tnet.trainer.model, x)
    assert tnet.forward_flops(2) == got   # an image's, at any batch
    ratio = got / jnet.forward_flops()
    assert abs(ratio - FLOPS_OVER_JAX[which]) < 5e-4, ratio


# ---------------------------------------------------------- evaluators


def test_evaluators_match_jax_exactly():
    rng = np.random.RandomState(6)
    logits = rng.randn(3, 40, 7).astype(np.float32)
    labels = rng.randint(0, 7, (3, 40))
    names = [f"class{i}" for i in range(7)]
    pairs = [(jev.AccuracyEvaluator(k=5), ev.AccuracyEvaluator(k=5)),
             (jev.AccuracyEvaluator(), ev.AccuracyEvaluator()),
             (jev.ConfusionMatrixEvaluator(7),
              ev.ConfusionMatrixEvaluator(7)),
             (jev.JointEvaluator(jev.AccuracyEvaluator(k=3),
                                 jev.ConfusionMatrixEvaluator(7)),
              ev.JointEvaluator(ev.AccuracyEvaluator(k=3),
                                ev.ConfusionMatrixEvaluator(7)))]
    for j, t in pairs:
        for b in range(3):
            j.update(jnp.asarray(logits[b]), jnp.asarray(labels[b]))
            t.update(torch.from_numpy(logits[b]), torch.from_numpy(
                labels[b]))
        assert t.name == j.name and t.higher_is_better == j.higher_is_better
        assert t.score() == j.score()
        if hasattr(j, "report"):
            assert t.report(names) == j.report(names)
            assert t.report() == j.report()
    cm_j, cm_t = pairs[2]
    np.testing.assert_array_equal(cm_t.matrix, cm_j.matrix)
    assert cm_t.macro_f1() == cm_j.macro_f1()


# --------------------------------------------------------- checkpoints


def _write_runs(directory, writer, jnet, tnet):
    """Three checkpoints (steps 1-3, the parameters moved each time),
    step 2 the best, written by ``writer``'s package."""
    params = _np_tree(jnet.state.params)
    for s in (1, 2, 3):
        moved = {k: {n: v + np.float32(0.01 * s) * np.sign(v) for n, v
                     in d.items()} for k, d in params.items()}
        if writer == "jax":
            state = jnet.state._replace(params=moved, step=jnp.asarray(s))
            jckpt.save_checkpoint(directory, s, state._asdict(),
                                  metric=float(s), is_best=s == 2)
        else:
            weights.from_jax(tnet.trainer.model, moved,
                             _np_tree(jnet.state.model_state))
            tnet.trainer.step = s
            ckpt.save_checkpoint(directory, s, tnet.state._asdict(),
                                 metric=float(s), is_best=s == 2)


def _flat(tree):
    return {k: np.asarray(v) for k, v in ckpt.flatten(tree).items()
            if not k.startswith("rng")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_average_and_best_checkpoints_match_jax(tmp_path, writer):
    jnet, tnet = _smallnets()
    d = str(tmp_path)
    _write_runs(d, writer, jnet, tnet)
    for n in (0, 1, 2):
        want = jckpt.average_checkpoints(d, jnet.state._asdict(), n_last=n)
        got = ckpt.average_checkpoints(d, tnet.state._asdict(), n_last=n)
        want = _flat(jax_tree_to_dict(want))
        got = _flat(got)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ckpt.best_checkpoint(d) == jckpt.best_checkpoint(d)
    best = ckpt.best_checkpoint(d)
    assert ckpt.checkpoint_step(best) == jckpt.checkpoint_step(best) == 2
    assert ckpt.checkpoint_step(ckpt.latest_checkpoint(d)) == 3
    assert ckpt.best_checkpoint(str(tmp_path / "none")) is None


def jax_tree_to_dict(state: dict) -> dict:
    """A restored JAX state (NamedTuple opt states) as nested dicts keyed
    as the checkpoint names them."""
    from test_torch_optim_wrappers import nested
    return nested(jckpt._flatten(state))


def test_apply_pretrained_from_a_jax_written_npz(tmp_path):
    """JAX's encoder export (a ``scope::name`` subset without the head)
    warm-starts the port's net as JAX's ``apply_pretrained`` does; the
    torch-file form and a shape that differs are refused."""
    src, _ = _smallnets()
    path = export_encoder_npz(src.state.params, str(tmp_path / "enc.npz"))
    cfg = {"pretrained": {"path": path}}
    jnet = JConvNet(jmodels.smallnet, input_shape=(16, 16, 3),
                    num_classes=4, width=4, dropout_rate=0.0, seed=9)
    jnet.build()
    jrecipes.apply_pretrained(jnet, cfg)
    tnet = ConvNet(models.smallnet, input_shape=(16, 16, 3), num_classes=4,
                   width=4, dropout_rate=0.0, seed=9, device="cpu")
    before = weights.to_jax(tnet.trainer.model)[0]
    recipes.apply_pretrained(tnet, cfg)
    got = weights.to_jax(tnet.trainer.model)[0]
    want = _np_tree(jnet.state.params)
    with np.load(path) as f:
        in_file = {k.split("::")[0] for k in f.files}
    assert "logits" not in in_file and "fc1" not in in_file
    for scope in want:
        for n in want[scope]:   # the head stays at each package's init
            np.testing.assert_array_equal(
                got[scope][n], (want if scope in in_file
                                else before)[scope][n])
    with pytest.raises(ValueError, match="'pretrained'"):
        recipes.apply_pretrained(tnet, {"pretrained": {"path": "r50.pth"}})
    with pytest.raises(ValueError, match="'pretrained'"):
        recipes.apply_pretrained(tnet, {"pretrained": "enc.npz"})
    wide = ConvNet(models.smallnet, input_shape=(16, 16, 3), num_classes=4,
                   width=8, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        recipes.apply_pretrained(wide, cfg)


# ------------------------------------------------------ build and train


def test_build_is_idempotent_and_a_new_optimizer_resets(trees):
    import myconvnet_tpu_torch
    assert myconvnet_tpu_torch.ConvNet is ConvNet   # as myconvnet_tpu's
    _, tnet = _resnets(trees)
    model = tnet.trainer.model
    assert tnet.build() is tnet and tnet.trainer.model is model
    assert tnet.optimizer.momentum == 0.9        # momentum(0.01, 0.9)
    assert tnet.optimizer.schedule(0) == np.float32(0.01)
    factory = recipes.optimizer_factory(dict(name="sgd", lr=0.1))
    tnet.train(_Empty(), total_steps=0, optimizer=factory)
    assert tnet.trainer.model is not model       # a fresh, seeded build
    fresh = ConvNet(models.resnet18, input_shape=(HW, HW, 3),
                    num_classes=CLASSES, width=WIDTH, device="cpu")
    a = weights.to_jax(tnet.trainer.model)[0]
    b = weights.to_jax(fresh.trainer.model)[0]
    for s in a:
        for n in a[s]:
            np.testing.assert_array_equal(a[s][n], b[s][n])
    again = tnet.trainer
    tnet.train(_Empty(), total_steps=0, optimizer=factory)
    assert tnet.trainer is again                 # the same factory: kept
    tnet.close()
    assert tnet.model is None and tnet._trainer is None


class _Empty:
    def __len__(self):
        return 0

    def train_iter(self, batch_size, device):
        return iter([])
