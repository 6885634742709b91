"""The port's self-supervised task against the JAX package, on the CPU.

MAE (``tinymae``: the ViT "test" encoder, patch 4 at 8x8, one decoder
block of width 32) and SimCLR (SmallNet at width 8 on 32x32 CIFAR-size
views), LARS, the kNN probe, the encoder export and the ``ssl`` entry
points.  Inputs are seeded numpy; weights are made in the JAX layout and
loaded through ``weights.from_jax``; every random draw of a JAX step (the
crop boxes and flips, the jitter factors, SimCLR's grayscale choice) is
taken from its keys and handed to the port, and MAE's masking is handed
over as a draw whose kept set is JAX's ``mask`` (the encoder does not
depend on the order of the kept tokens).  Tolerances: patchify, the kept
set and the kNN labels exactly; float32 outputs within 1e-5 of their
largest; gradients within 1e-4 of each leaf's largest; the losses within
1e-5; LARS within 1e-6 (relative, of each leaf's largest).
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.models.pretrained import load_npz_weights as jload_npz
from myconvnet_tpu.train import optim as joptim
from myconvnet_tpu.train import ssl as jssl
from myconvnet_tpu_torch import models, recipes, recipes_ssl, weights
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.train import optim, ssl
from myconvnet_tpu_torch.train.ssl import SSLDraws

jmae = importlib.import_module("myconvnet_tpu.models.mae")
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (2), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(2)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAE_CONFIG = os.path.join(ROOT, "configs", "cifar10_mae.py")
SIMCLR_CONFIG = os.path.join(ROOT, "configs", "cifar10_simclr.py")
HW, N = 8, 4


def _np_tree(tree):
    return {s: {n: np.array(v) for n, v in d.items()}
            for s, d in tree.items()}


def _assert_leaves_close(got, want, rtol, what):
    assert set(got) == set(want), what
    for scope, d in want.items():
        assert set(got[scope]) == set(d), (what, scope)
        for name, ref in d.items():
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                got[scope][name], ref, rtol=rtol,
                atol=rtol * max(np.abs(ref).max(), 1e-30),
                err_msg=f"{what} {scope}/{name}")


def _grad_tree(model):
    out = {}
    for path, p, view in weights.param_views(model):
        scope, name = path.rsplit("/", 1)
        g = torch.zeros_like(p) if p.grad is None else p.grad
        out.setdefault(scope, {})[name] = view(g).numpy()
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ MAE


def _jax_mae(**kw):
    return transform(lambda x, train=False, features_only=False:
                     jmae.tinymae(x, train=train, features_only=features_only,
                                  **kw))


def _mae_params(seed=0, **kw):
    """tinymae's JAX-layout weights at HW (random, non-zero biases)."""
    params, _ = weights.random_jax_params(
        models.tinymae(input_hw=(HW, HW), **kw), seed)
    rng = np.random.RandomState(seed + 100)
    for p in params.values():
        if "b" in p:
            p["b"] = (0.05 * rng.randn(*p["b"].shape)).astype(np.float32)
    return params


def _noise_of(mask):
    """A masking draw whose kept set is JAX's: the kept tokens (mask 0)
    first, each set in token order."""
    mask = np.asarray(mask, np.float32)
    return torch.from_numpy(mask + np.arange(mask.shape[1],
                                             dtype=np.float32) * 1e-3)


@pytest.mark.parametrize("hw,patch,c", [((8, 8), 4, 3), ((32, 48), 16, 3),
                                        ((12, 8), 4, 1)])
def test_patchify_unpatchify_equal_jax(hw, patch, c):
    x = np.random.RandomState(0).randn(2, *hw, c).astype(np.float32)
    want = np.asarray(jmae.patchify(jnp.asarray(x), patch))
    got = models.patchify(torch.from_numpy(x), patch)
    np.testing.assert_array_equal(got.numpy(), want)
    back = models.unpatchify(got, patch, hw, c)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jmae.unpatchify(jnp.asarray(want), patch, hw, c)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("n,ratio", [(4, 0.75), (64, 0.75), (196, 0.75),
                                     (196, 0.9), (10, 0.999), (7, 0.3)])
def test_random_masking_keeps_jaxs_count_and_set(n, ratio):
    """``max(int(n (1 - ratio)), 1)`` tokens kept, as JAX; with a draw
    of JAX's kept set the port keeps that set, its mask equals JAX's and
    the kept rows are the input's."""
    x = np.random.RandomState(1).randn(3, n, 5).astype(np.float32)
    kept, mask, restore = jmae.random_masking(jax.random.PRNGKey(2),
                                              jnp.asarray(x), ratio)
    keep = ssl_keep = models.mae.keep_count(n, ratio)
    assert kept.shape[1] == keep == max(int(n * (1.0 - ratio)), 1)
    got_kept, got_mask, got_restore = models.mae.random_masking(
        torch.from_numpy(x), ratio, _noise_of(mask))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    assert got_kept.shape == (3, ssl_keep, 5)
    for b in range(3):
        rows = np.flatnonzero(np.asarray(mask)[b] == 0)
        np.testing.assert_array_equal(got_kept[b].numpy(), x[b, rows])
    order = torch.argsort(got_restore, dim=1)
    np.testing.assert_array_equal(
        torch.gather(got_mask, 1, order)[:, :keep].numpy(), 0)


@pytest.mark.parametrize("norm_pix", [True, False])
def test_tinymae_forward_matches_jax(norm_pix):
    """(pred, target, mask) with JAX's kept set, float32 within 1e-5 of
    their largest; ``features`` (``features_only``) too."""
    params = _mae_params(1)
    x = np.random.RandomState(3).randn(N, HW, HW, 3).astype(np.float32)
    fn = _jax_mae(norm_pix=norm_pix)

    @jax.jit
    def run(p, x):
        with policy_scope(JFULL):
            out, _ = fn.apply(p, {}, jax.random.PRNGKey(4), x, True)
            feats, _ = fn.apply(p, {}, None, x, False, features_only=True)
        return out, feats

    (pred, target, mask), feats = run(params, jnp.asarray(x))
    model = weights.from_jax(models.tinymae(input_hw=(HW, HW),
                                            norm_pix=norm_pix), params, {})
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x), _noise_of(mask))
        got_feats = model.eval().features(torch.from_numpy(x))
    for g, w in zip(got, (pred, target, mask)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert got_feats.shape == (N, 32)
    np.testing.assert_allclose(got_feats.numpy(), np.asarray(feats), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(feats)).max())


def test_norm_pix_target_uses_the_biased_variance():
    """ddof 0 and +1e-6 inside the root, as ``jnp.var``: a patch of two
    levels has unit variance after it (torch.var's default ddof 1 would
    not)."""
    x = torch.zeros(1, HW, HW, 3)
    x[..., 0] = 1.0
    t = models.tinymae(input_hw=(HW, HW)).target(x)
    assert torch.allclose(t.var(-1, correction=0), torch.ones(1, 4),
                          atol=1e-5)


def test_masked_mse_matches_jax():
    rng = np.random.RandomState(5)
    pred, target = (rng.randn(3, 6, 7).astype(np.float32) for _ in range(2))
    for mask in ((rng.rand(3, 6) < 0.6).astype(np.float32),
                 np.zeros((3, 6), np.float32)):
        want = jssl.masked_mse(jnp.asarray(pred), jnp.asarray(target),
                               jnp.asarray(mask))
        got = ssl.masked_mse(_t(pred), _t(target), _t(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _mae_cfg(**over):
    cfg = recipes.load_config(MAE_CONFIG)
    cfg.update(batch_size=N, total_steps=4, synthetic_n=16)
    cfg["augment"] = dict(cfg["augment"], out_hw=(HW, HW))
    cfg.update(over)
    return cfg


def test_mae_step_matches_jax():
    """One step of configs/cifar10_mae.py (at 8x8 views) through
    ``SSLTrainer``: the view from the draws of JAX's ``augment_train`` at
    its key (crop boxes, flips), the masking with JAX's kept set at its
    model key; the view within 1e-5, the loss within 1e-5 and every
    gradient ``jax.grad``'s within 1e-4 of the leaf's largest."""
    cfg = _mae_cfg()
    params = _mae_params(2)
    trainer, train_set, _ = recipes_ssl.build_ssl(
        cfg, True, device=torch.device("cpu"))
    weights.from_jax(trainer.model, params, {})
    x = train_set.source.get_batch(np.arange(N))[0]
    k_aug, k_model = jax.random.split(jax.random.PRNGKey(3))
    jcfg = jrecipes.make_augment(cfg["augment"])
    views = jaug.augment_train(k_aug, jnp.asarray(x), jcfg)
    fn = _jax_mae(**cfg["model_kwargs"])

    def loss_fn(p):
        (pred, target, m), _ = fn.apply(p, {}, k_model, views, True)
        return jssl.masked_mse(pred, target, m), m

    (jloss, mask), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    boxes, flip, _ = jaug._sample_geometry(jax.random.split(k_aug, 3)[0], N,
                                           (32, 32), jcfg)
    draws = SSLDraws(((_t(boxes), _t(flip), None, None),), _noise_of(mask))
    np.testing.assert_allclose(
        trainer.views.apply(torch.from_numpy(x), draws.views[0]).numpy(),
        np.asarray(views), rtol=0, atol=1e-5)
    out = trainer.loss(torch.from_numpy(x), draws)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    _assert_leaves_close(_grad_tree(trainer.model), jgrads, 1e-4, "grad")


# --------------------------------------------------------------- SimCLR


@pytest.mark.parametrize("temperature", [0.5, 0.1])
def test_nt_xent_matches_jax(temperature):
    rng = np.random.RandomState(6)
    for z in (rng.randn(8, 5).astype(np.float32),
              np.concatenate([np.eye(4, 6), np.eye(4, 6) + 0.1 * rng.randn(
                  4, 6)]).astype(np.float32)):
        loss, acc = jssl.nt_xent(jnp.asarray(z), temperature)
        got_loss, got_acc = ssl.nt_xent(_t(z), temperature)
        np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6)
        assert float(got_acc) == float(acc)


def _simclr_cfg(**over):
    cfg = recipes.load_config(SIMCLR_CONFIG)
    cfg.update(batch_size=N, total_steps=4, model_kwargs=dict(width=8),
               proj_dim=16, synthetic_n=16)
    cfg.update(over)
    return cfg


def _jax_jitter(key, n, aug):
    """The factors ``jaug.color_jitter`` draws from ``key``."""
    k_b, k_c, k_s, k_h = jax.random.split(key, 4)

    def u(k, lo, hi, shape=(n, 1, 1, 1)):
        return _t(jax.random.uniform(k, shape, minval=lo,
                                     maxval=hi)).reshape(n)

    b, c, s, h = aug.brightness, aug.contrast, aug.saturation, aug.hue
    return taug.JitterDraws(
        u(k_b, -b, b) if b else None, u(k_c, 1 - c, 1 + c) if c else None,
        u(k_s, 1 - s, 1 + s) if s else None,
        u(k_h, -h, h, (n, 1, 1)) if h else None)


def _simclr_view_draws(key, n, hw, cfg):
    """The draws of JAX's SimCLR ``view_fn(key, x)``
    (``representation.py:104-113``)."""
    jcfg = jrecipes.make_augment(cfg["augment"])
    k1, k2 = jax.random.split(key)
    k_geom, k_color, _ = jax.random.split(k1, 3)
    boxes, flip, _ = jaug._sample_geometry(k_geom, n, hw, jcfg)
    gray = jax.random.bernoulli(k2, cfg["grayscale_prob"], (n, 1, 1, 1))
    return (_t(boxes), _t(flip), None, _jax_jitter(k_color, n, jcfg),
            _t(gray).reshape(n))


def _jax_simclr_view(key, x, cfg):
    """JAX's SimCLR ``view_fn(key, x)`` (``representation.py:104-113``)."""
    aug = jrecipes.make_augment(cfg["augment"])
    raw = aug._replace(mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0))
    ka, kb = jax.random.split(key)
    v = jaug.augment_train(ka, jnp.asarray(x), raw)
    sel = jax.random.bernoulli(kb, cfg["grayscale_prob"],
                               (x.shape[0], 1, 1, 1))
    return jaug.normalize(jnp.where(sel, jaug._rgb_to_gray(v), v), aug.mean,
                          aug.std)


def test_simclr_step_on_smallnet_matches_jax():
    """One step of configs/cifar10_simclr.py (SmallNet at width 8) through
    ``SSLTrainer`` with the draws of JAX's two views (each a crop, flip,
    colour jitter and grayscale choice at its key): the loss and
    contrast_acc of the [2N] batch within 1e-5 of JAX's (nt_xent on its
    forward, train-mode BN over both views), every gradient ``jax.grad``'s
    within 1e-4 of its leaf's largest (the dead 1-class head's zero on
    both) and the BN moving statistics after the step within 1e-5."""
    cfg = _simclr_cfg(grayscale_prob=0.5)
    trainer, train_set, _ = recipes_ssl.build_ssl(
        cfg, True, device=torch.device("cpu"))
    params, mstate = weights.random_jax_params(trainer.model, 4)
    weights.from_jax(trainer.model, params, mstate)
    x = train_set.source.get_batch(np.arange(N))[0]
    k1, k2, k_model = jax.random.split(jax.random.PRNGKey(5), 3)
    jviews = jnp.concatenate([_jax_simclr_view(k, x, cfg) for k in (k1, k2)])
    model = _jax_simclr_model(cfg)

    def loss_fn(p):
        z, st = model.apply(p, mstate, k_model, jviews, True)
        loss, acc = jssl.nt_xent(z, cfg["temperature"])
        return loss, (acc, st)

    (jloss, (jacc, jnew)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    draws = SSLDraws(tuple(_simclr_view_draws(k, N, (32, 32), cfg)
                           for k in (k1, k2)))
    out = trainer.loss(torch.from_numpy(x), draws)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    assert float(out["contrast_acc"]) == float(jacc)
    _assert_leaves_close(_grad_tree(trainer.model), jgrads, 1e-4, "grad")
    assert not np.asarray(jgrads["logits"]["w"]).any()
    _assert_leaves_close(weights.to_jax(trainer.model)[1], jnew, 1e-5, "bn")


def _jax_simclr_model(cfg):
    """JAX's SimCLR forward of ``build_ssl`` (its step's ``model``),
    rebuilt: the recipe returns only the jitted step."""
    from myconvnet_tpu import models as jmodels
    from myconvnet_tpu import nn as jnn
    from myconvnet_tpu.core.module import collecting
    model_fn = jmodels.get_model(cfg["model"])

    def fwd(x, train=False, features_only=False):
        with collecting() as c:
            model_fn(x, 1, train=train, **cfg["model_kwargs"])
        h = [v for k, v in c.items() if k.endswith("/features")][-1]
        h = jnn.gap(h) if h.ndim == 4 else h
        if features_only:
            return h
        with jnn.scope_named("projector"):
            z = jnn.relu(jnn.dense(h, h.shape[-1], name="fc1"))
            return jnn.dense(z, cfg["proj_dim"], use_bias=False, name="fc2")

    return transform(fwd)


def test_simclr_view_matches_jax():
    """The view chain on [0, 1] (crop, flip, jitter), the grayscale, the
    normalize: JAX's ``view_fn`` at its own key, within 1e-5."""
    cfg = _simclr_cfg(grayscale_prob=0.5)
    x = np.random.RandomState(8).randint(0, 256, (6, 32, 32, 3), np.uint8)
    key = jax.random.PRNGKey(9)
    want = _jax_simclr_view(key, x, cfg)
    draws = _simclr_view_draws(key, 6, (32, 32), cfg)
    assert 0 < int(draws[4].sum()) < 6
    views = recipes_ssl.augment_views(recipes.make_augment(cfg["augment"]),
                                      "cpu", gray_prob=0.5)
    got = views.apply(torch.from_numpy(x), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ----------------------------------------------------------------- LARS


def test_lars_three_steps_match_jax():
    """The ImageNet SimCLR recipe's LARS (momentum 0.9, decay 1e-6, a
    warmup-cosine schedule) with norms and biases excluded (plain
    momentum), a zero leaf (trust ratio 1) and clipping off: parameters
    and momentum over 3 steps within 1e-6 of each leaf's largest; the
    momentum is JAX's opt_state tree through ``optimizer_to_jax``."""
    rng = np.random.RandomState(10)
    params = {"conv": {"w": rng.randn(3, 3, 4, 8).astype(np.float32)},
              "bn": {"gamma": rng.rand(8).astype(np.float32),
                     "beta": rng.randn(8).astype(np.float32)},
              "fc": {"w": rng.randn(8, 5).astype(np.float32),
                     "b": rng.randn(5).astype(np.float32)},
              "zero": {"w": np.zeros((4, 4), np.float32)}}
    lr = dict(kind="cosine", lr=4.8, total_steps=5, warmup_steps=2)
    for exclude in (None, joptim.norm_and_bias_exclusion):
        jopt = joptim.lars(joptim.make_schedule(lr), 0.9,
                           weight_decay=1e-6, weight_decay_exclude=exclude)
        jparams, jstate = params, jopt.init(params)
        named = [(f"{s}/{n}", torch.nn.Parameter(_t(v).clone()))
                 for s, d in params.items() for n, v in d.items()]
        opt = optim.make_optimizer(
            named, "lars", optim.make_schedule(lr), momentum_coef=0.9,
            weight_decay=1e-6,
            weight_decay_exclude=exclude and optim.norm_and_bias_exclusion)
        for i in range(3):
            grads = {s: {n: (rng.randn(*v.shape) * (0.1 if s == "fc"
                                                    else 1.0)
                             ).astype(np.float32) for n, v in d.items()}
                     for s, d in params.items()}
            for path, p in named:
                s, n = path.split("/")
                p.grad = _t(grads[s][n])
            opt.step(i)
            jparams, jstate = jopt.update(grads, jstate, jparams,
                                          jnp.asarray(i, jnp.int32))
            got = {}
            for path, p in named:
                s, n = path.split("/")
                got.setdefault(s, {})[n] = p.detach().numpy()
            _assert_leaves_close(got, jparams, 1e-6, f"step {i} params")
            mom = {}
            for path, m in opt.state_trees()[""].items():
                s, n = path.split("/")
                mom.setdefault(s, {})[n] = m.numpy()
            _assert_leaves_close(mom, jstate, 1e-6, f"step {i} momentum")
        assert not np.allclose(np.asarray(jparams["zero"]["w"]), 0.0)


# ------------------------------------------------------------------ kNN


def test_knn_classify_labels_equal_jax():
    """Random features (no tied similarity at the k-th place, no tied
    vote): the labels equal JAX's at several k."""
    rng = np.random.RandomState(11)
    bank = rng.randn(64, 12).astype(np.float32)
    bank_y = rng.randint(0, 5, 64).astype(np.int32)
    query = rng.randn(40, 12).astype(np.float32)
    for k in (1, 5, 20, 100):
        want = jssl.knn_classify(jnp.asarray(bank), jnp.asarray(bank_y),
                                 jnp.asarray(query), k=k, num_classes=5)
        got = ssl.knn_classify(_t(bank), _t(bank_y), _t(query), k=k,
                               num_classes=5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_eval_equals_jax_over_batches():
    """The bank and query caps over batch iterators, and the top-1: equal
    to JAX's ``knn_eval`` with the same embedding."""
    rng = np.random.RandomState(12)
    w = rng.randn(6, 10).astype(np.float32)
    xs = [rng.randn(8, 6).astype(np.float32) for _ in range(7)]
    ys = [rng.randint(0, 4, 8).astype(np.int32) for _ in range(7)]

    def batches(lo, hi, wrap):
        return iter([(wrap(x), wrap(y)) for x, y in
                     zip(xs[lo:hi], ys[lo:hi])])

    kw = dict(k=5, num_classes=4, max_bank=20, max_query=12)
    want = jssl.knn_eval(lambda s, x: x @ w, None,
                         batches(0, 4, np.asarray), batches(4, 7, np.asarray),
                         **kw)
    got = ssl.knn_eval(lambda x: x @ _t(w), batches(0, 4, _t),
                       batches(4, 7, _t), **kw)
    assert got == want


# ------------------------------------------------ export and warm start


def _shapes(tree):
    return {s: {n: tuple(v.shape) for n, v in d.items()}
            for s, d in tree.items()}


@pytest.fixture(scope="module")
def mae_trees():
    """tinymae's weights, its tree's scopes and shapes those of JAX's
    init."""
    params = _mae_params(7)
    want = jax.eval_shape(
        lambda x: _jax_mae().init(jax.random.PRNGKey(0), x, True)[0],
        jax.ShapeDtypeStruct((2, HW, HW, 3), jnp.float32))
    assert _shapes(params) == _shapes(want)
    return params


def test_encoder_npz_keys_equal_jax(mae_trees, tmp_path):
    """MAE's and SimCLR's encoder files hold JAX's keys (the decoder, the
    projector and the 1-class head left out) and its arrays; SimCLR's tree
    has the scopes and shapes of JAX's init."""
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    model = weights.from_jax(models.tinymae(input_hw=(HW, HW)), mae_trees,
                             {})
    jssl.export_encoder_npz(mae_trees, jpath)
    ssl.export_encoder_npz(weights.to_jax(model)[0], tpath)
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(j.files) == sorted(t.files)
        assert "~::pos_embed" in t.files and not any(
            k.startswith("decoder") for k in t.files)
        for key in j.files:
            np.testing.assert_array_equal(t[key], j[key])
    cfg = _simclr_cfg()
    trainer, _, _ = recipes_ssl.build_ssl(cfg, True,
                                          device=torch.device("cpu"))
    params, _ = weights.to_jax(trainer.model)
    want = jax.eval_shape(
        lambda x: _jax_simclr_model(cfg).init(jax.random.PRNGKey(0), x,
                                              True)[0],
        jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32))
    assert _shapes(params) == _shapes(want)
    assert set(params["projector/fc2"]) == {"w"}
    jssl.export_encoder_npz(params, jpath)
    trainer.export_encoder(tpath)
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(j.files) == sorted(t.files)
        assert not any(k.split("/")[0] in ("projector", "logits", "fc1")
                       for k in t.files)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encoder_warm_starts_tinyvit(mae_trees, tmp_path, writer):
    """Either package's encoder file warm-starts either package's
    ``tinyvit`` through ``pretrained=dict(path=...)``: every encoder leaf
    equal to the MAE's, the head fresh."""
    path = str(tmp_path / "encoder.npz")
    if writer == "jax":
        jssl.export_encoder_npz(mae_trees, path)
    else:
        model = weights.from_jax(models.tinymae(input_hw=(HW, HW)),
                                 mae_trees, {})
        ssl.export_encoder_npz(weights.to_jax(model)[0], path)
    cfg = recipes.load_config(os.path.join(ROOT, "configs",
                                           "imagenet_vit_b16.py"))
    cfg.update(model="tinyvit", input_hw=(HW, HW), raw_hw=(12, 12),
               num_classes=10, synthetic_n=8, pretrained=dict(path=path),
               augment=dict(out_hw=(HW, HW)))
    trainer, _, _ = recipes.build_trainer(cfg, True,
                                          device=torch.device("cpu"))
    got, _ = weights.to_jax(trainer.model)
    jvit = jload_npz(path, {s: dict(d) for s, d in got.items()})
    for scope, d in mae_trees.items():
        if scope.startswith("decoder"):
            continue
        for name, v in d.items():
            np.testing.assert_array_equal(got[scope][name], v)
            np.testing.assert_array_equal(jvit[scope][name], v)
    assert "head/logits" in got


# --------------------------------------------------------- entry points


@pytest.mark.parametrize("config,sets", [
    (MAE_CONFIG, ["synthetic_n=32"]),
    (SIMCLR_CONFIG, ["synthetic_n=32", "model_kwargs.width=8",
                     "proj_dim=16"])], ids=["mae", "simclr"])
def test_ssl_cli_round_trip_across_the_packages(tmp_path, capsys, config,
                                                sets):
    """``train`` a few steps (log, probe and checkpoint every 2), then
    ``test`` on the checkpoint; the port's checkpoint restores into JAX's
    state (LARS's or Adam's moments included) equal leaf by leaf, and a
    JAX checkpoint restores into the port, whose probe features then
    equal JAX's ``feats_fn`` within 1e-5."""
    args = ["--config", config, "--synthetic", "--device", "cpu",
            "--batch", "8"] + [a for s in sets for a in ("--set", s)]
    out = str(tmp_path / "run")
    trainer = train_entry.main(args + ["--steps", "4", "--out", out,
                                       "--set", "log_every=2",
                                       "--set", "val_every=2"])
    text = capsys.readouterr().out
    assert "step 2: kNN top-1" in text and "final kNN top-1" in text
    assert os.path.exists(os.path.join(out, "encoder.npz"))
    assert os.path.exists(os.path.join(out, "best.npz"))
    assert trainer.step == 4
    knn, restored = test_entry.main(args + ["--ckpt", out])
    assert 0.0 <= knn <= 1.0 and restored.step == 4
    assert f"{restored.kind} kNN top-1" in capsys.readouterr().out
    cfg = recipes.apply_overrides(recipes.load_config(config),
                                  sets + ["batch_size=8"])
    jstate, _, jtrain, _, feats_fn, _ = jrecipes.build_ssl(cfg,
                                                           synthetic=True)
    got = jckpt.restore_checkpoint(out, jstate._asdict())
    want = restored.state()._asdict()
    for field in ("params", "model_state", "opt_state"):
        _assert_leaves_close(_np_tree(got[field]) if field != "opt_state"
                             else _flat(got[field]),
                             want[field] if field != "opt_state"
                             else _flat(want[field]), 0.0, field)
    assert int(got["step"]) == 4
    jdir = str(tmp_path / "jax")
    jckpt.save_checkpoint(jdir, 7, jstate._replace(
        step=jnp.asarray(7, jnp.int32))._asdict())
    port, _, _ = recipes_ssl.build_ssl(cfg, True, device=torch.device("cpu"))
    port.restore(jdir)
    assert port.step == 7
    x = np.asarray(jtrain.source.get_batch(np.arange(8))[0])
    want = np.asarray(feats_fn(jstate, jnp.asarray(x)))
    got = port.embed(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _flat(tree, prefix=""):
    """An optimizer state as {field path: {"": leaf}} for the leaf
    comparison."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif hasattr(tree, "_asdict"):   # a JAX state's fields: ".mu", ...
        out.update(_flat({f".{k}": v for k, v in tree._asdict().items()},
                         prefix))
    else:
        out[prefix] = {"": np.asarray(tree)}
    return out


def test_imagenet_simclr_recipe_takes_lars_and_its_mesh():
    """configs/imagenet_simclr_resnet50.py (ResNet-50 at width 8, 32x32
    views): LARS built from the recipe, ``mesh=dict(data=None)`` accepted,
    a step runs with a finite loss; LARS's momentum in the checkpoint is
    the tree JAX's LARS state has (the parameters' scopes and shapes), and
    loads back equal."""
    cfg = recipes.load_config(os.path.join(
        ROOT, "configs", "imagenet_simclr_resnet50.py"))
    assert cfg["mesh"] == dict(data=None)
    cfg.update(model_kwargs=dict(width=8), synthetic_n=4, raw_hw=(40, 40),
               augment=dict(cfg["augment"], out_hw=(32, 32)))
    trainer, train_set, _ = recipes_ssl.build_ssl(
        cfg, True, device=torch.device("cpu"))
    assert isinstance(trainer.optimizer, optim.LARS)
    x, _ = train_set.source.get_batch(np.arange(4))
    m = trainer.train_step(torch.from_numpy(x))
    assert np.isfinite(float(m["loss"])) and trainer.step == 1
    state = trainer.state()
    jstate = jrecipes.make_optimizer(cfg["optimizer"]).init(state.params)
    assert _shapes(state.opt_state) == _shapes(jstate)
    assert any(np.abs(v).max() > 0 for d in state.opt_state.values()
               for v in d.values())
    fresh, _, _ = recipes_ssl.build_ssl(cfg, True,
                                        device=torch.device("cpu"))
    fresh.load_state(state)
    _assert_leaves_close(fresh.state().opt_state, state.opt_state, 0.0,
                         "momentum")


@pytest.mark.parametrize("key,value,match", [
    ("mesh", dict(data=2), "'mesh'"), ("mesh", dict(data=None, model=2),
                                       "'mesh'"),
    ("mesh", "auto", "'mesh'"), ("ssl_kind", "byol", "'byol'")])
def test_refusals_by_name(key, value, match):
    cfg = _simclr_cfg(**{key: value})
    with pytest.raises(ValueError, match=match):
        recipes_ssl.build_ssl(cfg, True, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="recipes_ssl.build_ssl"):
        recipes.build_trainer(_simclr_cfg(), True,
                              device=torch.device("cpu"))
