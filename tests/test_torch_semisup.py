"""The port's FixMatch against the JAX package, on the CPU.

``labeled_subset``, the EMA decay, one step of ``configs/cifar10_fixmatch.py``
(WRN-10-1 in float32: depth and width cut) through
``recipes_semisup.build_semisup`` with the EMA of the parameters and of
the BN statistics, the checkpoint across the packages, the entry points
end to end with JAX's EMA evaluation of the port's checkpoint, and the
refusal of a corpus that is not in memory.  Inputs are seeded numpy;
weights are made in the JAX layout and loaded through ``weights.from_jax``;
the three views' draws (crops, flips, the strong view's RandAugment
layers) come from JAX's keys.  Tolerances: indices and decays exactly;
the step's losses within 1e-5, its gradients, the parameters after the
update, the BN statistics and both EMA trees within 1e-4 of each leaf's
largest (each ReLU's derivative where JAX's pre-activation is positive, a
disagreement within 1e-5 of 0); the EMA top-1 within one example.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.train import semisup as jsemi
from myconvnet_tpu.train.losses import softmax_cross_entropy as jce
from myconvnet_tpu_torch import recipes, recipes_semisup, weights
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.train.semisup import (SemiDraws, ema_decay_at,
                                               labeled_subset)
from test_torch_randaugment import jax_ra_draws
from test_torch_seg_family import KINK, spy_relus, traced_step
from test_torch_zoo import assert_trees_close, grad_tree

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "cifar10_fixmatch.py")
CPU = torch.device("cpu")
NL, MU = 4, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return {s: {n: np.asarray(v) for n, v in d.items()}
            for s, d in tree.items()}


def _cfg(**over):
    cfg = recipes.load_config(CONFIG)
    cfg.update(model_kwargs=dict(depth=10, width_mult=1), batch_size=NL,
               mu=MU, synthetic_n=64, labeled_per_class=3, precision="f32")
    cfg.update(over)
    return cfg


def test_labeled_subset_equals_jax():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 6, 50)
    labels[labels == 4] = 5          # a class with no example
    images = np.arange(50)[:, None] * np.ones((1, 3), np.int64)
    for per_class in (2, 9):
        got = labeled_subset(images, labels, per_class, 6, seed=3)
        want = jsemi.labeled_subset(images, labels, per_class, 6, seed=3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("decay", [0.999, 0.5])
def test_ema_decay_equals_jax(decay):
    for step in (0, 1, 9, 100, 5000, 2 ** 20):
        t = jnp.asarray(step, jnp.int32)
        d = jnp.minimum(decay, (1.0 + t) / (10.0 + t))
        assert ema_decay_at(step, decay) == (float(d), float(1.0 - d))


def _jax_model(cfg):
    fn = jmodels.get_model(cfg["model"])
    return transform(lambda x, train=False: fn(x, cfg["num_classes"],
                                               train=train,
                                               **cfg["model_kwargs"]))


def _view_draws(key, n, cfg_aug, ra_ops=None):
    """(boxes, flip, policy, jitter): the draws ``augment_train(key, ...)``
    makes (``augment.py:350-388``)."""
    k_geom, _, k_ra = jax.random.split(key, 3)
    boxes, flip, _ = jaug._sample_geometry(k_geom, n, (32, 32), cfg_aug)
    policy = (jax_ra_draws(k_ra, n, int(cfg_aug.randaugment[0]), ra_ops)
              if ra_ops else None)
    return (_t(boxes), _t(flip), policy, None)


def test_fixmatch_step_matches_jax(monkeypatch):
    """One FixMatch step at float32 through ``build_semisup``'s trainer:
    the three views (the strong one with RandAugment (2, 10)) in one
    train-mode batch, the threshold set between two of JAX's confidences
    so that some pseudo-labels pass and some do not: the losses, the
    mask rate, every gradient, the parameters after the nesterov
    momentum, the BN statistics, and the EMA of both at decay 0.1."""
    cfg = _cfg()
    trainer, _, _ = recipes_semisup.build_semisup(cfg, True, device=CPU)
    params, state = weights.random_jax_params(trainer.model, 4)
    rng = np.random.RandomState(5)
    x_l = rng.randint(0, 256, (NL, 32, 32, 3)).astype(np.uint8)
    y_l = rng.randint(0, 10, NL)
    x_u = rng.randint(0, 256, (MU * NL, 32, 32, 3)).astype(np.uint8)
    weak = jrecipes.make_augment(cfg["augment"])
    strong = jrecipes.make_augment({**cfg["augment"],
                                    **cfg["augment_strong"]})
    kl, kw, ks, km = jax.random.split(jax.random.PRNGKey(21), 4)
    xb = jnp.concatenate([jaug.augment_train(kl, jnp.asarray(x_l), weak),
                          jaug.augment_train(kw, jnp.asarray(x_u), weak),
                          jaug.augment_train(ks, jnp.asarray(x_u), strong)])
    model = _jax_model(cfg)
    relus = spy_relus(monkeypatch)
    nl, nu = NL, MU * NL

    def jax_loss(p, threshold):
        relus.clear()
        with policy_scope(JFULL):
            logits, mstate = model.apply(p, state, km, xb, True)
        logits = logits.astype(jnp.float32)
        sup = jce(logits[:nl], jnp.asarray(y_l))
        probs = jax.lax.stop_gradient(jax.nn.softmax(logits[nl:nl + nu]))
        conf = jnp.max(probs, axis=-1)
        mask = (conf >= threshold).astype(jnp.float32)
        per = -jnp.take_along_axis(jax.nn.log_softmax(logits[nl + nu:]),
                                   jnp.argmax(probs, -1)[:, None], -1)[:, 0]
        unsup = jnp.sum(per * mask) / nu
        return sup + cfg["lambda_u"] * unsup, (mstate, sup, unsup,
                                               jnp.mean(mask), conf,
                                               list(relus))

    step = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    conf = np.sort(np.asarray(step(params, 0.0)[0][1][4]))
    threshold = float((conf[nu // 2 - 1] + conf[nu // 2]) / 2)
    (jloss, (jstate, jsup, junsup, jrate, _, jzs)), jgrads = step(
        params, threshold)
    assert 0.0 < float(jrate) < 1.0
    jopt = jrecipes.make_optimizer(cfg["optimizer"])
    jparams, _ = jopt.update(jgrads, jopt.init(params), params,
                             jnp.asarray(0, jnp.int32))
    d = jnp.minimum(cfg["ema_decay"], (1.0 + 0) / (10.0 + 0))
    jema = jsemi._ema_tree(params, jparams, d)
    jema_state = jsemi._ema_tree(state, jstate, d)
    ops = len(taug._randaugment_ops(recipes.make_augment(
        {**cfg["augment"], **cfg["augment_strong"]})))
    draws = SemiDraws(_view_draws(kl, nl, weak), _view_draws(kw, nu, weak),
                      _view_draws(ks, nu, strong, ops), None)

    def port_step():
        t, _, _ = recipes_semisup.build_semisup(dict(cfg,
                                                     threshold=threshold),
                                                True, device=CPU)
        for m in (t.model, t.ema_model):
            weights.from_jax(m, params, state)
        t.optimizer.zero_grad()
        out = t.loss(torch.from_numpy(x_l), torch.from_numpy(y_l),
                     torch.from_numpy(x_u), draws)
        out["loss"].backward()
        grads = grad_tree(t.model)
        t.optimizer.step(0)
        t.update_ema(0)
        return t, out, grads

    _, zs = traced_step(port_step, None, monkeypatch)
    assert [tuple(z.shape) for z in zs] == [tuple(z.shape) for z in jzs]
    keeps = []
    for z, jz in zip(zs, jzs):
        jz = torch.from_numpy(np.array(jz))
        differ = (z > 0) != (jz > 0)
        if differ.any():
            assert z[differ].abs().max() <= KINK * z.abs().max()
        keeps.append(jz > 0)
    (t, out, grads), _ = traced_step(port_step, keeps, monkeypatch)
    for key, want in (("loss", jloss), ("sup_loss", jsup),
                      ("unsup_loss", junsup), ("mask_rate", jrate)):
        np.testing.assert_allclose(float(out[key].detach()), float(want),
                                   rtol=1e-5, err_msg=key)
    assert_trees_close(grads, _np_tree(jgrads), 1e-4, "grad",
                       zero_leaves=True)
    got_p, got_s = weights.to_jax(t.model)
    assert_trees_close(got_p, _np_tree(jparams), 1e-4, "params")
    assert_trees_close(got_s, _np_tree(jstate), 1e-4, "bn state")
    ema_p, ema_s = weights.to_jax(t.ema_model)
    assert_trees_close(ema_p, _np_tree(jema), 1e-4, "ema params")
    assert_trees_close(ema_s, _np_tree(jema_state), 1e-4, "ema bn state")


def test_checkpoint_crosses_the_packages(tmp_path):
    """The port's SemiState checkpoint restores in JAX and JAX's in the
    port, the EMA trees included."""
    cfg = _cfg()
    trainer, _, _ = recipes_semisup.build_semisup(cfg, True, device=CPU)
    p, s = weights.random_jax_params(trainer.model, 6)
    ep, es = weights.random_jax_params(trainer.model, 7)
    weights.from_jax(trainer.model, p, s)
    weights.from_jax(trainer.ema_model, ep, es)
    trainer.step = 4
    trainer.save(str(tmp_path / "port"))
    jstate = jrecipes.build_semisup(cfg, synthetic=True)[0]
    back = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                    jstate._asdict())
    assert_trees_close(_np_tree(back["ema_params"]), ep, 0.0, "ema")
    assert_trees_close(_np_tree(back["ema_model_state"]), es, 0.0, "ema bn")
    assert int(back["step"]) == 4
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jstate._asdict())
    trainer.restore(str(tmp_path / "jax"))
    assert trainer.step == 0
    assert_trees_close(weights.to_jax(trainer.ema_model)[0],
                       _np_tree(jstate.ema_params), 0.0, "ema")
    assert_trees_close(weights.to_jax(trainer.model)[0],
                       _np_tree(jstate.params), 0.0, "params")
    p, s = weights.load_jax_checkpoint(str(tmp_path / "port"),
                                       ("ema_params", "ema_model_state"))
    assert_trees_close(p, ep, 0.0, "ema params")
    assert_trees_close(s, es, 0.0, "ema state")


def test_entry_points_and_jax_scores_the_checkpoint(tmp_path, capsys):
    """``train.main`` (3 steps, a validation at step 2) and ``test.main``
    on its checkpoint; JAX's ``make_eval_fn`` on the same checkpoint gives
    the same EMA top-1 within one example (the default 512-image split,
    as JAX renders it: ``synthetic_n`` is the port's own key)."""
    cfg = _cfg()
    cfg.pop("synthetic_n")
    config = tmp_path / "fixmatch.py"
    config.write_text(f"config = {cfg!r}\n")
    out = str(tmp_path / "run")
    common = ["--config", str(config), "--synthetic", "--device", "cpu"]
    trainer = train_entry.main(common + ["--steps", "3", "--out", out,
                                         "--set", "log_every=1",
                                         "--set", "val_every=2"])
    text = capsys.readouterr().out
    assert "step 2: val_acc" in text and "semisup_fixmatch training done" \
        in text
    acc, restored = test_entry.main(common + ["--ckpt", out])
    assert "val accuracy (EMA)" in capsys.readouterr().out
    assert restored.step == trainer.step == 3
    jstate, _, _, val_set, eval_fn = jrecipes.build_semisup(cfg,
                                                            synthetic=True)
    jstate = type(jstate)(**jckpt.restore_checkpoint(out,
                                                     jstate._asdict()))
    want = eval_fn(jstate, val_set.eval_iter(cfg["batch_size"]))
    assert abs(acc - want) <= 1.0 / len(val_set.source) + 1e-12


def test_semisup_refuses_a_corpus_not_in_memory(monkeypatch):
    """The labeled split is drawn from an in-memory corpus; any other
    source is refused, as in JAX."""
    class Files:
        def __len__(self):
            return 8

    monkeypatch.setattr(recipes_semisup, "make_sources",
                        lambda cfg, synthetic: (Files(), Files()))
    with pytest.raises(ValueError, match="in-memory corpus"):
        recipes_semisup.build_semisup(_cfg(), True, device=CPU)
