"""The port's training path against the JAX package, on the CPU.

ResNet-18 at width 8 (stages of 8, 16, 32 and 64 channels), 32x32 input,
10 classes, batch 8.  The JAX weights come from ``ConvNet.build`` with
every BN's gamma, beta and moving statistics randomized from a seed (the
zero-init ``bn_b`` gamma would otherwise switch every residual branch
off) and go to the port through ``weights.from_jax``.  Random draws
(crop offsets, flips, MixUp) are made by JAX from its keys and injected
into the port, whose own generators draw other numbers.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import nn as jnn
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu import serving as jserving
from myconvnet_tpu.core import transform
from myconvnet_tpu.core import init as jinit
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.data import mix as jmix
from myconvnet_tpu.models.base import ConvNet
from myconvnet_tpu.ops.batch_norm import batch_norm_train as jbn_train
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu.train import optim as joptim
from myconvnet_tpu_torch import models, recipes, serving, weights
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.core import init as tinit
from myconvnet_tpu_torch.core.precision import FULL, get_policy
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.data import mix as tmix
from myconvnet_tpu_torch.models.resnet import BasicBlock
from myconvnet_tpu_torch.nn import BatchNorm
from myconvnet_tpu_torch.ops.batch_norm import batch_norm_train
from myconvnet_tpu_torch.train import losses, optim
from myconvnet_tpu_torch.train.trainer import StepDraws, Trainer, \
    TrainState

from test_torch_data import jax_mix_draws

torch.set_num_threads(1)

WIDTH, HW, BATCH, CLASSES = 8, 32, 8, 10
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "cifar100_resnet18.py")
MEAN, STD = (0.5071, 0.4866, 0.4409), (0.2673, 0.2564, 0.2762)
AUG = dict(out_hw=(HW, HW), area_range=None, pad=4, flip=True, mean=MEAN,
           std=STD)
MIX = dict(mixup_alpha=0.2, cutmix_alpha=0.0, prob=0.5)
# the recipe's optimizer, with a schedule short enough that three steps
# see warmup and the cosine both
OPT = dict(name="momentum", momentum_coef=0.9, nesterov=True,
           weight_decay=5e-4, wd_exclude_norms=True,
           lr=dict(kind="cosine_restarts", lr=0.1, first_decay_steps=2,
                   t_mul=2.0, warmup_steps=2))


def _randomize(params, state, seed=0):
    rng = np.random.RandomState(seed)
    params = {k: {n: np.array(v) for n, v in d.items()}
              for k, d in params.items()}
    state = {k: {n: np.array(v) for n, v in d.items()}
             for k, d in state.items()}
    for scope in sorted(params):
        p = params[scope]
        if "gamma" in p:
            c = p["gamma"].shape[0]
            p["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p["beta"] = (0.2 * rng.randn(c)).astype(np.float32)
            state[scope] = {
                "moving_mean": (0.2 * rng.randn(c)).astype(np.float32),
                "moving_var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        elif scope == "logits":
            p["b"] = (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)
    return params, state


def _net(precision="f32", **kw):
    return ConvNet(jmodels.resnet18, input_shape=(HW, HW, 3),
                   num_classes=CLASSES, precision=precision, width=WIDTH,
                   **kw)


@pytest.fixture(scope="module")
def trees():
    """Randomized JAX-layout (params, state) of ResNet-18 at width 8."""
    net = _net().build()
    return _randomize(net.state.params, net.state.model_state)


def _port_model(params, state):
    return weights.from_jax(models.resnet18(CLASSES, width=WIDTH), params,
                            state)


def _grad_tree(model):
    """{scope: {name: grad}} in the JAX layout."""
    out = {}
    for path, p, view in weights.param_views(model):
        scope, name = path.rsplit("/", 1)
        out.setdefault(scope, {})[name] = view(p.grad).numpy()
    return out


def _assert_trees_close(got, want, rtol, what):
    assert set(got) == set(want), what
    for scope in want:
        assert set(got[scope]) == set(want[scope]), (what, scope)
        for name, ref in want[scope].items():
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                got[scope][name], ref, rtol=rtol,
                atol=rtol * max(np.abs(ref).max(), 1e-30),
                err_msg=f"{what} {scope}/{name}")


# ------------------------------------------------------------------ init


def test_initializers_match_jax_in_distribution():
    g = torch.Generator().manual_seed(0)
    for shape, init_t, init_j in (
            ((3, 3, 64, 128), tinit.he_normal(), jinit.he_normal()),
            ((512, 100), tinit.glorot_uniform(), jinit.glorot_uniform())):
        t = init_t(shape, g).numpy()
        j = np.asarray(init_j(jax.random.key(0), shape, jnp.float32))
        assert t.shape == shape and t.dtype == np.float32
        # same law: equal bounds and second moments within sampling noise
        assert abs(t.std() / j.std() - 1) < 0.03
        assert abs(np.abs(t).max() / np.abs(j).max() - 1) < 0.03
    he = tinit.he_normal()((3, 3, 64, 128), g).numpy()
    std = math.sqrt(2 / 576) / 0.87962566103423978
    assert np.abs(he).max() <= 2 * std  # truncated at 2 sigma


def test_init_model_is_seeded_and_zero_inits_the_last_bn():
    def build(seed):
        return tinit.init_model(models.resnet18(CLASSES, width=WIDTH),
                                torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    pa, _ = weights.to_jax(a)
    pb, _ = weights.to_jax(b)
    pc, _ = weights.to_jax(c)
    for scope in pa:
        for name in pa[scope]:
            np.testing.assert_array_equal(pa[scope][name], pb[scope][name])
    assert not np.array_equal(pa["stem/conv"]["w"], pc["stem/conv"]["w"])
    assert (pa["stage2/block1/bn_b"]["gamma"] == 0).all()
    assert (pa["stage2/block1/bn_a"]["gamma"] == 1).all()
    assert (pa["logits"]["b"] == 0).all()


# ------------------------------------------------------- BN, loss, optim


def test_batch_norm_train_matches_jax():
    """Outputs, batch statistics and the custom-vjp gradients in float32
    (tolerance 1e-5); a constant channel far from 0 checks the clamped
    one-pass variance."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 5, 5, 6) * 2 + 3).astype(np.float32)
    x[..., 2] = 100.0
    gamma = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    beta = rng.randn(6).astype(np.float32)
    dy = rng.randn(*x.shape).astype(np.float32)
    (y, mean, var), vjp = jax.vjp(
        lambda a, g, b: jbn_train(a, g, b, 1e-5), jnp.asarray(x),
        jnp.asarray(gamma), jnp.asarray(beta))
    dx, dgamma, dbeta = vjp((jnp.asarray(dy), jnp.zeros(6), jnp.zeros(6)))
    xt, gt, bt = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    yt, mt, vt = batch_norm_train(xt, gt, bt, 1e-5)
    yt.backward(torch.from_numpy(dy))
    for got, want in ((yt, y), (mt, mean), (vt, var), (xt.grad, dx),
                      (gt.grad, dgamma), (bt.grad, dbeta)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert float(vt[2]) >= 0.0
    yb, _, _ = batch_norm_train(xt.detach().bfloat16(), gt, bt, 1e-5)
    assert yb.dtype == torch.bfloat16


def test_batch_norm_layer_updates_moving_stats_like_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(8, 3, 3, 5).astype(np.float32)
    t = transform(lambda v: jnn.batch_norm(v, train=True, momentum=0.9,
                                           eps=1e-5, name="bn"))
    params, state = t.init(jax.random.key(0), jnp.asarray(x))
    params = {"bn": {"gamma": rng.rand(5).astype(np.float32) + 0.5,
                     "beta": rng.randn(5).astype(np.float32)}}
    state = {"bn": {"moving_mean": rng.randn(5).astype(np.float32),
                    "moving_var": rng.rand(5).astype(np.float32) + 0.5}}
    y, new_state = t.apply(params, state, None, jnp.asarray(x))
    bn = BatchNorm(5, 1e-5, 0.9)
    with torch.no_grad():
        for name, v in (("gamma", params["bn"]["gamma"]),
                        ("beta", params["bn"]["beta"]),
                        ("moving_mean", state["bn"]["moving_mean"]),
                        ("moving_var", state["bn"]["moving_var"])):
            getattr(bn, name).copy_(torch.from_numpy(v))
    out = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    for name in ("moving_mean", "moving_var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(new_state["bn"][name]),
                                   rtol=1e-5, atol=1e-5)
    before = bn.moving_mean.clone()
    bn.eval()(torch.from_numpy(x))  # eval mode leaves the stats alone
    torch.testing.assert_close(bn.moving_mean, before, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["int", "soft", "smoothed"])
def test_softmax_cross_entropy_matches_jax(kind):
    rng = np.random.RandomState(2)
    logits = (rng.randn(6, CLASSES) * 3).astype(np.float32)
    labels = rng.randint(0, CLASSES, 6).astype(np.int32)
    if kind == "soft":
        labels = rng.dirichlet(np.ones(CLASSES), 6).astype(np.float32)
    smooth = 0.1 if kind == "smoothed" else 0.0
    want = jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels),
                                         label_smoothing=smooth)
    got = losses.softmax_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels),
                                       label_smoothing=smooth)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_schedule_matches_jax_at_the_recipes_boundaries():
    """The recipe's SGDR with warmup (float32 closed form on both sides;
    the transcendental functions may differ by an ulp: rtol 1e-6)."""
    lr_cfg = jrecipes.load_config(CONFIG)["optimizer"]["lr"]
    jsched = joptim.make_schedule(lr_cfg)
    tsched = optim.make_schedule(lr_cfg)
    for step in (0, 1, 390, 391, 3910, 4301, 11730):
        want = float(jsched(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(tsched(step), want, rtol=1e-6,
                                   err_msg=str(step))
    assert tsched(0) == pytest.approx(0.1 / 391, rel=1e-6)
    for cfg in (dict(kind="constant", lr=0.05),
                dict(kind="cosine", lr=0.2, total_steps=100,
                     warmup_steps=10)):
        j, t = joptim.make_schedule(cfg), optim.make_schedule(cfg)
        for step in (0, 5, 50, 99, 150):
            np.testing.assert_allclose(
                t(step), float(j(jnp.asarray(step, jnp.int32))), rtol=1e-6)
    with pytest.raises(ValueError):   # a kind neither package has
        optim.make_schedule(dict(kind="linear", lr=0.1))


def test_decay_mask_matches_jax(trees):
    params, _ = trees
    want = joptim._decay_mask(params, joptim.norm_and_bias_exclusion)
    model = _port_model(*trees)
    got = optim.decay_mask([(path, p) for path, p, _ in
                            weights.param_views(model)],
                           optim.norm_and_bias_exclusion)
    flat = {f"{s}/{n}": bool(v) for s, d in want.items()
            for n, v in d.items()}
    assert got == flat
    assert not got["stage1/block1/bn_a/gamma"] and not got["logits/b"]
    assert got["stage1/block1/conv_a/w"] and got["logits/w"]


# ----------------------------------------------------------- ResNet-18


def test_resnet18_scopes_and_kernel_routing(trees):
    params, state = trees
    model = models.resnet18(CLASSES, width=WIDTH)
    p2, s2 = weights.to_jax(model)
    assert set(p2) == set(params) and set(s2) == set(state)
    for scope in params:
        for name, v in params[scope].items():
            assert p2[scope][name].shape == v.shape, (scope, name)
    # identity shortcuts in stage 1, projections where the shape changes
    assert "stage1/block1/conv_proj" not in p2
    assert "stage2/block1/conv_proj" in p2
    fused = [n for n, m in model.named_modules()
             if isinstance(m, BasicBlock) and m.fused]
    assert fused == ["stage1.block1", "stage1.block2", "stage2.block2",
                     "stage3.block2", "stage4.block2"]


@pytest.fixture(scope="module")
def jax_eval_logits(trees):
    params, state = trees
    x = np.random.RandomState(3).randn(2, HW, HW, 3).astype(np.float32)
    cache = {}

    def get(precision, fold):
        if (precision, fold) not in cache:
            fn = jserving.make_inference_fn(_net(precision)._transformed,
                                            params, state, fold_bn=fold,
                                            bn_eps=1e-5)
            cache[precision, fold] = np.asarray(jax.jit(fn)(x), np.float32)
        return cache[precision, fold]
    return x, get


def _port_eval(trees, x, precision, fold):
    fn = serving.make_inference_fn(models.resnet18(CLASSES, width=WIDTH),
                                   *trees, fold_bn=fold, device="cpu",
                                   policy=get_policy(precision))
    return fn(x).numpy()


@pytest.mark.parametrize("fold", [False, True])
def test_resnet18_eval_logits_match_jax_f32(trees, jax_eval_logits, fold):
    x, get = jax_eval_logits
    ref = get("f32", fold)
    out = _port_eval(trees, x, "f32", fold)
    # float32 on both sides (JAX at Precision.HIGHEST), summed in another
    # order through 20 convs: 1e-4 of the logits' scale
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale)


# bf16: conv_fused keeps each stride-1 conv_a's sum in float32 through the
# BN epilogue and rounds once, where JAX rounds the conv output to bf16
# before BN.  Measured on the CPU, max |diff| / max |ref|: 0.011 unfolded
# and 0.010 folded (JAX's own bf16 logits sit 0.012 from its float32
# ones); the bound is the ResNet-50 test's, 0.05.
@pytest.mark.parametrize("fold", [False, True])
def test_resnet18_eval_logits_match_jax_bf16(trees, jax_eval_logits, fold):
    x, get = jax_eval_logits
    ref = get("bf16", fold)
    out = _port_eval(trees, x, "bf16", fold)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 0.05
    f32 = get("f32", fold)
    assert np.abs(out - f32).max() / np.abs(f32).max() < 0.05


def test_train_mode_step_matches_jax_f32(trees):
    """Train-mode logits, loss, every gradient and the new BN moving
    statistics of one forward/backward at float32 (1e-4 relative)."""
    params, state = trees
    # a seed whose inputs put no ReLU input within float32 rounding of 0:
    # at seed 4 one lies at 1.5e-6, the two frameworks take opposite sides
    # of it, and the gradients upstream of it move by up to 3%
    rng = np.random.RandomState(5)
    x = rng.randn(BATCH, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, BATCH).astype(np.int32)
    apply = _net()._transformed.apply

    def loss_fn(p):
        with policy_scope(JFULL):
            logits, new_state = apply(p, state, None, jnp.asarray(x), True)
        return jlosses.softmax_cross_entropy(logits, jnp.asarray(y)), \
            (logits, new_state)

    (jloss, (jlogits, jstate)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    model = _port_model(params, state).train()
    logits = model(torch.from_numpy(x))
    loss = losses.softmax_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4,
                               atol=1e-4 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    _assert_trees_close(_grad_tree(model), jgrads, 1e-4, "grad")
    _assert_trees_close(weights.to_jax(model)[1], jstate, 1e-4, "bn state")


# ------------------------------------------------------ 3-step trajectory


def _jax_draws(rng_data, step, jcfg, mcfg):
    """The draws the JAX train step makes at ``step`` (trainer.py:213-217,
    models/base.py:191-196, augment.py:358-359), for the port."""
    key = jax.random.fold_in(jax.random.wrap_key_data(rng_data), step)
    k_aug, _ = jax.random.split(key)
    k_img, k_mix, _ = jax.random.split(k_aug, 3)
    k_geom = jax.random.split(k_img, 3)[0]
    boxes, flip, _ = jaug._sample_geometry(k_geom, BATCH, (HW, HW), jcfg)
    return StepDraws(torch.from_numpy(np.array(boxes)),
                     torch.from_numpy(np.array(flip)),
                     jax_mix_draws(k_mix, BATCH, mcfg))


def _port_trainer(trees, **kw):
    model = _port_model(*trees)
    return Trainer(model, recipes.make_optimizer(model, OPT),
                   losses.softmax_cross_entropy, device="cpu", policy=FULL,
                   num_classes=CLASSES, augment=taug.AugmentConfig(**AUG),
                   mix=tmix.MixConfig(**MIX), **kw)


def _batches(n=3):
    rng = np.random.RandomState(6)
    return [(rng.randint(0, 256, (BATCH, HW, HW, 3), dtype=np.uint8),
             rng.randint(0, CLASSES, BATCH).astype(np.int32))
            for _ in range(n)]


def _np_tree(tree):
    return {s: {n: np.asarray(v) for n, v in d.items()}
            for s, d in tree.items()}


def test_three_step_trajectory_matches_jax(trees):
    """Params, momentum and BN state over three steps of the recipe's
    optimizer (nesterov, coupled decay off norms and biases, warmup and
    SGDR at its 0.1 peak), with pad-crop, flip and MixUp, at float32:
    1e-4 relative.  Each port step starts from JAX's state (momentum and
    moving statistics included), so what is held is every step's update;
    left to run free, float32 rounding differences (1e-5) grow by 10-100x
    a step in this batch-8 network and pass 1e-4 by the third step."""
    params, state = trees
    jcfg, mcfg = jaug.AugmentConfig(**AUG), jmix.MixConfig(**MIX)
    net = _net(augment=jcfg, mix=mcfg)
    net.build(jrecipes.make_optimizer(OPT))
    jstate = net.state._replace(params=params, model_state=state)
    jstep = net._make_trainer(None)._train_step
    port = _port_trainer(trees)
    for i, (x, y) in enumerate(_batches()):
        port.load_state(TrainState(
            _np_tree(jstate.params), _np_tree(jstate.model_state),
            _np_tree(jstate.opt_state), np.asarray(jstate.step),
            np.asarray([0])))
        draws = _jax_draws(jstate.rng, i, jcfg, tmix.MixConfig(**MIX))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tm = port.train_step(torch.from_numpy(x), torch.from_numpy(y),
                             draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        got = port.state()
        assert int(got.step) == int(jstate.step) == i + 1
        for field in ("params", "opt_state", "model_state"):
            _assert_trees_close(getattr(got, field), getattr(jstate, field),
                                1e-4, f"step {i} {field}")
    # the momentum is live: the last update used the previous steps'
    assert np.abs(got.opt_state["logits"]["w"]).max() > 0


def test_resume_continues_the_same_run(trees, tmp_path):
    """Three steps straight equal two steps, a checkpoint, a restore into
    a fresh trainer and one step: draws are a function of (seed, step)."""
    data = _batches()
    straight = _port_trainer(trees)
    for x, y in data:
        straight.train_step(torch.from_numpy(x), torch.from_numpy(y))
    first = _port_trainer(trees, ckpt_dir=str(tmp_path))
    for x, y in data[:2]:
        first.train_step(torch.from_numpy(x), torch.from_numpy(y))
    first.save()
    resumed = _port_trainer(trees)
    resumed.restore(str(tmp_path))
    assert resumed.step == 2
    resumed.train_step(*map(torch.from_numpy, data[2]))
    a, b = straight.state(), resumed.state()
    for field in ("params", "opt_state", "model_state"):
        _assert_trees_close(getattr(b, field), getattr(a, field), 0.0,
                            field)


def test_checkpoint_keys_are_the_jax_trainers(trees, tmp_path):
    net = _net()
    net.build(jrecipes.make_optimizer(OPT))
    net.save(str(tmp_path / "jax"))
    port = _port_trainer(trees, ckpt_dir=str(tmp_path / "port"))
    port.save()
    with np.load(tmp_path / "jax" / "ckpt-0.npz") as j, \
            np.load(tmp_path / "port" / "ckpt-0.npz") as t:
        jshapes = {k: j[k].shape for k in j.files if k != "rng"}
        tshapes = {k: t[k].shape for k in t.files if k != "rng"}
    assert jshapes == tshapes
    assert any(k.startswith("opt_state::stage4/block2/conv_b::")
               for k in tshapes)


# ---------------------------------------------------------- entry points


def test_train_and_test_entry_points_on_the_cpu(tmp_path):
    out = str(tmp_path / "run")
    common = ["--config", CONFIG, "--synthetic", "--device", "cpu",
              "--set", f"model_kwargs.width={WIDTH}"]
    net = train_entry.main(common + ["--steps", "2", "--batch", "16",
                                         "--val_every", "1", "--out", out])
    trainer = net.trainer
    assert trainer.step == 2
    files = set(os.listdir(out))
    assert {"ckpt-1.npz", "ckpt-2.npz", "best.npz", "config.json",
            "train.jsonl"} <= files
    with open(os.path.join(out, "train.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert any("val_accuracy" in r for r in records)
    assert all(math.isfinite(r["loss"]) for r in records if "loss" in r)

    score, restored_net = test_entry.main(common + ["--ckpt", out])
    restored = restored_net.trainer
    assert 0.0 <= score <= 1.0 and restored.step == 2
    a, b = trainer.state(), restored.state()
    for field in ("params", "opt_state", "model_state"):
        _assert_trees_close(getattr(b, field), getattr(a, field), 0.0,
                            field)

    # the JAX checkpoint reader of the serving path loads the same model
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (4, HW, HW, 3), dtype=np.uint8))
    logits = restored.eval_step(x).numpy()
    params, state = weights.load_jax_checkpoint(out)
    fn = serving.make_inference_fn(models.resnet18(100, width=WIDTH),
                                   params, state, fold_bn=False,
                                   device="cpu", policy=get_policy("bf16"))
    normed = taug.augment_eval(x, restored.augment)
    np.testing.assert_array_equal(fn(normed).numpy(), logits)


def test_cuda_device_without_cuda_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_entry.main(["--config", CONFIG, "--synthetic", "--steps", "1"])


def test_resnet50_recipe_trains_on_the_cpu_with_colour_jitter(tmp_path):
    """``configs/imagenet_resnet50.py`` as written (random-resized crop,
    flip, brightness/contrast/saturation jitter, label smoothing, nesterov
    momentum, 2 microbatches a step) at width 8 and 32x32: two steps with
    finite losses, each step's jitter factors drawn in the recipe's
    ranges, and a checkpoint that test.main restores."""
    out = str(tmp_path / "run")
    common = ["--config", os.path.join(os.path.dirname(CONFIG),
                                       "imagenet_resnet50.py"),
              "--synthetic", "--device", "cpu",
              "--set", "model_kwargs.width=8", "--set", "input_hw=[32,32]",
              "--set", "augment.out_hw=[32,32]", "--set", "raw_hw=[40,40]"]
    net = train_entry.main(common + [
        "--steps", "2", "--batch", "8", "--val_every", "0", "--set",
        "accum_steps=2", "--set", "log_every=1", "--out", out])
    trainer = net.trainer
    assert trainer.step == 2 and trainer.accum_steps == 2
    assert trainer.augment.brightness == trainer.augment.contrast == 0.4
    with open(os.path.join(out, "train.jsonl")) as f:
        losses_ = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    assert len(losses_) == 2 and np.isfinite(losses_).all()
    draws = trainer.sample(8, (40, 40))
    assert draws.jitter.hue is None and draws.policy is None
    for t, lo, hi in ((draws.jitter.brightness, -0.4, 0.4),
                      (draws.jitter.contrast, 0.6, 1.4),
                      (draws.jitter.saturation, 0.6, 1.4)):
        assert t.shape == (8,) and lo <= float(t.min()) \
            and float(t.max()) <= hi
    again = trainer.sample(8, (40, 40))    # a function of (seed, step)
    assert torch.equal(again.jitter.contrast, draws.jitter.contrast)
    score, restored_net = test_entry.main(common + ["--ckpt", out,
                                                    "--batch", "64"])
    restored = restored_net.trainer
    assert 0.0 <= score <= 1.0 and restored.step == 2


# recipe keys the JAX builders read (recipes/vision.py:51-63), at a value
# that is not the default, that change no number (how JAX runs its step,
# not what it computes): the port accepts them; the keys it now trains
# (erasing, SAM and the optimizer wrappers) are held in
# test_torch_convnet_cli.py
RECIPE_KEYS = [("remat", True, False), ("chain_steps", 2, False),
               ("zero_sharding", True, False)]
RECIPE_IDS = [k for k, _, _ in RECIPE_KEYS]
# a ``pretrained`` block (the JAX trainer's warm start,
# recipes/common.py:247-275): its torch-file form warm-starts the
# classification recipe's ResNet-18 from a torchvision-layout ``.pth`` the
# test writes, and is refused by name for the flow recipe (no ResNet stem
# to map it onto); a bare path (JAX wants dict(path=...)) is refused for
# both
FLOW_CONFIG = os.path.join(os.path.dirname(CONFIG), "chairs_pwcnet.py")
for _task, _config in (("classification", None), ("flow", FLOW_CONFIG)):
    for _form, _value in (("dict", dict(path="r18.pth", depth=18,
                                        load_head=False)),
                          ("path", "encoder.npz")):
        RECIPE_KEYS.append(("pretrained", _value,
                            _form == "path" or _task == "flow", _config))
        RECIPE_IDS.append(f"pretrained-{_form}-{_task}")


def _torchvision_file(path, model):
    """A seeded torchvision-layout state dict of ``model``'s ResNet
    shapes (OIHW convs, running statistics), saved at ``path``."""
    from myconvnet_tpu_torch.models.resnet import STAGE_BLOCKS
    params, state = weights.to_jax(model)
    g = torch.Generator().manual_seed(0)
    sd = {}

    def conv(key, scope):
        kh, kw, cin, cout = params[scope]["w"].shape
        sd[key] = torch.randn(cout, cin, kh, kw, generator=g)

    def bn(key, scope):
        c = params[scope]["gamma"].shape[0]
        for name in ("weight", "bias", "running_mean"):
            sd[f"{key}.{name}"] = torch.randn(c, generator=g)
        sd[f"{key}.running_var"] = torch.rand(c, generator=g) + 0.5

    conv("conv1.weight", "stem/conv")
    bn("bn1", "stem/bn")
    for s, n in enumerate(STAGE_BLOCKS[18]):
        for b in range(n):
            scope, key = f"stage{s + 1}/block{b + 1}", f"layer{s + 1}.{b}"
            for j, letter in enumerate("ab"):
                conv(f"{key}.conv{j + 1}.weight", f"{scope}/conv_{letter}")
                bn(f"{key}.bn{j + 1}", f"{scope}/bn_{letter}")
            if f"{scope}/conv_proj" in params:
                conv(f"{key}.downsample.0.weight", f"{scope}/conv_proj")
                bn(f"{key}.downsample.1", f"{scope}/bn_proj")
    torch.save(sd, path)
    return sd


@pytest.mark.parametrize("key,value,refused,config",
                         [(*k, None)[:4] for k in RECIPE_KEYS],
                         ids=RECIPE_IDS)
def test_recipe_keys_are_refused_by_name_or_inert(key, value, refused,
                                                  config, tmp_path):
    cfg = recipes.load_config(config or CONFIG)
    if config:   # the flow recipe at a tiny size
        cfg.update(model="tinypwc", model_kwargs={}, synthetic_n=4,
                   input_hw=(32, 32))
    else:
        cfg["model_kwargs"] = {**cfg.get("model_kwargs", {}),
                               "width": WIDTH}
    *path, last = key.split(".")
    target = cfg
    for part in path:
        target[part] = dict(target[part])
        target = target[part]
    target[last] = value
    if refused:
        with pytest.raises(ValueError, match=repr(last)):
            recipes.build_trainer(cfg, True, device=torch.device("cpu"))
    elif key == "pretrained":
        probe = recipes.build_trainer(dict(cfg, pretrained=None), True,
                                      device=torch.device("cpu"))[0]
        path = str(tmp_path / value["path"])
        sd = _torchvision_file(path, probe.model)
        target[last] = dict(value, path=path)
        trainer, _, _ = recipes.build_trainer(
            cfg, True, device=torch.device("cpu"))
        got_p, got_s = weights.to_jax(trainer.model)
        np.testing.assert_array_equal(
            got_p["stage1/block1/conv_a"]["w"],
            sd["layer1.0.conv1.weight"].permute(2, 3, 1, 0).numpy())
        np.testing.assert_array_equal(got_s["stem/bn"]["moving_var"],
                                      sd["bn1.running_var"].numpy())
    else:
        trainer, _, _ = recipes.build_trainer(
            cfg, True, device=torch.device("cpu"))
        assert trainer.step == 0
