"""The port's optimizer wrappers, focal loss, random erasing and SAM
against the JAX package, on the CPU.

ResNet-18 at width 8 (the trees of ``test_torch_train``): each wrapper
alone and the chains ``recipes.make_optimizer`` composes take three steps
of seeded gradients, each port step restarted from JAX's parameters and
optimizer state (moved by ``weights.optimizer_from_jax``), so every
step's update is held at 1e-5 of each leaf's largest and the state's
layout in the JAX checkpoint keys is held with it.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.data import mix as jmix
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu.train import optim as joptim
from myconvnet_tpu_torch import recipes, weights
from myconvnet_tpu_torch.core.precision import FULL
from myconvnet_tpu_torch.data import mix as tmix
from myconvnet_tpu_torch.train import losses, optim
from myconvnet_tpu_torch.train.trainer import Trainer

from test_torch_train import (BATCH, CLASSES, HW, _assert_trees_close, _net,
                              _np_tree, _port_model, trees)  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


BASE = dict(name="momentum", momentum_coef=0.9, nesterov=True,
            weight_decay=5e-4, wd_exclude_norms=True,
            lr=dict(kind="cosine", lr=0.1, total_steps=10))
ADAMW = dict(name="adamw", weight_decay=0.05, wd_exclude_norms=True,
             lr=dict(kind="cosine", lr=1e-3, total_steps=10,
                     warmup_steps=2))
FULL_CHAIN = dict(clip_norm=0.5, plateau=True, freeze=["stem", "stage1"],
                  lookahead=dict(sync_period=2, slow_step=0.5),
                  ema_decay=0.9)
# (base, wrapper keys, the plateau scale set before each step or None)
WRAPPERS = {
    "plateau": (BASE, dict(plateau=True), (1.0, 0.5, 0.25)),
    "freeze_clip": (BASE, dict(freeze=["stem", "stage1"], clip_norm=0.5),
                    None),
    "lookahead": (BASE, dict(lookahead=2), None),
    "ema": (BASE, dict(ema_decay=0.9), None),
    "ema_plateau": (BASE, dict(ema_decay=0.9, plateau=True),
                    (1.0, 0.5, 0.5)),
    "chain_momentum": (BASE, FULL_CHAIN, None),
    "chain_adamw": (ADAMW, FULL_CHAIN, None),
}


def nested(flat: dict) -> dict:
    """{"a::b::c": x} -> {"a": {"b": {"c": x}}}."""
    out = {}
    for key, value in flat.items():
        parts = key.split("::")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = np.asarray(value)
    return out


def flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return {s: {n: (0.1 * rng.randn(*v.shape)).astype(np.float32)
                for n, v in d.items()} for s, d in sorted(params.items())}


def _set_grads(model, g):
    for path, p, view in weights.param_views(model):
        scope, name = path.rsplit("/", 1)
        p.grad = torch.empty_like(p)
        view(p.grad).copy_(torch.from_numpy(g[scope][name]))


def _assert_flat_close(got, want, rtol, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    for k, ref in want.items():
        np.testing.assert_allclose(
            got[k], ref, rtol=rtol,
            atol=rtol * max(np.abs(ref).max(), 1e-30), err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_steps_match_jax(trees, name):
    """Params and the whole optimizer state (its JAX checkpoint keys
    included) after each of three steps: 1e-5 of each leaf's largest."""
    base, keys, scales = WRAPPERS[name]
    cfg = dict(base, **keys)
    params, state = trees
    jopt = jrecipes.make_optimizer(cfg)
    jparams = {s: {n: jnp.asarray(v) for n, v in d.items()}
               for s, d in params.items()}
    jstate = jopt.init(jparams)
    model = _port_model(params, state)
    opt = recipes.make_optimizer(model, cfg)
    for step in range(3):
        weights.from_jax(model, _np_tree(jparams), state)
        weights.optimizer_from_jax(model, opt, nested(flat_np(jstate)))
        if scales is not None:
            jstate = joptim.set_plateau_scale(jstate, scales[step])
            optim.set_plateau_scale(opt, scales[step])
        g = _grads(params, step)
        jparams, jstate = jopt.update(
            jax.tree.map(jnp.asarray, g), jstate, jparams,
            jnp.asarray(step, jnp.int32))
        _set_grads(model, g)
        opt.step(step)
        _assert_trees_close(weights.to_jax(model)[0], _np_tree(jparams),
                            1e-5, f"step {step} params")
        _assert_flat_close(
            {k: v for k, v in jckpt._flatten(
                weights.optimizer_to_jax(model, opt)).items()},
            flat_np(jstate), 1e-5, f"step {step} opt_state")
    if "freeze" in keys:   # the frozen leaves kept their exact values
        got = weights.to_jax(model)[0]
        for scope in params:
            if scope.startswith(("stem", "stage1")):
                for n, v in params[scope].items():
                    np.testing.assert_array_equal(got[scope][n], v)


def test_plateau_under_lookahead_is_refused_as_in_jax(trees):
    """JAX finds the plateau scale through EmaOptState only, so plateau
    under lookahead has none (``Trainer.fit``'s fail-fast); the port
    refuses the same chain, and its ``fit`` fails before a step."""
    cfg = dict(BASE, plateau=True, lookahead=2, ema_decay=0.9)
    jstate = jrecipes.make_optimizer(cfg).init({"a": {"w": jnp.zeros(2)}})
    with pytest.raises(ValueError, match="plateau"):
        joptim.plateau_scale(jstate)
    model = _port_model(*trees)
    opt = recipes.make_optimizer(model, cfg)
    with pytest.raises(ValueError, match="plateau"):
        optim.plateau_scale(opt)
    trainer = Trainer(model, opt, losses.softmax_cross_entropy,
                      device="cpu", policy=FULL, num_classes=CLASSES,
                      plateau_factor=0.5, plateau_patience=1)
    with pytest.raises(ValueError, match="plateau"):
        trainer.fit(iter([]), total_steps=1)
    assert trainer.step == 0
    # through EMA (and a stateless freeze) it is found
    opt = recipes.make_optimizer(model, dict(BASE, plateau=True,
                                             freeze=["stem"],
                                             ema_decay=0.9))
    optim.set_plateau_scale(opt, 0.25)
    assert optim.plateau_scale(opt) == 0.25


def test_wrapper_checkpoint_keys_are_the_jax_convnets(trees, tmp_path):
    """The full chain's checkpoint: the key set and shapes JAX's ConvNet
    writes, and each restores the other's file."""
    cfg = dict(BASE, **FULL_CHAIN)
    net = _net()
    net.build(jrecipes.make_optimizer(cfg))
    net.save(str(tmp_path / "jax"))
    model = _port_model(*trees)
    port = Trainer(model, recipes.make_optimizer(model, cfg),
                   losses.softmax_cross_entropy, device="cpu", policy=FULL,
                   num_classes=CLASSES, ckpt_dir=str(tmp_path / "port"))
    port.save()
    with np.load(tmp_path / "jax" / "ckpt-0.npz") as j, \
            np.load(tmp_path / "port" / "ckpt-0.npz") as t:
        assert {k: j[k].shape for k in j.files} == \
            {k: t[k].shape for k in t.files}
        assert {k: j[k].dtype for k in j.files if "::." in k} == \
            {k: t[k].dtype for k in t.files if "::." in k}
    assert any(k.startswith("opt_state::.ema::") for k in t.files)
    restored = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                        net.state._asdict())
    want = flat_np(port.state()._asdict())
    for k, v in flat_np(restored).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    port.restore(str(tmp_path / "jax"))
    got = flat_np(port.state()._asdict())
    for k, v in flat_np(net.state._asdict()).items():
        if k != "rng":
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# ----------------------------------------------------------- focal loss


@pytest.mark.parametrize("shape,alpha,ignore", [
    ((16, 5), [0.1, 0.2, 0.3, 0.15, 0.25], -1),
    ((16, 5), 0.25, None),
    ((16, 5), None, None),
    ((2, 6, 7, 4), [0.4, 0.3, 0.2, 0.1], 255)],
    ids=["per_class_ignore", "scalar", "plain", "dense_ignore"])
def test_focal_loss_and_gradient_match_jax(shape, alpha, ignore):
    rng = np.random.RandomState(1)
    logits = (2.0 * rng.randn(*shape)).astype(np.float32)
    labels = rng.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    if ignore is not None:
        labels.reshape(-1)[::5] = ignore
    kw = dict(gamma=2.0, alpha=alpha, ignore_label=ignore)
    jl, jg = jax.value_and_grad(lambda z: jlosses.focal_loss(
        z, jnp.asarray(labels), **kw))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    loss = losses.focal_loss(z, torch.from_numpy(labels), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jg)).max())


def test_focal_loss_refuses_soft_labels_and_a_wrong_alpha():
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="integer class labels"):
        losses.focal_loss(z, torch.full((4, 3), 1.0 / 3))
    with pytest.raises(ValueError, match="length 3"):
        losses.focal_loss(z, torch.zeros(4, dtype=torch.long),
                          alpha=[0.5, 0.5])


# ------------------------------------------------------- random erasing


@pytest.mark.parametrize("fill,dtype", [("noise", "float32"),
                                        ("noise", "bfloat16"),
                                        ("zero", "float32")])
def test_random_erasing_under_jax_draws_is_bit_exact(fill, dtype):
    """JAX's draws (area, log aspect, centre, apply and the noise) given
    to the port's ``random_erasing``: the same output, bit for bit."""
    n, h, w, c = 8, 24, 20, 3
    rng = np.random.RandomState(2)
    x = rng.randn(n, h, w, c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    key = jax.random.key(7)
    want = jmix.random_erasing(key, jnp.asarray(x, jdt), prob=0.5,
                               fill=fill)
    k_area, k_aspect, k_rect, k_apply, k_fill = jax.random.split(key, 5)
    k_cy, k_cx = jax.random.split(k_rect)

    def t(a):
        return torch.from_numpy(np.array(a))

    draws = tmix.EraseDraws(
        area=t(jax.random.uniform(k_area, (n,), minval=0.02,
                                  maxval=1.0 / 3.0)),
        log_ar=t(jax.random.uniform(k_aspect, (n,),
                                    minval=jnp.log(0.3),
                                    maxval=jnp.log(3.3))),
        centre=t(jnp.stack([jax.random.uniform(k_cy, (n,)),
                            jax.random.uniform(k_cx, (n,))], axis=1)),
        apply=t(jax.random.bernoulli(k_apply, 0.5, (n,))),
        noise=(t(jax.random.normal(k_fill, (n, h, w, c), jnp.float32))
               if fill == "noise" else None))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tmix.random_erasing(xt, draws)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert 0 < int(draws.apply.sum()) < n   # both branches are held


def test_erasing_draws_are_made_on_the_generator_and_in_range():
    g = torch.Generator().manual_seed(3)
    d = tmix.sample_erasing(g, (64, 8, 8, 3), prob=0.25)
    assert d.noise.shape == (64, 8, 8, 3)
    assert 0.02 <= float(d.area.min()) and float(d.area.max()) <= 1 / 3
    assert math.log(0.3) <= float(d.log_ar.min()) \
        and float(d.log_ar.max()) <= math.log(3.3)
    assert 0 < int(d.apply.sum()) < 64
    again = tmix.sample_erasing(torch.Generator().manual_seed(3),
                                (64, 8, 8, 3), prob=0.25)
    assert torch.equal(d.noise, again.noise)


# ------------------------------------------------------------------ SAM


@pytest.mark.parametrize("accum,batch", [(1, BATCH), (2, 2 * BATCH)])
def test_sam_step_matches_jax_f32(trees, accum, batch):
    """One SAM step (rho 0.05; with accumulation, per microbatch) of
    ResNet-18 at float32 from the same weights, on float inputs (seed 5,
    as ``test_train_mode_step_matches_jax_f32``): params, momentum and BN
    moving statistics (from the perturbed pass) at 1e-4 of each leaf's
    largest.  Both cases run microbatches of 8: at 4 images a BN batch
    the plain step (rho 0) of this net already differs between the
    frameworks by 1.6e-4 of a leaf."""
    params, state = trees
    rng = np.random.RandomState(5)
    x = rng.randn(batch, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, batch).astype(np.int32)
    net = _net(sam_rho=0.05, accum_steps=accum)
    net.build(jrecipes.make_optimizer(BASE))
    jstate = net.state._replace(params=params, model_state=state)
    jstate, jm = net._make_trainer(None)._train_step(
        jstate, (jnp.asarray(x), jnp.asarray(y)))
    model = _port_model(params, state)
    port = Trainer(model, recipes.make_optimizer(model, BASE),
                   losses.softmax_cross_entropy, device="cpu", policy=FULL,
                   num_classes=CLASSES, sam_rho=0.05, accum_steps=accum)
    tm = port.train_step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    got = port.state()
    for field in ("params", "opt_state", "model_state"):
        _assert_trees_close(getattr(got, field),
                            _np_tree(getattr(jstate, field)), 1e-4, field)
    # the step moved away from a plain one's: SAM's gradient is another
    plain_model = _port_model(params, state)
    plain = Trainer(plain_model, recipes.make_optimizer(plain_model, BASE),
                    losses.softmax_cross_entropy, device="cpu", policy=FULL,
                    num_classes=CLASSES, accum_steps=accum)
    plain.train_step(torch.from_numpy(x), torch.from_numpy(y))
    diff = np.abs(plain.state().params["logits"]["w"]
                  - got.params["logits"]["w"]).max()
    assert diff > 1e-6
