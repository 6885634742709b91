"""Spectral normalization (``nn.Conv``/``nn.Dense`` with ``spectral_norm``)
and the SN-GAN recipe (``configs/sngan_cifar10.py``) against the JAX
package, on the CPU.

The SN conv and dense layers over k train-mode applies (outputs and the
power-iteration vector ``sn_u`` at 1e-6), the SN discriminators' logits
at 1e-5, a 3-step hinge SN-GAN trajectory at base width 16 against JAX's
``make_gan_step`` with JAX's latents (every leaf of both nets and their
Adam moments within 1e-4 of the leaf's largest |JAX| value, ``sn_u``
within 1e-6 after step 1, then as ``SN_U_ATOL`` says), checkpoints with ``sn_u`` across the packages
(exact), the layer's bound on the leading singular value, and the recipe
through ``train.main`` and ``generate.main``.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn as tnn

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import nn as jnn
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.core import transform
from myconvnet_tpu_torch import generate, models, nn, recipes, recipes_gan, \
    train, weights
from myconvnet_tpu_torch.subsets import cifar10
from myconvnet_tpu_torch.train.gan import GANDraws, GANState
from myconvnet_tpu_torch.train.trainer import frozen_stats

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
SNGAN = os.path.join(CONFIGS, "sngan_cifar10.py")
BATCH = 4
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class _Holder(tnn.Module):
    """A module whose child sits at the JAX scope ``name``."""

    def __init__(self, name, layer):
        super().__init__()
        self.add_module(name, layer)
        self.name = name

    def forward(self, x):
        return getattr(self, self.name)(x)


# ----------------------------------------------------------- layers

@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_sn_layer_and_its_vector_match_jax_over_applies(kind):
    rng = np.random.RandomState(0)
    if kind == "conv":
        x = rng.rand(2, 8, 8, 4).astype(np.float32)
        jnet = transform(lambda x: jnn.conv(x, 8, 3, spectral_norm=True,
                                            name="sn"))
        layer = nn.Conv(4, 8, 3, bias=True, spectral_norm=True)
    else:
        x = rng.rand(3, 12).astype(np.float32)
        jnet = transform(lambda x: jnn.dense(x, 5, spectral_norm=True,
                                             name="sn"))
        layer = nn.Dense(12, 5, spectral_norm=True)
    params, state = jnet.init(jax.random.key(1), jnp.asarray(x))
    params = _np(params)
    params["sn"]["b"] = rng.randn(*params["sn"]["b"].shape).astype(
        np.float32)
    state = _np(state)
    np.testing.assert_array_equal(layer.sn_u.numpy(), state["sn"]["sn_u"])
    model = weights.from_jax(_Holder("sn", layer), params, state).train()
    for k in range(5):
        want, state = jnet.apply(params, state, None, jnp.asarray(x))
        got = model(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6, err_msg=str(k))
        np.testing.assert_allclose(layer.sn_u.numpy(),
                                   np.asarray(state["sn"]["sn_u"]),
                                   rtol=1e-6, atol=1e-6, err_msg=str(k))
    assert weights.to_jax(model)[1]["sn"]["sn_u"].shape == \
        (layer.sn_u.shape[0],)


def test_sn_vector_stays_in_eval_and_under_frozen_stats():
    layer = nn.Conv(3, 4, 3, spectral_norm=True)
    torch.nn.init.normal_(layer.weight)
    x = torch.randn(1, 5, 5, 3)
    u0 = layer.sn_u.clone()
    layer.eval()(x)
    assert torch.equal(layer.sn_u, u0)
    with frozen_stats(_Holder("c", layer.train())):
        layer(x)
    assert torch.equal(layer.sn_u, u0)
    layer(x)
    assert not torch.equal(layer.sn_u, u0)


def test_sn_layer_bounds_the_leading_singular_value():
    """After the power iteration converges, the normalized weight's
    spectral norm is 1 (JAX's ``test_spectral_norm_bounds_singular_value``
    at its 1e-3)."""
    layer = nn.Conv(4, 8, 3, spectral_norm=True).train()
    torch.nn.init.normal_(layer.weight, generator=torch.Generator()
                          .manual_seed(0))
    x = torch.rand(2, 8, 8, 4)
    for _ in range(30):
        layer(x)
    w_sn = nn.spectral_normalize(layer.eval(), layer.w).detach().double()
    np.testing.assert_allclose(
        float(torch.linalg.matrix_norm(w_sn.reshape(-1, 8), ord=2)), 1.0,
        rtol=1e-3)


# ---------------------------------------------------- discriminators

def _dcgan_d(size, base):
    return (transform(lambda x, train=False: jmodels.dcgan_discriminator(
        x, train=train, base_features=base, spectral_norm=True)),
        models.DCGANDiscriminator(image_size=size, base_features=base,
                                  spectral_norm=True))


def _patch_d(size, base):
    return (transform(lambda x, train=False: jmodels.patchgan_discriminator(
        x, train=train, base_features=base, n_layers=2,
        spectral_norm=True)),
        models.PatchGANDiscriminator(in_channels=6, base_features=base,
                                     n_layers=2, spectral_norm=True))


@pytest.mark.parametrize("build,channels", [(_dcgan_d, 3), (_patch_d, 6)],
                         ids=["dcgan", "patchgan"])
def test_sn_discriminators_match_jax(build, channels):
    """The SN forms' scopes are JAX's (no norm layers, a bias on every
    conv); two train-mode applies give JAX's logits within 1e-5 of their
    largest and its ``sn_u``."""
    jnet, port = build(32, 8)
    x = np.random.RandomState(1).uniform(
        -1, 1, (BATCH, 32, 32, channels)).astype(np.float32)
    params, state = _np(jnet.init(jax.random.key(2), jnp.asarray(x), True))
    assert set(weights.to_jax(port)[0]) == set(params)
    assert all(set(s) == {"sn_u"} for s in state.values())
    assert all("b" in p for p in params.values())
    weights.from_jax(port, params, state).train()
    for _ in range(2):
        want, state = jnet.apply(params, state, None, jnp.asarray(x), True)
        got = port(torch.from_numpy(x)).detach().numpy()
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    got_state = weights.to_jax(port)[1]
    for scope in state:
        np.testing.assert_allclose(got_state[scope]["sn_u"],
                                   state[scope]["sn_u"], atol=1e-6)


# ------------------------------------------------------ the recipe

SMALL = ["image_size=16", "generator_kwargs.base_features=16",
         "discriminator_kwargs.base_features=16"]


def _cfg(*sets, **kw):
    cfg = recipes.apply_overrides(recipes.load_config(SNGAN),
                                  SMALL + list(sets))
    cfg.update(batch_size=BATCH, **kw)
    return cfg


def _port_state(jstate) -> GANState:
    s = _np(jstate)
    return GANState(s.g_params, s.g_state, s.d_params, s.d_state,
                    {".mu": s.g_opt.mu, ".nu": s.g_opt.nu},
                    {".mu": s.d_opt.mu, ".nu": s.d_opt.nu}, s.step, s.rng)


def _z(jstate, latent):
    key = jax.random.fold_in(jax.random.wrap_key_data(jstate.rng),
                             jstate.step)
    return np.array(jax.random.normal(jax.random.split(key, 5)[0],
                                      (BATCH, latent), jnp.float32))


def _walk(a, b, path=()):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            yield from _walk(a[k], b[k], path + (k,))
        return
    yield path, np.asarray(a), np.asarray(b, np.float32)


# D's sn_u against JAX's after each step.  Step 1's power iterations run
# on equal weights (8.9e-8 apart); after it the vector tracks D's weights,
# which Adam at b1 = 0 (a sign-like first step) leaves 8.2e-5 of their
# largest apart, and the vectors drift with them: 8.9e-7 after step 2,
# 1.97e-6 after step 3
SN_U_ATOL = (1e-6, 2e-6, 5e-6)


def test_sngan_trajectory_matches_jax():
    """Three hinge steps of the SN-GAN recipe (Adam b1 = 0, b2 = 0.9) from
    JAX's initial state with JAX's latents: D's ``sn_u`` moves twice a
    step (real, then fake) and not in the G pass."""
    cfg = _cfg()
    jstate, jstep, _, _ = jrecipes.build_gan(cfg, synthetic=True)
    jstate = _np(jstate)
    real = np.float32(cifar10.synthetic_subset(512, 0)[0][:BATCH, ::2, ::2]
                      ) / 127.5 - 1.0
    trainer, _ = recipes_gan.build_gan(cfg, True, device=CPU)
    trainer.load_state(_port_state(jstate))
    assert any("sn_u" in s for s in jstate.d_state.values())
    for step, atol in enumerate(SN_U_ATOL):
        z = _z(jstate, cfg["latent_dim"])
        jstate, jm = jstep(jstate, jnp.asarray(real))
        jstate = _np(jstate)
        m = trainer.train_step(torch.from_numpy(real.copy()),
                               GANDraws(z=torch.from_numpy(z)))
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        got = trainer.state()
        for path, a, b in _walk(got.d_state, jstate.d_state):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=f"step {step + 1} {path}")
    want = _port_state(jstate)
    assert int(got.step) == 3
    for name in ("g_params", "g_state", "d_params", "g_opt", "d_opt"):
        for path, a, b in _walk(getattr(got, name), getattr(want, name)):
            gap = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert gap <= 1e-4, (name, path, gap)


def test_sn_checkpoints_cross_the_packages(tmp_path):
    cfg = _cfg(seed=3)
    jstate = _np(jrecipes.build_gan(cfg, synthetic=True)[0])
    trainer, _ = recipes_gan.build_gan(cfg, True, device=CPU)
    x = np.random.RandomState(5).uniform(-1, 1, (BATCH, 16, 16, 3))
    trainer.train_step(torch.from_numpy(x.astype(np.float32)))
    path = trainer.save(str(tmp_path / "port"))
    restored = jckpt.restore_checkpoint(path, jstate._asdict())
    ours = trainer.state()
    for scope, s in ours.d_state.items():
        np.testing.assert_array_equal(restored["d_state"][scope]["sn_u"],
                                      s["sn_u"])
    u = {k: v["sn_u"] + 0.25 for k, v in jstate.d_state.items()}
    jsaved = jstate._replace(d_state={k: {"sn_u": v} for k, v in u.items()})
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 0,
                                  jsaved._asdict())
    fresh, _ = recipes_gan.build_gan(cfg, True, device=CPU)
    fresh.restore(jpath)
    for scope, s in fresh.state().d_state.items():
        np.testing.assert_array_equal(s["sn_u"], u[scope])


def trainer_cfg(args):
    sets = [v for k, v in zip(args, args[1:]) if k == "--set"]
    return recipes.apply_overrides(recipes.load_config(SNGAN), sets)


def test_sngan_recipe_trains_and_generates_on_the_cpu(tmp_path):
    out = str(tmp_path / "run")
    args = ["--config", SNGAN, "--device", "cpu",
            "--set", "generator_kwargs.base_features=16",
            "--set", "discriminator_kwargs.base_features=8"]
    trainer = train.main(args + ["--synthetic", "--steps", "3", "--batch",
                                 "8", "--set", "log_every=3", "--out", out])
    assert trainer.step == 3
    d = trainer.discriminator
    sn = [m for m in d.modules() if getattr(m, "spectral_norm", False)]
    assert len(sn) == 4 and not any(isinstance(m, nn.BatchNorm)
                                    for m in d.modules())
    fresh = [m for m in recipes_gan.gan_discriminator(
        trainer_cfg(args)).modules() if getattr(m, "spectral_norm", False)]
    # every vector moved but the head's [1] (always 1 after l2)
    assert all(not torch.equal(m.sn_u.cpu(), f.sn_u)
               for m, f in zip(sn, fresh) if m.sn_u.numel() > 1)
    png = str(tmp_path / "grid.png")
    generate.main(args + ["--ckpt", out, "--n", "4", "--out", png])
    assert os.path.getsize(png) > 0
