"""BASELINE config #5 (``configs/dcgan_cifar10.py``, ``configs/pix2pix.py``)
through the port against the JAX recipes, on the CPU.

One fused step of each recipe, at small sizes (DCGAN at 16x16, every
other pixel of the synthetic CIFAR-10 images, with G base 16 and D base
8; pix2pix at 32x32 with a 5-level U-Net of base 8 and a 2-layer
PatchGAN of base 8; batch 4; float32), from the JAX recipe's own
initial state loaded through the checkpoint layout, with JAX's z and
dropout masks: the losses and metrics, both nets' BN moving statistics
(D's after its real and fake passes, its G-pass statistics dropped), and
every parameter leaf and Adam moment within 1e-4 of the leaf's largest
|JAX| value.  Then checkpoints across the packages (exact), the refusals
by name, and ``train.main`` -> ``test.main`` -> ``generate.main`` for both
recipes at a tiny width, with B2's launches a step counted by a spy (on
the CPU every wrapper runs its plain version).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.train.optim import AdamState
from myconvnet_tpu_torch import generate, recipes, recipes_gan, test, train
from myconvnet_tpu_torch.subsets import cifar10, pairs
from myconvnet_tpu_torch.train import gan as gan_mod
from myconvnet_tpu_torch.train.gan import GANDraws, GANState

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
DCGAN = os.path.join(CONFIGS, "dcgan_cifar10.py")
PIX2PIX = os.path.join(CONFIGS, "pix2pix.py")
BATCH = 4
SMALL = {
    "dcgan": ["generator_kwargs.base_features=16",
              "discriminator_kwargs.base_features=8"],
    "pix2pix": ["image_size=32", "generator_kwargs.base_features=8",
                "generator_kwargs.n_levels=5",
                "discriminator_kwargs.base_features=8",
                "discriminator_kwargs.n_layers=2", "synthetic_n=8"]}
CPU = torch.device("cpu")


def _cfg(kind, *sets, **kw):
    cfg = recipes.load_config(DCGAN if kind == "dcgan" else PIX2PIX)
    cfg = recipes.apply_overrides(cfg, SMALL[kind] + list(sets))
    cfg.update(batch_size=BATCH, **kw)
    return cfg


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jstate) -> GANState:
    """A JAX GANState as the port's (numpy trees, Adam as {.mu, .nu})."""
    s = _numpy(jstate)
    return GANState(s.g_params, s.g_state, s.d_params, s.d_state,
                    {".mu": s.g_opt.mu, ".nu": s.g_opt.nu},
                    {".mu": s.d_opt.mu, ".nu": s.d_opt.nu}, s.step, s.rng)


def _step_keys(jstate):
    key = jax.random.fold_in(jax.random.wrap_key_data(jstate.rng),
                             jstate.step)
    return jax.random.split(key, 5)


def _leaf_gaps(got: GANState, want: GANState) -> dict:
    """{(tree, scope, name): max |got - want| / max |want|} over every
    leaf of the six trees."""
    out = {}

    def walk(name, a, b, path=()):
        if isinstance(b, dict):
            assert set(a) == set(b), (name, path)
            for k in b:
                walk(name, a[k], b[k], path + (k,))
            return
        b = np.asarray(b, np.float32)
        out[(name, *path)] = float(np.abs(np.asarray(a) - b).max()
                                   / max(np.abs(b).max(), 1e-30))

    for name in ("g_params", "g_state", "d_params", "d_state", "g_opt",
                 "d_opt"):
        walk(name, getattr(got, name), getattr(want, name))
    return out


def _real(kind, n=BATCH):
    """The first n train examples, rescaled as JAX does."""
    if kind == "dcgan":
        x = cifar10.synthetic_subset(512, 0)[0][:n]
        return np.float32(x) / 127.5 - 1.0
    if kind == "dcgan16":
        return _real("dcgan", n)[:, ::2, ::2].copy()
    a, b = pairs.synthetic_subset(8, (32, 32), 0)
    return (a[:n].astype(np.float32) / 127.5 - 1.0,
            b[:n].astype(np.float32) / 127.5 - 1.0)


@pytest.mark.parametrize("gan_loss", ["nonsaturating", "lsgan", "hinge"])
def test_dcgan_step_matches_jax(gan_loss):
    """One step of the DCGAN recipe with JAX's z: d_loss, g_loss and the
    accuracies; every leaf of both nets' parameters, BN statistics and
    Adam moments within 1e-4 of its largest."""
    cfg = _cfg("dcgan", "image_size=16", gan_loss=gan_loss)
    jstate, jstep, _, _ = jrecipes.build_gan(cfg, synthetic=True)
    jstate = _numpy(jstate)
    kz = _step_keys(jstate)[0]
    z = np.asarray(jax.random.normal(kz, (BATCH, 100), jnp.float32))
    real = _real("dcgan16")
    jnew, jmetrics = jstep(jstate, jnp.asarray(real))
    want = _port_state(jnew)

    trainer, _ = recipes_gan.build_gan(cfg, True, device=CPU)
    trainer.load_state(_port_state(jstate))
    metrics = trainer.train_step(torch.from_numpy(real),
                                 GANDraws(z=torch.from_numpy(z.copy())))
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got = trainer.state()
    assert int(got.step) == int(want.step) == 1
    gaps = _leaf_gaps(got, want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1e-4, (worst, gaps[worst])


def _jax_masks(cfg, jstate, keys, x):
    """The dropout masks of G's train-mode apply with each of ``keys``, in
    order."""
    gen = jrecipes.gan_generator(cfg)
    bernoulli = jax.random.bernoulli

    def run(p, s, k, xv):
        drawn = []

        def spy(key, p=0.5, shape=None):
            drawn.append(bernoulli(key, p, shape))
            return drawn[-1]

        jax.random.bernoulli = spy
        try:
            gen.apply(p, s, k, xv, True)
        finally:
            jax.random.bernoulli = bernoulli
        return drawn

    run = jax.jit(run)
    return [[np.array(m) for m in run(jstate.g_params, jstate.g_state, key,
                                      jnp.asarray(x))] for key in keys]


def test_pix2pix_step_matches_jax():
    """One step of the pix2pix recipe (float32) with JAX's dropout masks
    for both G passes (kg, kg2): d_loss, g_loss, g_adv, g_l1, and every
    leaf within 1e-4 of its largest; G's statistics are the G-loss
    pass's, D's those of its two passes in the D update."""
    cfg = _cfg("pix2pix", precision="f32")
    jstate, jstep, _, _ = jrecipes.build_gan(cfg, synthetic=True)
    jstate = _numpy(jstate)
    kg, _, _, _, kg2 = _step_keys(jstate)
    x, target = _real("pix2pix")
    trainer, _ = recipes_gan.build_gan(cfg, True, device=CPU)
    sites = list(trainer.generator.dropout_sites())
    draws = {}
    for name, masks in zip(("d_masks", "g_masks"),
                           _jax_masks(cfg, jstate, (kg, kg2), x)):
        assert len(masks) == len(sites) == 3
        draws[name] = {s: torch.from_numpy(m) for s, m in zip(sites, masks)}
    assert not torch.equal(draws["d_masks"][sites[0]],
                           draws["g_masks"][sites[0]])
    jnew, jmetrics = jstep(jstate, (jnp.asarray(x), jnp.asarray(target)))
    want = _port_state(jnew)

    trainer.load_state(_port_state(jstate))
    metrics = trainer.train_step(
        (torch.from_numpy(x), torch.from_numpy(target)), GANDraws(**draws))
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    gaps = _leaf_gaps(trainer.state(), want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1e-4, (worst, gaps[worst])


@pytest.mark.parametrize("kind", ["dcgan", "pix2pix"])
def test_checkpoints_cross_the_packages(kind, tmp_path):
    """A checkpoint the port writes restores in JAX's GANState, and one
    JAX writes restores in the port, leaf for leaf exactly (rng as JAX's
    uint32 [2] key data)."""
    cfg = _cfg(kind, seed=7)
    jstate = _numpy(jrecipes.build_gan(cfg, synthetic=True)[0])
    trainer, _ = recipes_gan.build_gan(cfg, True, device=CPU)
    batch = _real(kind)
    batch = (torch.from_numpy(batch) if kind == "dcgan"
             else tuple(map(torch.from_numpy, batch)))
    trainer.train_step(batch)
    path = trainer.save(str(tmp_path / "port"))
    restored = jckpt.restore_checkpoint(path, jstate._asdict())
    back = _port_state(type(jstate)(**restored))
    ours = trainer.state()
    assert all(g == 0.0 for g in _leaf_gaps(back, ours).values())
    assert int(back.step) == 1 and back.rng.dtype == np.uint32
    assert list(back.rng) == [0, 7]
    assert list(np.asarray(jstate.rng)) == [0, 7]

    jsaved = jstate._replace(step=np.asarray(5, np.int32),
                             g_opt=AdamState(*[jax.tree.map(
                                 lambda v: v + 0.5, t)
                                 for t in jstate.g_opt]))
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 5,
                                  jsaved._asdict())
    fresh, _ = recipes_gan.build_gan(cfg, True, device=CPU)
    fresh.restore(jpath)
    assert fresh.step == 5 and fresh.seed == 7
    assert all(g == 0.0 for g in _leaf_gaps(
        fresh.state(), _port_state(jsaved)).values())


# -------------------------------------------------------------- refusals

@pytest.mark.parametrize("sets,match", [
    (["gan_kind=cyclegan"], "cyclegan"), (["gan_kind=srgan"], "srgan"),
    (["gan_kind=stylegan"], "unknown gan kind")])
def test_recipe_refuses_what_is_not_ported_by_name(sets, match):
    with pytest.raises(ValueError, match=match):
        recipes_gan.build_gan(_cfg("pix2pix", *sets), True, device=CPU)


def test_dcgan_dataset_is_cifar10():
    with pytest.raises(ValueError, match="dcgan dataset"):
        recipes_gan.build_gan(_cfg("dcgan", "dataset=mnist"), True,
                              device=CPU)


def _args(kind):
    return ["--config", DCGAN if kind == "dcgan" else PIX2PIX,
            *[a for kv in SMALL[kind] for a in ("--set", kv)]]


@pytest.mark.parametrize("entry,extra,match", [
    (test, ["--ckpt", "x", "--fid"], "--fid"),
    (test, ["--ckpt", "x", "--export", "out", "--int8"], "--int8")])
def test_entry_points_refuse_unported_flags(entry, extra, match):
    with pytest.raises(SystemExit, match=match):
        entry.main(_args("pix2pix") + ["--device", "cpu", *extra])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the "
                    "refusal without CUDA")
@pytest.mark.parametrize("entry,extra", [
    (train, ["--synthetic", "--steps", "1"]), (test, ["--ckpt", "x"]),
    (generate, ["--ckpt", "x"])])
def test_entry_points_need_cuda_unless_told_cpu(entry, extra):
    with pytest.raises(SystemExit, match="CUDA is not available"):
        entry.main(_args("dcgan") + extra)


# ------------------------------------------------------------ end to end

def _count_b2(monkeypatch):
    calls = []
    plain = gan_mod.normalize_u8

    def spy(x, *a, **k):
        calls.append(tuple(x.shape))
        return plain(x, *a, **k)

    monkeypatch.setattr(gan_mod, "normalize_u8", spy)
    return calls


def test_dcgan_trains_samples_and_generates_on_the_cpu(tmp_path,
                                                       monkeypatch):
    """train.main for 4 steps of 8 (a log, a checkpoint and a 16-sample
    grid every 2 steps; B2 once a step), test.main exits with the
    reference's message, generate.main writes the 64-sample grid of the
    restored G, equal to the writer's samples; the PNG decodes to it."""
    from PIL import Image
    out = str(tmp_path / "run")
    b2 = _count_b2(monkeypatch)
    args = _args("dcgan") + ["--device", "cpu"]
    trainer = train.main(args + ["--synthetic", "--steps", "4", "--batch",
                                 "8", "--set", "log_every=2", "--set",
                                 "sample_every=2", "--out", out])
    assert trainer.step == 4 and b2 == [(8, 32, 32, 3)] * 4
    with open(os.path.join(out, "gan_dcgan.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [2, 4]
    assert all(np.isfinite(r[k]) for r in rows
               for k in ("d_loss", "g_loss", "d_real_acc", "d_fake_acc"))
    assert sorted(os.listdir(os.path.join(out, "images"))) == [
        "samples_00000002.png", "samples_00000004.png"]
    with pytest.raises(SystemExit, match="generate"):
        test.main(args + ["--ckpt", out])
    png = str(tmp_path / "s.png")
    grid = generate.main(args + ["--ckpt", out, "--n", "9", "--out", png])
    sampler = recipes_gan.make_gan_sampler(_cfg("dcgan"))
    from myconvnet_tpu_torch.utils.images import make_grid
    assert np.array_equal(grid, make_grid(
        sampler(trainer, 9, seed=0).numpy(), pad=0))
    assert grid.shape == (96, 96, 3)
    assert np.array_equal(np.asarray(Image.open(png)), grid)


def test_pix2pix_trains_tests_and_generates_on_the_cpu(tmp_path,
                                                       monkeypatch):
    """train.main for 3 steps (bf16, as written; B2 twice a step),
    test.main prints PSNR and SSIM of the restored G on the 8 val pairs
    (B2 once a batch), generate.main writes input | output pairs; the
    restored G translates as the writer's did."""
    out = str(tmp_path / "run")
    b2 = _count_b2(monkeypatch)
    args = _args("pix2pix") + ["--device", "cpu"]
    trainer = train.main(args + ["--synthetic", "--steps", "3", "--batch",
                                 "4", "--set", "log_every=1", "--out", out])
    assert trainer.step == 3 and b2 == [(4, 32, 32, 3)] * 6
    with open(os.path.join(out, "gan_pix2pix.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert all(np.isfinite(r[k]) for r in rows
               for k in ("d_loss", "g_loss", "g_adv", "g_l1"))
    del b2[:]
    (psnr, ssim), restored = test.main(args + ["--ckpt", out, "--synthetic",
                                               "--batch", "4"])
    assert b2 == [(4, 32, 32, 3)] * 2
    assert psnr > 0 and -1.0 <= ssim <= 1.0
    x = restored.to_unit_range(torch.from_numpy(
        pairs.synthetic_subset(8, (32, 32), 1)[0][:4]))
    assert torch.equal(restored.generate(x), trainer.generate(x))
    assert restored.generate(x).dtype == torch.bfloat16
    grid = generate.main(args + ["--ckpt", out, "--n", "4", "--out",
                                 str(tmp_path / "t.png")])
    assert grid.shape == (2 * 32 + 2, 2 * 64 + 2, 3)
