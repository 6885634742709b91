"""GAN metrics (``myconvnet_tpu_torch/eval/gan_metrics.py``) and
``test --fid`` against the JAX package, on the CPU.

The closed forms of ``tests/test_gan_metrics.py``; the port's FID against
JAX's on the same seeded features, with fewer samples than feature
dimensions (a rank-deficient covariance, the usual case at ``--fid_samples
256`` over 512-d features) and with more; the Inception Score at 1e-6;
then ``test.main --fid`` against JAX's ``eval_gan_fid`` on a tiny DCGAN and
SmallNet extractor that JAX wrote, the port's sampler handed JAX's
latents, so both score the same images.

The two eigensolvers order their round-off differently, and the clamped
square root of a rank-deficient covariance magnifies it: over the seeds
below the FIDs sat 3.7e-6 to 4.6e-5 apart (relative) at N < D and 0 to
1.0e-5 at N > D, so the tests hold 2e-4 and 5e-5.
"""

import argparse
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.eval import gan_metrics as jgm
from myconvnet_tpu_torch import recipes_gan, test as test_entry
from myconvnet_tpu_torch.eval import gan_metrics as gm
from myconvnet_tpu_torch.utils.images import to_uint8

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# relative FID gap, port against JAX, at N < D and at N > D
FID_RTOL = {"n_below_d": 2e-4, "n_above_d": 5e-5}


# ------------------------------------------------------- closed forms

def test_frechet_identical_gaussians_zero():
    rng = np.random.RandomState(0)
    cov = rng.randn(4, 4)
    cov = cov @ cov.T + np.eye(4)
    mu = rng.randn(4)
    assert abs(float(gm.frechet_distance(mu, cov, mu, cov))) < 1e-4


def test_frechet_mean_shift_closed_form():
    rng = np.random.RandomState(1)
    cov = rng.randn(5, 5)
    cov = cov @ cov.T + np.eye(5)
    mu1, dmu = rng.randn(5), rng.randn(5)
    d = float(gm.frechet_distance(mu1, cov, mu1 + dmu, cov))
    np.testing.assert_allclose(d, float(np.sum(dmu ** 2)), rtol=1e-4,
                               atol=1e-4)


def test_frechet_diagonal_closed_form():
    a, b = np.array([1.0, 4.0, 9.0]), np.array([4.0, 1.0, 16.0])
    mu1, mu2 = np.zeros(3), np.array([1.0, 0.0, 2.0])
    want = np.sum((mu1 - mu2) ** 2) + np.sum((np.sqrt(a) - np.sqrt(b)) ** 2)
    d = float(gm.frechet_distance(mu1, np.diag(a), mu2, np.diag(b)))
    np.testing.assert_allclose(d, want, rtol=1e-5)


def test_fid_from_features_sampled():
    rng = np.random.RandomState(2)
    a = rng.randn(4000, 8).astype(np.float32)
    b = rng.randn(4000, 8).astype(np.float32)
    assert gm.fid_from_features(a, b) < 0.1
    np.testing.assert_allclose(gm.fid_from_features(a, b + 3.0), 9.0 * 8,
                               rtol=0.1)


def test_activation_statistics_match_jax():
    f = np.random.RandomState(3).randn(16, 2, 2, 3).astype(np.float32)
    mu, cov = gm.activation_statistics(torch.from_numpy(f))
    assert mu.shape == (12,) and cov.shape == (12, 12)
    np.testing.assert_allclose(cov.numpy(), cov.numpy().T, atol=1e-5)
    jmu, jcov = jgm.activation_statistics(f)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-5,
                               atol=1e-6)


def test_inception_score_bounds():
    n, c = 100, 7
    mean, _ = gm.inception_score(np.zeros((n, c), np.float32), splits=2)
    np.testing.assert_allclose(mean, 1.0, rtol=1e-5)
    onehot = np.full((n, c), -30.0, np.float32)
    onehot[np.arange(n), np.arange(n) % c] = 30.0
    np.testing.assert_allclose(gm.inception_score(onehot, splits=1)[0],
                               float(c), rtol=1e-3)


# ---------------------------------------------------- against JAX

@pytest.mark.parametrize("n,d,case", [
    (64, 128, "n_below_d"), (256, 512, "n_below_d"),
    (512, 64, "n_above_d"), (300, 32, "n_above_d")])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fid_matches_jax(n, d, case, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, d).astype(np.float32)
    b = (rng.randn(n, d) * 1.1 + 0.2).astype(np.float32)
    want = jgm.fid_from_features(a, b)
    got = gm.fid_from_features(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got, want, rtol=FID_RTOL[case])


@pytest.mark.parametrize("splits", [1, 3, 10])
def test_inception_score_matches_jax(splits):
    logits = np.random.RandomState(4).randn(50, 10).astype(np.float32) * 3
    got = gm.inception_score(logits, splits=splits)
    want = jgm.inception_score(logits, splits=splits)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ test --fid

GAN_CFG = dict(task="gan", gan_kind="dcgan", dataset="cifar10",
               data_dir=None, image_size=32, batch_size=16, total_steps=4,
               log_every=2, latent_dim=16,
               generator_kwargs=dict(base_features=8),
               discriminator_kwargs=dict(base_features=8),
               g_optimizer=dict(name="adam", b1=0.5, lr=2e-4),
               d_optimizer=dict(name="adam", b1=0.5, lr=2e-4),
               precision="f32", seed=0)
# the FID of the same images through the two packages' extractors
# (features within float32 round-off): 5.2e-7 apart (relative) at 48
# samples of 32-d features, FID 0.172
CLI_FID_RTOL = 1e-5


def _write(path, cfg):
    path.write_text(f"config = {cfg!r}\n")
    return str(path)


def _jax_checkpoints(tmp_path):
    """(gan config, gan ckpt dir, extractor spec) written by JAX: a
    random DCGAN and a SmallNet at width 8."""
    gan_cfg = _write(tmp_path / "gan.py", GAN_CFG)
    gan_dir = str(tmp_path / "gan")
    jckpt.save_checkpoint(gan_dir, 0, jax.tree.map(
        np.asarray, jrecipes.build_gan(dict(GAN_CFG), synthetic=True)[0]
    )._asdict())
    ecfg = jrecipes.load_config(os.path.join(ROOT, "configs",
                                             "cifar10_smallnet.py"))
    ecfg["model_kwargs"] = dict(ecfg.get("model_kwargs", {}), width=8)
    cls_cfg = _write(tmp_path / "cls.py", ecfg)
    cls_dir = str(tmp_path / "cls")
    net, _, _ = jrecipes.build_classifier(dict(ecfg), True, ckpt_dir=cls_dir)
    net.build(jrecipes.make_optimizer(ecfg["optimizer"]))
    net.save(cls_dir)
    return gan_cfg, gan_dir, f"{cls_cfg}:{cls_dir}"


def _jax_latent_sampler(cfg):
    """The port's DCGAN sampler with JAX's latents of ``seed``."""
    latent = cfg.get("latent_dim", 100)

    def sample(trainer, n=64, seed=0):
        z = np.array(jax.random.normal(jax.random.key(seed), (n, latent)))
        return to_uint8(trainer.generate(torch.from_numpy(z)))
    return sample


def test_fid_cli_matches_jax_on_jax_checkpoints(tmp_path, monkeypatch,
                                                 capsys):
    gan_cfg, gan_dir, spec = _jax_checkpoints(tmp_path)
    spec_j = importlib.util.spec_from_file_location(
        "jax_test_entry", os.path.join(ROOT, "test.py"))
    jtest = importlib.util.module_from_spec(spec_j)
    spec_j.loader.exec_module(jtest)
    want = jtest.eval_gan_fid(dict(GAN_CFG), argparse.Namespace(
        fid_extractor=spec, synthetic=True, ckpt=gan_dir, fid_samples=48))
    monkeypatch.setattr(recipes_gan, "make_gan_sampler",
                        _jax_latent_sampler)
    fid, trainer = test_entry.main([
        "--config", gan_cfg, "--ckpt", gan_dir, "--synthetic", "--fid",
        "--fid_extractor", spec, "--fid_samples", "48", "--device", "cpu"])
    assert trainer.kind == "dcgan" and np.isfinite(fid) and fid > 0
    np.testing.assert_allclose(fid, want, rtol=CLI_FID_RTOL)
    assert f"fid: {fid:.3f} (n=48" in capsys.readouterr().out


def test_fid_cli_runs_pix2pix_on_the_cpu(tmp_path):
    """pix2pix fakes are the val inputs translated, the reals their
    targets: a tiny checkpoint the port writes, scored end to end."""
    from myconvnet_tpu_torch import recipes, train
    pcfg = recipes.apply_overrides(
        recipes.load_config(os.path.join(ROOT, "configs", "pix2pix.py")),
        ["image_size=32", "generator_kwargs.base_features=8",
         "generator_kwargs.n_levels=5", "discriminator_kwargs.base_features=8",
         "discriminator_kwargs.n_layers=2", "synthetic_n=8",
         "precision=f32"])
    gan_cfg = _write(tmp_path / "p2p.py", pcfg)
    ecfg = recipes.load_config(os.path.join(ROOT, "configs",
                                            "cifar10_smallnet.py"))
    ecfg["model_kwargs"] = dict(ecfg.get("model_kwargs", {}), width=4)
    cls_cfg = _write(tmp_path / "cls.py", ecfg)
    train.main(["--config", gan_cfg, "--synthetic", "--steps", "1",
                "--batch", "4", "--out", str(tmp_path / "p2p"),
                "--device", "cpu"])
    train.main(["--config", cls_cfg, "--synthetic", "--steps", "1",
                "--batch", "8", "--set", "synthetic_n=16", "--out",
                str(tmp_path / "cls"), "--device", "cpu"])
    fid, _ = test_entry.main([
        "--config", gan_cfg, "--ckpt", str(tmp_path / "p2p"), "--synthetic",
        "--batch", "4", "--fid", "--fid_samples", "8", "--fid_extractor",
        f"{cls_cfg}:{tmp_path / 'cls'}", "--device", "cpu"])
    assert np.isfinite(fid) and fid >= 0.0


@pytest.mark.parametrize("extra,match", [
    ([], "--fid needs --fid_extractor"),
    (["--fid_extractor", "inception:w.npz"], "inception_v3"),
    (["--fid_extractor", "configs/cifar10_smallnet.py"], "CONFIG:CKPT_DIR")],
    ids=["no_extractor", "inception", "no_ckpt"])
def test_fid_cli_refusals(tmp_path, extra, match):
    gan_cfg = _write(tmp_path / "gan.py", GAN_CFG)
    with pytest.raises(SystemExit, match=match):
        test_entry.main(["--config", gan_cfg, "--ckpt", "x", "--fid",
                         "--device", "cpu", *extra])


def test_fid_of_a_diffusion_recipe_is_refused_by_name(tmp_path):
    cfg = _write(tmp_path / "diff.py", dict(task="diffusion"))
    with pytest.raises(SystemExit, match="diffusion"):
        test_entry.main(["--config", cfg, "--ckpt", "x", "--fid",
                         "--fid_extractor", "a:b", "--device", "cpu"])
