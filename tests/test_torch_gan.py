"""The port's GAN pieces against the JAX package's, on the CPU.

``conv2d_transpose`` (forward and both gradients, k in {3, 4}, stride in
{1, 2}, SAME and VALID, odd and even sizes); the DCGAN generator (16x16,
base 16) and discriminator (base 8), the U-Net (32x32, 5 levels, base 8,
batch and instance norm) and the PatchGAN (2 layers, base 8) in train and
eval mode under both policies; the GAN losses; the weight bridge; the
synthetic pairs; PSNR and SSIM; B1's routing in the generators' eval
forwards; B2's rescale.  Batch 4; inputs from numpy seeds; JAX under
``jax.jit``; on the CPU every kernel wrapper runs its plain version.

Tolerances: ``conv2d_transpose`` 1e-5 of max |JAX|; model outputs and BN
moving statistics float32 1e-5 of max |JAX|, bf16 0.05; the losses 1e-6
relative; PSNR and SSIM 1e-5; the weight bridge and the synthetic pairs
exact; the routed eval forwards equal the unrouted ones (bit for bit in
float32; under bf16 within a bf16 ulp of max, since the plain leaky ReLU
rounds BN's output to bf16 before its product and B1 after); B2's
rescale within 2^-23 (one float32 ulp at magnitude 1) of x / 127.5 - 1
over all 256 uint8 values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import BF16 as JBF16
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.eval import image_metrics as jmetrics
from myconvnet_tpu.ops.conv import conv2d_transpose as jconv_t
from myconvnet_tpu.subsets import pairs as jpairs
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu_torch import models, weights
from myconvnet_tpu_torch.eval import image_metrics
from myconvnet_tpu_torch.models import blocks
from myconvnet_tpu_torch.ops.conv import conv2d_transpose, transpose_pads
from myconvnet_tpu_torch.ops.kernels import normalize_u8
from myconvnet_tpu_torch.subsets import pairs
from myconvnet_tpu_torch.train import losses

torch.set_num_threads(1)

BATCH = 4


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


# ------------------------------------------------------ conv2d_transpose

CT_CASES = [(k, s, pad, hw) for k in (3, 4) for s in (1, 2)
            for pad in ("SAME", "VALID") for hw in (5, 6)]


@pytest.mark.parametrize("k,s,pad,hw", CT_CASES,
                         ids=[f"k{k}s{s}-{p}-{h}" for k, s, p, h in CT_CASES])
def test_conv2d_transpose_matches_jax(k, s, pad, hw):
    """Forward, input and weight gradients (of a random projection of the
    output), float32: 1e-5 of max |JAX|."""
    x = _rand(k * 10 + s, 2, hw, hw + 1, 3)
    w = _rand(k + s, k, k, 3, 5, scale=0.3)
    out_shape = jconv_t(jnp.asarray(x), jnp.asarray(w), stride=s,
                        padding=pad).shape
    proj = _rand(7, *out_shape)

    def f(xv, wv):
        y = jconv_t(xv, wv, stride=s, padding=pad,
                    precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(y * proj), y

    (_, want), (gx, gw) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = conv2d_transpose(xt, wt, stride=s, padding=pad)
    (got * torch.from_numpy(proj)).sum().backward()
    for a, b in ((got.detach(), want), (xt.grad, gx), (wt.grad, gw)):
        _close(a.numpy(), b, 1e-5)


def test_transpose_pads_follow_lax():
    from jax._src.lax.convolution import _conv_transpose_padding
    for k in range(1, 8):
        for s in range(1, 5):
            for pad in ("SAME", "VALID"):
                assert transpose_pads(k, s, pad) == tuple(
                    _conv_transpose_padding(k, s, pad)), (k, s, pad)


# ---------------------------------------------------------------- models

def _jax_fn(name, norm="batch"):
    if name == "dcgan_g":
        return transform(lambda z, train: jmodels.dcgan_generator(
            z, train=train, image_size=16, base_features=16))
    if name == "dcgan_d":
        return transform(lambda x, train: jmodels.dcgan_discriminator(
            x, train=train, base_features=8))
    if name == "unet":
        return transform(lambda x, train: jmodels.unet_generator(
            x, train=train, base_features=8, n_levels=5, norm=norm))
    return transform(lambda a, b, train: jmodels.patchgan_discriminator(
        a, b, train=train, base_features=8, n_layers=2, norm=norm))


def _port_model(name, norm="batch"):
    if name == "dcgan_g":
        return models.DCGANGenerator(100, image_size=16, base_features=16)
    if name == "dcgan_d":
        return models.DCGANDiscriminator(image_size=16, base_features=8)
    if name == "unet":
        return models.UNetGenerator(image_size=32, base_features=8,
                                    n_levels=5, norm=norm)
    return models.PatchGANDiscriminator(base_features=8, n_layers=2,
                                        norm=norm)


def _inputs(name):
    if name == "dcgan_g":
        return [_rand(1, BATCH, 100)]
    if name == "dcgan_d":
        return [np.tanh(_rand(2, BATCH, 16, 16, 3))]
    if name == "unet":
        return [np.tanh(_rand(3, BATCH, 32, 32, 3))]
    return [np.tanh(_rand(4, BATCH, 32, 32, 3)),
            np.tanh(_rand(5, BATCH, 32, 32, 3))]


def jax_run(fn, params, state, args, train, precision, key=None):
    """(output, new state, dropout masks drawn in order) under jax.jit."""
    bernoulli = jax.random.bernoulli

    def run(p, s, k, *a):
        drawn = []

        def spy(key, p=0.5, shape=None):
            mask = bernoulli(key, p, shape)
            drawn.append(mask)
            return mask

        jax.random.bernoulli = spy
        try:
            with policy_scope(JBF16 if precision == "bf16" else JFULL):
                out, new = fn.apply(p, s, k, *a, train)
        finally:
            jax.random.bernoulli = bernoulli
        return out, new, drawn

    return jax.jit(run)(params, state, key,
                        *[jnp.asarray(a) for a in args])


MODEL_CASES = [(m, n) for m, n in (("dcgan_g", "batch"), ("dcgan_d", "batch"),
                                   ("unet", "batch"), ("unet", "instance"),
                                   ("patchgan", "batch"),
                                   ("patchgan", "instance"))]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,norm", MODEL_CASES,
                         ids=[f"{m}-{n}" for m, n in MODEL_CASES])
def test_model_matches_jax(name, norm, train, precision):
    """Outputs and (train mode) the BN moving statistics after the forward:
    float32 1e-5, bf16 0.05 of max |JAX|.  The U-Net's train-mode dropout
    masks are the ones JAX draws."""
    model = _port_model(name, norm)
    params, state = weights.random_jax_params(model, 11)
    args = _inputs(name)
    key = jax.random.PRNGKey(3) if name == "unet" else None
    want, new_state, masks = jax_run(_jax_fn(name, norm), params, state,
                                     args, train, precision, key)
    weights.from_jax(model, params, state).train(train)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    xs = [torch.from_numpy(a).to(dtype) for a in args]
    kw = {}
    if name == "unet" and train:
        sites = list(model.dropout_sites())
        assert len(masks) == len(sites) == 3
        kw["masks"] = {s: torch.from_numpy(np.array(m))
                       for s, m in zip(sites, masks)}
        for s, m in kw["masks"].items():
            assert tuple(m.shape) == (BATCH, *model.dropout_sites()[s])
    with torch.no_grad():
        got = model(*xs, **kw)
    assert got.dtype == dtype
    rel = 0.05 if precision == "bf16" else 1e-5
    _close(got.float().numpy(), np.asarray(want, np.float32), rel)
    if train:
        got_state = weights.to_jax(model)[1]
        assert set(got_state) == set(new_state)
        for scope, d in new_state.items():
            for k, v in d.items():
                _close(got_state[scope][k], v, rel)


def test_model_scopes_match_the_jax_init_tree():
    """Every module carries the JAX init tree's scope, name and shape, at
    the recipes' full widths (DCGAN at 32x32, the U-Net at 256x256 with 8
    levels, the 70x70 PatchGAN)."""
    cases = [
        (models.DCGANGenerator(100, image_size=32, base_features=256),
         transform(lambda z, t: jmodels.dcgan_generator(
             z, train=t, image_size=32, base_features=256)),
         [jnp.zeros((1, 100))]),
        (models.DCGANDiscriminator(image_size=32, base_features=64),
         transform(lambda x, t: jmodels.dcgan_discriminator(
             x, train=t, base_features=64)), [jnp.zeros((1, 32, 32, 3))]),
        (models.UNetGenerator(image_size=256),
         transform(lambda x, t: jmodels.unet_generator(x, train=t)),
         [jnp.zeros((1, 256, 256, 3))]),
        (models.PatchGANDiscriminator(),
         transform(lambda a, b, t: jmodels.patchgan_discriminator(
             a, b, train=t)), [jnp.zeros((1, 256, 256, 3))] * 2)]
    for model, fn, args in cases:
        params, state = jax.eval_shape(
            lambda *a: fn.init(jax.random.PRNGKey(0), *a, True), *args)
        got_p, got_s = weights.to_jax(model)
        shapes = {(s, k): v.shape for s, d in params.items()
                  for k, v in d.items()}
        assert {(s, k): v.shape for s, d in got_p.items()
                for k, v in d.items()} == shapes
        assert {(s, k): v.shape for s, d in got_s.items()
                for k, v in d.items()} == {
            (s, k): v.shape for s, d in state.items() for k, v in d.items()}


@pytest.mark.parametrize("name,norm", MODEL_CASES[:3] + MODEL_CASES[4:5],
                         ids=["dcgan_g", "dcgan_d", "unet", "patchgan"])
def test_weights_round_trip_exactly(name, norm):
    """from_jax then to_jax gives the trees back bit for bit; the
    transposed conv's HWIO view reads the [Cin, Cout, kh, kw] storage."""
    model = _port_model(name, norm)
    params, state = weights.random_jax_params(model, 5)
    weights.from_jax(model, params, state)
    got_p, got_s = weights.to_jax(model)
    for want, got in ((params, got_p), (state, got_s)):
        assert set(want) == set(got)
        for scope in want:
            assert set(want[scope]) == set(got[scope]), scope
            for k in want[scope]:
                assert np.array_equal(want[scope][k], got[scope][k])
    for m in model.modules():
        if isinstance(m, models.gan.ConvTranspose):
            cin, cout, kh, kw = m.weight.shape
            assert m.w.shape == (kh, kw, cin, cout)
            assert m.weight.is_contiguous(memory_format=torch.channels_last)


def test_gan_models_refuse_spectral_norm():
    with pytest.raises(ValueError, match="spectral_norm"):
        models.DCGANDiscriminator(image_size=32, spectral_norm=True)
    with pytest.raises(ValueError, match="spectral_norm"):
        models.PatchGANDiscriminator(spectral_norm=True)


# --------------------------------------------------------------- losses

@pytest.mark.parametrize("kind", ["nonsaturating", "lsgan", "hinge"])
def test_gan_losses_match_jax(kind):
    """D and G losses of each objective (and L1 beside them) on float32
    and bf16 logits: 1e-6 relative."""
    real, fake = _rand(1, 8, 5, 5, 1, scale=2), _rand(2, 8, 5, 5, 1,
                                                       scale=2)
    jd, jg = jlosses.get_gan_losses(kind)
    td, tg = losses.get_gan_losses(kind)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        r, f = torch.from_numpy(real).to(dtype), torch.from_numpy(fake).to(
            dtype)
        jr, jf = jnp.asarray(real, jdt), jnp.asarray(fake, jdt)
        np.testing.assert_allclose(float(td(r, f)), float(jd(jr, jf)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tg(f)), float(jg(jf)), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.l1_loss(torch.from_numpy(real),
                             torch.from_numpy(fake).bfloat16())),
        float(jlosses.l1_loss(jnp.asarray(real),
                              jnp.asarray(fake, jnp.bfloat16))), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown GAN loss"):
        losses.get_gan_losses("wasserstein")


# ----------------------------------------------------- data and metrics

@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_pairs_are_bit_equal(split):
    want = jpairs.make_source(None, split, synthetic=True, raw_hw=(32, 32))
    got = pairs.make_source(None, split, synthetic=True, raw_hw=(32, 32))
    idx = np.array([3, 0, 63])
    for a, b in zip(got.get_batch(idx), want.get_batch(idx)):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert np.array_equal(got.a, want.a) and np.array_equal(got.b, want.b)
    with pytest.raises(FileNotFoundError, match="no pix2pix layout"):
        pairs.make_source("/nonexistent", split)


def test_psnr_ssim_and_the_evaluator_match_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(3, 20, 18, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    for jfn, tfn in ((jmetrics.psnr, image_metrics.psnr),
                     (jmetrics.ssim, image_metrics.ssim)):
        want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
        got = tfn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for metric in ("psnr", "ssim"):
        jev = jmetrics.PairedImageEvaluator(metric)
        tev = image_metrics.PairedImageEvaluator(metric)
        for sl in (slice(0, 2), slice(2, 3)):
            jev.update(a[sl], b[sl])
            tev.update(torch.from_numpy(a[sl]), torch.from_numpy(b[sl]))
        np.testing.assert_allclose(tev.score(), jev.score(), rtol=1e-5)
        assert tev.is_better(1.0, 0.5) and tev.worst_score() == -np.inf
    with pytest.raises(ValueError, match="unknown image metric"):
        image_metrics.PairedImageEvaluator("lpips")


def test_b2_rescale_against_the_jax_expression():
    """normalize_u8 at mean = std = 0.5 computes x * fl(1/127.5) - 1; JAX
    computes x / 127.5 - 1.  Over every uint8 value they are at most 2^-23
    apart (one float32 ulp at magnitude 1), and equal at 0, 255 and most
    values between."""
    x = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1)
    x = x.expand(1, 16, 16, 3).contiguous()
    half = torch.full((3,), 0.5)
    got = normalize_u8.normalize_u8(x, half, half, torch.float32).numpy()
    want = x.numpy().astype(np.float32) / np.float32(127.5) - np.float32(1)
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 ** -23, diff.max()
    assert got.flat[0] == -1.0 and got.reshape(-1, 3)[255, 0] == 1.0
    assert (diff == 0).mean() > 0.5


# ------------------------------------------------------------ B1 routing

def _spy_b1(monkeypatch):
    calls = []
    plain = blocks.fused_scale_shift_act

    def spy(x, a, b, act="relu"):
        calls.append((act, tuple(x.shape)))
        return plain(x, a, b, act)

    monkeypatch.setattr(blocks, "fused_scale_shift_act", spy)
    return calls


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_dcgan_eval_routing(precision, monkeypatch):
    """DCGAN's eval forward at 32x32: B1 (ReLU) at bn_project and the two
    deconv BNs, at [n, 4, 4, 4c], [n, 8, 8, 2c], [n, 16, 16, c]; the
    output equals the unrouted forward bit for bit; train mode launches
    none."""
    model = models.DCGANGenerator(100, image_size=32, base_features=32)
    weights.from_jax(model, *weights.random_jax_params(model, 2)).eval()
    calls = _spy_b1(monkeypatch)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    z = torch.from_numpy(_rand(0, 3, 100)).to(dtype)
    with torch.no_grad():
        routed = model(z)
        assert calls == [("relu", (3, 4, 4, 32)), ("relu", (3, 8, 8, 16)),
                         ("relu", (3, 16, 16, 8))]
        plain = model(z, kernels=False)
    assert len(calls) == 3 and torch.equal(routed, plain)
    model.train()(z)
    assert len(calls) == 3


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_unet_eval_routing(precision, monkeypatch):
    """The U-Net at 256x256 with 8 levels (base 8): B1 at the 6 encoder BN
    sites (leaky ReLU) and the 7 decoder BN sites (ReLU), at the shapes of
    the recipe's sites with 1/8 of the channels; the output equals the
    unrouted forward (float32 bit for bit, bf16 within a bf16 ulp of max:
    the leaky slope's product is rounded once, after BN, where the plain
    path rounds BN's output first); instance norm and train mode launch
    none."""
    model = models.UNetGenerator(image_size=256, base_features=8)
    weights.from_jax(model, *weights.random_jax_params(model, 4)).eval()
    calls = _spy_b1(monkeypatch)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    x = torch.from_numpy(np.tanh(_rand(1, 1, 256, 256, 3))).to(dtype)
    with torch.no_grad():
        routed = model(x)
        enc = [("leaky_relu", (1, 256 >> i, 256 >> i, min(8 << (i - 1), 512)))
               for i in range(2, 8)]
        dec = [("relu", (1, 256 >> i, 256 >> i, min(8 << (i - 1), 512)))
               for i in range(7, 0, -1)]
        assert calls == enc + dec
        plain = model(x, kernels=False)
    assert len(calls) == 13
    if precision == "f32":
        assert torch.equal(routed, plain)
    else:
        _close(routed.float().numpy(), plain.float().numpy(), 2 ** -8)
    model.train()(x, generator=torch.Generator())
    inorm = models.UNetGenerator(image_size=32, base_features=8,
                                 n_levels=5, norm="instance").eval()
    with torch.no_grad():
        inorm(torch.zeros(1, 32, 32, 3))
    assert len(calls) == 13
