"""The port's ViT and its layers against the JAX package, on the CPU.

Two small variants: the package's ``tinyvit`` ("test": 2 blocks, dim 32,
2 heads, patch 4 at 8x8, L = 5) and a 2-block, dim-64, 4-head, patch-4
variant at 16x16 (L = 17), added to both ``VARIANTS`` tables for the test.
Weights are made with numpy from a seed in the JAX layout and loaded into
the port through ``weights.from_jax``.  Drop-path masks are the ones JAX
draws, recorded and handed to the port.  Tolerances: float32 logits
within 1e-4 of max |logit|, bf16 within 0.05 (the ResNet tests' bound:
bf16 rounds at other points in the two frameworks), float32 gradients
within 1e-4.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import nn as jnn
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import BF16 as JBF16
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu_torch import models, nn, weights
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.train import losses

# both packages export the function under the module's name
jvit = importlib.import_module("myconvnet_tpu.models.vit")
tvit = importlib.import_module("myconvnet_tpu_torch.models.vit")
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


CLASSES = 10
DIM64 = (4, 64, 2, 4, 128)   # patch, dim, depth, heads, mlp_dim
MODELS = {"tinyvit": ("test", 8), "dim64": ("dim64", 16)}


@pytest.fixture
def variants(monkeypatch):
    monkeypatch.setitem(jvit.VARIANTS, "dim64", DIM64)
    monkeypatch.setitem(tvit.VARIANTS, "dim64", DIM64)


def _jax_fn(variant, **kw):
    return transform(lambda x, train: jvit.vit(x, CLASSES, train=train,
                                               variant=variant, **kw))


def _port(variant, hw, **kw):
    return tvit.ViT(CLASSES, variant=variant, input_hw=(hw, hw), **kw)


def _params(variant, hw, seed=0):
    """Random JAX-layout weights, with non-zero dense biases."""
    params, _ = weights.random_jax_params(_port(variant, hw), seed)
    rng = np.random.RandomState(seed + 100)
    for p in params.values():
        if "b" in p:
            p["b"] = (0.05 * rng.randn(*p["b"].shape)).astype(np.float32)
    return params


def _grad_tree(model):
    out = {}
    for path, p, view in weights.param_views(model):
        scope, name = path.rsplit("/", 1)
        out.setdefault(scope, {})[name] = view(p.grad).numpy()
    return out


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_matches_jax(dtype):
    """eps 1e-6 (torch's default 1e-5 would scale these rows, of variance
    ~1e-6, 2.3x smaller), float32 statistics, output in x's dtype."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 16) * 1e-3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    beta = (0.1 * rng.randn(16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with policy_scope(JBF16 if dtype == torch.bfloat16 else JFULL):
        want = transform(lambda v: jnn.layer_norm(v, name="ln")).apply(
            {"ln": {"gamma": gamma, "beta": beta}}, {}, None,
            jnp.asarray(x, jdt))[0]
    ln = nn.LayerNorm(16)
    with torch.no_grad():
        ln.gamma.copy_(torch.from_numpy(gamma))
        ln.beta.copy_(torch.from_numpy(beta))
    out = ln(torch.from_numpy(x).to(dtype))
    assert out.dtype == dtype and ln.gamma.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_gelu_is_exact():
    x = np.linspace(-5, 5, 101).astype(np.float32)
    np.testing.assert_allclose(
        nn.gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
        rtol=1e-6, atol=1e-6)


def test_dropout_and_drop_path_masks():
    x = torch.arange(1.0, 13.0).reshape(3, 4)
    keep = torch.tensor([True, False, True])
    out = nn.drop_path(x, 0.25, train=True, mask=keep)
    torch.testing.assert_close(out[1], torch.zeros(4))
    torch.testing.assert_close(out[0], x[0] / 0.75)
    assert nn.drop_path(x, 0.25, train=False) is x
    emask = torch.rand(3, 4, generator=torch.Generator().manual_seed(0)) > .5
    torch.testing.assert_close(
        nn.dropout(x, 0.5, train=True, mask=emask),
        torch.where(emask, x / 0.5, torch.zeros_like(x)))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    torch.testing.assert_close(nn.dropout(x, 0.5, train=True, generator=g1),
                               nn.dropout(x, 0.5, train=True, generator=g2))
    with pytest.raises(ValueError, match="mask or a generator"):
        nn.drop_path(x, 0.25, train=True)


# ------------------------------------------------------------------ model


def test_scopes_and_weights_round_trip():
    """The port's tree has the JAX init tree's scopes and shapes (the
    embedding tokens in the root scope "~"), and from_jax -> to_jax gives
    the JAX arrays back bit for bit."""
    jparams, jstate = _jax_fn("test").init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 8, 8, 3)), False)
    model = _port("test", 8)
    p2, s2 = weights.to_jax(model)
    assert s2 == {} and jstate == {}
    assert set(p2) == set(jparams)
    for scope in jparams:
        assert {n: v.shape for n, v in p2[scope].items()} == \
            {n: v.shape for n, v in jparams[scope].items()}, scope
    assert set(p2["~"]) == {"cls_token", "pos_embed"}
    weights.from_jax(model, jparams, {})
    p3, _ = weights.to_jax(model)
    for scope in jparams:
        for name, v in jparams[scope].items():
            np.testing.assert_array_equal(p3[scope][name], np.asarray(v))
    paths = [path for path, _, _ in weights.param_views(model)]
    assert paths[:2] == ["~/cls_token", "~/pos_embed"]
    assert "block2/mlp/fc2/w" in paths and "head/logits/b" in paths


def test_registry_and_init():
    model = models.get_model("vit_b16", 1000, input_hw=(224, 224),
                             drop_path_rate=0.1)
    assert isinstance(model, tvit.ViT) and model.pos_embed.shape == \
        (1, 197, 768)
    rates = [b.drop_path_rate for b in model.blocks()]
    assert rates[0] == 0.0 and abs(rates[-1] - 0.1) < 1e-12
    small = init_model(_port("test", 8), torch.Generator().manual_seed(0))
    assert (small.cls_token == 0).all()
    assert 0.01 < float(small.pos_embed.detach().std()) < 0.03
    assert (small.ln.gamma == 1).all() and (small.block1.ln1.beta == 0).all()
    with pytest.raises(ValueError, match="divisible"):
        _port("test", 10)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_match_jax(variants, name, precision):
    variant, hw = MODELS[name]
    params = _params(variant, hw)
    x = np.random.RandomState(1).randn(2, hw, hw, 3).astype(np.float32)
    pol, dtype = ((JFULL, torch.float32) if precision == "f32"
                  else (JBF16, torch.bfloat16))
    with policy_scope(pol):
        want, _ = _jax_fn(variant).apply(
            params, {}, None, jnp.asarray(x, pol.compute_dtype), False)
    want = np.asarray(want, np.float32)
    model = weights.from_jax(_port(variant, hw), params, {}).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(dtype)).float().numpy()
    scale = np.abs(want).max()
    if precision == "f32":
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert np.isfinite(out).all()
        assert np.abs(out - want).max() / scale < 0.05


def test_train_loss_and_gradients_match_jax_f32(monkeypatch):
    """Train mode with drop-path at 0.5 (block 2 of tinyvit): JAX's own
    Bernoulli draws are recorded and handed to the port as its masks; the
    loss, the logits and every gradient within 1e-4."""
    params = _params("test", 8, seed=2)
    rng = np.random.RandomState(3)
    x = rng.randn(8, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, 8).astype(np.int32)
    drawn = []
    bernoulli = jax.random.bernoulli

    def spy(key, p=0.5, shape=None):
        mask = bernoulli(key, p, shape)
        drawn.append(np.asarray(mask))
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", spy)
    fn = _jax_fn("test", drop_path_rate=0.5)

    def loss_fn(p):
        with policy_scope(JFULL):
            logits, _ = fn.apply(p, {}, jax.random.PRNGKey(4),
                                 jnp.asarray(x), True)
        return jlosses.softmax_cross_entropy(logits, jnp.asarray(y)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    model = weights.from_jax(_port("test", 8, drop_path_rate=0.5), params,
                             {}).train()
    sites = list(model.sample_masks(8, torch.Generator().manual_seed(0)))
    assert sites == ["block2/path_attn", "block2/path_mlp"]
    assert len(drawn) == 2 and not all(m.all() for m in drawn)
    masks = {s: torch.from_numpy(m.reshape(-1).copy())
             for s, m in zip(sites, drawn)}
    logits = model(torch.from_numpy(x), masks)
    loss = losses.softmax_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4,
                               atol=1e-4 * np.abs(jlogits).max())
    got = _grad_tree(model)
    assert set(got) == set(jgrads)
    for scope, d in jgrads.items():
        for name, want in d.items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                got[scope][name], want, rtol=1e-4,
                atol=1e-4 * max(np.abs(want).max(), 1e-30),
                err_msg=f"{scope}/{name}")
    with pytest.raises(ValueError, match="mask or a generator"):
        model(torch.from_numpy(x))
