"""The port's SmallNet, VGG and DenseNet against the JAX models, on the CPU.

SmallNet at width 8, VGG-16 (and VGG-11 without BN and with the classic
flatten head), DenseNet-121 at growth_rate 4; 32x32 inputs, batch 2, 10
classes.  Weights are made with numpy from a seed in the JAX layout
(``weights.random_jax_params``, with non-zero dense biases) and loaded
into the port through ``weights.from_jax``; the dropout masks of a
train-mode forward are the ones JAX draws, recorded and handed to the
port by site.  On the CPU every kernel wrapper runs its plain version.

Tolerances: float32 logits within 1e-5 of max |logit| (rtol 1e-5); bf16
logits within 0.05 of max |JAX logit| (the other families' bound: the
frameworks round at other points, and conv3x3_bn_relu keeps the conv's
sum in float32 through the BN epilogue); float32 loss, gradients, BN
moving statistics and the parameters after one momentum step within 1e-4
relative (plus 1e-4 of each tree leaf's largest value), as the ResNet-18
step test; VGG-16's and DenseNet-121's gradients within 1e-3 of the
tree's largest and 5e-3 of each leaf's (see ``CHAOTIC``).  JAX runs under ``jax.jit`` (its
op-by-op dispatch takes minutes for DenseNet-121 on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import BF16 as JBF16
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu_torch import models, nn, recipes, weights
from myconvnet_tpu_torch.models import blocks
from myconvnet_tpu_torch.train import losses

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


HW, BATCH, CLASSES = 32, 2, 10
# name: (JAX function, port name, kwargs of both)
MODELS = {
    "smallnet": (jmodels.smallnet, "smallnet", dict(width=8)),
    "vgg16": (jmodels.vgg16, "vgg16", {}),
    "vgg11_nobn_classic": (jmodels.vgg11, "vgg11",
                           dict(use_bn=False, classic_head=True)),
    "densenet121": (jmodels.densenet121, "densenet121",
                    dict(growth_rate=4)),
}
# the recipe optimizer's kind (momentum, coupled decay off norms and
# biases) at a constant rate, for one step
OPT = dict(name="momentum", momentum_coef=0.9, nesterov=True,
           weight_decay=5e-4, wd_exclude_norms=True,
           lr=dict(kind="constant", lr=0.1))


def _jax_fn(name):
    fn, _, kw = MODELS[name]
    return transform(lambda x, train: fn(x, CLASSES, train=train, **kw))


def _port(name):
    _, port_name, kw = MODELS[name]
    return models.get_model(port_name, CLASSES, input_hw=(HW, HW), **kw)


@pytest.fixture(scope="module")
def trees():
    """{name: (params, state)} of random JAX-layout weights."""
    out = {}
    for i, name in enumerate(MODELS):
        params, state = weights.random_jax_params(_port(name), i)
        rng = np.random.RandomState(100 + i)
        for scope, p in params.items():
            if "b" in p:
                p["b"] = (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)
        out[name] = params, state
    return out


def _x(seed=1, n=BATCH):
    return np.random.RandomState(seed).randn(n, HW, HW, 3).astype(
        np.float32)


def _grad_tree(model):
    out = {}
    for path, p, view in weights.param_views(model):
        scope, name = path.rsplit("/", 1)
        out.setdefault(scope, {})[name] = view(p.grad).numpy()
    return out


def _assert_trees_close(got, want, rtol, what, tree_scale=False):
    """Each leaf within rtol of its reference, plus rtol of the leaf's
    largest value (``tree_scale``: of the largest value in the tree)."""
    assert set(got) == set(want), what
    biggest = max((np.abs(np.asarray(v)).max() for d in want.values()
                   for v in d.values()), default=0.0)
    for scope in want:
        assert set(got[scope]) == set(want[scope]), (what, scope)
        for name, ref in want[scope].items():
            ref = np.asarray(ref)
            scale = biggest if tree_scale else np.abs(ref).max()
            np.testing.assert_allclose(
                got[scope][name], ref, rtol=rtol,
                atol=rtol * max(scale, 1e-30),
                err_msg=f"{what} {scope}/{name}")


@pytest.mark.parametrize("name", list(MODELS))
def test_scopes_match_the_jax_init_tree(name):
    """The port's modules carry the JAX init tree's scopes and shapes
    (SmallNet's and VGG's auto-numbered ``conv_N``/``bn_N`` at the root,
    DenseNet's ``bn``/``bn_1`` inside every layer scope), and
    from_jax -> to_jax gives a tree of those shapes back bit for bit."""
    jparams, jstate = jax.eval_shape(lambda: _jax_fn(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), False))
    model = _port(name)
    p2, s2 = weights.to_jax(model)
    assert set(p2) == set(jparams) and set(s2) == set(jstate)
    for tree, mine in ((jparams, p2), (jstate, s2)):
        for scope in tree:
            assert {n: v.shape for n, v in mine[scope].items()} == \
                {n: tuple(v.shape) for n, v in tree[scope].items()}, scope
    params, state = weights.random_jax_params(model, 7)
    weights.from_jax(model, params, state)
    p3, s3 = weights.to_jax(model)
    for tree, back in ((params, p3), (state, s3)):
        for scope in tree:
            for n, v in tree[scope].items():
                np.testing.assert_array_equal(back[scope][n], v)


def test_bn_defaults_follow_the_jax_models():
    """SmallNet's and VGG's BNs take the JAX layer defaults (momentum
    0.99, eps 1e-3); DenseNet's pass 0.9 and 1e-5."""
    for name, (m, eps) in (("smallnet", (0.99, 1e-3)),
                           ("vgg16", (0.99, 1e-3)),
                           ("densenet121", (0.9, 1e-5))):
        bns = [b for b in _port(name).modules()
               if isinstance(b, nn.BatchNorm)]
        assert bns and all((b.momentum, b.eps) == (m, eps) for b in bns)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_eval_logits_match_jax(trees, name, precision):
    params, state = trees[name]
    x = _x()
    pol, dtype = ((JFULL, torch.float32) if precision == "f32"
                  else (JBF16, torch.bfloat16))
    fn = _jax_fn(name)

    def apply(p, s, v):
        with policy_scope(pol):
            return fn.apply(p, s, None, v, False)[0]

    want = np.asarray(jax.jit(apply)(params, state, jnp.asarray(
        x, pol.compute_dtype)), np.float32)
    model = weights.from_jax(_port(name), params, state).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(dtype))
    assert out.dtype == dtype
    out = out.float().numpy()
    scale = np.abs(want).max()
    if precision == "f32":
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        assert np.isfinite(out).all()
        assert np.abs(out - want).max() / scale < 0.05


def _port_step(name, params, state, x, y, masks):
    """The port's train-mode forward and backward: (model, logits,
    loss)."""
    model = weights.from_jax(_port(name), params, state).train()
    xt = torch.from_numpy(x)
    logits = model(xt, masks) if masks else model(xt)
    loss = losses.softmax_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return model, logits, loss


def _tree_gap(got, want):
    """max |got - want| over a gradient tree, over its largest |want|."""
    biggest = max(np.abs(np.asarray(v)).max() for d in want.values()
                  for v in d.values())
    return max(np.abs(got[s][n] - np.asarray(v)).max()
               for s, d in want.items() for n, v in d.items()) / biggest


# gradient tolerance: per leaf (rtol 1e-4 plus 1e-4 of the leaf's largest
# value) where the model is well conditioned at this size; for VGG-16 and
# DenseNet-121 1e-3 of the tree's largest gradient and, per leaf,
# CHAOTIC_LEAF_RTOL (plus as much of the leaf's largest value), so that no
# small leaf passes whatever its value.  Their float32 gradients at 32x32
# and batch 4 are ill conditioned: the test shows it by moving the port's
# own gradients by more than 1e-4 of the tree's scale with a 1e-6 relative
# change of the input (8 float32 ulps).  Both frameworks compute the BN
# statistics as E[x^2] - E[x]^2 and the BN backward as sums that cancel
# (each channel's input gradient sums to zero), in float32 and in
# another order.  On the CPU the per-leaf bound also holds at half its
# value.
CHAOTIC = ("vgg16", "densenet121")
CHAOTIC_LEAF_RTOL = 5e-3


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax_f32(trees, name, monkeypatch):
    """Train mode at float32: JAX's dropout draws recorded and handed to
    the port by site; the logits and the loss within 1e-4, every
    gradient (tolerance above), the BN moving statistics after the
    forward and the parameters after one momentum step (nesterov, decay
    off norms and biases) within 1e-4."""
    params, state = trees[name]
    rng = np.random.RandomState(3)
    x = _x(5, 4)
    y = rng.randint(0, CLASSES, 4).astype(np.int32)
    drawn = []
    bernoulli = jax.random.bernoulli

    def spy(key, p=0.5, shape=None):
        mask = bernoulli(key, p, shape)
        drawn.append(mask)
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", spy)
    fn = _jax_fn(name)

    def loss_fn(p):
        drawn.clear()
        with policy_scope(JFULL):
            logits, new_state = fn.apply(p, state, jax.random.PRNGKey(4),
                                         jnp.asarray(x), True)
        return jlosses.softmax_cross_entropy(logits, jnp.asarray(y)), \
            (logits, new_state, list(drawn))

    (jloss, (jlogits, jstate, jmasks)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = _port(name)
    sites = (model.sample_masks(4, torch.Generator().manual_seed(0))
             if hasattr(model, "sample_masks") else {})
    assert len(sites) == len(jmasks)
    masks = {}
    for (site, mine), theirs in zip(sites.items(), jmasks):
        assert tuple(mine.shape) == theirs.shape, site
        masks[site] = torch.from_numpy(np.array(theirs))
    if masks:
        assert not all(m.all() for m in masks.values())
    model, logits, loss = _port_step(name, params, state, x, y, masks)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4,
                               atol=1e-4 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    grads = _grad_tree(model)
    if name in CHAOTIC:
        nudged = _grad_tree(_port_step(name, params, state,
                                       x * np.float32(1 + 1e-6), y,
                                       masks)[0])
        assert _tree_gap(nudged, grads) > 1e-4
        assert set(grads) == set(jgrads)
        assert _tree_gap(grads, jgrads) < 1e-3
        _assert_trees_close(grads, jgrads, CHAOTIC_LEAF_RTOL, "grad")
    else:
        _assert_trees_close(grads, jgrads, 1e-4, "grad")
    _assert_trees_close(weights.to_jax(model)[1], jstate, 1e-4, "bn state")

    jopt = jrecipes.make_optimizer(OPT)
    jparams, _ = jopt.update(jgrads, jopt.init(params), params, 0)
    opt = recipes.make_optimizer(model, OPT)
    opt.step(0)
    after = weights.to_jax(model)[0]
    if name in CHAOTIC:   # the step's update, as its gradients
        def update(tree):
            return {s: {n: np.asarray(v) - params[s][n]
                        for n, v in d.items()} for s, d in tree.items()}
        assert _tree_gap(update(after), update(jparams)) < 1e-3
        _assert_trees_close(update(after), update(jparams),
                            CHAOTIC_LEAF_RTOL, "the step's update")
    else:
        _assert_trees_close(after, jparams, 1e-4, "params after a step")


# (name, dtype) -> launches of B4 (conv3x3_bn_relu) and B1
# (fused_scale_shift_act) and the convs cuDNN runs, in one eval forward
ROUTES = {("smallnet", "f32"): (0, 6, 6), ("smallnet", "bf16"): (5, 1, 1),
          ("vgg16", "f32"): (0, 13, 13), ("vgg16", "bf16"): (12, 1, 1),
          ("vgg11_nobn_classic", "bf16"): (7, 1, 1),
          ("densenet121", "f32"): (0, 121, 120),
          ("densenet121", "bf16"): (0, 121, 120)}


@pytest.mark.parametrize("name,precision", list(ROUTES),
                         ids=[f"{n}-{p}" for n, p in ROUTES])
def test_eval_routing(trees, name, precision, monkeypatch):
    """Which sites an eval forward sends to B4, to B1 and to cuDNN, counted
    on the plain path by spies on the wrappers and hooks on the convs:
    under bf16 every 3x3 stride-1 conv with C % 8 == 0 goes to B4, the
    rest of the conv -> BN -> ReLU sites to cuDNN + B1; DenseNet's 121
    BN -> ReLU sites all go to B1."""
    calls = {"b4": 0, "b1": 0, "cudnn": 0}

    def counted(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(blocks, "conv3x3_bn_relu",
                        counted("b4", blocks.conv3x3_bn_relu))
    monkeypatch.setattr(blocks, "fused_scale_shift_act",
                        counted("b1", blocks.fused_scale_shift_act))
    model = weights.from_jax(_port(name), *trees[name]).eval()
    for m in model.modules():
        if isinstance(m, nn.Conv):
            m.register_forward_hook(
                lambda *_: calls.__setitem__("cudnn", calls["cudnn"] + 1))
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    with torch.no_grad():
        model(torch.from_numpy(_x()).to(dtype))
    assert (calls["b4"], calls["b1"], calls["cudnn"]) == ROUTES[name,
                                                                precision]
    calls.update(b4=0, b1=0, cudnn=0)
    model.train()(torch.from_numpy(_x()).to(dtype),
                  **({"generator": torch.Generator()}
                     if hasattr(model, "sample_masks") else {}))
    assert calls["b4"] == calls["b1"] == 0   # train mode is plain PyTorch


def test_registry_and_masks():
    """The JAX registry's names; VGG's depths and classic head; the
    dropout sites in forward order, drawn from a generator."""
    for name in ("smallnet", "vgg11", "vgg16", "vgg19", "densenet121",
                 "densenet169", "densenet201"):
        assert name in models.MODELS
    vgg19 = models.get_model("vgg19", 1000)
    assert vgg19.n_convs == 16 and vgg19.fused.count(True) == 15
    classic = models.get_model("vgg16", 1000, input_hw=(224, 224),
                               classic_head=True)
    assert classic.fc1.weight.shape == (4096, 7 * 7 * 512)
    d201 = models.get_model("densenet201", 1000)
    assert d201.logits.weight.shape == (1000, 1920)
    net = models.get_model("smallnet", 10, width=8, dropout_rate=0.3)
    m = net.sample_masks(64, torch.Generator().manual_seed(0))
    assert list(m) == ["gap", "fc1"] and m["fc1"].shape == (64, 64)
    assert 0.55 < float(m["fc1"].float().mean()) < 0.85
    assert models.get_model("smallnet", 10, dropout_rate=0.0).sample_masks(
        4, torch.Generator()) == {}
    with pytest.raises(ValueError, match="depth"):
        models.VGG(10, depth=13)
    with pytest.raises(ValueError, match="mask or a generator"):
        net.train()(torch.zeros(2, 32, 32, 3))
