"""The port's segmenters beside DeepLab (U-Net, PSPNet, FCN), DeepLab's
Xception-65 backbone and the Dice, CE + Dice and focal losses against the
JAX package, on the CPU.

Sizes: U-Net at base 8, depth 3 on 32x32 inputs; PSPNet and FCN on a
ResNet-18 backbone (PSPNet at output stride 8, FCN at 16) on 33x33;
DeepLabv3+ on Xception-65 (its widths are fixed) at output stride 16 on
33x33; 21 classes (``CLASSES``).  Weights are made with numpy from a
seed in the JAX layout (``weights.random_jax_params``, every bias
non-zero) and loaded through ``weights.from_jax``; a train-mode forward's
dropout mask is the one JAX draws, recorded by a spy on
``jax.random.bernoulli`` and handed to the port by site.  JAX runs under
``jax.jit``; on the CPU every kernel wrapper runs its plain version.

Tolerances: float32 eval logits within 1e-4 of max |JAX logit|, bf16
within 0.05 of it; the Xception backbone's maps (the last and the
stride-4 tap) at output stride 8, 16 and 32 within 1e-5 of their largest;
train mode at float32 (batch ``TRAIN_BATCH``, a fifth of the pixels at
the ignore label): logits 1e-4 of the largest, the loss 1e-4 relative,
the BN moving statistics and every gradient leaf 1e-4 relative plus 1e-4
of the leaf's largest, after the test has shown the case well
conditioned (an 8-ulp change of the input moves none of the port's own
gradient leaves by 1e-4; ``test_torch_zoo.check_train_step``'s rule); the
losses and their gradients with respect to the logits within 1e-5
relative of JAX's.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from myconvnet_tpu import models as jmodels
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import BF16 as JBF16
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import Policy, policy_scope
from myconvnet_tpu.models.xception import xception_backbone as jxception
from myconvnet_tpu.ops import pool as jpool
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu_torch import models, weights
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.models import blocks, resnet
from myconvnet_tpu_torch.models.xception import XceptionBackbone, block_plan
from myconvnet_tpu_torch.ops import pool as tpool
from myconvnet_tpu_torch.train import losses

from test_torch_zoo import (assert_trees_close, grad_tree, leaf_gap,
                            tree_gap)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


CLASSES = 21
# case: (registry name, kwargs of both packages, input size, weight seed)
SEG = {
    "unet": ("unet", dict(base_features=8, depth=3), 32, 0),
    "pspnet": ("pspnet", dict(backbone_depth=18), 33, 1),
    "fcn": ("fcn", dict(backbone_depth=18), 33, 2),
    "deeplab_xception": ("deeplab_v3_plus", dict(backbone="xception"), 33,
                         0),
}
TRAIN_BATCH = 4


def jax_fn(name, kw):
    fn = jmodels.SEGMENTERS[name]
    return transform(lambda x, train: fn(x, CLASSES, train=train, **kw))


def port_model(name, kw, hw):
    return models.get_model(name, CLASSES, input_hw=(hw, hw), **kw)


def make_trees(case):
    name, kw, hw, seed = SEG[case]
    params, state = weights.random_jax_params(port_model(name, kw, hw),
                                              seed)
    rng = np.random.RandomState(100 + seed)
    for p in params.values():
        if "b" in p:
            p["b"] = (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)
    return params, state


def x_batch(seed, hw, n=2):
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(
        np.float32)


@pytest.mark.parametrize("case", list(SEG))
def test_scopes_match_the_jax_init_tree(case):
    """The port's modules carry the JAX init tree's scopes and shapes, and
    from_jax -> to_jax gives a random tree back bit for bit."""
    name, kw, hw, _ = SEG[case]
    jparams, jstate = jax.eval_shape(lambda: jax_fn(name, kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)), False))
    model = port_model(name, kw, hw)
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


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(SEG))
def test_eval_logits_match_jax(case, precision):
    name, kw, hw, _ = SEG[case]
    params, state = make_trees(case)
    x = x_batch(5, hw)
    pol, dtype = ((JFULL, torch.float32) if precision == "f32"
                  else (JBF16, torch.bfloat16))
    fn = jax_fn(name, kw)

    def apply(p, s, v):
        with policy_scope(pol):
            return fn.apply(p, s, None, v, False)[0]

    want = np.asarray(jax.jit(apply)(params, state, jnp.asarray(
        x, pol.compute_dtype)), np.float32)
    model = weights.from_jax(port_model(name, kw, hw), params, state).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(dtype))
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert out.shape == (2, hw, hw, CLASSES)
    out = out.numpy()
    scale = np.abs(want).max()
    if precision == "f32":
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert np.abs(out - want).max() / scale < 0.05


def _pixel_labels(seed, n, hw):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, CLASSES, (n, hw, hw)).astype(np.int32)
    y[rng.rand(n, hw, hw) < 0.2] = 255
    return y


# a ReLU pre-activation this near 0, relative to its site's largest, lies
# within the two frameworks' float32 disagreement: its derivative may be
# taken either way
KINK = 1e-5


class _SignedRelu(torch.autograd.Function):
    """relu(z) whose derivative is taken where ``keep`` is true."""

    @staticmethod
    def forward(ctx, z, keep):
        ctx.save_for_backward(keep)
        return z.clamp_min(0.0)

    @staticmethod
    def backward(ctx, g):
        keep, = ctx.saved_tensors
        return g * keep, None


def traced_step(step, keeps, monkeypatch):
    """``step()`` with every ``torch.relu`` recorded: (its result, each
    call's pre-activation in call order); with ``keeps`` (a bool tensor a
    call) the derivative is taken where they are true."""
    zs = []

    def relu(z):
        keep = z > 0 if keeps is None else keeps[len(zs)]
        zs.append(z.detach())
        return _SignedRelu.apply(z, keep)

    with monkeypatch.context() as m:
        m.setattr(torch, "relu", relu)
        out = step()
    return out, zs


def spy_relus(monkeypatch):
    """A list that collects the pre-activations of ``jax.nn.relu`` calls
    (the JAX package's ``nn.relu``), cleared by the caller at the start
    of each trace."""
    seen = []
    relu = jax.nn.relu

    def spy(x):
        seen.append(x)
        return relu(x)

    monkeypatch.setattr(jax.nn, "relu", spy)
    return seen


def check_grads_with_kinks(step, jgrads, jzs, monkeypatch, bound=1e-4,
                           tree_bound=None, kink=KINK):
    """Every gradient leaf of ``step()`` (the port's train step, returning
    the model after its backward) within ``bound`` of JAX's, relative and
    of the leaf's largest, with each ReLU's derivative taken where JAX's
    pre-activation (``jzs``, call by call) is positive: every element
    whose sign differs between the frameworks must lie within ``kink`` of
    0 in both, relative to its site's largest.  ``tree_bound``: also the
    largest gap over the tree's largest gradient.  Returns the count of
    such elements."""
    model, zs = traced_step(step, None, monkeypatch)
    assert [tuple(z.shape) for z in zs] == [tuple(z.shape) for z in jzs]
    keeps, kinks = [], 0
    for z, jz in zip(zs, jzs):
        jz = torch.from_numpy(np.asarray(jz))
        differ = (z > 0) != (jz > 0)
        if differ.any():
            assert z[differ].abs().max() <= kink * z.abs().max()
            assert jz[differ].abs().max() <= kink * jz.abs().max()
            kinks += int(differ.sum())
        keeps.append(jz > 0)
    if kinks:
        model, _ = traced_step(step, keeps, monkeypatch)
    grads = grad_tree(model)
    if tree_bound is not None:
        assert tree_gap(grads, jgrads) < tree_bound
    assert_trees_close(grads, jgrads, bound, "grad", zero_leaves=True)
    return kinks


def spy_draws(monkeypatch):
    """A list that collects the keep masks ``jax.random.bernoulli`` draws
    (cleared by the caller at the start of each trace)."""
    drawn = []
    bernoulli = jax.random.bernoulli

    def spy(key, p=0.5, shape=None):
        mask = bernoulli(key, p, shape)
        drawn.append(mask)
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", spy)
    return drawn


def masks_by_site(model, n, jmasks):
    """JAX's masks handed to the port by site, in forward order (each
    the port's site's shape)."""
    sites = (model.sample_masks(n, torch.Generator())
             if hasattr(model, "sample_masks") else {})
    assert len(sites) == len(jmasks)
    masks = {}
    for (site, mine), theirs in zip(sites.items(), jmasks):
        assert mine.numel() == theirs.size, site
        masks[site] = torch.from_numpy(np.array(theirs)).reshape(mine.shape)
    if masks:
        assert not all(m.all() for m in masks.values())
    return masks if sites else None


def jax_float64(monkeypatch):
    """A context in which JAX computes in float64: x64 on, and the JAX
    package's ``jnp.float32`` (its layers cast to it by name) read as
    float64.  Yields the float64 policy."""
    @contextlib.contextmanager
    def scope():
        with jax.enable_x64(True), monkeypatch.context() as m:
            m.setattr(jnp, "float32", jnp.float64)
            yield Policy(jnp.float64, jnp.float64, jnp.float64,
                         lax.Precision.HIGHEST)
    return scope()


def check_train_step(jfn, new_model, x, y, jloss_fn, loss_fn, monkeypatch,
                     chaotic=None, exact=False):
    """Train mode at float32 with JAX's draws handed over by site: the
    logits and the loss, the BN moving statistics, the case shown well
    conditioned (8 ulps of input, each ReLU's derivative held, move no
    gradient leaf of the port's own by 1e-4), and every gradient leaf
    (:func:`check_grads_with_kinks`).
    ``chaotic``: the case is shown ill conditioned instead (those 8 ulps
    move a leaf by more than 1e-4), and its logits, gradient tree and
    gradient leaves are held at the bounds ``chaotic`` gives, (logits,
    tree, leaf) over their largest values, its BN moving statistics at
    the leaf bound.  ``exact``: JAX runs the step in float64
    (:func:`jax_float64`; its own draws) and the port's float32 step is
    held to it.  Returns the count of kinks."""
    params, state = new_model.trees
    drawn = spy_draws(monkeypatch)
    relus = spy_relus(monkeypatch)

    def jax_step(pol, dtype):
        def jax_loss(p):
            drawn.clear()
            relus.clear()
            with policy_scope(pol):
                logits, new_state = jfn.apply(
                    p, cast(state), jax.random.PRNGKey(8),
                    jnp.asarray(x, dtype), True)
            return jloss_fn(logits, jnp.asarray(y)), \
                (logits, new_state, list(drawn), list(relus))

        def cast(tree):
            return jax.tree_util.tree_map(lambda v: jnp.asarray(v, dtype),
                                          tree)

        return jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            cast(params))

    if exact:
        with jax_float64(monkeypatch) as pol:
            out = jax.tree_util.tree_map(np.asarray,
                                         jax_step(pol, jnp.float64))
    else:
        out = jax_step(JFULL, jnp.float32)
    (jloss, (jlogits, jstate, jmasks, jzs)), jgrads = out
    masks = masks_by_site(new_model(), x.shape[0], jmasks)

    def port_step(inputs=x):
        model = weights.from_jax(new_model(), params, state).train()
        xt = torch.from_numpy(inputs)
        logits = model(xt) if masks is None else model(xt, masks)
        loss = loss_fn(logits, torch.from_numpy(y))
        loss.backward()
        port_step.out = (logits, loss)
        return model

    model, zs = traced_step(port_step, None, monkeypatch)
    logits, loss = port_step.out
    logit_bound, tree_bound, leaf_bound = chaotic or (1e-4, None, 1e-4)
    bound = logit_bound
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=bound,
                               atol=bound * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    if jstate:
        assert_trees_close(weights.to_jax(model)[1], jstate, leaf_bound,
                           "bn state")
    # the nudge with the ReLU derivatives held: a pre-activation within
    # rounding of 0 is a kink, which check_grads_with_kinks takes up
    nudged = grad_tree(traced_step(
        lambda: port_step(x * np.float32(1 + 1e-6)), [z > 0 for z in zs],
        monkeypatch)[0])
    if chaotic:
        assert leaf_gap(nudged, grad_tree(model)) > 1e-4
        # the frameworks' pre-activations differ as their logits do
        return check_grads_with_kinks(port_step, jgrads, jzs, monkeypatch,
                                      leaf_bound, tree_bound, logit_bound)
    assert_trees_close(nudged, grad_tree(model), 1e-4, "nudged grad",
                       zero_leaves=True)
    return check_grads_with_kinks(port_step, jgrads, jzs, monkeypatch)


@pytest.mark.parametrize("case", list(SEG))
def test_train_step_matches_jax_f32(case, monkeypatch):
    """Train mode at float32 (per-pixel CE, a fifth of the pixels at the
    ignore label) with JAX's dropout draws: logits, loss, BN moving
    statistics and every gradient (:func:`check_train_step`)."""
    name, kw, hw, _ = SEG[case]
    trees = make_trees(case)

    def new_model():
        return port_model(name, kw, hw)

    new_model.trees = trees
    check_train_step(
        jax_fn(name, kw), new_model, x_batch(7, hw, TRAIN_BATCH),
        _pixel_labels(6, TRAIN_BATCH, hw), jlosses.pixel_cross_entropy,
        losses.pixel_cross_entropy, monkeypatch)


@pytest.mark.parametrize("os_", [8, 16, 32])
def test_xception_backbone_matches_jax(os_):
    """The Xception-65 backbone's last map and entry1's stride-4 tap at
    output stride 8, 16 and 32, eval mode, float32: 1e-5 of max |JAX|;
    the strides and rates of ``block_plan`` are JAX's conversion."""
    model = XceptionBackbone(output_stride=os_)
    params, state = weights.random_jax_params(model, os_)
    x = x_batch(1, 33)
    fn = transform(lambda v, train: jxception(
        v, train=train, output_stride=os_, return_low_level=True))

    def apply(p, s, v):
        with policy_scope(JFULL):
            return fn.apply(p, s, None, v, False)[0]

    want, want_low = jax.jit(apply)(params, state, jnp.asarray(x))
    model = weights.from_jax(model, params, state).eval()
    with torch.no_grad():
        got, low = model(torch.from_numpy(x), return_low_level=True)
    assert got.shape == want.shape == (2, -(-33 // os_), -(-33 // os_),
                                       2048)
    assert low.shape == want_low.shape == (2, 9, 9, 128)
    for a, b in ((got, want), (low, want_low)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    plan = block_plan(os_)
    assert (plan["middle"][1], plan["exit1"], plan["exit2"][1]) == {
        8: (2, (1, 2), 4), 16: (1, (1, 1), 2), 32: (1, (2, 1), 1)}[os_]


def count_routes(model, x, monkeypatch):
    """{"b1": n, "b4": n, "b5": n} of one eval forward by spies on the
    wrappers the models call."""
    calls = {"b1": 0, "b4": 0, "b5": 0}

    def count(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(blocks, "fused_scale_shift_act",
                        count("b1", blocks.fused_scale_shift_act))
    monkeypatch.setattr(blocks, "conv3x3_bn_relu",
                        count("b4", blocks.conv3x3_bn_relu))
    monkeypatch.setattr(resnet, "conv1x1_conv3x3_bn_relu",
                        count("b5", resnet.conv1x1_conv3x3_bn_relu))
    with torch.no_grad():
        model.eval()(x)
    return calls


# registry name and kwargs -> launches of B5, B4 and B1 in one bf16 eval
# forward at full width (ResNet-50 backbones)
ROUTES = {
    "unet": ({}, (0, 17, 1)),
    "pspnet": ({}, (6, 1, 25)),
    "fcn": ({}, (11, 1, 11)),
    "deeplab_v3_plus": (dict(backbone="xception"), (0, 3, 74)),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_eval_routing_at_full_width(name, monkeypatch):
    """Which sites a bf16 eval forward at full width (on a 32x32 image)
    sends to B5, B4 and B1: U-Net's 17 double convs past the C = 3 first
    to B4; PSPNet's and FCN's undilated stride-1 bottlenecks to B5 and
    their 3x3 heads to B4, the stem, the stride-2 and dilated convs and
    PSPNet's four projections to B1; DeepLab-Xception's stem conv2,
    refine1 and refine2 to B4, every depthwise's BN -> ReLU, exit2's three
    pointwise BN -> ReLUs and the ASPP and decoder sites to B1.  A train
    forward launches none."""
    kw, want = ROUTES[name]
    model = models.get_model(name, CLASSES, input_hw=(32, 32), **kw)
    init_model(model, torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16)
    x = torch.from_numpy(x_batch(2, 32, 1)).to(torch.bfloat16)
    calls = count_routes(model, x, monkeypatch)
    assert (calls["b5"], calls["b4"], calls["b1"]) == want
    calls.update(b1=0, b4=0, b5=0)
    model.train()(x, **({"generator": torch.Generator()}
                        if hasattr(model, "sample_masks") else {}))
    assert calls == {"b1": 0, "b4": 0, "b5": 0}


def test_masks_follow_the_input_size():
    """PSPNet's and FCN's dropout masks at their recipes' sizes (473 at
    output stride 8: 60 x 60; 513 at 16: 33 x 33), U-Net's none."""
    psp = models.get_model("pspnet", 21, input_hw=(473, 473))
    m = psp.sample_masks(2, torch.Generator().manual_seed(0))
    assert list(m) == ["dropout"] and m["dropout"].shape == (2, 60, 60, 512)
    assert 0.85 < float(m["dropout"].float().mean()) < 0.95
    fcn = models.get_model("fcn", 21, input_hw=(513, 513))
    assert fcn.sample_masks(1, torch.Generator())["dropout"].shape == (
        1, 33, 33, 512)
    assert not hasattr(models.get_model("unet", 21), "sample_masks")
    assert {"pspnet", "fcn", "deeplab_v3_plus"} <= models.SIZED
    with pytest.raises(ValueError, match="divisible by 16"):
        models.get_model("unet", 21)(torch.zeros(1, 40, 40, 3))


def test_adaptive_avg_pool_matches_jax():
    """The pyramid's pools at bins 1, 2, 3 and 6 over uneven sizes,
    float32 within 1e-6; bf16 in and out."""
    x = np.random.RandomState(0).randn(2, 13, 60, 5).astype(np.float32)
    for b in (1, 2, 3, 6, (3, 7)):
        want = np.asarray(jpool.adaptive_avg_pool2d(jnp.asarray(x), b))
        got = tpool.adaptive_avg_pool2d(torch.from_numpy(x), b).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    y = tpool.adaptive_avg_pool2d(torch.from_numpy(x).bfloat16(), 6)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 6, 6, 5)


LOSSES = {"dice": (losses.dice_loss, jlosses.dice_loss, {}),
          "ce_dice": (losses.ce_dice_loss, jlosses.ce_dice_loss,
                      dict(dice_weight=0.5, label_smoothing=0.1)),
          "focal": (losses.focal_loss, jlosses.focal_loss,
                    dict(gamma=1.5, ignore_label=255))}


@pytest.mark.parametrize("kind", list(LOSSES))
def test_segmentation_losses_match_jax(kind):
    """The loss and its gradient with respect to the logits, with a fifth
    of the pixels at the ignore label, within 1e-5 relative of JAX's."""
    mine, theirs, kw = LOSSES[kind]
    logits = np.random.RandomState(1).randn(2, 9, 11, CLASSES).astype(
        np.float32) * 3
    y = np.random.RandomState(2).randint(0, CLASSES, (2, 9, 11)).astype(
        np.int32)
    y[np.random.RandomState(3).rand(2, 9, 11) < 0.2] = 255
    want, jgrad = jax.value_and_grad(lambda v: theirs(
        v, jnp.asarray(y), **kw))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = mine(t, torch.from_numpy(y).long(), **kw)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(t.grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-5 * np.abs(jgrad).max())
