"""The port's grouped and depthwise classifiers, its new schedules and
RMSprop against the JAX package, on the CPU.

Each model runs at 32x32, 10 classes, at the narrowest width its JAX
function takes: SE-ResNet-50 at width 8, ResNeXt-50 and SE-ResNeXt-50 at
width 16 (32 groups need 32 inner channels), WRN-16-8 at width_mult 1
with dropout 0.3, RegNet X and Y 400MF, ShuffleNetV2 0.5 (this file),
MobileNetV2 and V3 at width_multiplier 0.25, EfficientNet-B0 and
EfficientNetV2-S (``test_torch_zoo_mobile.py``).  Weights are made with
numpy from a seed in the JAX layout (``weights.random_jax_params``, with
non-zero biases) and loaded into the port through ``weights.from_jax``;
the random draws of a train-mode forward (dropout, drop-path) are the
ones JAX draws, recorded by a spy and handed to the port by site.  On the
CPU every kernel wrapper runs its plain version.

Tolerances: float32 eval logits within 1e-4 of max |JAX logit|; float32
train-mode logits and loss, every leaf's gradient after one step and the
BN moving statistics within 1e-4 relative plus 1e-4 of the leaf's
largest value; the schedules within one float32 ulp of JAX's eager
values; RMSprop's parameters and state after each of three steps within
1e-6 of each leaf's largest.  JAX runs under ``jax.jit``.

The train step runs at batch 8 (ShuffleNetV2's at 16): at batch 4 the last stages' 1x1 and 2x2
maps give each train-mode BN four values a channel, and most of these
nets' float32 gradients move by more than 1e-4 under an 8-ulp change of
the input, in either framework.  Each case's weights come from a seed of
its own, and the test first shows that its gradients are well
conditioned there: the port's own gradients under that change move by
less than the 1e-4 the test then holds JAX's to (a ReLU input within
rounding of 0 takes its derivative either way; ResNeXt-50's seed 1 has
one, and moves by 8.5e-2).  MobileNetV2 at 0.25 and EfficientNetV2-S
are ill conditioned at every seed and batch tried (8 and 16; their own
gradients move by 1e-4 to 0.2 of a leaf, MobileNetV2's train-mode
logits by 1.07e-4 of their largest): the test shows that the gradients
move by more than 1e-4 and holds them as ``test_torch_classifiers``
holds VGG-16 and DenseNet-121, at 1e-3 of the tree's largest gradient
and 5e-3 of each leaf's, and their train-mode logits at 1e-3 of the
largest (``CHAOTIC_*``).  A leaf whose gradient is zero in exact
arithmetic (ShuffleNet's ``bn_dw/beta``: the shift a train-mode BN
removes two layers on) is rounding noise below 1e-6 of the tree's
largest gradient; it is held at 1e-4 of the tree's largest instead of
its own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.models import folding as jfolding
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu.train import optim as joptim
from myconvnet_tpu_torch import models, weights
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.models import blocks, folding, resnet
from myconvnet_tpu_torch.ops import conv as tconv
from myconvnet_tpu_torch.train import losses, optim

torch.set_num_threads(1)

HW, CLASSES = 32, 10
# test name: (registry name in both packages, kwargs of both, the seed
# of its weights, the train step's batch)
ZOO = {
    "se_resnet50": ("se_resnet50", dict(width=8), 0, 8),
    "resnext50_32x4d": ("resnext50_32x4d", dict(width=16), 5, 8),
    "se_resnext50_32x4d": ("se_resnext50_32x4d", dict(width=16), 2, 8),
    "wrn_16_8": ("wrn_16_8", dict(width_mult=1, dropout_rate=0.3), 3, 8),
    "regnet_x_400mf": ("regnet_x_400mf", {}, 3, 8),
    "regnet_y_400mf": ("regnet_y_400mf", {}, 6, 8),
    "shufflenet_v2": ("shufflenet_v2", dict(width_multiplier=0.5), 1, 16),
}
# the names of the JAX CLASSIFIERS table this port builds since its
# grouped and depthwise slice
NEW_NAMES = (
    "resnet101", "resnet152", "se_resnet50", "se_resnet101",
    "resnext50_32x4d", "resnext101_32x8d", "se_resnext50_32x4d",
    "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small",
    *(f"efficientnet_b{v}" for v in range(8)),
    "efficientnet_v2_s", "efficientnet_v2_m", "efficientnet_v2_l",
    "wrn_28_10", "wrn_16_8", "wide_resnet", "shufflenet_v2",
    "repvgg_a0", "repvgg_a1", "tinyrepvgg", "regnet_x_400mf",
    "regnet_y_400mf", "regnet_x_1_6gf", "regnet_y_1_6gf")


def jax_fn(name, kw, classes=CLASSES):
    fn = jmodels.CLASSIFIERS[name]
    return transform(lambda x, train: fn(x, classes, train=train, **kw))


def port_model(name, kw, classes=CLASSES):
    return models.get_model(name, classes, input_hw=(HW, HW), **kw)


def make_trees(name, kw, seed):
    """Random JAX-layout trees for the model, every bias non-zero."""
    params, state = weights.random_jax_params(port_model(name, kw), seed)
    rng = np.random.RandomState(100 + seed)
    for p in params.values():
        if "b" in p:
            p["b"] = (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)
    return params, state


def x_batch(seed=1, n=2):
    return np.random.RandomState(seed).randn(n, HW, HW, 3).astype(
        np.float32)


def grad_tree(model):
    out = {}
    for path, p, view in weights.param_views(model):
        scope, name = path.rsplit("/", 1)
        out.setdefault(scope, {})[name] = view(p.grad).numpy()
    return out


# a gradient leaf below this share of the tree's largest is zero in exact
# arithmetic (see the module's docstring)
ZERO_LEAF = 1e-6


def assert_trees_close(got, want, rtol, what, zero_leaves=False):
    """Each leaf within rtol of its reference plus rtol of the leaf's
    largest value (with ``zero_leaves``, of the tree's largest where the
    leaf's is below ``ZERO_LEAF`` of it)."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    biggest = max(np.abs(np.asarray(v)).max() for d in want.values()
                  for v in d.values())
    for scope in want:
        assert set(got[scope]) == set(want[scope]), (what, scope)
        for name, ref in want[scope].items():
            ref = np.asarray(ref)
            scale = np.abs(ref).max()
            if zero_leaves and scale < ZERO_LEAF * biggest:
                scale = biggest
            np.testing.assert_allclose(
                got[scope][name], ref, rtol=rtol,
                atol=rtol * max(scale, 1e-30),
                err_msg=f"{what} {scope}/{name}")


def check_scopes(name, kw):
    """The port's modules carry the JAX init tree's scopes and shapes,
    and from_jax -> to_jax gives a random tree back bit for bit."""
    jparams, jstate = jax.eval_shape(lambda: jax_fn(name, kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), False))
    model = port_model(name, kw)
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


def check_eval(name, kw, trees):
    """float32 eval logits within 1e-4 of max |JAX logit|."""
    params, state = trees
    x = x_batch()
    fn = jax_fn(name, kw)

    def apply(p, s, v):
        with policy_scope(JFULL):
            return fn.apply(p, s, None, v, False)[0]

    want = np.asarray(jax.jit(apply)(params, state, jnp.asarray(x)))
    model = weights.from_jax(port_model(name, kw), params, state).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(out).all()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4 * scale)


def leaf_gap(got, want):
    """The largest leaf gap |got - want| over the leaf's largest |want|
    (over the tree's largest for a zero leaf)."""
    biggest = max(np.abs(v).max() for d in want.values() for v in d.values())
    gaps = []
    for s, d in want.items():
        for n, v in d.items():
            v = np.asarray(v)
            scale = np.abs(v).max()
            if scale < ZERO_LEAF * biggest:
                scale = biggest
            gaps.append(np.abs(got[s][n] - v).max() / max(scale, 1e-30))
    return max(gaps)


def tree_gap(got, want):
    """max |got - want| over the tree, over its largest |want|."""
    biggest = max(np.abs(np.asarray(v)).max() for d in want.values()
                  for v in d.values())
    return max(np.abs(got[s][n] - np.asarray(v)).max()
               for s, d in want.items() for n, v in d.items()) / biggest


# the chaotic cases' bounds (test_torch_classifiers' CHAOTIC)
CHAOTIC_TREE, CHAOTIC_LEAF = 1e-3, 5e-3


def check_train_step(name, kw, trees, monkeypatch, batch=8,
                     chaotic=False):
    """Train mode at float32 with JAX's draws handed over by site: the
    logits, the loss, every gradient and the BN moving statistics.
    ``chaotic``: the case's gradients are ill conditioned (shown), and
    are held at the ``CHAOTIC_*`` bounds."""
    params, state = trees
    x = x_batch(5, batch)
    y = np.random.RandomState(3).randint(0, CLASSES, batch).astype(np.int32)
    drawn = []
    bernoulli = jax.random.bernoulli

    def spy(key, p=0.5, shape=None):
        mask = bernoulli(key, p, shape)
        drawn.append(mask)
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", spy)
    fn = jax_fn(name, kw)

    def loss_fn(p):
        drawn.clear()
        with policy_scope(JFULL):
            logits, new_state = fn.apply(p, state, jax.random.PRNGKey(4),
                                         jnp.asarray(x), True)
        return jlosses.softmax_cross_entropy(logits, jnp.asarray(y)), \
            (logits, new_state, list(drawn))

    (jloss, (jlogits, jstate, jmasks)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = port_model(name, kw)
    sites = (model.sample_masks(batch, torch.Generator().manual_seed(0))
             if hasattr(model, "sample_masks") else {})
    assert len(sites) == len(jmasks)
    masks = {}
    for (site, mine), theirs in zip(sites.items(), jmasks):
        assert mine.numel() == theirs.size, site
        masks[site] = torch.from_numpy(np.array(theirs)).reshape(mine.shape)
    if masks:
        assert not all(m.all() for m in masks.values())

    def port_step(inputs):
        model = weights.from_jax(port_model(name, kw), params, state).train()
        xt = torch.from_numpy(inputs)
        logits = model(xt, masks) if masks else model(xt)
        loss = losses.softmax_cross_entropy(logits, torch.from_numpy(y))
        loss.backward()
        return model, logits, loss

    model, logits, loss = port_step(x)
    grads = grad_tree(model)
    nudged = grad_tree(port_step(x * np.float32(1 + 1e-6))[0])
    bound = CHAOTIC_TREE if chaotic else 1e-4
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=bound,
                               atol=bound * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    if chaotic:
        assert leaf_gap(nudged, grads) > 1e-4
        assert tree_gap(grads, jgrads) < CHAOTIC_TREE
        assert_trees_close(grads, jgrads, CHAOTIC_LEAF, "grad",
                           zero_leaves=True)
    else:
        # well conditioned here: 8 ulps of input move no leaf by 1e-4
        assert_trees_close(nudged, grads, 1e-4, "nudged grad",
                           zero_leaves=True)
        assert_trees_close(grads, jgrads, 1e-4, "grad", zero_leaves=True)
    assert_trees_close(weights.to_jax(model)[1], jstate, 1e-4, "bn state")


def count_routes(model, x, monkeypatch):
    """{"b1": {act: launches}, "b4": n, "b5": n} of one eval forward, on
    the plain path, by spies on the wrappers the models call."""
    calls = {"b1": {}, "b4": 0, "b5": 0}

    def b1(fn):
        def spy(x, a, b, act="relu"):
            calls["b1"][act] = calls["b1"].get(act, 0) + 1
            return fn(x, a, b, act)
        return spy

    def count(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(blocks, "fused_scale_shift_act",
                        b1(blocks.fused_scale_shift_act))
    monkeypatch.setattr(blocks, "conv3x3_bn_relu",
                        count("b4", blocks.conv3x3_bn_relu))
    monkeypatch.setattr(resnet, "conv1x1_conv3x3_bn_relu",
                        count("b5", resnet.conv1x1_conv3x3_bn_relu))
    with torch.no_grad():
        model.eval()(x)
    return calls


@pytest.mark.parametrize("case", list(ZOO))
def test_scopes_match_the_jax_init_tree(case):
    check_scopes(*ZOO[case][:2])


@pytest.mark.parametrize("case", list(ZOO))
def test_eval_logits_match_jax(case):
    name, kw, seed, _ = ZOO[case]
    check_eval(name, kw, make_trees(name, kw, seed))


@pytest.mark.parametrize("case", list(ZOO))
def test_train_step_matches_jax_f32(case, monkeypatch):
    name, kw, seed, batch = ZOO[case]
    check_train_step(name, kw, make_trees(name, kw, seed), monkeypatch,
                     batch)


def check_builds(name):
    """``name`` builds in the port at full width, and ``from_jax`` loads
    JAX's init tree of it (zeros of its shapes) with no scope left over
    and none missing."""
    jparams, jstate = jax.eval_shape(lambda: jax_fn(name, {}, 1000).init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), False))
    model = models.get_model(name, 1000, input_hw=(224, 224))
    zeros = [{s: {n: np.zeros(v.shape, np.float32) for n, v in d.items()}
              for s, d in tree.items()} for tree in (jparams, jstate)]
    weights.from_jax(model, *zeros)
    want = sum(int(np.prod(v.shape)) for d in jparams.values()
               for v in d.values())
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("name", [n for n in NEW_NAMES if n.startswith(
    ("resnet", "se_res", "resnext", "wrn", "wide", "shuffle", "regnet"))])
def test_listed_name_builds_with_the_jax_tree(name):
    check_builds(name)


def test_deep_resnets_follow_stage_blocks():
    for depth, blocks_ in ((101, (3, 4, 23, 3)), (152, (3, 8, 36, 3))):
        model = models.get_model(f"resnet{depth}", 1000)
        assert resnet.STAGE_BLOCKS[depth] == blocks_
        assert [len(list(getattr(model, f"stage{s + 1}").children()))
                for s in range(4)] == list(blocks_)


@pytest.mark.parametrize("depth", [101, 152])
def test_deep_resnets_forward_matches_jax(depth):
    """ResNet-101 and -152 at width 8: one float32 eval forward."""
    name, kw = f"resnet{depth}", dict(width=8)
    check_eval(name, kw, make_trees(name, kw, depth))


def test_grouped_and_depthwise_conv_match_lax():
    """``conv2d(groups=)`` and ``depthwise_conv2d`` (multiplier 2, SAME at
    stride 2 on an even size: the asymmetric pad) against
    ``lax.conv_general_dilated`` at float32."""
    from myconvnet_tpu.ops import conv as jconv
    rng = np.random.RandomState(0)
    x = rng.randn(2, 10, 10, 8).astype(np.float32)
    w = rng.randn(3, 3, 2, 12).astype(np.float32)
    dw = rng.randn(5, 5, 8, 2).astype(np.float32)
    for stride in (1, 2):
        want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                            groups=4, precision="highest")
        got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           stride=stride, groups=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        want = jconv.depthwise_conv2d(jnp.asarray(x), jnp.asarray(dw),
                                      stride=stride, precision="highest")
        got = tconv.depthwise_conv2d(torch.from_numpy(x),
                                     torch.from_numpy(dw), stride=stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_from_jax_refuses_a_depthwise_or_grouped_shape_that_does_not_fit():
    model = port_model("shufflenet_v2", dict(width_multiplier=0.5))
    params, state = weights.random_jax_params(model, 0)
    scope = "stage2_2/main/dwconv"
    kh, kw, c, m = params[scope]["w"].shape
    params[scope]["w"] = np.zeros((kh, kw, 1, c * m), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        weights.from_jax(model, params, state)
    model = port_model("resnext50_32x4d", dict(width=16))
    params, state = weights.random_jax_params(model, 0)
    w = params["stage1/block1/conv_b"]["w"]
    assert w.shape == (3, 3, 1, 32)
    params["stage1/block1/conv_b"]["w"] = np.zeros((3, 3, 32, 32),
                                                   np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        weights.from_jax(model, params, state)


def test_grouped_refusals_follow_jax():
    for kw, match in ((dict(groups=32, width_per_group=4), "depth >= 50"),
                      (dict(se_ratio=16), "bottleneck")):
        with pytest.raises(ValueError, match=match):
            jmodels.resnet18(jnp.zeros((1, 32, 32, 3)), 10, **kw)
        with pytest.raises(ValueError, match=match):
            models.get_model("resnet18", 10, **kw)


# registry name -> (B1 launches by activation, B4, B5) of one bf16 eval
# forward at full width
ROUTES = {
    "mobilenet_v2": ({"relu6": 35}, 0, 0),
    "mobilenet_v3_large": ({"relu": 11}, 0, 0),
    "mobilenet_v3_small": ({"relu": 5}, 0, 0),
    "resnext50_32x4d": ({"relu": 33}, 0, 0),
    "resnet101": ({"relu": 7}, 0, 30),
    "resnet152": ({"relu": 7}, 0, 47),
    "se_resnet50": ({"relu": 7}, 0, 13),
    "wrn_28_10": ({"relu": 15}, 10, 0),
    "efficientnet_b0": ({}, 0, 0),
    "shufflenet_v2": ({"relu": 37}, 0, 0),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_eval_routing_at_full_width(name, monkeypatch):
    """Which sites a bf16 eval forward at full width (of a 16x16 image)
    sends to B1 (by activation), B4 and B5: ReLU6 at MobileNetV2's 35 BN
    sites, B4 at WRN-28-10's stride-1 conv_a, B5 at every one-group
    stride-1 bottleneck; the hard-swish and swish sites stay plain.  A
    train-mode forward launches none."""
    model = models.get_model(name, 1000, input_hw=(16, 16))
    init_model(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(x_batch(2, 2)[:, :16, :16]).to(torch.bfloat16)
    model = model.to(torch.bfloat16)
    calls = count_routes(model, x, monkeypatch)
    assert (calls["b1"], calls["b4"], calls["b5"]) == ROUTES[name]
    calls.update(b1={}, b4=0, b5=0)
    model.train()(x, **({"generator": torch.Generator()}
                        if hasattr(model, "sample_masks") else {}))
    assert calls == {"b1": {}, "b4": 0, "b5": 0}


@pytest.mark.parametrize("name,kw", [
    ("mobilenet_v2", dict(width_multiplier=0.25)),
    ("wrn_16_8", dict(width_mult=1))])
def test_folded_count_is_jaxs(name, kw):
    """``fold_batch_norms`` folds JAX's ``folded_scope_count`` pairs
    (MobileNetV2: not ``dwconv``/``bn_dw``; WRN: none of its ``preact_*``)
    and leaves the eval logits within 1e-4 of max |logit|."""
    params, state = make_trees(name, kw, 11)
    model = weights.from_jax(port_model(name, kw), params, state).eval()
    x = torch.from_numpy(x_batch())
    with torch.no_grad():
        before = model(x).numpy()
        n = folding.fold_batch_norms(model)
        after = model(x).numpy()
    assert n == jfolding.folded_scope_count(params, state)
    assert n == (35 if name == "mobilenet_v2" else 0)
    np.testing.assert_allclose(after, before, rtol=1e-4,
                               atol=1e-4 * np.abs(before).max())


def test_features_are_the_tagged_maps():
    """``features`` of the ResNeXt, WRN and RegNet is the map before the
    pooling; the logits are the head over its mean."""
    for name, kw in (("resnext50_32x4d", dict(width=16)),
                     ("wrn_16_8", dict(width_mult=1)),
                     ("regnet_x_400mf", {})):
        model = weights.from_jax(port_model(name, kw),
                                 *make_trees(name, kw, 5)).eval()
        x = torch.from_numpy(x_batch())
        with torch.no_grad():
            f = model.features(x)
            np.testing.assert_allclose(
                model(x).numpy(), model.logits(f.mean((1, 2))).numpy(),
                rtol=1e-5, atol=1e-5)
        assert f.dim() == 4


# ------------------------------------------------------- schedules

SCHEDULES = [
    dict(kind="step", lr=0.1, boundaries=[23460, 46920, 62560],
         rates=[0.2, 0.04, 0.008]),
    dict(kind="exponential", lr=0.256, decay_steps=3003, decay_rate=0.97,
         staircase=True, warmup_steps=1251),
    dict(kind="exponential", lr=0.1, decay_steps=1000, decay_rate=0.5),
]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=["step", "exp_staircase",
                                                "exp"])
def test_schedules_within_an_ulp_of_jax(cfg):
    """step_decay and exponential_decay (with and without staircase and
    warmup) within one float32 ulp of JAX's eager values."""
    j, t = joptim.make_schedule(cfg), optim.make_schedule(cfg)
    for step in (0, 1, 1250, 1251, 3002, 3003, 23459, 23460, 46920, 62559,
                 62560, 100000, 437399):
        want = np.float32(j(jnp.asarray(step, jnp.int32)))
        got = np.float32(t(step))
        assert abs(got - want) <= np.spacing(want), (cfg["kind"], step)


# ------------------------------------------------------- RMSprop

@pytest.mark.parametrize("exclude", [False, True],
                         ids=["decay_all", "decay_mask"])
def test_rmsprop_steps_match_jax(exclude):
    """Three RMSprop steps (decay 0.9, momentum 0.9, eps 1e-3, coupled
    decay 1e-2, the EfficientNet recipe's kind) on MobileNetV2 at 0.25,
    whose depthwise leaves carry the state's layout: the parameters and
    the ``.nu``/``.mom`` state within 1e-6 of each leaf's largest after
    each, and nu started at 0."""
    from test_torch_optim_wrappers import (_assert_flat_close, _grads,
                                           _set_grads, flat_np, nested)
    from myconvnet_tpu.ckpt import checkpoint as jckpt
    from myconvnet_tpu_torch import recipes

    cfg = dict(name="rmsprop", decay=0.9, momentum_coef=0.9, eps=1e-3,
               weight_decay=1e-2, wd_exclude_norms=exclude,
               lr=dict(kind="exponential", lr=0.256, decay_steps=2,
                       decay_rate=0.97, staircase=True))
    from myconvnet_tpu import recipes as jrecipes
    kw = dict(width_multiplier=0.25)
    params, state = make_trees("mobilenet_v2", kw, 13)
    jopt = jrecipes.make_optimizer(cfg)
    jparams = {s: {n: jnp.asarray(v) for n, v in d.items()}
               for s, d in params.items()}
    jstate = jopt.init(jparams)
    update = jax.jit(jopt.update)
    model = weights.from_jax(port_model("mobilenet_v2", kw), params, state)
    opt = recipes.make_optimizer(model, cfg)
    assert isinstance(opt, optim.RMSprop)
    for buf in opt.nu:
        assert not buf.any()
    for step in range(3):
        weights.from_jax(model, {s: {n: np.asarray(v) for n, v in d.items()}
                                 for s, d in jparams.items()}, state)
        weights.optimizer_from_jax(model, opt, nested(flat_np(jstate)))
        g = _grads(params, step)
        jparams, jstate = update(jax.tree.map(jnp.asarray, g), jstate,
                                 jparams, jnp.asarray(step, jnp.int32))
        _set_grads(model, g)
        opt.step(step)
        assert_trees_close(weights.to_jax(model)[0],
                           {s: {n: np.asarray(v) for n, v in d.items()}
                            for s, d in jparams.items()}, 1e-6,
                           f"step {step} params")
        _assert_flat_close(jckpt._flatten(
            weights.optimizer_to_jax(model, opt)), flat_np(jstate), 1e-6,
            f"step {step} opt_state")
