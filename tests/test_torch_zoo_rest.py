"""The rest of the port's classifier zoo (Inception-v3, Xception-65,
ConvNeXt-T/S, SqueezeNet, AlexNet), Adagrad and Shampoo against the JAX
package, on the CPU.

Sizes: Inception-v3 at 75x75 (its smallest input), AlexNet at 64x64, the
others at 32x32; widths are the models' own (none has a width knob), 10
classes.  Weights are made with numpy from a seed in the JAX layout
(``weights.random_jax_params``, every bias non-zero) and loaded through
``weights.from_jax``; a train-mode forward's dropout and drop-path masks
are the ones JAX draws, handed to the port by site.  JAX runs under
``jax.jit``; on the CPU every kernel wrapper runs its plain version.

Tolerances: float32 eval logits within 1e-4 of max |JAX logit|, bf16
within 0.05 of it; one train step at float32 (batch ``TRAIN_BATCH``) as
``test_torch_seg_family.check_train_step`` holds it: logits 1e-4 of the
largest, the loss 1e-4 relative, the BN moving statistics and every
gradient leaf 1e-4 relative plus 1e-4 of the leaf's largest, each ReLU's
derivative taken as JAX's where the two frameworks' pre-activations
straddle 0 within 1e-5 of their site's largest, after the case is shown
well conditioned; a case that no seed conditions (``CHAOTIC``: an 8-ulp
change of the input moves the port's own gradients by more than 1e-4
at every seed tried) is held at the bounds ``CHAOTIC`` states, and
Inception-v3 against JAX's float64 step, which its float32 one is nearer
than JAX's float32 one is.
Adagrad's parameters and state after each of three steps within 1e-6 of
each leaf's largest.  Shampoo's and blocked Shampoo's parameters,
statistics, momentum and inverse fourth roots within ``SHAMPOO_*_TOL``,
about twice the gaps measured over six seeds: ``torch.linalg.eigh`` and
``jnp.linalg.eigh`` round differently, and the eps-regularized
directions a few rank-one statistics leave open amplify it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import BF16 as JBF16
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu.train import shampoo as jshampoo
from myconvnet_tpu_torch import models, recipes, weights
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.models import convnext as tconvnext
from myconvnet_tpu_torch.train import losses, optim
from myconvnet_tpu_torch.train import shampoo as tshampoo

from test_torch_optim_wrappers import _grads, _set_grads, flat_np, nested
from test_torch_seg_family import check_train_step, count_routes
from test_torch_zoo import CHAOTIC_LEAF, CHAOTIC_TREE

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


CLASSES = 10
# case: (registry name, kwargs of both packages, input size, weight seed)
ZOO = {
    "inception_v3": ("inception_v3", {}, 75, 0),
    "xception65": ("xception65", {}, 32, 0),
    "convnext_tiny": ("convnext_tiny", {}, 32, 0),
    "convnext_small": ("convnext_small", {}, 32, 0),
    "squeezenet": ("squeezenet", {}, 32, 0),
    "alexnet": ("alexnet", {}, 64, 0),
    "alexnet_gap_nobn": ("alexnet", dict(use_bn=False, classic_head=False),
                         64, 0),
}
TRAIN_BATCH = 4
# case -> (batch, (logits, gradient tree, gradient leaf) bounds, JAX in
# float64) of the train step of a case no seed conditions
# (``check_train_step``): 8 ulps of input, ReLU derivatives held, move
# Xception-65's gradients (its exit at 1x1, the BN over the batch alone)
# by 7.5e-5 to 3.4e-4 of a leaf over seeds 0-5, held at test_torch_zoo's
# CHAOTIC bounds.  Inception-v3 at 75 x 75 (1x1 maps from reduction_b on)
# moves by 1.9e-2 at batch 4 and 7.1e-4 to 9.0e-4 at 8, where it runs.
# Against JAX's float32 step its logits differ by 2.0e-3 and one leaf
# (mixed_b4/b1x1/conv/w) by 0.13, and the float64 step sides with the
# port: the two packages' float64 steps agree within 1e-11 of a leaf, and
# on the same draws that leaf of the port's float32 step is 3.4e-4 from
# the float64 one where JAX's float32 one is 0.13 off.  XLA's float32 reductions on the CPU
# round about 9x as much as torch's (the BN variance mean(x^2) - mean^2
# over [8, 17, 17, 80]: 1.4e-5 against 1.5e-6), which the BN over 8
# values at the 1x1 maps amplifies.  So Inception-v3 is held to JAX's
# float64 step, at about twice the largest gaps over four weight and input
# seeds: logits 3.3e-4, tree 4.3e-4, leaf 1.05e-3, BN statistics 2.1e-5.
CHAOTIC = {"inception_v3": (8, (7e-4, 1e-3, 2e-3), True),
           "xception65": (4, (CHAOTIC_TREE, CHAOTIC_TREE, CHAOTIC_LEAF),
                          False)}


def jax_fn(name, kw):
    fn = jmodels.CLASSIFIERS[name]
    return transform(lambda x, train: fn(x, CLASSES, train=train, **kw))


def port_model(name, kw, hw):
    return models.get_model(name, CLASSES, input_hw=(hw, hw), **kw)


def make_trees(case):
    name, kw, hw, seed = ZOO[case]
    params, state = weights.random_jax_params(port_model(name, kw, hw),
                                              seed)
    rng = np.random.RandomState(100 + seed)
    for scope, p in params.items():
        if "b" in p:
            p["b"] = (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)
        if "layer_scale" in p:    # ConvNeXt's: 1e-6 at init; larger here
            p["layer_scale"] = rng.uniform(
                0.1, 0.3, p["layer_scale"].shape).astype(np.float32)
    return params, state


def x_batch(seed, hw, n=2):
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(
        np.float32)


@pytest.mark.parametrize("case", list(ZOO))
def test_scopes_match_the_jax_init_tree(case):
    """The port's modules carry the JAX init tree's scopes and shapes
    (ConvNeXt's ``layer_scale``, depthwise biases, rectangular kernels),
    and from_jax -> to_jax gives a random tree back bit for bit."""
    name, kw, hw, _ = ZOO[case]
    jparams, jstate = jax.eval_shape(lambda: jax_fn(name, kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)), False))
    model = port_model(name, kw, hw)
    p2, s2 = weights.to_jax(model)
    assert set(p2) == set(jparams) and set(s2) == set(jstate)
    for tree, mine in ((jparams, p2), (jstate, s2)):
        for scope in tree:
            assert {n: v.shape for n, v in mine[scope].items()} == \
                {n: tuple(v.shape) for n, v in tree[scope].items()}, scope
    params, state = make_trees(case)
    weights.from_jax(model, params, state)
    p3, s3 = weights.to_jax(model)
    for tree, back in ((params, p3), (state, s3)):
        for scope in tree:
            for n, v in tree[scope].items():
                np.testing.assert_array_equal(back[scope][n], v)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(ZOO))
def test_eval_logits_match_jax(case, precision):
    name, kw, hw, _ = ZOO[case]
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
        out = model(torch.from_numpy(x).to(dtype)).float().numpy()
    assert out.shape == want.shape == (2, CLASSES)
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(out).all()
    if precision == "f32":
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert np.abs(out - want).max() / scale < 0.05


@pytest.mark.parametrize("case", list(ZOO))
def test_train_step_matches_jax_f32(case, monkeypatch):
    """Train mode at float32 (softmax CE) with JAX's dropout and
    drop-path draws: logits, loss, BN moving statistics and every
    gradient (``check_train_step``); Inception-v3 against JAX's float64
    step (``CHAOTIC``)."""
    name, kw, hw, _ = ZOO[case]

    def new_model():
        return port_model(name, kw, hw)

    new_model.trees = make_trees(case)
    n, chaotic, exact = CHAOTIC.get(case, (TRAIN_BATCH, None, False))
    y = np.random.RandomState(3).randint(0, CLASSES, n).astype(np.int32)
    check_train_step(jax_fn(name, kw), new_model, x_batch(7, hw, n), y,
                     jlosses.softmax_cross_entropy,
                     losses.softmax_cross_entropy, monkeypatch, chaotic,
                     exact)


# registry name and kwargs -> launches of B5, B4 and B1 in one bf16 eval
# forward at full width
ROUTES = {
    "inception_v3": ({}, 80, (0, 10, 84)),
    "xception65": ({}, 32, (0, 1, 67)),
    "convnext_tiny": ({}, 32, (0, 0, 0)),
    "convnext_small": ({}, 32, (0, 0, 0)),
    "squeezenet": ({}, 32, (0, 8, 18)),
    "alexnet": ({}, 64, (0, 3, 2)),
    "alexnet_nobn": (dict(use_bn=False), 64, (0, 3, 2)),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_eval_routing_at_full_width(case, monkeypatch):
    """Which sites a bf16 eval forward sends to B4 and B1: Inception's
    3x3 stride-1 SAME convs (stem/conv3, b3_2 and b3_3 of each A module,
    reduction_a/r3d_2, b33_2 of each C module) to B4, its 84 other conv
    -> BN -> ReLUs to B1; Xception's stem conv2 to B4 and its stride-2
    stem conv, 63 depthwise BN -> ReLUs and exit2's three pointwise ones
    to B1; SqueezeNet's eight expand3x3 (bias as the epilogue) to B4, its
    stem, squeezes, expand1x1s and classifier to B1; AlexNet's three 3x3s
    to B4 and its 11x11 and 5x5 to B1, with or without BN; ConvNeXt none.
    A train forward launches none."""
    kw, hw, want = ROUTES[case]
    name = case.replace("_nobn", "")
    model = models.get_model(name, 1000, input_hw=(hw, hw), **kw)
    init_model(model, torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16)
    x = torch.from_numpy(x_batch(2, hw, 1)).to(torch.bfloat16)
    calls = count_routes(model, x, monkeypatch)
    assert (calls["b5"], calls["b4"], calls["b1"]) == want
    calls.update(b1=0, b4=0, b5=0)
    model.train()(x, generator=torch.Generator())
    assert calls == {"b1": 0, "b4": 0, "b5": 0}


# name -> the input size JAX's init takes at full width
FULL = {"inception_v3": 299, "xception65": 224, "convnext_tiny": 224,
        "convnext_small": 224, "squeezenet": 224, "alexnet": 224}


@pytest.mark.parametrize("name", list(FULL))
def test_full_width_builds_with_the_jax_tree(name):
    """At full width (1000 classes, the canonical input) ``from_jax``
    loads JAX's init tree with no scope left over and none missing, and
    the parameter counts agree (AlexNet's classic fc1 sized at 224)."""
    hw = FULL[name]
    jparams, jstate = jax.eval_shape(lambda: transform(
        lambda x, train: jmodels.CLASSIFIERS[name](x, 1000, train=train)
    ).init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)), False))
    model = models.get_model(name, 1000, input_hw=(hw, hw))
    zeros = [{s: {n: np.zeros(v.shape, np.float32) for n, v in d.items()}
              for s, d in tree.items()} for tree in (jparams, jstate)]
    weights.from_jax(model, *zeros)
    want = sum(int(np.prod(v.shape)) for d in jparams.values()
               for v in d.values())
    assert sum(p.numel() for p in model.parameters()) == want


def test_every_jax_classifier_and_segmenter_builds():
    """``get_model`` builds each of JAX's classifier and segmenter
    names (on the meta device, at 224 x 224; Inception at 299)."""
    names = list(jmodels.CLASSIFIERS) + list(jmodels.SEGMENTERS)
    assert len(jmodels.CLASSIFIERS) == 58 and len(jmodels.SEGMENTERS) == 4
    with torch.device("meta"):
        for name in names:
            hw = 299 if name == "inception_v3" else 224
            assert isinstance(models.get_model(name, 10, input_hw=(hw, hw)),
                              torch.nn.Module), name
    assert {"unet", "fcn", "pspnet", "deeplab_v3_plus"} <= set(models.MODELS)
    assert {"alexnet", "squeezenet", "pspnet", "fcn"} <= models.SIZED


def test_model_refusals_follow_jax():
    """Inception-v3 below 75 x 75, an unknown ConvNeXt variant and a
    variant handed to ``convnext_tiny`` (JAX's passes its own too) are
    refused; none of the six has a ``features`` map (JAX tags none, so
    ``ConvNet.features`` and SimCLR refuse them in both); the ``base``
    variant builds through the ConvNeXt class."""
    with pytest.raises(ValueError, match="at least 75"):
        models.get_model("inception_v3", 10)(torch.zeros(1, 74, 74, 3))
    with pytest.raises(ValueError, match="variant"):
        tconvnext.ConvNeXt(10, variant="huge")
    with pytest.raises(TypeError):
        jmodels.convnext_tiny(jnp.zeros((1, 32, 32, 3)), 10, variant="base")
    with pytest.raises(TypeError):
        models.get_model("convnext_tiny", 10, variant="base")
    for name in FULL:    # JAX tags no "features" map in these six
        with torch.device("meta"):
            assert not hasattr(models.get_model(name, 10), "features")
    with torch.device("meta"):
        base = tconvnext.ConvNeXt(10, variant="base")
    assert base.width == 1024
    rates = list(tconvnext.ConvNeXt(10).rates.values())
    assert rates[0] == 0.0 and np.isclose(rates[-1], 0.1)
    assert len(tconvnext.ConvNeXt(10).sample_masks(
        2, torch.Generator())) == 17


# ------------------------------------------------------- optimizers


def _trajectory(cfg, case="squeezenet", seed=13, steps=3):
    """[(param gap, {state field: gap})] after each of ``steps`` steps of
    the recipe's optimizer ``cfg`` in both packages from the same
    parameters, state and gradients (``seed`` draws the gradients), each
    gap over the leaf's largest value; the port's state goes out through
    ``weights.optimizer_to_jax`` under JAX's checkpoint keys."""
    name, kw, hw, _ = ZOO[case]
    params, state = make_trees(case)
    jopt = jrecipes.make_optimizer(cfg)
    jparams = {s: {n: jnp.asarray(v) for n, v in d.items()}
               for s, d in params.items()}
    jstate = jopt.init(jparams)
    update = jax.jit(jopt.update)
    model = weights.from_jax(port_model(name, kw, hw), params, state)
    opt = recipes.make_optimizer(model, cfg)
    out = []
    for step in range(steps):
        weights.from_jax(model, {s: {n: np.asarray(v) for n, v in d.items()}
                                 for s, d in jparams.items()}, state)
        weights.optimizer_from_jax(model, opt, nested(flat_np(jstate)))
        g = _grads(params, 1000 * seed + step)
        jparams, jstate = update(jax.tree.map(jnp.asarray, g), jstate,
                                 jparams, jnp.asarray(step, jnp.int32))
        _set_grads(model, g)
        opt.step(step)
        got = weights.to_jax(model)[0]
        pgap = max(np.abs(got[s][n] - np.asarray(v)).max()
                   / max(np.abs(np.asarray(v)).max(), 1e-30)
                   for s, d in jparams.items() for n, v in d.items())
        mine = jckpt._flatten(weights.optimizer_to_jax(model, opt))
        theirs = flat_np(jstate)
        assert set(mine) == set(theirs), sorted(set(mine) ^ set(theirs))[:5]
        fields = {}
        for k, ref in theirs.items():
            f = k.split("::")[0]
            gap = np.abs(mine[k] - ref).max() / max(np.abs(ref).max(), 1e-30)
            fields[f] = max(fields.get(f, 0.0), float(gap))
        out.append((float(pgap), fields))
    return opt, out


@pytest.mark.parametrize("exclude", [False, True],
                         ids=["decay_all", "decay_mask"])
def test_adagrad_steps_match_jax(exclude):
    """Three Adagrad steps (initial accumulator 0.1, eps 1e-10, coupled
    decay 1e-2, with and without the norm-and-bias mask) on SqueezeNet:
    parameters and the accumulator tree within 1e-6 of each leaf's
    largest after each, the accumulator started at 0.1."""
    cfg = dict(name="adagrad", lr=dict(kind="cosine", lr=0.1,
                                       total_steps=10),
               weight_decay=1e-2, wd_exclude_norms=exclude)
    opt, gaps = _trajectory(cfg)
    assert isinstance(opt, optim.Adagrad)
    for pgap, fields in gaps:
        assert pgap <= 1e-6 and max(fields.values()) <= 1e-6, gaps


# the bounds of the Shampoo trajectories, about twice the largest gaps
# measured over seeds 0-5 of both variants: parameters 3.5e-5, the
# statistics 7.4e-7, the momentum 2.2e-4 (after a preconditioned step
# it is the grafted direction), the inverse fourth roots 6.5e-2
SHAMPOO_PARAM_TOL = 1e-4
SHAMPOO_STATS_TOL = 2e-6
SHAMPOO_MOMENTUM_TOL = 5e-4
SHAMPOO_ROOT_TOL = 0.15


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["shampoo", "blocked_shampoo"])
def test_shampoo_steps_match_jax(kind, seed):
    """Three steps of Shampoo (max_dim 64: SqueezeNet's wider axes keep
    the identity) and of blocked Shampoo (blocks of 32) on SqueezeNet,
    preconditioning from step 1 with a refresh every step, coupled decay
    1e-2 off norms and biases, in JAX's state layout (``.stats_l::<i>``
    ...): the parameters, statistics, momentum and inverse fourth roots
    within SHAMPOO_*_TOL of each leaf's largest.  The roots' gap lies in
    the directions the eps-regularized statistics of one or two rank-one
    updates leave open: their eigenvalues are eps plus each eigh's
    rounding and go in at the power -1/4; grafting to the gradient's norm
    keeps the parameters' gap small."""
    cfg = dict(name=kind, lr=0.1, weight_decay=1e-2, wd_exclude_norms=True,
               precond_every=1, start_step=1,
               **(dict(max_dim=64) if kind == "shampoo"
                  else dict(block_size=32)))
    _, gaps = _trajectory(cfg, seed=seed)
    for step, (pgap, fields) in enumerate(gaps):
        assert pgap <= SHAMPOO_PARAM_TOL, (step, pgap)
        for f, gap in fields.items():
            tol = (SHAMPOO_ROOT_TOL if f.startswith(".precond")
                   else SHAMPOO_MOMENTUM_TOL if f == ".momentum"
                   else SHAMPOO_STATS_TOL)
            assert gap <= tol, (step, f, gap)


@pytest.mark.parametrize("rank", [3, 256])
def test_inverse_fourth_root_gap_over_seeds(rank):
    """``_inv_fourth_root`` against JAX's on 64 x 64 statistics G G^T,
    seeds 0-5.  Full rank (G 64 x 256, eigenvalues far from eps): the
    roots within 1e-5 of the largest entry (measured 9.6e-7).  Rank 3 (a
    few steps' outer products): the 61 open directions' eigenvalues are
    each eigh's rounding clamped at eps, so the roots differ there by up
    to 0.40 of the largest entry, which no bound tightens; applied to the
    statistics' own columns, the directions an update draws from, they
    agree within 1e-4 of the largest (measured 5.2e-5)."""
    worst = 0.0
    for seed in range(6):
        g = np.random.RandomState(seed).randn(64, rank).astype(np.float32)
        s = g @ g.T
        want = np.asarray(jshampoo._inv_fourth_root(jnp.asarray(s), 1e-6))
        got = tshampoo._inv_fourth_root(torch.from_numpy(s), 1e-6).numpy()
        if rank < 64:
            got, want = got @ g, want @ g
        worst = max(worst, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
    assert worst <= (1e-5 if rank >= 64 else 1e-4), worst


def test_shampoo_layout_follows_jax():
    """The per-leaf state in JAX's leaf order (scopes, then names,
    sorted), in the JAX layout (a conv's statistics over kh * kw * cin
    rows of its HWIO matrix), an axis beyond max_dim holding nothing;
    the tile plan; ``mesh`` refused by name; the factory's names."""
    name, kw, hw, _ = ZOO["squeezenet"]
    model = port_model(name, kw, hw)
    opt = recipes.make_optimizer(model, dict(name="shampoo", lr=0.1,
                                             max_dim=300))
    paths = [p for p, _ in opt.named]
    order = [paths[i] for i in opt.order]
    assert order == sorted(paths, key=lambda p: tuple(p.rsplit("/", 1)))
    i = order.index("fire2/expand3x3/w")
    assert opt.stats_l[i].shape == (144, 144)     # 3 * 3 * 16
    assert opt.stats_r[i].shape == (64, 64)
    j = order.index("fire9/expand3x3/w")          # 3 * 3 * 64 > 300
    assert opt.stats_l[j] is None and opt.pre_l[j] is None
    assert opt.stats_l[order.index("fire2/expand3x3/b")] is None
    plan, total = tshampoo._tile_plan([(3, 3, 16, 64), (5,), (70, 40)], 32)
    assert plan == list(jshampoo._tile_plan([(3, 3, 16, 64), (5,),
                                             (70, 40)], 32)[0])
    assert total == 5 * 2 + 3 * 2
    with pytest.raises(ValueError, match="mesh"):
        recipes.make_optimizer(model, dict(name="blocked_shampoo", lr=0.1,
                                           mesh=object()))
    for n in ("adagrad", "shampoo", "blocked_shampoo"):
        assert recipes.make_optimizer(model, dict(name=n, lr=0.1))
    with pytest.raises(ValueError, match="adagrad"):
        recipes.make_optimizer(model, dict(name="adadelta", lr=0.1))
