"""The port's dilated ResNet backbone and DeepLabv3+ against the JAX
models, on the CPU, and the segmentation recipe end to end.

Backbones at depth 18 (both paddings, output_stride 8, 16 and 32) and
depth 50 (output_stride 16) on 33x33 inputs; DeepLabv3+ on a ResNet-18
backbone at 65x65 (21 classes); batch 2.  Weights are made with numpy from
a seed in the JAX layout (``weights.random_jax_params``, a non-zero
``decoder/logits`` bias) and loaded through ``weights.from_jax``; the
train-mode dropout mask is the one JAX draws, recorded by a spy on
``jax.random.bernoulli`` and handed to the port.  JAX runs under
``jax.jit``; on the CPU every kernel wrapper runs its plain version.

Tolerances: backbone maps (the last and the low-level one) float32 within
1e-5 of max |JAX|; DeepLab logits float32 within 1e-4 of max |JAX logit|,
bf16 within 0.05 of it; train mode float32 (batch 4, see
``TRAIN_BATCH``): loss 1e-4 relative, logits and BN moving statistics
1e-4, every gradient within 1e-4 of its leaf's largest value, a ReLU
kink explained (``test_train_step_matches_jax_f32``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import BF16 as JBF16
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.models.deeplab import deeplab_v3_plus as jdeeplab
from myconvnet_tpu.models.resnet import resnet_backbone as jbackbone
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu_torch import models, recipes, test, train, weights
from myconvnet_tpu_torch.models import blocks
from myconvnet_tpu_torch.models import resnet as resnet_mod
from myconvnet_tpu_torch.models.resnet import ResNetBackbone
from myconvnet_tpu_torch.train import losses

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


CLASSES, HW, BATCH = 21, 65, 2
CONFIG = "configs/voc_deeplabv3plus.py"


def _x(seed, hw, n=BATCH):
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(
        np.float32)


def _jax_backbone(depth, os_, tp):
    return transform(lambda x, train: jbackbone(
        x, depth, train=train, output_stride=os_, return_low_level=True,
        torch_padding=tp))


def _jax_deeplab(**kw):
    return transform(lambda x, train: jdeeplab(
        x, CLASSES, train=train, backbone_depth=18, output_stride=16, **kw))


def _port_deeplab():
    return models.get_model("deeplab_v3_plus", CLASSES, input_hw=(HW, HW),
                            backbone_depth=18, output_stride=16)


@pytest.fixture(scope="module")
def deeplab_tree():
    params, state = weights.random_jax_params(_port_deeplab(), 3)
    rng = np.random.RandomState(4)
    params["decoder/logits"]["b"] = (0.1 * rng.randn(CLASSES)).astype(
        np.float32)
    return params, state


BACKBONES = [(18, 8, False), (18, 16, False), (18, 32, False),
             (18, 8, True), (18, 16, True), (18, 32, True), (50, 16, False)]


@pytest.mark.parametrize("depth,os_,tp", BACKBONES,
                         ids=[f"r{d}-os{o}{'-torchpad' if t else ''}"
                              for d, o, t in BACKBONES])
def test_backbone_matches_jax(depth, os_, tp):
    """The last map and stage 1's, eval mode, float32: 1e-5 of max
    |JAX|."""
    model = ResNetBackbone(depth, output_stride=os_, torch_padding=tp)
    params, state = weights.random_jax_params(model, depth + os_)
    x = _x(1, 33)
    fn = _jax_backbone(depth, os_, tp)

    def apply(p, s, v):
        with policy_scope(JFULL):
            return fn.apply(p, s, None, v, False)[0]

    want, want_low = jax.jit(apply)(params, state, jnp.asarray(x))
    model = weights.from_jax(model, params, state).eval()
    with torch.no_grad():
        got, low = model(torch.from_numpy(x), return_low_level=True)
    assert got.shape == want.shape and low.shape == want_low.shape
    assert got.shape[1] == -(-33 // os_)
    for a, b in ((got, want), (low, want_low)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("os_,pairs", [(8, [3, 3, 0, 0]),
                                       (16, [3, 3, 5, 0]),
                                       (32, [3, 3, 5, 2])])
def test_dilated_blocks_do_not_take_the_pair_kernel(os_, pairs):
    """conv1x1_conv3x3_bn_relu pads its 3x3 by 1 and takes no dilation:
    a dilated bottleneck (stage 4 at output_stride 16, stages 3-4 at 8,
    the swapped stage's first block too) is never routed to it, and each
    dilated 3x3 pads by its dilation under torch_padding."""
    for tp in (False, True):
        net = ResNetBackbone(50, output_stride=os_, torch_padding=tp)
        for s, want in enumerate(pairs):
            stage = list(getattr(net, f"stage{s + 1}").children())
            assert sum(b.pair for b in stage) == want, (os_, s)
            for b in stage:
                d = b.conv_b.dilation
                assert not (b.pair and d != 1)
                if tp:
                    assert b.conv_b.padding == ((d, d), (d, d))
        dil = [list(getattr(net, f"stage{s + 1}").children())[0]
               .conv_b.dilation for s in range(4)]
        assert dil == {8: [1, 1, 2, 4], 16: [1, 1, 1, 2],
                       32: [1, 1, 1, 1]}[os_]


# (policy, output_stride) -> launches of B5 (conv_pair), B4 (conv_fused)
# and B1 (bn_act) in one eval forward of DeepLabv3+ on ResNet-50
ROUTES = {("bf16", 16): (11, 2, 18), ("bf16", 8): (6, 2, 28),
          ("f32", 16): (0, 0, 42)}


@pytest.mark.parametrize("prec,os_", list(ROUTES),
                         ids=[f"{p}-os{o}" for p, o in ROUTES])
def test_eval_routing(prec, os_, monkeypatch):
    """Spies on the wrappers count an eval forward's launches: under bf16
    at output_stride 16 the 11 undilated stride-1 bottlenecks take B5,
    refine1 (304 input channels) and refine2 take B4, the 18 other conv ->
    BN -> ReLU sites B1; a train-mode forward launches none."""
    calls = {"b5": 0, "b4": 0, "b1": 0}

    def counted(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(resnet_mod, "conv1x1_conv3x3_bn_relu",
                        counted("b5", resnet_mod.conv1x1_conv3x3_bn_relu))
    monkeypatch.setattr(blocks, "conv3x3_bn_relu",
                        counted("b4", blocks.conv3x3_bn_relu))
    monkeypatch.setattr(blocks, "fused_scale_shift_act",
                        counted("b1", blocks.fused_scale_shift_act))
    model = models.get_model("deeplab_v3_plus", CLASSES, input_hw=(33, 33),
                             output_stride=os_)
    weights.from_jax(model, *weights.random_jax_params(model, 0)).eval()
    dtype = torch.bfloat16 if prec == "bf16" else torch.float32
    x = torch.from_numpy(_x(2, 33, 1)).to(dtype)
    with torch.no_grad():
        out = model(x)
    assert out.dtype == torch.float32 and out.shape == (1, 33, 33, CLASSES)
    assert (calls["b5"], calls["b4"], calls["b1"]) == ROUTES[prec, os_]
    calls.update(b5=0, b4=0, b1=0)
    model.train()(x, generator=torch.Generator())
    assert calls == {"b5": 0, "b4": 0, "b1": 0}


def test_scopes_match_the_jax_init_tree():
    """DeepLab's modules carry the JAX init tree's scopes and shapes
    (``backbone/...``, ``aspp_rate6``, ``aspp_pool/conv``,
    ``decoder/logits`` with its bias), and from_jax -> to_jax gives the
    tree back bit for bit."""
    jparams, jstate = jax.eval_shape(lambda: _jax_deeplab().init(
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), False))
    model = _port_deeplab()
    p2, s2 = weights.to_jax(model)
    assert set(p2) == set(jparams) and set(s2) == set(jstate)
    for tree, mine in ((jparams, p2), (jstate, s2)):
        for scope in tree:
            assert {n: v.shape for n, v in mine[scope].items()} == \
                {n: tuple(v.shape) for n, v in tree[scope].items()}, scope
    assert "aspp_pool/bn" in p2 and set(p2["decoder/logits"]) == {"w", "b"}
    params, state = weights.random_jax_params(model, 7)
    weights.from_jax(model, params, state)
    p3, s3 = weights.to_jax(model)
    for tree, back in ((params, p3), (state, s3)):
        for scope in tree:
            for n, v in tree[scope].items():
                np.testing.assert_array_equal(back[scope][n], v)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_eval_logits_match_jax(deeplab_tree, precision):
    params, state = deeplab_tree
    x = _x(5, HW)
    pol, dtype = ((JFULL, torch.float32) if precision == "f32"
                  else (JBF16, torch.bfloat16))
    fn = _jax_deeplab()

    def apply(p, s, v):
        with policy_scope(pol):
            return fn.apply(p, s, None, v, False)[0]

    want = np.asarray(jax.jit(apply)(params, state, jnp.asarray(
        x, pol.compute_dtype)), np.float32)
    model = weights.from_jax(_port_deeplab(), params, state).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(dtype))
    assert out.dtype == torch.float32 and out.shape == want.shape
    out = out.numpy()
    scale = np.abs(want).max()
    if precision == "f32":
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        # logits rounded to bf16 after the last resize, as in JAX
        assert np.array_equal(out, out.astype(jnp.bfloat16).astype(
            np.float32))
        assert np.abs(out - want).max() / scale < 0.05


def _grad_tree(model):
    out = {}
    for path, p, view in weights.param_views(model):
        scope, name = path.rsplit("/", 1)
        out.setdefault(scope, {})[name] = view(p.grad).numpy()
    return out


def _leaf_gaps(got, want):
    """{(scope, name): max |got - want| over the leaf's largest |want|}."""
    assert set(got) == set(want)
    out = {}
    for scope, d in want.items():
        assert set(got[scope]) == set(d), scope
        for name, ref in d.items():
            ref = np.asarray(ref)
            out[scope, name] = float(np.abs(got[scope][name] - ref).max()
                                     / max(np.abs(ref).max(), 1e-30))
    return out


def _port_train_step(params, state, x, y, masks, monkeypatch, flips=()):
    """The port's train-mode forward and backward: (model, logits, loss,
    {ConvBNReLU path: its pre-activation}).  ``flips``: (path, channel)
    pairs whose ReLU derivative is taken the other way at the channel's
    pre-activation nearest 0 (its forward value unchanged); a site may
    have several."""
    model = weights.from_jax(_port_deeplab(), params, state).train()
    names = {m.conv: n for n, m in model.named_modules()
             if isinstance(m, blocks.ConvBNReLU)}
    pre, flip = {}, {}
    for path, c in flips:
        flip.setdefault(path, []).append(c)
    plain = blocks.conv_bn_relu

    def traced(conv, bn, v, fused=False):
        if conv not in names:
            return plain(conv, bn, v, fused)
        name = names[conv]
        z = bn(conv(v))
        out = torch.relu(z)
        pre[name] = z.detach()
        if name in flip:
            upstream = {}
            out.register_hook(lambda g: upstream.setdefault("g", g))

            def turn(g, channels=flip[name], zd=z.detach()):
                g = g.clone()
                for c in channels:
                    zc = zd[..., c].reshape(-1)
                    at = int(zc.abs().argmin())
                    gc = g[..., c].reshape(-1).clone()
                    up = upstream["g"][..., c].reshape(-1)[at]
                    gc[at] = up if zc[at] <= 0 else 0.0
                    g[..., c] = gc.reshape(g[..., c].shape)
                return g
            z.register_hook(turn)
        return out

    monkeypatch.setattr(blocks, "conv_bn_relu", traced)
    try:
        logits = model(torch.from_numpy(x), masks)
        loss = losses.pixel_cross_entropy(logits, torch.from_numpy(y))
        loss.backward()
    finally:
        monkeypatch.setattr(blocks, "conv_bn_relu", plain)
    return model, logits, loss, pre


# the train step's batch: at 2 images the pooling branch's BN normalizes
# each channel over two values, (x1 - x2) / |x1 - x2| up to eps, and a
# 1e-6 relative change of the input moves the port's own float32
# gradients by 1% of their largest (13% of a leaf's): no bound holds there
TRAIN_BATCH = 4


def test_train_step_matches_jax_f32(deeplab_tree, monkeypatch):
    """:func:`check_train_step_f32` at this module's one torch thread."""
    check_train_step_f32(deeplab_tree, monkeypatch)


def test_train_step_matches_jax_f32_at_two_threads(deeplab_tree,
                                                   monkeypatch):
    """The same case at two torch threads (as a module that sets two
    leaves them): the float32 sums' order changes, the bounds hold."""
    torch.set_num_threads(2)
    check_train_step_f32(deeplab_tree, monkeypatch)


def check_train_step_f32(deeplab_tree, monkeypatch):
    """Train mode at float32 with the ASPP dropout JAX draws: the logits,
    the loss (per-pixel CE, a fifth of the pixels at the ignore label),
    the BN moving statistics after the forward, and every gradient within
    1e-4 of its leaf's largest value.  A ReLU whose pre-activation sits
    nearer 0 than the two frameworks' forwards agree takes its derivative
    either way: a gradient leaf of a conv -> BN -> ReLU site past the
    bound must be brought inside it, with every other leaf, by flipping
    that derivative at each such output channel's pre-activation nearest
    0, and that pre-activation must lie within 1e-5 of the site's
    largest.  Which channels sit there follows the float32 sums' order,
    so the thread count: one at one thread, three (two sites) at two."""
    params, state = deeplab_tree
    rng = np.random.RandomState(6)
    n = TRAIN_BATCH
    x = _x(7, HW, n)
    y = rng.randint(0, CLASSES, (n, HW, HW)).astype(np.int32)
    y[rng.rand(n, HW, HW) < 0.2] = 255
    drawn = []
    bernoulli = jax.random.bernoulli

    def spy(key, p=0.5, shape=None):
        mask = bernoulli(key, p, shape)
        drawn.append(mask)
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", spy)
    fn = _jax_deeplab()

    def loss_fn(p):
        drawn.clear()
        with policy_scope(JFULL):
            logits, new_state = fn.apply(p, state, jax.random.PRNGKey(8),
                                         jnp.asarray(x), True)
        return jlosses.pixel_cross_entropy(logits, jnp.asarray(y)), \
            (logits, new_state, list(drawn))

    (jloss, (jlogits, jstate, jmasks)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    sites = _port_deeplab().sample_masks(n, torch.Generator())
    assert list(sites) == ["dropout"] and len(jmasks) == 1
    assert tuple(sites["dropout"].shape) == jmasks[0].shape == (
        n, 5, 5, 256)
    masks = {"dropout": torch.from_numpy(np.array(jmasks[0]))}
    assert not masks["dropout"].all()
    model, logits, loss, pre = _port_train_step(params, state, x, y, masks,
                                                monkeypatch)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4,
                               atol=1e-4 * np.abs(jlogits).max())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    for key, gap in _leaf_gaps(weights.to_jax(model)[1], jstate).items():
        assert gap <= 1e-4, ("bn state", key, gap)

    # kinks, the site nearest the output first: a flip there moves every
    # gradient upstream of it, so the sites are taken one at a time (at
    # most two sites; a site may have more than one channel's kink)
    flips = []
    while True:
        grads = _grad_tree(model)
        gaps = _leaf_gaps(grads, jgrads)
        over = {scope for (scope, _), g in gaps.items() if g > 1e-4}
        if not over or len({p for p, _ in flips}) >= 2:
            break
        path = next(p for p in reversed(list(pre))
                    if {f"{p.replace('.', '/')}/conv",
                        f"{p.replace('.', '/')}/bn"} & over)
        scope = path.replace(".", "/") + "/conv"
        ref = np.asarray(jgrads[scope]["w"])
        d = np.abs(grads[scope]["w"] - ref)
        d = d.reshape(-1, d.shape[-1]).max(0)
        channels = np.flatnonzero(d > 1e-4 * np.abs(ref).max())
        assert len(channels), (path, over)
        for c in channels:
            z = pre[path]
            near = float(z[..., int(c)].abs().min())
            assert near <= 1e-5 * float(z.abs().max()), (path, c, near)
            flips.append((path, int(c)))
        model = _port_train_step(params, state, x, y, masks, monkeypatch,
                                 flips)[0]
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1e-4, (worst, gaps[worst], flips)
    assert len({p for p, _ in flips}) <= 2, flips


def test_registry_masks_and_refusals():
    assert models.MODELS["deeplab_v3_plus"] is models.deeplab_v3_plus
    big = models.get_model("deeplab_v3_plus", 21, input_hw=(513, 513))
    assert big.rates == (6, 12, 18)
    m = big.sample_masks(3, torch.Generator().manual_seed(0))
    assert m["dropout"].shape == (3, 33, 33, 256)
    assert 0.85 < float(m["dropout"].float().mean()) < 0.95
    small = models.get_model("deeplab_v3_plus", 21, input_hw=(96, 96),
                             output_stride=8, backbone_depth=18)
    assert small.rates == (12, 24, 36)
    assert small.sample_masks(2, torch.Generator())["dropout"].shape == (
        2, 12, 12, 256)
    with pytest.raises(ValueError, match="unknown backbone 'mobilenet'"):
        models.get_model("deeplab_v3_plus", 21, backbone="mobilenet")
    with pytest.raises(ValueError, match="output_stride"):
        ResNetBackbone(18, output_stride=4)
    with pytest.raises(ValueError, match="mask or a generator"):
        small.train()(torch.zeros(1, 32, 32, 3))


def _cfg(**sets):
    cfg = recipes.load_config(CONFIG)
    cfg["model_kwargs"] = dict(cfg["model_kwargs"], backbone_depth=18)
    cfg.update(sets)
    return cfg


@pytest.mark.parametrize("key,value", [("seg_loss", "dice"),
                                       ("seg_loss", "ce_dice"),
                                       ("seg_loss", "focal"),
                                       ("pretrained", {"path": "x"})])
def test_recipe_refuses_unported_keys_by_name(key, value):
    """``pretrained`` with a path that is no file is refused by name.  The
    ``seg_loss`` kinds train like JAX's: the recipe's loss (its ignore
    label, ``focal_gamma`` 1.5 for focal) and its gradient with respect
    to the logits within 1e-5 relative of the JAX loss ``vision.py:73-84``
    picks, and one train step on the synthetic pairs gives that loss of
    its logits."""
    if key != "seg_loss":
        with pytest.raises(ValueError, match=key):
            recipes.build_trainer(_cfg(**{key: value}), True,
                                  device=torch.device("cpu"))
        return
    trainer, train_set, _ = recipes.build_trainer(
        _cfg(seg_loss=value, focal_gamma=1.5), True,
        device=torch.device("cpu"))
    jfn = {"dice": jlosses.dice_loss, "ce_dice": jlosses.ce_dice_loss,
           "focal": jlosses.focal_loss}[value]
    extra = {"gamma": 1.5} if value == "focal" else {}
    rng = np.random.RandomState(9)
    logits = (3 * rng.randn(2, 12, 12, CLASSES)).astype(np.float32)
    y = rng.randint(0, CLASSES, (2, 12, 12)).astype(np.int32)
    y[rng.rand(2, 12, 12) < 0.2] = 255
    want, jgrad = jax.value_and_grad(lambda v: jfn(
        v, jnp.asarray(y), ignore_label=255, **extra))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = trainer.loss_fn(t, torch.from_numpy(y).long())
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgrad)).max())
    xs, ys = [torch.from_numpy(a) for a in _pairs()]
    draws = trainer.sample(4, (96, 96))
    loss, logits_t, y_aug = trainer.loss_and_grads(xs, ys, draws)
    assert torch.isfinite(loss)
    np.testing.assert_allclose(
        float(loss), float(trainer.loss_fn(logits_t, y_aug)), rtol=1e-6)


def test_recipe_reads_the_corpus_only_through_the_native_loader():
    """A data_dir goes to the VOCdevkit reader (``subsets.voc``), which
    finds no split list under a missing directory."""
    with pytest.raises(FileNotFoundError, match="ImageSets/Segmentation"):
        recipes.build_trainer(_cfg(data_dir="/nonexistent"), False,
                              device=torch.device("cpu"))


def test_recipe_as_written_is_shrunk_for_a_synthetic_run():
    """The recipe's parts: 96 x 96 crops (JAX's synthetic shrink), its
    momentum optimizer on the poly schedule with decay off norms, the
    mIoU evaluator with the ignore label, ``spatial`` accepted and
    inert."""
    trainer, train_set, val_set = recipes.build_trainer(
        _cfg(spatial=True), True, device=torch.device("cpu"))
    assert trainer.model.input_hw == (96, 96)
    assert train_set.source.images.shape[1:] == (96, 96, 3)
    assert trainer.evaluator.name == "miou"
    assert trainer.evaluator.ignore_label == 255
    assert trainer.policy.compute_dtype == torch.bfloat16
    assert trainer.optimizer.momentum == 0.9
    lr = trainer.optimizer.schedule
    np.testing.assert_allclose([lr(0), lr(15000), lr(30000)],
                               [0.007, 0.007 * 0.5 ** 0.9, 0.0], rtol=1e-6)


def test_segmenter_trainer_builds_the_recipe_at_a_given_crop():
    """``recipes.segmenter_trainer`` (what ``build_segmenter`` builds after
    its synthetic shrink, and what a run at the recipe's own crop calls):
    the model sized for the chain's crop (its dropout mask at the ASPP
    map, 65 / 16 rounded up = 5), the recipe's accumulation and log
    settings, the paired chain's crop."""
    cfg = _cfg(accum_steps=2, log_every=3)
    aug = recipes.make_augment(cfg["augment"])._replace(out_hw=(65, 65))
    trainer = recipes.segmenter_trainer(cfg, aug, torch.device("cpu"))
    assert trainer.model.input_hw == (65, 65)
    assert trainer.accum_steps == 2 and trainer.log_every == 3
    draws = trainer.sample(4, (80, 80))
    assert [tuple(m["dropout"].shape) for m in draws.masks] == \
        [(2, 5, 5, 256)] * 2
    x = torch.zeros(4, 80, 80, 3, dtype=torch.uint8)
    y = torch.zeros(4, 80, 80, dtype=torch.int64)
    xa, ya = trainer.input_fns.train(x, y, draws.recipe)
    assert xa.shape == (4, 65, 65, 3) and ya.shape == (4, 65, 65)


def test_recipe_trains_and_tests_on_the_cpu(tmp_path):
    """``train.main`` for 3 steps with a validation (the masks resized with
    the images) and ``test.main`` on its checkpoint, with and without
    ``--scales``: the restored model gives the writer's logits.  The train
    accuracy is JAX's: argmax against the mask over every pixel, the
    ignore label's included."""
    out = str(tmp_path / "run")
    args = ["--config", CONFIG, "--synthetic", "--device", "cpu",
            "--set", "model_kwargs.backbone_depth=18",
            "--set", "synthetic_n=8", "--batch", "4"]
    net = train.main(args + ["--steps", "3", "--val_every", "2",
                                 "--out", out, "--set", "log_every=1"])
    trainer = net.trainer
    assert trainer.step == 3
    score, restored_net = test.main(args + ["--ckpt", out])
    restored = restored_net.trainer
    ms_score, _ = test.main(args + ["--ckpt", out, "--scales",
                                    "0.75,1.0,1.25"])
    assert 0.0 <= score <= 1.0 and 0.0 <= ms_score <= 1.0
    xs, ys = [torch.from_numpy(a) for a in _pairs()]
    assert torch.equal(restored.eval_step(xs), trainer.eval_step(xs))
    out_pair, y_pair = trainer.eval_batch(xs, ys)
    assert out_pair.shape == (4, 96, 96, CLASSES)
    assert torch.equal(y_pair, ys)     # 96 -> 96: the resize keeps labels

    ys = ys.clone()
    ys[:, :20] = 255
    draws = trainer.sample(4, (96, 96))
    _, logits, y_aug = trainer.loss_and_grads(xs, ys, draws)
    metrics = trainer.train_step(xs, ys, draws)
    hit = (logits.argmax(-1) == y_aug).float()
    assert (y_aug == 255).any()
    assert float(metrics["accuracy"]) == float(hit.mean())


def _pairs(n=4):
    from myconvnet_tpu_torch.subsets import voc
    return voc.synthetic_subset(n, (96, 96), 3)
