"""The port's ViT training path against the JAX package, on the CPU.

AdamW with global-norm clipping and the warmup-cosine schedule, gradient
accumulation, the crop-resize augmentation, the synthetic ImageNet split
and Adam checkpoints, each held against the JAX package on the same seeded
numpy inputs (JAX's random draws are made from its keys and handed to the
port).  The model is ``tinyvit`` (2 blocks, dim 32, 8x8 input, patch 4).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.models.base import ConvNet
from myconvnet_tpu.subsets import imagenet as jimagenet
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu.train import optim as joptim
from myconvnet_tpu.train.optim import AdamState
from myconvnet_tpu_torch import models, recipes, weights
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.core.precision import FULL
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.data.randaugment import RandAugmentDraws
from myconvnet_tpu_torch.subsets import imagenet
from myconvnet_tpu_torch.train import losses, optim
from myconvnet_tpu_torch.train.trainer import Trainer, TrainState

torch.set_num_threads(1)

CLASSES, HW, BATCH = 10, 8, 8
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "imagenet_vit_b16.py")
# the recipe's optimizer with a schedule short enough that three steps see
# the warmup and the cosine both
OPT = dict(name="adamw", b1=0.9, b2=0.999, weight_decay=0.05,
           wd_exclude_norms=True, clip_norm=1.0,
           lr=dict(kind="cosine", lr=1e-3, total_steps=5, alpha=1e-5,
                   warmup_steps=2))
# the tiny ViT run of the README: RandAugment off, 32x32 from 40x40
TINY = ["model=tinyvit", "input_hw=[32,32]", "augment.out_hw=[32,32]",
        "raw_hw=[40,40]", "augment.randaugment=None"]


def _np_tree(tree):
    return {s: {n: np.array(v) for n, v in d.items()}
            for s, d in tree.items()}


def _assert_trees_close(got, want, rtol, what):
    assert set(got) == set(want), what
    for scope in want:
        assert set(got[scope]) == set(want[scope]), (what, scope)
        for name, ref in want[scope].items():
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                got[scope][name], ref, rtol=rtol,
                atol=rtol * max(np.abs(ref).max(), 1e-30),
                err_msg=f"{what} {scope}/{name}")


@pytest.fixture(scope="module")
def params():
    """Random JAX-layout weights of tinyvit (non-zero biases)."""
    model = models.tinyvit(CLASSES, input_hw=(HW, HW))
    p, _ = weights.random_jax_params(model, 0)
    rng = np.random.RandomState(1)
    for d in p.values():
        if "b" in d:
            d["b"] = (0.05 * rng.randn(*d["b"].shape)).astype(np.float32)
    return p


def _trainer(params, **kw):
    model = weights.from_jax(models.tinyvit(CLASSES, input_hw=(HW, HW)),
                             params, {})
    return Trainer(model, recipes.make_optimizer(model, OPT),
                   losses.softmax_cross_entropy, device="cpu", policy=FULL,
                   num_classes=CLASSES, **kw)


def _adam_state(state: AdamState) -> dict:
    return {".mu": _np_tree(state.mu), ".nu": _np_tree(state.nu)}


def _net(**kw):
    return ConvNet(jmodels.tinyvit, input_shape=(HW, HW, 3),
                   num_classes=CLASSES, precision="f32",
                   loss_fn=jlosses.softmax_cross_entropy, **kw)


# ------------------------------------------------------------- optimizer


def test_decay_mask_excludes_tokens_and_norms_like_jax(params):
    want = joptim._decay_mask(params, joptim.norm_and_bias_exclusion)
    model = weights.from_jax(models.tinyvit(CLASSES, input_hw=(HW, HW)),
                             params, {})
    got = optim.decay_mask([(path, p) for path, p, _ in
                            weights.param_views(model)],
                           optim.norm_and_bias_exclusion)
    assert got == {f"{s}/{n}": bool(v) for s, d in want.items()
                   for n, v in d.items()}
    assert not any(got[k] for k in ("~/cls_token", "~/pos_embed",
                                    "block1/ln1/gamma", "ln/beta",
                                    "block2/qkv/b"))
    assert got["block2/qkv/w"] and got["patch_embed/w"]


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_jax(scale):
    """JAX's min(1, max / max(norm, 1e-12)), not torch's max / (norm +
    1e-6): below the threshold the gradients stay as they are."""
    rng = np.random.RandomState(2)
    grads = [(scale * rng.randn(*s)).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    want, jnorm = joptim.clip_by_global_norm(
        {str(i): g for i, g in enumerate(grads)}, 1.0)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = optim.clip_by_global_norm(got, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[str(i)]),
                                   rtol=1e-6, atol=1e-7)
    if scale < 1:
        np.testing.assert_array_equal(got[0].numpy(), grads[0])


def test_momentum_with_clip_norm_matches_jax():
    """``clip_norm`` on the SGD family, as JAX's with_gradient_clipping
    around nesterov momentum with coupled decay: within 1e-6."""
    rng = np.random.RandomState(5)
    p = {"a": {"w": rng.randn(3, 4).astype(np.float32)}}
    g = {"a": {"w": (5 * rng.randn(3, 4)).astype(np.float32)}}
    jopt = joptim.with_gradient_clipping(
        joptim.momentum(0.1, 0.9, nesterov=True, weight_decay=1e-3), 1.0)
    want, _ = jopt.update(g, jopt.init(p), p, jnp.asarray(0))
    w = torch.nn.Parameter(torch.from_numpy(p["a"]["w"].copy()))
    opt = optim.make_optimizer([("a/w", w)], "momentum", 0.1, nesterov=True,
                               weight_decay=1e-3, clip_norm=1.0)
    w.grad = torch.from_numpy(g["a"]["w"].copy())
    opt.step(0)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(want["a"]["w"]),
                               rtol=1e-6, atol=1e-6)


def test_adamw_clip_warmup_cosine_steps_match_jax(params):
    """Three steps of the recipe's optimizer (AdamW, decay off norms,
    biases and the embedding tokens, clipping at 1.0, warmup + cosine)
    with gradients whose norm is 5, 0.5 and 3, each port step starting
    from JAX's parameters and moments: parameters, mu and nu within
    1e-5."""
    jopt = jrecipes.make_optimizer(OPT)
    jparams, jstate = params, jopt.init(params)
    port = _trainer(params)
    rng = np.random.RandomState(3)
    for i, target in enumerate((5.0, 0.5, 3.0)):
        grads = {s: {n: rng.randn(*v.shape).astype(np.float32)
                     for n, v in d.items()} for s, d in jparams.items()}
        norm = np.sqrt(sum((g ** 2).sum() for d in grads.values()
                           for g in d.values()))
        grads = {s: {n: g * np.float32(target / norm) for n, g in d.items()}
                 for s, d in grads.items()}
        port.load_state(TrainState(_np_tree(jparams), {},
                                   _adam_state(jstate), np.asarray(i),
                                   np.asarray([0])))
        for path, p, view in weights.param_views(port.model):
            scope, name = path.rsplit("/", 1)
            g = torch.empty_like(p)
            view(g).copy_(torch.from_numpy(grads[scope][name]))
            p.grad = g
        port.optimizer.step(i)
        jparams, jstate = jopt.update(grads, jstate, jparams,
                                      jnp.asarray(i, jnp.int32))
        got = port.state()
        _assert_trees_close(got.params, jparams, 1e-5, f"step {i} params")
        for field, tree in _adam_state(jstate).items():
            _assert_trees_close(got.opt_state[field], tree, 1e-5,
                                f"step {i} {field}")


# --------------------------------------------------- gradient accumulation


def test_accum_steps_match_the_jax_microbatch_scan(params):
    """One step at accum_steps=2 on a batch of 8: the loss (the
    microbatches' mean), and the parameters and momentum after the update
    (the microbatch gradients summed in float32, divided by 2), within
    1e-4.  The optimizer is nesterov momentum, linear in the gradient:
    Adam's first step divides each gradient by its own magnitude, and the
    key projection's bias has a gradient of pure round-off (softmax does
    not see it), which Adam would blow up to a full step either way."""
    opt = dict(name="momentum", momentum_coef=0.9, nesterov=True,
               weight_decay=5e-4, wd_exclude_norms=True, lr=0.1)
    rng = np.random.RandomState(4)
    x = rng.randn(BATCH, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, BATCH).astype(np.int32)
    net = _net(accum_steps=2)
    net.build(jrecipes.make_optimizer(opt))
    jstate = net.state._replace(params=params)
    model = weights.from_jax(models.tinyvit(CLASSES, input_hw=(HW, HW)),
                             params, {})
    port = Trainer(model, recipes.make_optimizer(model, opt),
                   losses.softmax_cross_entropy, device="cpu", policy=FULL,
                   num_classes=CLASSES, accum_steps=2)
    jstep = net._make_trainer(None)._train_step  # donates its state
    new, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
    tm = port.train_step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    got = port.state()
    _assert_trees_close(got.params, new.params, 1e-4, "params")
    _assert_trees_close(got.opt_state, new.opt_state, 1e-4, "momentum")
    with pytest.raises(ValueError, match="microbatches"):
        _trainer(params, accum_steps=3).train_step(torch.from_numpy(x),
                                                   torch.from_numpy(y))


# ----------------------------------------------------------- augmentation


def _u8(n, hw, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, hw, hw, 3),
                                               dtype=np.uint8)


@pytest.mark.parametrize("clamp", [True, False])
def test_batched_crop_resize_matches_jax(clamp):
    """At JAX's random-resized boxes and flips, float32 on both sides:
    within 1e-5 of the pixel scale (255)."""
    x = _u8(4, 40, 5)
    kb, kf = jax.random.split(jax.random.PRNGKey(6))
    boxes = jaug.random_resized_crop_boxes(kb, 4, (40, 40))
    if not clamp:  # boxes that reach past the frame
        boxes = boxes + jnp.asarray([-3.0, 2.5, 4.0, 1.0])
    flip = jax.random.bernoulli(kf, 0.5, (4,))
    want = jaug.batched_crop_resize(x, boxes, (32, 24), flip, clamp=clamp)
    got = taug.batched_crop_resize(torch.from_numpy(x),
                                   torch.from_numpy(np.array(boxes)),
                                   (32, 24), torch.from_numpy(np.array(flip)),
                                   clamp=clamp)
    assert got.shape == (4, 32, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * 255)


def test_augment_train_resized_matches_jax():
    """The recipe's random-resized crop + flip + normalize from 40x40 to
    32x32 with the draws JAX's augment_train makes from its key
    (``augment.py:358-359``): within 1e-5."""
    cfg = dict(out_hw=(32, 32), area_range=(0.08, 1.0), flip=True)
    jcfg, tcfg = jaug.AugmentConfig(**cfg), taug.AugmentConfig(**cfg)
    x = _u8(6, 40, 7)
    key = jax.random.PRNGKey(8)
    want = jaug.augment_train(key, jnp.asarray(x), jcfg)
    k_geom = jax.random.split(key, 3)[0]
    boxes, flip, clamp = jaug._sample_geometry(k_geom, 6, (40, 40), jcfg)
    assert clamp
    got = taug.augment_train(torch.from_numpy(x),
                             torch.from_numpy(np.array(boxes)),
                             torch.from_numpy(np.array(flip)), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hw", [40, 32])
def test_augment_eval_matches_jax(hw):
    """The centre crop (0.875 of the shorter side) resized to 32x32, and
    at the model's size the normalize alone: within 1e-5."""
    cfg = dict(out_hw=(32, 32))
    x = _u8(3, hw, 9)
    want = jaug.augment_eval(jnp.asarray(x), jaug.AugmentConfig(**cfg))
    got = taug.augment_eval(torch.from_numpy(x), taug.AugmentConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_random_resized_crop_sampler_bounds():
    """The port's own draws: boxes inside the frame, clamped (not
    rejected), with the JAX sampler's area distribution within sampling
    noise."""
    g = torch.Generator().manual_seed(0)
    boxes, flip = taug.sample_geometry(
        g, 4096, (256, 256), taug.AugmentConfig(area_range=(0.08, 1.0)))
    b = boxes.numpy()
    assert (b[:, 2:] > 0).all() and (b[:, 2:] <= 256).all()
    assert (b[:, :2] >= 0).all()
    assert (b[:, 0] + b[:, 2] <= 256 + 1e-3).all()
    assert (b[:, 1] + b[:, 3] <= 256 + 1e-3).all()
    jb = np.asarray(jaug.random_resized_crop_boxes(jax.random.PRNGKey(0),
                                                   4096, (256, 256)))
    area, jarea = (v[:, 2] * v[:, 3] / 256 ** 2 for v in (b, jb))
    assert abs(area.mean() - jarea.mean()) < 0.02
    assert abs(flip.float().mean() - 0.5) < 0.03


# ------------------------------------------------------------------ data


def test_synthetic_imagenet_matches_jax_bit_for_bit():
    for seed in (0, 1):
        for a, b in zip(imagenet.synthetic_subset(8, raw_hw=(16, 16),
                                                  seed=seed),
                        jimagenet.synthetic_subset(8, raw_hw=(16, 16),
                                                   seed=seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    cfg = {"dataset": "imagenet", "raw_hw": [16, 16], "data_dir": None}
    for t, j in zip(recipes.make_sources(cfg, True),
                    jrecipes.make_sources(cfg, True)):
        assert t.images.shape == (256, 16, 16, 3)
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)
    with pytest.raises(FileNotFoundError, match="no 'train' directory"):
        imagenet.make_source("/nonexistent", "train")


# ------------------------------------------------------------ checkpoints


def test_adam_checkpoints_cross_between_the_packages(params, tmp_path):
    """A port checkpoint (after one step, so the moments are live) read by
    the JAX restore, and a JAX checkpoint read by the port: parameters and
    both Adam moments equal; the keys are the JAX trainer's
    (``opt_state::.mu::~::cls_token``)."""
    rng = np.random.RandomState(10)
    x = rng.randn(BATCH, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, BATCH).astype(np.int32)
    port = _trainer(params, ckpt_dir=str(tmp_path / "port"))
    port.train_step(torch.from_numpy(x), torch.from_numpy(y))
    path = port.save()
    with np.load(path) as f:
        assert "opt_state::.mu::~::cls_token" in f.files
        assert "opt_state::.nu::block2/mlp/fc1::w" in f.files
    net = _net()
    net.build(jrecipes.make_optimizer(OPT))
    net.restore(str(tmp_path / "port"))
    mine = port.state()
    assert int(net.state.step) == 1
    _assert_trees_close(_np_tree(net.state.params), mine.params, 0.0,
                        "params")
    for field, tree in _adam_state(net.state.opt_state).items():
        _assert_trees_close(tree, mine.opt_state[field], 0.0, field)

    jstep = net._make_trainer(None)._train_step
    net.state, _ = jstep(net.state, (jnp.asarray(x), jnp.asarray(y)))
    net.save(str(tmp_path / "jax"))
    other = _trainer(params)
    other.restore(str(tmp_path / "jax"))
    got = other.state()
    assert int(got.step) == 2
    _assert_trees_close(got.params, _np_tree(net.state.params), 0.0,
                        "params")
    for field, tree in _adam_state(net.state.opt_state).items():
        _assert_trees_close(got.opt_state[field], tree, 0.0, field)


# ---------------------------------------------------------- entry points


def test_vit_entry_points_on_the_cpu(tmp_path):
    """The README's tiny ViT run: the recipe with RandAugment off at
    32x32 from 40x40 raw images, 2 steps of 16 as 2 microbatches, then
    test.main restores the run."""
    out = str(tmp_path / "run")
    common = ["--config", CONFIG, "--synthetic", "--device", "cpu",
              *[a for kv in TINY for a in ("--set", kv)]]
    net = train_entry.main(common + ["--steps", "2", "--batch", "16",
                                         "--set", "accum_steps=2",
                                         "--out", out])
    trainer = net.trainer
    assert trainer.step == 2 and trainer.accum_steps == 2
    assert isinstance(trainer.optimizer, optim.Adam)
    assert trainer.model.block2.drop_path_rate == pytest.approx(0.1)
    score, restored_net = test_entry.main(common + ["--ckpt", out,
                                                    "--batch", "64"])
    restored = restored_net.trainer
    assert 0.0 <= score <= 1.0 and restored.step == 2
    a, b = trainer.state(), restored.state()
    _assert_trees_close(b.params, a.params, 0.0, "params")
    for field in (".mu", ".nu"):
        _assert_trees_close(b.opt_state[field], a.opt_state[field], 0.0,
                            field)


def test_vit_entry_point_with_randaugment_on_the_cpu(tmp_path):
    """The README's tiny ViT run with the recipe's RandAugment (2, 9), as
    written: 3 steps of 16 as 2 microbatches, every loss finite, each
    step's draws with two layers of op positions in the FAST pool."""
    out = str(tmp_path / "run")
    sets = [kv for kv in TINY if not kv.startswith("augment.randaugment")]
    net = train_entry.main([
        "--config", CONFIG, "--synthetic", "--device", "cpu",
        *[a for kv in sets for a in ("--set", kv)], "--steps", "3",
        "--batch", "16", "--set", "accum_steps=2", "--set", "log_every=1",
        "--out", out])
    trainer = net.trainer
    assert trainer.step == 3 and trainer.augment.randaugment == (2, 9)
    with open(os.path.join(out, "train.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
    draws = trainer.sample(16, (40, 40))
    assert isinstance(draws.policy, RandAugmentDraws)
    assert draws.policy.op.shape == (2, 16) and draws.policy.op.max() < 12
