"""The port's monocular-depth slice against the JAX package, on the CPU.

The 16-bit depth PNG pairs (written here with Pillow) and the synthetic
fogged scenes, the DispNet ``depth_unet`` on a ResNet-18 at a small
decoder (``decoder_width=8``, 64 x 96) and ``tinydepth``, the
scale-invariant log loss, the Eigen evaluator, the recipe's input chain
at JAX's draws, its eval routing, and the entry points end to end: a
tiny run's checkpoint read by both packages, ``test --save_preds`` and
``--export``, ``serve --artifact --depth`` and the ``depth`` route.

Tolerances: the readers and the synthetic scenes equal JAX's bit for bit;
float32 eval depth within 1e-4 of the largest; one float32 train step
(batch 4): the loss 1e-4 relative, the gradient tree within 1e-3 of its
largest and each leaf within 5e-3 of its own largest, the BN statistics
1e-4 (the bounds of PR 11's ill-conditioned classifiers: a ReLU
pre-activation near 0 takes its derivative either way, and those derivatives
are taken where JAX's pre-activation is positive); the loss and its gradient
1e-6 (relative, plus 1e-6 of the largest gradient); the evaluator 1e-9; the
input chain 1e-6; the artifact within 1e-4 of JAX's StableHLO artifact of
the same weights and bit for bit against its in-memory program;
``--save_preds`` files equal JAX's except where a float32 disagreement (1e-4
of a metre) carries a value across an integer step of the 16-bit or 8-bit
scale.
"""

import argparse
import base64
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from myconvnet_tpu import export_cli as jexport_cli
from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu import serving as jserving
from myconvnet_tpu import serving_http as jhttp
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.eval.depth import DepthEvaluator as JDepthEvaluator
from myconvnet_tpu.subsets import depth as jdepth
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu_torch import (recipes, serve, serving, serving_http,
                                 weights)
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.data.augment import JitterDraws
from myconvnet_tpu_torch.eval.depth import DepthEvaluator
from myconvnet_tpu_torch.models import blocks, resnet
from myconvnet_tpu_torch.models.depth import DEPTH_MODELS
from myconvnet_tpu_torch.subsets import depth as tdepth
from myconvnet_tpu_torch.train import losses

from test_torch_seg_family import check_grads_with_kinks, spy_relus
from test_torch_zoo import assert_trees_close

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "nyu_depth_unet.py")
# case: (registry name, kwargs of both packages, input hw, weight seed)
MODELS = {"depth_unet": ("depth_unet", dict(depth=18, decoder_width=8),
                         (64, 96), 0),
          "tinydepth": ("tinydepth", dict(width=8), (32, 48), 1)}
TINY = ["model=tinydepth", "model_kwargs={}", "input_hw=[32,48]",
        "synthetic_n=8"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_fn(name, kw):
    fn = jmodels.DEPTH_MODELS[name]
    return transform(lambda x, train: fn(x, 0, train=train, **kw))


def make_trees(case):
    name, kw, _, seed = MODELS[case]
    model = DEPTH_MODELS[name](0, **kw)
    params, state = weights.random_jax_params(model, seed)
    rng = np.random.RandomState(50 + seed)
    for p in params.values():
        if "b" in p:
            p["b"] = (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)
    return params, state


def frames(seed, hw, n=2):
    return np.random.RandomState(seed).rand(n, *hw, 3).astype(np.float32)


# ----------------------------------------------------------------- data


def test_depth_pairs_read_the_16_bit_pngs_as_jax(tmp_path):
    """Frames and 16-bit millimetre PNGs (Pillow's ``I;16``) at another
    size than the recipe's: the pairing, the bilinear RGB and nearest
    depth resize, the scale to metres, equal to JAX's reader."""
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        os.makedirs(tmp_path / split / "rgb")
        os.makedirs(tmp_path / split / "depth")
        for i in range(3):
            Image.fromarray(rng.randint(0, 256, (40, 52, 3)).astype(
                np.uint8)).save(tmp_path / split / "rgb" / f"f{i}.png")
            mm = rng.randint(0, 12000, (40, 52)).astype(np.uint16)
            mm[:3] = 0   # no return
            Image.fromarray(mm).save(tmp_path / split / "depth" / f"f{i}.png")
    for split in ("train", "val"):
        assert tdepth.read_subset(str(tmp_path), split) == \
            jdepth.read_subset(str(tmp_path), split)
    mine = tdepth.make_source(str(tmp_path), "val", hw=(32, 48))
    theirs = jdepth.make_source(str(tmp_path), "val", hw=(32, 48))
    got, want = mine.get_batch([2, 0]), theirs.get_batch([2, 0])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[1].max() > 10.0 and (got[1] == 0).any()
    mine.close()
    os.remove(tmp_path / "val" / "depth" / "f1.png")
    with pytest.raises(FileNotFoundError, match="twin"):
        tdepth.read_subset(str(tmp_path), "val")


def test_synthetic_scenes_equal_jax_exactly():
    for seed in (0, 1):
        got = tdepth.synthetic_depth_scenes(6, (32, 48), seed=seed)
        want = jdepth.synthetic_depth_scenes(6, (32, 48), seed=seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- models


@pytest.mark.parametrize("case", list(MODELS))
def test_scopes_match_the_jax_init_tree(case):
    name, kw, hw, _ = MODELS[case]
    jparams, jstate = jax.eval_shape(lambda: jax_fn(name, kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), False))
    p2, s2 = weights.to_jax(DEPTH_MODELS[name](0, **kw))
    assert set(p2) == set(jparams) and set(s2) == set(jstate)
    for tree, mine in ((jparams, p2), (jstate, s2)):
        for scope in tree:
            assert {n: v.shape for n, v in mine[scope].items()} == \
                {n: tuple(v.shape) for n, v in tree[scope].items()}, scope


@pytest.mark.parametrize("case", list(MODELS))
def test_eval_depth_matches_jax(case):
    name, kw, hw, _ = MODELS[case]
    params, state = make_trees(case)
    x = frames(5, hw)
    fn = jax_fn(name, kw)

    def apply(p, s, v):
        with policy_scope(JFULL):
            return fn.apply(p, s, None, v, False)[0]

    want = np.asarray(jax.jit(apply)(params, state, jnp.asarray(x)))
    model = weights.from_jax(DEPTH_MODELS[name](0, **kw), params,
                             state).eval()
    with torch.no_grad():
        out = model(_t(x))
    assert out.dtype == torch.float32 and out.shape == (2, *hw, 1)
    assert float(out.min()) >= 0.1 - 1e-6 and float(out.max()) <= 10.0
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_depth_models_refuse_bad_sizes_and_group_norm():
    with pytest.raises(ValueError, match="divisible by 32"):
        DEPTH_MODELS["depth_unet"](0, decoder_width=8)(torch.zeros(
            1, 48, 64, 3))
    with pytest.raises(ValueError, match="divisible by 8"):
        DEPTH_MODELS["tinydepth"](0)(torch.zeros(1, 36, 48, 3))
    with pytest.raises(ValueError, match="not ported"):
        DEPTH_MODELS["depth_unet"](0, norm="group")


@pytest.mark.parametrize("case", list(MODELS))
def test_train_step_matches_jax_f32(case, monkeypatch):
    """One float32 train step under the recipe's loss: the depth, the
    loss, the BN moving statistics, and the gradients with each ReLU's
    derivative taken where JAX's pre-activation is positive
    (``test_torch_seg_family.check_grads_with_kinks``): the tree within
    1e-3 of its largest, each leaf within 5e-3 of its own."""
    name, kw, hw, _ = MODELS[case]
    params, state = make_trees(case)
    x = frames(6, hw, 4)
    y = np.random.RandomState(7).uniform(0.5, 9.5, (4, *hw, 1)).astype(
        np.float32)
    y[:, :2] = 0.0   # invalid rows
    fn = jax_fn(name, kw)
    relus = spy_relus(monkeypatch)

    def jloss(p):
        relus.clear()
        with policy_scope(JFULL):
            out, new_state = fn.apply(p, state, None, jnp.asarray(x), True)
        return jlosses.silog_loss(out, jnp.asarray(y)), \
            (out, new_state, list(relus))

    (jl, (jout, jstate, jzs)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    seen = {}

    def step():
        model = weights.from_jax(DEPTH_MODELS[name](0, **kw), params,
                                 state).train()
        out = model(_t(x))
        loss = losses.silog_loss(out, _t(y))
        loss.backward()
        seen.update(out=out.detach(), loss=float(loss.detach()),
                    state=weights.to_jax(model)[1])
        return model

    check_grads_with_kinks(step, jgrads, jzs, monkeypatch, bound=5e-3,
                           tree_bound=1e-3)
    np.testing.assert_allclose(seen["out"].numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-4 * np.abs(jout).max())
    np.testing.assert_allclose(seen["loss"], float(jl), rtol=1e-4)
    if jstate:
        assert_trees_close(seen["state"], jstate, 1e-4, "bn state")


def count_routes(model, x, monkeypatch):
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


def test_eval_routing_at_the_recipes_width(monkeypatch):
    """Under bf16 at the recipe's widths (ResNet-18, decoder_width 32):
    B4 at the encoder's 5 stride-1 ``conv_a`` and the decoder's 10 convs,
    B1 after the stem and the 3 stride-2 ``conv_a``; float32 takes cuDNN +
    B1 everywhere."""
    model = DEPTH_MODELS["depth_unet"](0, depth=18)
    x = torch.zeros(1, 64, 64, 3, dtype=torch.bfloat16)
    assert count_routes(model, x, monkeypatch) == {"b1": 4, "b4": 15,
                                                   "b5": 0}
    assert count_routes(model, x.float(), monkeypatch) == {"b1": 19,
                                                           "b4": 0,
                                                           "b5": 0}


# ----------------------------------------------------- losses, metrics


def test_silog_loss_and_gradient_match_jax():
    """With invalid pixels, a prediction at the ``eps`` floor (a tie of
    ``jnp.maximum``, whose gradient splits) and lam 0.5 and 0."""
    rng = np.random.RandomState(3)
    pred = rng.uniform(0.2, 9.0, (2, 6, 8, 1)).astype(np.float32)
    pred[0, 0, 0] = 1e-6
    pred[0, 0, 1] = -0.5
    gt = rng.uniform(0.2, 9.0, (2, 6, 8, 1)).astype(np.float32)
    gt[1, :2] = 0.0
    for lam in (0.5, 0.0):
        jl, jg = jax.value_and_grad(lambda p: jlosses.silog_loss(
            p, jnp.asarray(gt), lam=lam))(jnp.asarray(pred))
        p = _t(pred).requires_grad_(True)
        loss = losses.silog_loss(p, _t(gt), lam=lam)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=1e-6)
        got, want = p.grad.numpy().copy(), np.array(jg)
        # the tie's (half) gradient is ~1e5 (1 / eps); every other within
        # 1e-6 relative plus 1e-6 of their largest
        np.testing.assert_allclose(got[0, 0, 0], want[0, 0, 0], rtol=1e-6)
        assert float(got[0, 0, 0, 0]) != 0.0
        got[0, 0, 0] = want[0, 0, 0] = 0.0
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("kw", [
    dict(), dict(metric="delta1"), dict(metric="rmse", median_scaling=True),
    dict(metric="log10", min_depth=0.5, max_depth=8.0)])
def test_depth_evaluator_matches_jax(kw):
    rng = np.random.RandomState(4)
    mine, theirs = DepthEvaluator(**kw), JDepthEvaluator(**kw)
    for _ in range(3):
        p = rng.uniform(0.1, 10.0, (3, 8, 10, 1)).astype(np.float32)
        g = rng.uniform(0.1, 10.0, (3, 8, 10, 1)).astype(np.float32)
        g[0, :3] = 0.0
        g[2] = 0.0    # no valid pixel: the image does not count
        mine.update(_t(p), _t(g))
        theirs.update(p, g)
    assert mine.higher_is_better == theirs.higher_is_better
    np.testing.assert_allclose(mine.score(), theirs.score(), rtol=1e-9)
    for k, v in theirs.report().items():
        np.testing.assert_allclose(mine.report()[k], v, rtol=1e-9)


# ------------------------------------------------------------ the recipe


def _tiny_cfg(**sets):
    cfg = recipes.apply_overrides(recipes.load_config(CONFIG), TINY)
    cfg.update(sets)
    return cfg


def test_depth_input_chain_matches_jax():
    """The recipe's train input at JAX's draws: the flip of frame and
    depth together, brightness and contrast on the frame alone, the clip;
    the eval input is x / 255 (B2 at mean 0, std 1)."""
    cfg = _tiny_cfg()
    net, train_set, _ = jrecipes.build_depth(cfg, synthetic=True)
    train_fn, eval_fn, _ = net.augment_fns
    x, y = train_set.source.get_batch(np.arange(6))
    key = jax.random.PRNGKey(11)
    jx, jy = train_fn(key, jnp.asarray(x), jnp.asarray(y))
    kf, kj = jax.random.split(key)
    k_b, k_c, _, _ = jax.random.split(kj, 4)
    draws = recipes.DepthDraws(
        _t(np.array(jax.random.bernoulli(kf, 0.5, (6, 1, 1, 1))).reshape(6)),
        JitterDraws(_t(np.array(jax.random.uniform(
            k_b, (6,), minval=-0.2, maxval=0.2))), _t(np.array(
                jax.random.uniform(k_c, (6,), minval=0.8, maxval=1.2)))))
    assert draws.flip.any() and not draws.flip.all()
    fns = recipes.depth_input_fns(0.2, 0.2)
    tx, ty = fns.train(_t(x), _t(y), draws)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(fns.eval(_t(x)).numpy(),
                               np.asarray(eval_fn(jnp.asarray(x), None)[0]),
                               atol=1e-7)


def _jax_entry(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_entry", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pixels(path):
    return np.asarray(Image.open(path)).astype(np.int64)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 2-step float32 tinydepth run of the port (its checkpoint read by
    both packages), its config file and the JAX ConvNet restored from
    it."""
    tmp = tmp_path_factory.mktemp("depth")
    out = str(tmp / "run")
    sets = [*TINY, "precision=f32"]
    common = ["--config", CONFIG, "--synthetic", "--device", "cpu",
              *[a for kv in sets for a in ("--set", kv)]]
    net = train_entry.main(common + ["--steps", "2", "--batch", "4",
                                     "--val_every", "2", "--out", out])
    cfg = recipes.apply_overrides(recipes.load_config(CONFIG), sets)
    jnet, _, jval = jrecipes.build_depth(cfg, synthetic=True)
    jnet.build(jrecipes.make_optimizer(cfg["optimizer"]))
    jnet.restore(out)
    return dict(tmp=tmp, out=out, common=common, net=net, cfg=cfg,
                jnet=jnet, jval=jval, sets=sets)


def test_train_and_test_entry_points(run):
    assert run["net"].trainer.step == 2
    with open(os.path.join(run["out"], "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert any("val_depth" in r for r in rows)
    score, net = test_entry.main(run["common"] + ["--ckpt", run["out"],
                                                  "--report"])
    assert np.isfinite(score) and net.trainer.step == 2
    want = run["jnet"].evaluate(run["jval"],
                                jrecipes.build_evaluator(run["cfg"]),
                                batch_size=run["cfg"]["batch_size"])
    np.testing.assert_allclose(score, want, rtol=1e-4)


def _save_preds_close(mine, theirs, names):
    for name in names:
        a, b = _pixels(os.path.join(mine, name)), _pixels(
            os.path.join(theirs, name))
        assert a.shape == b.shape, name
        off = np.abs(a - b)
        assert off.max() <= 1, name
        assert (off == 0).mean() > 0.99, name


def test_save_preds_writes_jaxs_depth_files(run, monkeypatch):
    """``test --save_preds`` against JAX's ``test.py --save_preds`` on the
    same checkpoint: the same file names; the 16-bit millimetres and the
    8-bit view equal but for values a float32 disagreement carries across
    one integer step (at most 1, at under 1% of the pixels); the
    millimetres equal the eval forward's depth x 1000, clipped."""
    mine, theirs = str(run["tmp"] / "mine"), str(run["tmp"] / "theirs")
    test_entry.main(run["common"] + ["--ckpt", run["out"], "--save_preds",
                                     mine])
    monkeypatch.setattr(sys, "argv", [
        "test.py", "--config", CONFIG, "--ckpt", run["out"], "--synthetic",
        "--save_preds", theirs,
        *[a for kv in run["sets"] for a in ("--set", kv)]])
    _jax_entry("test").main()
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(mine)) == names and len(names) == 16
    _save_preds_close(mine, theirs, names)
    val = tdepth.make_source(None, "val", synthetic_n=8, hw=(32, 48))
    d = run["net"].predict(val.imgs)[0, ..., 0]
    np.testing.assert_array_equal(
        np.asarray(Image.open(os.path.join(mine, "00000_depth16.png"))),
        np.clip(d * 1000.0, 0, 65535).astype(np.uint16))


@pytest.fixture(scope="module")
def arts(run):
    """The port's depth artifact (``test --export``) and JAX's of the same
    weights (its ``export_depth``)."""
    port = str(run["tmp"] / "depth.pt2")
    test_entry.main(run["common"] + ["--ckpt", run["out"], "--export", port])
    jpath = str(run["tmp"] / "depth.hlo")
    jexport_cli.export_depth(run["cfg"], argparse.Namespace(
        export=jpath, int8=False), run["jnet"], run["jval"])
    return port, jpath


def test_depth_artifact_matches_jax_and_its_program(run, arts):
    port, jpath = arts
    meta = serving.artifact_meta(port)
    assert meta["kind"] == "depth" and meta["input_shape"] == [4, 32, 48, 3]
    x = frames(8, (32, 48), 4)
    got = serving.load_inference(port, "cpu")(x)
    want = np.asarray(jserving.load_inference(jpath)(x))
    assert got.shape == (4, 32, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    route = serving_http.build_route("d", "depth", run["cfg"],
                                     ckpt=run["out"], batch=4, device="cpu")
    assert torch.equal(route.fn(torch.from_numpy(x)), got)


def _frame_dir(path, n=3):
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(12)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (40, 60, 3)).astype(
            np.uint8)).save(os.path.join(path, f"im{i}.png"))
    return path


def test_serve_depth_matches_jax_serve(run, arts, capsys, monkeypatch):
    port, jpath = arts
    images = _frame_dir(str(run["tmp"] / "frames"))
    monkeypatch.setattr(sys, "argv", ["serve.py", "--artifact", jpath,
                                      "--depth", "--images", images,
                                      "--out", str(run["tmp"] / "jout")])
    _jax_entry("serve").main()
    want = capsys.readouterr().out.splitlines()
    rows = serve.main(["--artifact", port, "--depth", "--images", images,
                       "--out", str(run["tmp"] / "pout"), "--device",
                       "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(rows) == 3 and len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.split(" -> ")[0] == w.split(" -> ")[0]


def test_depth_route_matches_jax_server(run, arts):
    """The ``depth`` route (in memory, from the recipe and checkpoint, and
    on the artifact) against JAX's ``ModelServer`` on its artifact: the
    same reply fields, metres within 1e-4 of the largest, PNG levels
    within 1."""
    port, jpath = arts
    x = frames(9, (32, 48), 2)
    body = json.dumps({"instances": x.tolist()}).encode()
    want = jhttp.ModelServer([jhttp.build_route("d", "depth", jpath)]
                             ).predict("d", body)["depths"]
    for route in (serving_http.artifact_route("d", "depth", port,
                                              device="cpu"),
                  serving_http.build_route("d", "depth", run["cfg"],
                                           ckpt=run["out"], batch=4,
                                           device="cpu")):
        got = serving_http.ModelServer([route]).predict("d", body)["depths"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["size"] == w["size"] == [32, 48]
            for k in ("min", "max", "mean"):
                assert abs(g[k] - w[k]) <= 1e-4 * 10 + 1e-4, k
            a = np.asarray(Image.open(io.BytesIO(base64.b64decode(
                g["png"])))).astype(int)
            b = np.asarray(Image.open(io.BytesIO(base64.b64decode(
                w["png"])))).astype(int)
            assert np.abs(a - b).max() <= 1
    # an image body: decoded to the route's size, B2 at mean 0 and std 1
    buf = io.BytesIO()
    Image.fromarray((x[0] * 255).astype(np.uint8)).save(buf, "PNG")
    got = serving_http.ModelServer([serving_http.artifact_route(
        "d", "depth", port, device="cpu")]).predict(
            "d", buf.getvalue(), "image/png")
    assert got["depths"][0]["size"] == [32, 48]


@pytest.mark.parametrize("config,sets,names", [
    ("voc_unet.py", ["model_kwargs.base_features=8", "model_kwargs.depth=3",
                     "precision=f32"], ("mask", "overlay")),
    ("chairs_pwcnet.py", ["model=tinypwc", "input_hw=[32,32]",
                          "synthetic_n=16", "precision=f32"], ("flow",))],
    ids=["segmentation", "flow"])
def test_save_preds_writes_jaxs_files_for_segmentation_and_flow(
        tmp_path, monkeypatch, config, sets, names):
    """``test --save_preds`` of a 1-step run of the port, against JAX's
    ``test.py --save_preds`` on the same checkpoint: the same files; the
    colourized masks and overlays, and the flow's colour wheel, within
    one level where a near-tie or a float32 disagreement moves a pixel
    (under 1% of them); the ``.flo`` flows within 1e-4 of the largest."""
    cfg_path = os.path.join(ROOT, "configs", config)
    out = str(tmp_path / "run")
    common = ["--config", cfg_path, "--synthetic", "--device", "cpu",
              *[a for kv in sets for a in ("--set", kv)]]
    train_entry.main(common + ["--steps", "1", "--batch", "4", "--out",
                               out])
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    test_entry.main(common + ["--ckpt", out, "--save_preds", mine])
    monkeypatch.setattr(sys, "argv", [
        "test.py", "--config", cfg_path, "--ckpt", out, "--synthetic",
        "--save_preds", theirs, *[a for kv in sets for a in ("--set", kv)]])
    _jax_entry("test").main()
    files = sorted(os.listdir(theirs))
    assert sorted(os.listdir(mine)) == files
    assert {f.split("_", 1)[1].split(".")[0] for f in files} == set(names)
    for f in files:
        if f.endswith(".flo"):
            from myconvnet_tpu_torch.subsets.flow import read_flo
            a = read_flo(os.path.join(mine, f))
            b = read_flo(os.path.join(theirs, f))
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max())
        else:
            _save_preds_close(mine, theirs, [f])


@pytest.mark.parametrize("config", ["cifar100_resnet18.py", "voc_ssd300.py"])
def test_save_preds_of_a_task_that_writes_none_is_refused(tmp_path, config):
    with pytest.raises(SystemExit, match="--save_preds writes"):
        test_entry.main(["--config", os.path.join(ROOT, "configs", config),
                         "--ckpt", str(tmp_path), "--device", "cpu",
                         "--save_preds", str(tmp_path / "p")])
