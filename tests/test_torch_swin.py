"""The port's Swin Transformer against the JAX package, on the CPU.

Two small variants: the package's ``tinyswin`` ("test": 2 stages of one
block, dim 16, window 4, patch 2 at 32x32) and "test2", the same with two
blocks a stage, so that every stage has a shifted block (16x16 and 8x8
maps, window 4, shift 2), added to both ``VARIANTS`` tables for the test.
Weights are made with numpy from a seed in the JAX layout and loaded
through ``weights.from_jax``; drop-path masks are JAX's own draws,
recorded and handed to the port by site.  JAX's shift mask calls
``np.asarray`` on a ``jnp`` value, which ``jax.jit`` refuses to trace
(ROADMAP C), so the tests that trace JAX's Swin swap in the port's numpy
mask, which ``test_shift_mask_equals_jax`` holds equal to JAX's.
Tolerances: the window machinery exactly; float32 logits
within 1e-5 of max |JAX|, bf16 within 0.05; float32 gradients within 1e-4
of each leaf's largest; the optimizer within 1e-5; the artifact against
JAX's StableHLO one at the export tests' 0.05 (bf16) of max |JAX|.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu import serving as jserving
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import BF16 as JBF16
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu_torch import models, recipes, serving, serving_http, \
    weights
from myconvnet_tpu_torch.core.precision import BF16, FULL
from myconvnet_tpu_torch.train import losses
from myconvnet_tpu_torch.train.trainer import Trainer, TrainState

jswin = importlib.import_module("myconvnet_tpu.models.swin")
tswin = importlib.import_module("myconvnet_tpu_torch.models.swin")
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (2), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(2)


CLASSES, HW = 10, 32
TEST2 = (16, (2, 2), (2, 2), 4)
# the Swin-T recipe's optimizer with a schedule short enough that three
# steps see the warmup and the cosine both
OPT = dict(name="adamw", b1=0.9, b2=0.999, weight_decay=0.05,
           wd_exclude_norms=True, clip_norm=1.0,
           lr=dict(kind="cosine", lr=1e-3, total_steps=5, alpha=1e-5,
                   warmup_steps=2))


@pytest.fixture
def variants(monkeypatch):
    monkeypatch.setitem(jswin.VARIANTS, "test2", TEST2)
    monkeypatch.setitem(tswin.VARIANTS, "test2", TEST2)
    monkeypatch.setattr(jswin, "_shift_attn_mask", tswin.shift_attn_mask)


def _jax_fn(variant, **kw):
    kw.setdefault("patch", 2)
    kw.setdefault("drop_path_rate", 0.0)
    return transform(lambda x, train: jswin.swin(
        x, CLASSES, train=train, variant=variant, **kw))


def _port(variant, **kw):
    kw.setdefault("patch", 2)
    kw.setdefault("drop_path_rate", 0.0)
    return tswin.Swin(CLASSES, variant=variant, input_hw=(HW, HW), **kw)


def _params(variant, seed=0):
    """Random JAX-layout weights (non-zero dense biases, a bias table of
    0.3 so that it moves the scores)."""
    params, _ = weights.random_jax_params(_port(variant), seed)
    rng = np.random.RandomState(seed + 100)
    for p in params.values():
        if "b" in p:
            p["b"] = (0.05 * rng.randn(*p["b"].shape)).astype(np.float32)
        if "rel_bias" in p:
            p["rel_bias"] = (0.3 * rng.randn(*p["rel_bias"].shape)).astype(
                np.float32)
    return params


def _grad_tree(model):
    out = {}
    for path, p, view in weights.param_views(model):
        scope, name = path.rsplit("/", 1)
        out.setdefault(scope, {})[name] = view(p.grad).numpy()
    return out


def _assert_leaves_close(got, want, rtol, what):
    assert set(got) == set(want), what
    for scope, d in want.items():
        assert set(got[scope]) == set(d), (what, scope)
        for name, ref in d.items():
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                got[scope][name], ref, rtol=rtol,
                atol=rtol * max(np.abs(ref).max(), 1e-30),
                err_msg=f"{what} {scope}/{name}")


# ------------------------------------------------------- window machinery


@pytest.mark.parametrize("ws,hw", [(2, (8, 12)), (4, (8, 12)), (7, (14, 7))])
def test_window_partition_and_reverse_equal_jax(ws, hw):
    x = np.random.RandomState(0).randn(2, *hw, 5).astype(np.float32)
    want = np.asarray(jswin._window_partition(jnp.asarray(x), ws))
    got = tswin.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tswin.window_reverse(got, ws, hw, 2)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jswin._window_reverse(jnp.asarray(want), ws, hw, 2)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("ws", [2, 4, 7])
def test_relative_index_equals_jax(ws):
    want = jswin._relative_position_index(ws)
    got = tswin.relative_position_index(ws)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,ws,shift", [((8, 8), 4, 2), ((56, 56), 7, 3),
                                         ((14, 28), 7, 3)])
def test_shift_mask_equals_jax(hw, ws, shift):
    want = jswin._shift_attn_mask(hw, ws, shift)
    got = tswin.shift_attn_mask(hw, ws, shift)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_bias_gather_gradient_is_the_scatter_sum():
    """The table's gradient (each entry's positions summed in one fixed
    order, no atomics) equals ``jax.grad`` of JAX's gather, within float32
    round-off, and the gather itself is exact."""
    ws, heads = 4, 3
    rng = np.random.RandomState(5)
    table = rng.randn((2 * ws - 1) ** 2, heads).astype(np.float32)
    up = rng.randn(ws ** 4, heads).astype(np.float32)
    idx = jswin._relative_position_index(ws).reshape(-1)
    want = jax.grad(lambda t: jnp.sum(t[idx] * up))(jnp.asarray(table))
    attn = tswin.WindowAttention(heads * 4, heads, ws, None)
    with torch.no_grad():
        attn.rel_bias.copy_(torch.from_numpy(table))
    bias = attn.bias()
    np.testing.assert_array_equal(
        bias.detach().permute(1, 2, 0).reshape(-1, heads).numpy(),
        table[idx])
    (bias.permute(1, 2, 0).reshape(-1, heads) * torch.from_numpy(up)
     ).sum().backward()
    np.testing.assert_allclose(attn.rel_bias.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-5)


# ------------------------------------------------------------------ model


def test_scopes_and_weights_round_trip(variants):
    """The port's tree has the JAX init tree's scopes and shapes
    (``attn/rel_bias``, ``merge1/reduce`` without a bias), and from_jax ->
    to_jax gives the JAX arrays back bit for bit."""
    jparams = jax.eval_shape(
        lambda x: _jax_fn("test2").init(jax.random.PRNGKey(0), x, False)[0],
        jax.ShapeDtypeStruct((1, HW, HW, 3), jnp.float32))
    params, _ = weights.to_jax(_port("test2"))
    assert {s: {n: v.shape for n, v in d.items()}
            for s, d in params.items()} == \
        {s: {n: v.shape for n, v in d.items()} for s, d in jparams.items()}
    assert "rel_bias" in params["stage1_block2/attn"]
    assert set(params["merge1/reduce"]) == {"w"}
    trees = _params("test2")
    model = weights.from_jax(_port("test2"), trees, {})
    for scope, d in weights.to_jax(model)[0].items():
        for name, v in d.items():
            np.testing.assert_array_equal(v, trees[scope][name])


def test_swin_t_parameter_count_equals_jax(variants):
    """Swin-T's parameter count equals the JAX tree's (shapes only: JAX's
    init traced by ``eval_shape``), 28,288,354."""
    fn = transform(lambda x: jswin.swin_t(x, 1000))
    shapes = jax.eval_shape(lambda x: fn.init(jax.random.PRNGKey(0), x)[0],
                            jax.ShapeDtypeStruct((1, 224, 224, 3),
                                                 jnp.float32))
    want = sum(int(np.prod(v.shape)) for d in shapes.values()
               for v in d.values())
    model = models.get_model("swin_t", 1000, input_hw=(224, 224))
    assert sum(p.numel() for p in model.parameters()) == want == 28_288_354
    assert [(b.ws, b.shift) for b in model.blocks()] == \
        [(7, 0), (7, 3)] * 3 + [(7, 0), (7, 3)] * 2 + [(7, 0), (7, 0)]


@pytest.mark.parametrize("variant", ["test", "test2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_jax(variants, variant, dtype):
    params = _params(variant, seed=1)
    x = np.random.RandomState(2).randn(4, HW, HW, 3).astype(np.float32)
    bf16 = dtype == "bf16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    fn = _jax_fn(variant)
    with policy_scope(JBF16 if bf16 else JFULL):
        want = np.asarray(jax.jit(lambda p, v: fn.apply(
            p, {}, None, v, False)[0])(params, jnp.asarray(x, jdt)),
            np.float32)
    model = weights.from_jax(_port(variant), params, {}).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(
            torch.bfloat16 if bf16 else torch.float32)).float().numpy()
    tol = 0.05 if bf16 else 1e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _jax_step(fn, monkeypatch):
    """``step(params, x, y)`` -> JAX's train-mode loss, logits, gradients
    and Bernoulli draws (in draw order), one jitted program."""
    bernoulli = jax.random.bernoulli
    drawn = []

    def spy(key, p=0.5, shape=None):
        mask = bernoulli(key, p, shape)
        drawn.append(mask)
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", spy)

    def loss_fn(p, x, y):
        drawn.clear()
        with policy_scope(JFULL):
            logits, _ = fn.apply(p, {}, jax.random.PRNGKey(4), x, True)
        return (jlosses.softmax_cross_entropy(logits, y),
                (logits, list(drawn)))

    jitted = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def step(params, x, y):
        (loss, (logits, masks)), grads = jitted(params, jnp.asarray(x),
                                                jnp.asarray(y))
        return loss, logits, grads, [np.asarray(m) for m in masks]

    return step


def test_train_gradients_match_jax_f32(variants, monkeypatch):
    """A train step of "test2" with drop-path 0.5 (blocks 2-4 drop at
    1/6, 1/3 and 1/2): JAX's draws handed to the port by site; the loss,
    the logits and every gradient within 1e-4 (each leaf of its own
    largest)."""
    params = _params("test2", seed=3)
    rng = np.random.RandomState(4)
    x = rng.randn(4, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, 4).astype(np.int32)
    jloss, jlogits, jgrads, drawn = _jax_step(
        _jax_fn("test2", drop_path_rate=0.5), monkeypatch)(params, x, y)
    model = weights.from_jax(_port("test2", drop_path_rate=0.5), params,
                             {}).train()
    sites = list(model.sample_masks(4, torch.Generator().manual_seed(0)))
    assert sites == [f"stage{s}_block{b}/path_{w}" for s, b in
                     ((1, 2), (2, 1), (2, 2)) for w in ("attn", "mlp")]
    assert len(drawn) == len(sites) and not all(m.all() for m in drawn)
    masks = {s: torch.from_numpy(m.reshape(-1).copy())
             for s, m in zip(sites, drawn)}
    logits = model(torch.from_numpy(x), masks)
    loss = losses.softmax_cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5 * np.abs(jlogits).max())
    _assert_leaves_close(_grad_tree(model), jgrads, 1e-4, "grad")
    with pytest.raises(ValueError, match="mask or a generator"):
        model(torch.from_numpy(x))


def _np_tree(tree):
    return {s: {n: np.array(v) for n, v in d.items()}
            for s, d in tree.items()}


def test_adamw_clip_trajectory_matches_jax(variants, monkeypatch):
    """Three steps of the Swin-T recipe's optimizer (AdamW, no decay on
    norms and biases, the bias tables decayed, clipping at 1.0, warmup +
    cosine) on "test2" with drop-path 0.2, along JAX's trajectory: at
    each step the port's gradients from JAX's parameters (1e-4 of each
    leaf's largest), then the port's optimizer, from JAX's moments, fed
    JAX's gradients (parameters, mu and nu within 1e-5).  Feeding JAX's gradients keeps the key projection's
    bias out of it: its gradient is round-off (softmax ignores a per-row
    shift), and Adam's first steps scale round-off to the LR."""
    from myconvnet_tpu.train.optim import AdamState
    jstep = _jax_step(_jax_fn("test2", drop_path_rate=0.2), monkeypatch)
    jopt = jrecipes.make_optimizer(OPT)
    jupdate = jax.jit(jopt.update)
    params = _params("test2", seed=6)
    jstate = jopt.init(params)
    model = weights.from_jax(_port("test2", drop_path_rate=0.2), params, {})
    opt = recipes.make_optimizer(model, OPT)
    trainer = Trainer(model, opt, losses.softmax_cross_entropy,
                      device="cpu", policy=FULL, num_classes=CLASSES)
    rng = np.random.RandomState(7)
    for i in range(3):
        x = rng.randn(4, HW, HW, 3).astype(np.float32)
        y = rng.randint(0, CLASSES, 4).astype(np.int32)
        _, _, jgrads, drawn = jstep(params, x, y)
        trainer.load_state(TrainState(
            _np_tree(params), {}, {".mu": _np_tree(jstate.mu),
                                   ".nu": _np_tree(jstate.nu)},
            np.asarray(i), np.asarray([0])))
        sites = list(model.sample_masks(4, torch.Generator()))
        masks = {s: torch.from_numpy(m.reshape(-1).copy())
                 for s, m in zip(sites, drawn)}
        model.train()
        opt.zero_grad()
        losses.softmax_cross_entropy(
            model(torch.from_numpy(x), masks),
            torch.from_numpy(y).long()).backward()
        _assert_leaves_close(_grad_tree(model), jgrads, 1e-4,
                             f"step {i} grad")
        for path, p, view in weights.param_views(model):
            scope, name = path.rsplit("/", 1)
            g = torch.empty_like(p)
            view(g).copy_(torch.from_numpy(np.array(jgrads[scope][name])))
            p.grad = g
        opt.step(i)
        params, jstate = jupdate(jgrads, jstate, params,
                                 jnp.asarray(i, jnp.int32))
        params = _np_tree(params)
        assert isinstance(jstate, AdamState)
        got = trainer.state()
        _assert_leaves_close(got.params, params, 1e-5, f"step {i} params")
        _assert_leaves_close(got.opt_state[".mu"], jstate.mu, 1e-5,
                             f"step {i} mu")
        _assert_leaves_close(got.opt_state[".nu"], jstate.nu, 1e-5,
                             f"step {i} nu")


def test_recipe_builds_swin_at_its_input_size():
    """configs/imagenet_swin_t.py through the port's classifier builder:
    Swin-T at 224 with the recipe's drop-path, and its window masks made
    for the recipe's input (the model is SIZED)."""
    cfg = recipes.load_config("configs/imagenet_swin_t.py")
    assert "swin_t" in models.SIZED and "tinyswin" in models.MODELS
    cfg.update(model="tinyswin", input_hw=(HW, HW),
               augment=dict(cfg["augment"], out_hw=(HW, HW)),
               raw_hw=(40, 40), synthetic_n=8)
    trainer, _, _ = recipes.build_trainer(cfg, True,
                                          device=torch.device("cpu"))
    assert trainer.model.input_hw == (HW, HW)
    assert trainer.model.blocks()[-1].drop_path_rate == 0.2


# ------------------------------------------------------------- artifacts


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """tinyswin (bf16) exported by both packages from one set of weights,
    and the port's classify route over the same trees."""
    tmp = tmp_path_factory.mktemp("swin_artifacts")
    params = _params("test", seed=8)
    model = models.get_model("tinyswin", CLASSES, input_hw=(HW, HW))
    sample = np.zeros((2, HW, HW, 3), np.float32)
    port_path, jax_path = str(tmp / "swin.pt2"), str(tmp / "swin")
    serving.export_inference(model, params, {}, sample, port_path,
                             device="cpu", policy=BF16)
    with policy_scope(JBF16):
        jserving.export_inference(
            transform(lambda x, train=False: jswin.tinyswin(
                x, CLASSES, train=train)),
            params, {}, sample, jax_path, fold_bn=False)
    cfg = dict(task="classification", model="tinyswin", model_kwargs={},
               num_classes=CLASSES, input_hw=(HW, HW), dataset="imagenet",
               augment=dict(out_hw=(HW, HW)), precision="bf16")
    route = serving_http.build_route("s", "classify", cfg, params=params,
                                     state={}, batch=2, device="cpu")
    wire = (np.random.RandomState(9).rand(2, HW, HW, 3) * 4.0 - 2.0
            ).astype(np.float32)
    return dict(port=serving.load_inference(port_path),
                jax=jserving.load_inference(jax_path), route=route,
                wire=wire, path=port_path)


def test_artifact_matches_jax(artifact):
    got = artifact["port"](artifact["wire"]).float().numpy()
    want = np.asarray(artifact["jax"](artifact["wire"]), np.float32)
    assert got.shape == want.shape == (2, CLASSES)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.05 * np.abs(want).max())


def test_artifact_gives_the_routes_bits(artifact):
    """The classify route's program and the artifact run one program: the
    same rows give the same bits, and the graph holds no mcn:: op (the
    window attention is plain ops)."""
    x = torch.from_numpy(artifact["wire"])
    with torch.inference_mode():
        want = artifact["route"].fn(x)
    got = artifact["port"](x)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert artifact["port"].meta["ops"] == {}


def test_shifted_swin_exports(variants, tmp_path):
    """A shifted Swin (rolls and the mask buffers) exports, and the
    artifact gives the eager module's bits."""
    params = _params("test2", seed=10)
    model = _port("test2")
    sample = np.zeros((2, HW, HW, 3), np.float32)
    path = str(tmp_path / "s2.pt2")
    serving.export_inference(model, params, {}, sample, path, device="cpu",
                             policy=BF16)
    fn = serving.make_inference_fn(_port("test2"), params, {}, device="cpu",
                                   policy=BF16)
    x = torch.from_numpy(np.random.RandomState(11).randn(
        2, HW, HW, 3).astype(np.float32))
    assert torch.equal(serving.load_inference(path)(x), fn(x))


def test_export_cli_and_route_of_a_swin_checkpoint(tmp_path, capsys):
    """A ``tinyswin`` run of the Swin-T recipe through ``train``, then
    ``test --export``: the artifact (no mcn:: op) gives the classify
    route's bits, built from the same checkpoint."""
    from myconvnet_tpu_torch import test as test_entry
    from myconvnet_tpu_torch import train as train_entry
    config = "configs/imagenet_swin_t.py"
    sets = ["model=tinyswin", f"input_hw=[{HW},{HW}]",
            f"augment.out_hw=[{HW},{HW}]", "raw_hw=[40,40]",
            "synthetic_n=8", "export_batch=2"]
    args = ["--config", config, "--synthetic", "--device", "cpu",
            *[a for s in sets for a in ("--set", s)]]
    run = str(tmp_path / "run")
    train_entry.main(args + ["--steps", "1", "--batch", "4", "--out", run])
    path = str(tmp_path / "swin.pt2")
    assert test_entry.main(args + ["--ckpt", run, "--export", path]) == path
    assert "no mcn:: op" in capsys.readouterr().out
    cfg = recipes.apply_overrides(recipes.load_config(config), sets)
    route = serving_http.build_route("s", "classify", cfg, ckpt=run,
                                     batch=2, device="cpu")
    x = torch.from_numpy(np.random.RandomState(12).randn(
        2, HW, HW, 3).astype(np.float32))
    with torch.inference_mode():
        want = route.fn(x)
    got = serving.load_inference(path)(x)
    assert got.shape == (2, 1000) and torch.equal(got, want)
