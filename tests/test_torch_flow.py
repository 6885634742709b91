"""The port's optical-flow slice against the JAX package, on the CPU.

The correlation volume (against the XLA op and the interpreted Pallas
kernel) and its gradients, resize, warp, the flow losses, the synthetic
scenes, the evaluator, the five flow models from JAX's weights, three AdamW
steps of the recipe and checkpoints crossing both ways: the same seeded
numpy inputs through both packages, JAX's random draws handed to the port.
On the CPU the port's correlation wrapper runs its plain version.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.eval.flow import FlowEvaluator as JFlowEvaluator
from myconvnet_tpu.models.base import ConvNet
from myconvnet_tpu.ops import correlation as jcorr
from myconvnet_tpu.ops import resize as jresize
from myconvnet_tpu.ops import warp as jwarp
from myconvnet_tpu.ops.pallas.correlation import pallas_correlation_volume
from myconvnet_tpu.subsets import flow as jflow
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu.train.optim import AdamState
from myconvnet_tpu_torch import models, recipes, weights
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.data.augment import JitterDraws
from myconvnet_tpu_torch.eval.flow import FlowEvaluator
from myconvnet_tpu_torch.ops import resize, warp
from myconvnet_tpu_torch.ops.correlation import correlation_volume
from myconvnet_tpu_torch.ops.kernels import correlation as ckern
from myconvnet_tpu_torch.subsets import flow as tflow
from myconvnet_tpu_torch.train import losses
from myconvnet_tpu_torch.train.trainer import StepDraws, TrainState

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
PWC_CONFIG = os.path.join(CONFIGS, "chairs_pwcnet.py")
TINY = ["model=tinypwc", "input_hw=[32,32]", "synthetic_n=16"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol, what=""):
    """Within ``tol`` of the reference's scale (at least 1)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# ------------------------------------------------------------ correlation


def _features(shape, seed, bf16=False):
    rng = np.random.RandomState(seed)
    f1, f2 = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    if bf16:   # values on the bf16 grid, so both packages round nothing
        f1, f2 = (np.asarray(jnp.asarray(f, jnp.bfloat16)
                             .astype(jnp.float32)) for f in (f1, f2))
    return f1, f2


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d,shape", [(1, (2, 5, 7, 4)), (2, (2, 7, 5, 7)),
                                     (4, (1, 9, 11, 4)), (4, (2, 3, 5, 7))])
def test_correlation_volume_matches_the_xla_op(d, shape, bf16):
    """Float32 and bf16 inputs (a bf16 product is exact in float32):
    within 1e-5."""
    f1, f2 = _features(shape, d, bf16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    want = jcorr.correlation_volume(jnp.asarray(f1, jdt),
                                    jnp.asarray(f2, jdt),
                                    max_displacement=d)
    got = correlation_volume(_t(f1).to(tdt), _t(f2).to(tdt),
                             max_displacement=d)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("d,shape", [(1, (2, 8, 6, 4)), (2, (1, 8, 5, 7)),
                                     (4, (1, 8, 9, 4))])
def test_correlation_volume_matches_the_interpreted_pallas_kernel(d, shape):
    """The TPU kernel the CUDA kernel replaces, in interpret mode (it
    multiplies by 1 / C where the port divides by C): within 1e-5."""
    f1, f2 = _features(shape, 10 + d)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_correlation_volume(jnp.asarray(f1), jnp.asarray(f2), d)
    _close(correlation_volume(_t(f1), _t(f2), max_displacement=d), want,
           1e-5)


@pytest.mark.parametrize("d,shape", [(1, (2, 5, 7, 4)), (2, (2, 7, 5, 7)),
                                     (4, (1, 9, 11, 4))])
def test_correlation_gradients_match_jax_grad(d, shape):
    """Both feature maps' gradients under a random cotangent against
    ``jax.grad`` of the XLA op, through autograd of the plain version and
    through the backward wrappers: within 1e-5."""
    f1, f2 = _features(shape, 20 + d)
    g = np.random.RandomState(d).randn(*shape[:3], (2 * d + 1) ** 2) \
        .astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jcorr.correlation_volume(
        a, b, max_displacement=d) * g), argnums=(0, 1))(
            jnp.asarray(f1), jnp.asarray(f2))
    a, b = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    (correlation_volume(a, b, max_displacement=d) * _t(g)).sum().backward()
    _close(a.grad, want[0], 1e-5)
    _close(b.grad, want[1], 1e-5)
    _close(ckern.correlation_bwd_f1(_t(g), _t(f1), _t(f2), d), want[0], 1e-5)
    _close(ckern.correlation_bwd_f2(_t(g), _t(f1), _t(f2), d), want[1], 1e-5)


def test_correlation_volume_errors_are_jax_s():
    f = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="feature shapes differ"):
        correlation_volume(f, torch.zeros(1, 4, 5, 2))
    with pytest.raises(ValueError, match="max_displacement must be >= 0"):
        correlation_volume(f, f, max_displacement=-1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        correlation_volume(f.double(), f.double())
    for name in ("correlation_fwd", "correlation_bwd_f1",
                 "correlation_bwd_f2"):
        from myconvnet_tpu_torch.ops import kernels
        assert kernels.WRAPPERS[name].launches == 0   # no card, no launch


# ------------------------------------------------------- resize and warp


@pytest.mark.parametrize("hw,out,kw", [
    ((6, 8), (12, 16), {}), ((12, 16), (6, 8), {}), ((5, 7), (9, 4), {}),
    ((6, 8), (11, 16), dict(align_corners=True)),
    ((6, 8), (12, 3), dict(half_pixel=False)), ((4, 4), (1, 1), {})])
def test_resize_bilinear_matches_jax(hw, out, kw):
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    want = jresize.resize_bilinear(jnp.asarray(x), out, **kw)
    _close(resize.resize_bilinear(_t(x), out, **kw), want, 1e-5)
    np.testing.assert_array_equal(
        resize._interp_matrix(hw[0], out[0], kw.get("align_corners", False),
                              kw.get("half_pixel", True)),
        jresize._interp_matrix(hw[0], out[0],
                               kw.get("align_corners", False),
                               kw.get("half_pixel", True)))


def test_resize_nearest_and_upsample_match_jax():
    x = np.random.RandomState(1).randn(2, 5, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(
        resize.resize_nearest(_t(x), (9, 4)).numpy(),
        np.asarray(jresize.resize_nearest(jnp.asarray(x), (9, 4))))
    np.testing.assert_array_equal(
        resize.upsample2x_nearest(_t(x)).numpy(),
        np.asarray(jresize.upsample2x_nearest(jnp.asarray(x))))
    bf = resize.resize_bilinear(_t(x).bfloat16(), (10, 12))
    assert bf.dtype == torch.bfloat16 and bf.shape == (2, 10, 12, 3)
    assert resize.resize_bilinear(_t(x[0]), (3, 3)).shape == (3, 3, 3)


def _warp_case(kind, seed=0, hw=(7, 9)):
    rng = np.random.RandomState(seed)
    img = rng.randn(2, *hw, 3).astype(np.float32)
    flow = {"zero": np.zeros((2, *hw, 2), np.float32),
            "small": rng.uniform(-2.5, 2.5, (2, *hw, 2)),
            "integer": rng.randint(-2, 3, (2, *hw, 2)),
            "large": rng.uniform(-12, 12, (2, *hw, 2))}[kind]
    cot = rng.randn(2, *hw, 3).astype(np.float32)
    return img, flow.astype(np.float32), cot


@pytest.mark.parametrize("kind", ["zero", "small", "integer", "large"])
def test_warp_bilinear_value_and_gradients_match_jax(kind):
    """Value and both gradients under a random cotangent, 1e-5; at zero
    and integer flow the sample positions sit on the clamp's bounds, where
    JAX's clip splits the gradient at a tie."""
    img, flow, cot = _warp_case(kind)
    want = jwarp.warp_bilinear(jnp.asarray(img), jnp.asarray(flow))
    gi, gf = jax.grad(lambda a, f: jnp.sum(jwarp.warp_bilinear(a, f) * cot),
                      argnums=(0, 1))(jnp.asarray(img), jnp.asarray(flow))
    a, f = _t(img).requires_grad_(), _t(flow).requires_grad_()
    out = warp.warp_bilinear(a, f)
    _close(out, want, 1e-5)
    (out * _t(cot)).sum().backward()
    _close(a.grad, gi, 1e-5, "d img")
    _close(f.grad, gf, 1e-5, "d flow")


@pytest.mark.parametrize("kind", ["zero", "small", "integer"])
@pytest.mark.parametrize("d", [3, 4])
def test_warp_bounded_value_and_gradients_match_jax(kind, d):
    img, flow, cot = _warp_case(kind, seed=1)
    want = jwarp.warp_bounded(jnp.asarray(img), jnp.asarray(flow),
                              max_displacement=d)
    gi, gf = jax.grad(lambda a, f: jnp.sum(jwarp.warp_bounded(
        a, f, max_displacement=d) * cot), argnums=(0, 1))(
            jnp.asarray(img), jnp.asarray(flow))
    a, f = _t(img).requires_grad_(), _t(flow).requires_grad_()
    out = warp.warp_bounded(a, f, max_displacement=d)
    _close(out, want, 1e-5)
    _close(out, warp.warp_bilinear(_t(img), _t(flow)), 1e-5, "vs gather")
    (out * _t(cot)).sum().backward()
    _close(a.grad, gi, 1e-5, "d img")
    _close(f.grad, gf, 1e-5, "d flow")


def test_warp_keeps_dtype_and_rejects_bad_shapes():
    img, flow, _ = _warp_case("small")
    assert warp.warp_bilinear(_t(img).bfloat16(), _t(flow)).dtype \
        == torch.bfloat16
    with pytest.raises(ValueError, match="disagree"):
        warp.warp_bilinear(_t(img), _t(flow)[:, :3])
    with pytest.raises(ValueError, match=r"\[\.\.\., 2\]"):
        warp.warp_bounded(_t(img), _t(img))


# ----------------------------------------------------------------- losses


def _flow_pair(seed, hw=(8, 12), n=2, nan=True):
    rng = np.random.RandomState(seed)
    pred = rng.randn(n, *hw, 2).astype(np.float32) * 2
    target = rng.randn(n, *hw, 2).astype(np.float32) * 2
    if nan:
        target[0, :3, :5] = np.nan      # a whole 2x2 window and more
        target[1, 4, 7, 1] = np.nan     # one component
    return pred, target


def test_epe_loss_value_and_gradient_match_jax_with_nan_targets():
    pred, target = _flow_pair(0)
    want, grad = jax.jit(jax.value_and_grad(
        lambda p: jlosses.epe_loss(p, jnp.asarray(target))))(
            jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    got = losses.epe_loss(p, _t(target))
    got.backward()
    _close(got, want, 1e-5)
    assert torch.isfinite(p.grad).all()
    _close(p.grad, grad, 1e-5)


@pytest.mark.parametrize("levels", [5, 2])
def test_multiscale_epe_loss_matches_jax(levels):
    rng = np.random.RandomState(1)
    _, target = _flow_pair(1, hw=(32, 32))
    sizes = [32 >> k for k in range(levels, 0, -1)]
    preds = [rng.randn(2, s, s, 2).astype(np.float32) for s in sizes]
    want, grads = jax.jit(jax.value_and_grad(
        lambda ps: jlosses.multiscale_epe_loss(ps, jnp.asarray(target))))(
            [jnp.asarray(p) for p in preds])
    ps = [_t(p).requires_grad_() for p in preds]
    got = losses.multiscale_epe_loss(ps, _t(target))
    got.backward()
    _close(got, want, 1e-5)
    for p, g in zip(ps, grads):
        _close(p.grad, g, 1e-5)
    pooled = losses._nan_avg_pool_flow(_t(target), (16, 16)).numpy()
    jpooled = np.asarray(jlosses._nan_avg_pool_flow(jnp.asarray(target),
                                                    (16, 16)))
    np.testing.assert_array_equal(np.isnan(pooled), np.isnan(jpooled))
    assert np.isnan(pooled[0, 0, 0]).all()      # an all-unknown window
    np.testing.assert_allclose(np.nan_to_num(pooled),
                               np.nan_to_num(jpooled), atol=1e-6)
    with pytest.raises(ValueError, match="weights for"):
        losses.multiscale_epe_loss(ps, _t(target), weights=(1.0,))
    with pytest.raises(ValueError, match="non-integer stride"):
        losses._nan_avg_pool_flow(_t(target), (5, 5))


@pytest.mark.parametrize("occlusion", [False, True])
def test_unsupervised_flow_loss_matches_jax(occlusion):
    """Value and the flow's gradient, 1e-5; with ``occlusion`` 2N flows,
    the second half for the swapped pairs.  The frames are smooth, so the
    warp's bilinear weights are away from their kinks."""
    rng = np.random.RandomState(2)
    n, hw = 2, (8, 10)
    frames = rng.uniform(0, 1, (n, *hw, 6)).astype(np.float32)
    flows = rng.uniform(-1.4, 1.4, (2 * n if occlusion else n, 4, 5, 2)) \
        .astype(np.float32)
    kw = dict(occlusion=occlusion, smooth_weight=0.1)
    want, grad = jax.jit(jax.value_and_grad(
        lambda f: jlosses.unsupervised_flow_loss(
            [f], jnp.asarray(frames), **kw)))(jnp.asarray(flows))
    f = _t(flows).requires_grad_()
    got = losses.unsupervised_flow_loss([f], _t(frames), **kw)
    got.backward()
    _close(got, want, 1e-5)
    _close(f.grad, grad, 1e-5)
    if occlusion:
        m = losses.occlusion_mask(_t(flows[:n]), _t(flows[n:]))
        jm = jlosses.occlusion_mask(jnp.asarray(flows[:n]),
                                    jnp.asarray(flows[n:]))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        with pytest.raises(ValueError, match="needs 2N"):
            losses.unsupervised_flow_loss(f[:n], _t(frames), occlusion=True)


# ------------------------------------------------------ data and evaluator


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_flow_scenes_equal_jax_exactly(seed):
    kw = dict(hw=(24, 32), max_motion=3, seed=seed)
    for a, b in zip(tflow.synthetic_flow_scenes(5, **kw),
                    jflow.synthetic_flow_scenes(5, **kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    cfg = {"dataset": "flow", "data_dir": None, "input_hw": [24, 32],
           "synthetic_n": 4, "max_motion": 2}
    for split, src in zip(("train", "val"),
                          recipes.make_sources(cfg, True)):
        want = jflow.make_source(None, split, synthetic_n=4, hw=(24, 32),
                                 max_motion=2)
        np.testing.assert_array_equal(src.pairs, want.pairs)
        np.testing.assert_array_equal(src.flows, want.flows)


def test_flo_round_trip_and_triple_source(tmp_path):
    """A .flo file written by either package reads back in the other, NaN
    for unknown; the FlyingChairs layout loads as [N, H, W, 6] uint8."""
    from PIL import Image
    rng = np.random.RandomState(0)
    flow = rng.randn(6, 8, 2).astype(np.float32)
    flow[2, 3] = np.nan
    root = tmp_path / "train"
    root.mkdir()
    tflow.write_flo(str(root / "a_flow.flo"), flow)
    jflow.write_flo(str(root / "b_flow.flo"), flow)
    np.testing.assert_array_equal(jflow.read_flo(str(root / "a_flow.flo")),
                                  flow)
    np.testing.assert_array_equal(tflow.read_flo(str(root / "b_flow.flo")),
                                  flow)
    for stem in "ab":
        for k in (1, 2):
            Image.fromarray(rng.randint(0, 256, (6, 8, 3), dtype=np.uint8)
                            ).save(str(root / f"{stem}_img{k}.png"))
    src = tflow.make_source(str(tmp_path), "train", hw=(6, 8))
    want = jflow.make_source(str(tmp_path), "train", hw=(6, 8))
    x, y = src.get_batch([0, 1])
    jx, jy = want.get_batch([0, 1])
    assert x.shape == (2, 6, 8, 6) and x.dtype == np.uint8
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    (root / "bad_flow.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        tflow.read_flo(str(root / "bad_flow.flo"))
    with pytest.raises(FileNotFoundError, match="missing"):
        tflow.read_subset(str(tmp_path), "train")
    with pytest.raises(ValueError, match="resolution"):
        tflow.FlowTripleSource(src.img1, src.img2, src.flo,
                               hw=(4, 4)).get_batch([0])


@pytest.mark.parametrize("metric", ["epe", "fl"])
def test_flow_evaluator_matches_jax(metric):
    pred, target = _flow_pair(3, hw=(10, 12), n=3)
    pred *= 3
    target[2] = np.nan      # an image with no valid pixel is skipped
    mine, ref = FlowEvaluator(metric), JFlowEvaluator(metric)
    for lo in (0, 2):
        mine.update(_t(pred[lo:lo + 2]), _t(target[lo:lo + 2]))
        ref.update(pred[lo:lo + 2], target[lo:lo + 2])
    assert mine.score() == pytest.approx(ref.score(), abs=1e-12)
    for k, v in ref.report().items():
        assert mine.report()[k] == pytest.approx(v, abs=1e-12)
    assert mine.is_better(1.0, 2.0) and not mine.is_better(2.0, 1.0)
    assert mine.worst_score() == np.inf
    with pytest.raises(ValueError, match="unknown flow metric"):
        FlowEvaluator("nope")
    assert isinstance(recipes.build_evaluator(
        {"task": "flow", "flow_metric": metric}), FlowEvaluator)


# ----------------------------------------------------------------- models

# PWC-Net with a narrow pyramid and d = 2, so that all five levels, the
# warp, the dense estimators and the dilated context net run while JAX's
# compile of the 25-slice volume stays short; JAX runs under jit throughout
NARROW = dict(pyramid=(4, 4, 8, 8, 8, 8), md=2)
MODEL_CASES = {
    "tinyflow": ("tinyflow", {}, (16, 24)),
    "tinypwc": ("tinypwc", {}, (16, 24)),
    "tinypwc_gather": ("tinypwc", dict(warp_backend="gather"), (16, 24)),
    "flownet_s": ("flownet_s", dict(width=4), (64, 64)),
    "flownet_c": ("flownet_c", dict(width=4), (64, 64)),
    "pwcnet": ("pwcnet", NARROW, (64, 64)),
    "pwcnet_bounded": ("pwcnet", dict(NARROW, warp_backend="bounded"),
                       (64, 64)),
}
GRAD_CASES = sorted(set(MODEL_CASES) - {"pwcnet_bounded"})


def _random_params(model, seed):
    """Random JAX-layout weights over the whole tree: non-zero flow heads
    (their zero init would make every upstream gradient zero) and
    non-zero biases."""
    params, _ = weights.random_jax_params(model, seed)
    rng = np.random.RandomState(seed + 1)
    for d in params.values():
        d["b"] = (0.05 * rng.randn(*d["b"].shape)).astype(np.float32)
    return params


def _frames(hw, seed, n=2):
    """Smooth frame pairs in [0, 1], the second a shifted copy."""
    base, _ = tflow.synthetic_flow_scenes(n, hw, max_motion=2, seed=seed)
    return base.astype(np.float32) / 255.0


def _jnet(case, precision="f32", loss_fn=None):
    name, kw, hw = MODEL_CASES[case]
    return ConvNet(jmodels.FLOW_MODELS[name], input_shape=(*hw, 6),
                   num_classes=0, precision=precision, loss_fn=loss_fn,
                   accuracy_metric=False, **kw)


def _japply(case, params, x, train, precision="f32"):
    net = _jnet(case, precision)
    fn = jax.jit(lambda p, v: net._transformed.apply(p, {}, None, v,
                                                     train)[0])
    return fn(jax.tree.map(jnp.asarray, params), jnp.asarray(x))


def _port_model(case, params=None):
    name, kw, _ = MODEL_CASES[case]
    model = models.FLOW_MODELS[name](0, **kw)
    if params is not None:
        weights.from_jax(model, params, {})
    return model


@pytest.fixture(scope="module")
def case_params():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _random_params(_port_model(case), 3)
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_flow_model_tree_is_jax_s_and_zero_heads_give_zero_flow(case):
    """The port's parameter tree has JAX's scopes and shapes (shared scopes
    once), and the recipe's own initialisation predicts exactly zero flow,
    in eval mode and at every level in train mode."""
    hw = MODEL_CASES[case][2]
    init = _jnet(case)._transformed.init
    jparams, jstate = jax.eval_shape(
        lambda key, x: init(key, x, True), jax.random.key(0),
        jax.ShapeDtypeStruct((2, *hw, 6), jnp.float32))
    model = init_model(_port_model(case), torch.Generator().manual_seed(0))
    mine, _ = weights.to_jax(model)
    assert not jstate
    assert {s: {k: v.shape for k, v in d.items()} for s, d in mine.items()} \
        == {s: {k: tuple(v.shape) for k, v in d.items()}
            for s, d in jparams.items()}
    heads = [s for s in mine if s.split("/")[-1] == "flow"]
    assert heads and all(not mine[s]["w"].any() for s in heads)
    assert all(mine[s]["w"].any() for s in mine if s not in heads)
    x = _t(_frames(hw, 0))
    with torch.no_grad():
        assert not model.eval()(x).any()
        out = model.train()(x)
    for o in out if isinstance(out, list) else [out]:
        assert o.dtype == torch.float32 and not o.any()


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_flow_model_f32_matches_jax(case, case_params):
    """The eval flow and the train-mode output (the pyramid of the
    coarse-to-fine nets) in float32 from JAX's weights: within 1e-4 of the
    flow's scale."""
    params = case_params(case)
    hw = MODEL_CASES[case][2]
    x = _frames(hw, 1)
    want = _japply(case, params, x, False)
    want_train = _japply(case, params, x, True)
    model = _port_model(case, params)
    with torch.no_grad():
        got = model.eval()(_t(x))
        got_train = model.train()(_t(x))
    assert got.shape == (2, *hw, 2) and got.dtype == torch.float32
    assert float(np.abs(want).max()) > 1e-2      # the heads are not zero
    _close(got, want, 1e-4)
    if getattr(model, "multiscale", False):
        assert isinstance(got_train, list) \
            and len(got_train) == len(want_train)
        for g, w in zip(got_train, want_train):
            _close(g, w, 1e-4, "pyramid level")
    else:
        _close(got_train, want_train, 1e-4)


@pytest.mark.parametrize("case", ["tinyflow", "tinypwc", "flownet_c",
                                  "pwcnet"])
def test_flow_model_bf16_matches_jax(case, case_params):
    """Under the bf16 policy (bf16 features, float32 cost volume and
    flow): within 0.05 of max |flow|."""
    params = case_params(case)
    x = _frames(MODEL_CASES[case][2], 2)
    want = np.asarray(_japply(case, params, x, False, "bf16"), np.float32)
    model = _port_model(case, params).eval()
    with torch.no_grad():
        got = model(_t(x).bfloat16()).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def _loss_fn(model_is_multiscale):
    if model_is_multiscale:
        return jlosses.multiscale_epe_loss, losses.multiscale_epe_loss
    return jlosses.epe_loss, losses.epe_loss


@pytest.mark.parametrize("case", GRAD_CASES)
def test_flow_model_loss_and_every_gradient_match_jax(case, case_params):
    """From random non-zero heads, float32: the recipe's loss within 1e-4
    and every parameter's gradient within 1e-4 of its largest entry (plus
    1e-6 of the largest gradient in the tree)."""
    params = case_params(case)
    name, _, hw = MODEL_CASES[case]
    x = _frames(hw, 4)
    _, y = tflow.synthetic_flow_scenes(2, hw, max_motion=2, seed=4)
    y[0, :4, :4] = np.nan
    jloss, tloss = _loss_fn(getattr(models.FLOW_MODELS[name], "multiscale",
                                    False))
    net = _jnet(case)

    def objective(p):
        out, _ = net._transformed.apply(p, {}, None, jnp.asarray(x), True)
        return jloss(out, jnp.asarray(y))

    want, grads = jax.jit(jax.value_and_grad(objective))(
        jax.tree.map(jnp.asarray, params))
    model = _port_model(case, params).train()
    loss = tloss(model(_t(x)), _t(y))
    loss.backward()
    assert float(loss) == pytest.approx(float(want), rel=1e-4)
    top = max(float(np.abs(g).max()) for d in grads.values()
              for g in d.values())
    assert top > 1e-4
    for path, p, view in weights.param_views(model):
        scope, pname = path.rsplit("/", 1)
        ref = np.asarray(grads[scope][pname])
        np.testing.assert_allclose(
            view(p.grad).numpy(), ref, rtol=0,
            atol=1e-4 * float(np.abs(ref).max()) + 1e-6 * top,
            err_msg=path)


def test_zero_heads_give_exactly_zero_upstream_gradients():
    """From the recipe's initialisation only the heads' own parameters
    get a gradient, in the port as in JAX."""
    model = init_model(_port_model("tinypwc"),
                       torch.Generator().manual_seed(0)).train()
    x = _frames((16, 24), 5)
    _, y = tflow.synthetic_flow_scenes(2, (16, 24), max_motion=2, seed=5)
    losses.multiscale_epe_loss(model(_t(x)), _t(y)).backward()
    params, _ = weights.to_jax(model)
    net = _jnet("tinypwc")
    grads = jax.jit(jax.grad(lambda p: jlosses.multiscale_epe_loss(
        net._transformed.apply(p, {}, None, jnp.asarray(x), True)[0],
        jnp.asarray(y))))(jax.tree.map(jnp.asarray, params))
    for path, p, _ in weights.param_views(model):
        scope, pname = path.rsplit("/", 1)
        is_head = scope.split("/")[-1] == "flow"
        assert bool(p.grad.any()) == is_head, path
        assert bool(np.asarray(grads[scope][pname]).any()) == is_head, path


def test_flow_models_reject_bad_inputs():
    with pytest.raises(ValueError, match="frame pairs"):
        _port_model("tinyflow")(torch.zeros(1, 16, 16, 3))
    with pytest.raises(ValueError, match="divisible by 64"):
        _port_model("pwcnet")(torch.zeros(1, 32, 32, 6))
    with pytest.raises(KeyError):
        models.pwcnet(0, warp_backend="nope")
    assert sorted(models.FLOW_MODELS) == sorted(jmodels.FLOW_MODELS)


# ------------------------------------------------------------- the recipe


def _tiny_cfg(**over):
    cfg = recipes.apply_overrides(recipes.load_config(PWC_CONFIG), TINY)
    cfg.update(precision="f32", **over)
    cfg["optimizer"] = dict(
        name="adamw", weight_decay=4e-4,
        lr=dict(kind="cosine", lr=1e-3, total_steps=5, warmup_steps=2))
    return cfg


def _jax_draws(rng, step, n, bright, contrast):
    """The draws JAX's step makes from (rng, step): the trainer's
    fold_in and split (``train/trainer.py:213-215``), the recipe's
    (``recipes/perception.py:326-327``) and color_jitter's
    (``data/augment.py:284-292``)."""
    key = jax.random.fold_in(jax.random.wrap_key_data(rng), step)
    k_aug, _ = jax.random.split(key)
    kf, kj = jax.random.split(k_aug)
    flip = jax.random.bernoulli(kf, 0.5, (n, 1, 1, 1))
    k_b, k_c, _, _ = jax.random.split(kj, 4)
    delta = jax.random.uniform(k_b, (n, 1, 1, 1), minval=-bright,
                               maxval=bright)
    factor = jax.random.uniform(k_c, (n, 1, 1, 1), minval=1.0 - contrast,
                                maxval=1.0 + contrast)
    return recipes.FlowDraws(
        _t(np.array(flip)).reshape(n),
        JitterDraws(_t(np.array(delta)).reshape(n),
                    _t(np.array(factor)).reshape(n)))


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


def _adam_state(state: AdamState) -> dict:
    return {".mu": _np_tree(state.mu), ".nu": _np_tree(state.nu)}


@pytest.mark.parametrize("unsupervised", [False, True])
def test_flow_input_chain_matches_jax(unsupervised):
    """The recipe's train input function at JAX's draws: the paired flip
    (both frames and the flow mirrored, u negated), the same jitter on
    both frames, the clip: 1e-6; the eval input is x / 255."""
    cfg = _tiny_cfg(unsupervised=unsupervised, occlusion=unsupervised)
    net, train_set, _ = jrecipes.build_flow(cfg, synthetic=True)
    train_fn, eval_fn, _ = net.augment_fns
    x, y = train_set.source.get_batch(np.arange(6))
    key = jax.random.PRNGKey(7)
    jx, jy = train_fn(key, jnp.asarray(x), jnp.asarray(y))
    kf, kj = jax.random.split(key)
    k_b, k_c, _, _ = jax.random.split(kj, 4)
    draws = recipes.FlowDraws(
        _t(np.array(jax.random.bernoulli(kf, 0.5, (6,)))),
        JitterDraws(_t(np.array(jax.random.uniform(
            k_b, (6,), minval=-0.2, maxval=0.2))), _t(np.array(
                jax.random.uniform(k_c, (6,), minval=0.8, maxval=1.2)))))
    assert draws.flip.any() and not draws.flip.all()
    fns = recipes.flow_input_fns(0.2, 0.2, unsupervised=unsupervised,
                                 occlusion=unsupervised)
    tx, ty = fns.train(_t(x), _t(y), draws)
    assert tx.shape == jx.shape and ty.shape == jy.shape
    _close(tx, jx, 1e-6)
    _close(ty, jy, 1e-6)
    _close(fns.eval(_t(x)), eval_fn(jnp.asarray(x), None)[0], 1e-7)
    own = fns.sample(torch.Generator().manual_seed(0), 4096)
    assert abs(float(own.flip.float().mean()) - 0.5) < 0.03
    assert -0.2 <= float(own.jitter.brightness.min()) < -0.19
    assert 1.19 < float(own.jitter.contrast.max()) <= 1.2
    assert own.jitter.saturation is None and own.jitter.hue is None


def test_three_adamw_steps_of_the_recipe_match_jax(case_params):
    """Three steps of tinypwc under ``build_flow`` (multi-scale EPE,
    AdamW, warmup-cosine) at JAX's flips and jitter factors, each port
    step starting from JAX's parameters and Adam moments: the loss, the
    parameters and both moments within 1e-4."""
    cfg = _tiny_cfg()
    net, train_set, _ = jrecipes.build_flow(cfg, synthetic=True)
    net.build(jrecipes.make_optimizer(cfg["optimizer"]))
    jstate = net.state._replace(params=jax.tree.map(
        jnp.asarray, case_params("tinypwc")))
    jstep = net._make_trainer(None)._train_step     # donates its state
    port, _, _ = recipes.build_flow(cfg, True, device=torch.device("cpu"))
    assert port.input_fns is not None and not port.accuracy_metric
    n = 4
    for i in range(3):
        x, y = train_set.source.get_batch(np.arange(4 * i, 4 * i + n))
        rng = np.array(jstate.rng)
        port.load_state(TrainState(_np_tree(jstate.params), {},
                                   _adam_state(jstate.opt_state),
                                   np.asarray(i), rng))
        draws = StepDraws(None, None, None, recipe=_jax_draws(
            rng, i, n, 0.2, 0.2))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tm = port.train_step(_t(x), _t(y), draws)
        assert set(tm) == set(jm) == {"loss"}
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        got = port.state()
        assert int(got.step) == int(jstate.step) == i + 1
        _assert_trees_close(got.params, jstate.params, 1e-4,
                            f"step {i} params")
        for field, tree in _adam_state(jstate.opt_state).items():
            _assert_trees_close(got.opt_state[field], tree, 1e-4,
                                f"step {i} {field}")


def test_flow_entry_points_and_checkpoints_cross_the_packages(tmp_path):
    """``train.main`` then ``test.main`` on the PWC-Net recipe at the tiny
    size: finite losses, the best checkpoint chosen by the LOWER score, a
    restored run that scores what the writer scored; the JAX package
    restores the port's checkpoint and the port the JAX package's, with
    equal parameters and Adam moments."""
    out = str(tmp_path / "run")
    common = ["--config", PWC_CONFIG, "--synthetic", "--device", "cpu",
              *[a for kv in TINY for a in ("--set", kv)]]
    trainer = train_entry.main(common + [
        "--steps", "4", "--batch", "4", "--val_every", "2", "--set",
        "log_every=1", "--out", out])
    assert trainer.step == 4 and type(trainer.model).__name__ == "TinyPWC"
    assert trainer.policy.compute_dtype == torch.bfloat16
    with open(os.path.join(out, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_losses = [r["loss"] for r in rows if "loss" in r]
    vals = [r["val_flow"] for r in rows if "val_flow" in r]
    assert len(train_losses) == 4 and np.isfinite(train_losses).all()
    assert len(vals) == 2 and "accuracy" not in rows[0]
    assert os.path.exists(os.path.join(out, "best.npz"))
    with open(os.path.join(out, "best.json")) as f:
        assert json.load(f)["metric"] == pytest.approx(min(vals))
    score, restored = test_entry.main(common + ["--ckpt", out,
                                                "--batch", "8"])
    assert restored.step == 4 and np.isfinite(score)
    assert score == pytest.approx(
        trainer.evaluate(recipes.build_flow(
            json.load(open(os.path.join(out, "config.json"))), True,
            device=torch.device("cpu"))[2].eval_iter(8, "cpu")), abs=1e-6)

    cfg = recipes.apply_overrides(recipes.load_config(PWC_CONFIG), TINY)
    net, train_set, _ = jrecipes.build_flow(cfg, synthetic=True)
    net.build(jrecipes.make_optimizer(cfg["optimizer"]))
    net.restore(out)
    mine = trainer.state()
    assert int(net.state.step) == 4
    _assert_trees_close(_np_tree(net.state.params), mine.params, 0.0,
                        "params")
    for field, tree in _adam_state(net.state.opt_state).items():
        _assert_trees_close(tree, mine.opt_state[field], 0.0, field)

    x, y = train_set.source.get_batch(np.arange(4))
    net.state, _ = net._make_trainer(None)._train_step(
        net.state, (jnp.asarray(x), jnp.asarray(y)))
    net.save(str(tmp_path / "jax"))
    restored.restore(str(tmp_path / "jax"))
    got = restored.state()
    assert int(got.step) == 5
    _assert_trees_close(got.params, _np_tree(net.state.params), 0.0,
                        "params")
    for field, tree in _adam_state(net.state.opt_state).items():
        _assert_trees_close(got.opt_state[field], tree, 0.0, field)


@pytest.mark.parametrize("model,sets", [
    ("tinyflow", []), ("flownet_c", ["model_kwargs.width=4",
                                     "input_hw=[64,64]"]),
    ("tinypwc", ["unsupervised=True"]),
    ("tinypwc", ["unsupervised=True", "occlusion=True"])])
def test_flownet_recipe_runs_on_the_cpu(tmp_path, model, sets):
    """``configs/chairs_flownet_s.py`` with another model and objective:
    two steps and the final validation, every loss finite."""
    out = str(tmp_path / "run")
    trainer = train_entry.main([
        "--config", os.path.join(CONFIGS, "chairs_flownet_s.py"),
        "--synthetic", "--device", "cpu", "--steps", "2", "--batch", "2",
        "--out", out, "--set", f"model={model}", "--set", "synthetic_n=4",
        "--set", "input_hw=[32,32]", "--set", "log_every=1",
        *[a for kv in sets for a in ("--set", kv)]])
    with open(os.path.join(out, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert trainer.step == 2
    assert np.isfinite([r["loss"] for r in rows if "loss" in r]).all()


def test_build_flow_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="unknown flow model"):
        recipes.build_flow(dict(task="flow", model="nope"), True,
                           device=torch.device("cpu"))
    with pytest.raises(ValueError, match="set unsupervised=True"):
        recipes.build_flow(_tiny_cfg(occlusion=True), True,
                           device=torch.device("cpu"))
    with pytest.raises(ValueError, match="tasks"):
        recipes.build_trainer({"task": "nope"}, True,
                              device=torch.device("cpu"))
