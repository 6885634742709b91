"""The port's ResNet-50 eval forward against the JAX model, on the CPU.

Depth 50 at width 8, 32x32 inputs, batch 2, 10 classes.  The JAX weights
come from ``ConvNet.build`` with every BN's gamma, beta and moving
statistics randomized from a seed (the zero-init ``bn_c`` gamma would
otherwise turn every residual branch off), and go to the port through
``weights.from_jax``.  JAX runs ``serving.make_inference_fn``; the port
runs its counterpart with the CPU (plain) versions of the kernels.
"""

import numpy as np
import pytest
import torch

import jax

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import serving as jserving
from myconvnet_tpu.models.base import ConvNet
from myconvnet_tpu.models.folding import fold_batch_norms as jfold
from myconvnet_tpu_torch import models, serving, weights
from myconvnet_tpu_torch.core.precision import get_policy
from myconvnet_tpu_torch.models.folding import fold_batch_norms
from myconvnet_tpu_torch.models.resnet import Bottleneck

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


WIDTH, HW, BATCH, CLASSES = 8, 32, 2, 10


def _randomize(params, state, seed=0):
    rng = np.random.RandomState(seed)
    params = {k: {n: np.array(v) for n, v in d.items()}
              for k, d in params.items()}
    state = {k: {n: np.array(v) for n, v in d.items()}
             for k, d in state.items()}
    for scope in sorted(params):
        p = params[scope]
        if "gamma" in p:
            c = p["gamma"].shape[0]
            p["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p["beta"] = (0.2 * rng.randn(c)).astype(np.float32)
            state[scope] = {
                "moving_mean": (0.2 * rng.randn(c)).astype(np.float32),
                "moving_var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        elif scope == "logits":
            p["b"] = (0.1 * rng.randn(*p["b"].shape)).astype(np.float32)
    return params, state


def _net(precision):
    return ConvNet(jmodels.resnet50, input_shape=(HW, HW, 3),
                   num_classes=CLASSES, precision=precision, width=WIDTH)


@pytest.fixture(scope="module")
def trained():
    """(ConvNet built in f32, randomized params, state, input batch)."""
    net = _net("f32").build()
    params, state = _randomize(net.state.params, net.state.model_state)
    net.state = net.state._replace(params=params, model_state=state)
    x = np.random.RandomState(1).randn(BATCH, HW, HW, 3).astype(np.float32)
    return net, params, state, x


@pytest.fixture(scope="module")
def jax_logits(trained):
    _, params, state, x = trained
    cache = {}

    def get(precision, fold):
        if (precision, fold) not in cache:
            fn = jserving.make_inference_fn(_net(precision)._transformed,
                                            params, state, fold_bn=fold,
                                            bn_eps=1e-5)
            cache[precision, fold] = np.asarray(jax.jit(fn)(x), np.float32)
        return cache[precision, fold]
    return get


def _port_logits(params, state, x, precision, fold):
    fn = serving.make_inference_fn(models.resnet50(CLASSES, width=WIDTH),
                                   params, state, fold_bn=fold,
                                   device="cpu",
                                   policy=get_policy(precision))
    return fn(x).numpy()


def test_bridge_round_trip_is_exact(trained):
    _, params, state, _ = trained
    model = weights.from_jax(models.resnet50(CLASSES, width=WIDTH), params,
                             state)
    p2, s2 = weights.to_jax(model)
    assert set(p2) == set(params) and set(s2) == set(state)
    for tree, back in ((params, p2), (state, s2)):
        for scope in tree:
            assert set(back[scope]) == set(tree[scope])
            for name, v in tree[scope].items():
                np.testing.assert_array_equal(back[scope][name], v)


def test_bridge_rejects_foreign_scopes(trained):
    _, params, state, _ = trained
    extra = dict(params, **{"head/conv": {"w": np.zeros((1, 1, 2, 2))}})
    with pytest.raises(KeyError):
        weights.from_jax(models.resnet50(CLASSES, width=WIDTH), extra,
                         state)


def test_fold_matches_jax_fold_exactly(trained):
    """Folding by module (each BN's own eps, here 1e-5 everywhere) gives
    the JAX fold's float32 weights bit for bit: both fold in float64."""
    _, params, state, _ = trained
    model = weights.from_jax(models.resnet50(CLASSES, width=WIDTH), params,
                             state)
    assert fold_batch_norms(model) == 53
    p_port, s_port = weights.to_jax(model)
    p_jax, s_jax = jfold(params, state, 1e-5)
    assert set(p_port) == set(p_jax) and s_port == {} and s_jax == {}
    for scope in p_jax:
        for name, v in p_jax[scope].items():
            np.testing.assert_array_equal(p_port[scope][name], v)
    # and a JAX-folded tree loads into the port: folded BNs become identity
    loaded = weights.from_jax(models.resnet50(CLASSES, width=WIDTH), p_jax,
                              s_jax)
    assert all(m.folded for n, m in loaded.named_modules()
               if n.rsplit(".", 1)[-1].startswith("bn"))


def test_pair_routing_at_this_width():
    """Stride-1 blocks whose channel counts the kernel takes run through
    conv_pair: at width 8 the 7 of stages 3 and 4 (Cm = 32 and 64), and
    all 13 at full width."""
    model = models.resnet50(CLASSES, width=WIDTH)
    pair = [n for n, m in model.named_modules()
            if isinstance(m, Bottleneck) and m.pair]
    assert len(pair) == 7
    assert all(n.startswith(("stage3", "stage4")) for n in pair)
    full = models.resnet50(1000)
    assert sum(isinstance(m, Bottleneck) and m.pair
               for m in full.modules()) == 13


@pytest.mark.parametrize("fold", [False, True])
def test_f32_logits_match_jax(trained, jax_logits, fold):
    _, params, state, x = trained
    ref = jax_logits("f32", fold)
    out = _port_logits(params, state, x, "f32", fold)
    # float32 on both sides (JAX at Precision.HIGHEST), sums in another
    # order through 53 convs: 1e-4 of the logits' scale
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale)


# bf16: the two sides round at different points (the port's conv_pair
# keeps the 1x1 and 3x3 sums in float32 through the BN epilogue, where
# JAX rounds each conv output to bf16 first), and the differences
# compound through 16 blocks.  Measured on the CPU, max |diff| / max |ref|:
# 0.023 unfolded and 0.021 folded against JAX in bf16 (JAX's own bf16
# logits sit 0.012-0.016 from its float32 ones); the bound is 0.05.
BF16_REL = 0.05


@pytest.mark.parametrize("fold", [False, True])
def test_bf16_logits_match_jax(trained, jax_logits, fold):
    _, params, state, x = trained
    ref = jax_logits("bf16", fold)
    out = _port_logits(params, state, x, "bf16", fold)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < BF16_REL, err
    # and bf16 stays close to the float32 answer
    f32 = jax_logits("f32", fold)
    assert np.abs(out - f32).max() / np.abs(f32).max() < BF16_REL


def test_checkpoint_load_gives_same_logits(trained, tmp_path):
    net, params, state, x = trained
    net.save(str(tmp_path))
    p_ck, s_ck = weights.load_jax_checkpoint(str(tmp_path))
    assert set(p_ck) == set(params) and set(s_ck) == set(state)
    from_file = _port_logits(p_ck, s_ck, x, "f32", True)
    from_memory = _port_logits(params, state, x, "f32", True)
    np.testing.assert_array_equal(from_file, from_memory)
