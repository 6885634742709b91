"""The port's RepVGG, train and deploy forms, against the JAX package, on
the CPU.

``tinyrepvgg`` (a = 0.125, b = 0.25, stages (1, 1, 2, 2, 1)) at 32x32 and
10 classes, its weights made with numpy from a seed in the JAX layout and
loaded through ``weights.from_jax``: the train form as
``test_torch_zoo`` holds the other families (float32 eval logits within
1e-4 of max |JAX logit|; the train step's logits, loss, gradients and BN
statistics within 1e-4, with the head's dropout draws handed over by
site), ``deploy_params`` against JAX's within 1e-6 of each leaf's
largest, the deploy form against JAX's ``repvgg_deploy`` and against the
train form's eval forward within 1e-4, and the folded-BN count of the
train form equal to JAX's ``folded_scope_count``.  A RepVGG-A0 run at
full width (32x32, one step) exports through ``test --export`` and its
artifact gives the in-memory deploy program's bits.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.models import folding as jfolding
from myconvnet_tpu_torch import models, serving, test as test_entry, \
    train as train_entry, weights
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.core.precision import BF16
from myconvnet_tpu_torch.models import folding, repvgg

from test_torch_zoo import (HW, NEW_NAMES, check_builds, check_eval,
                            check_scopes, check_train_step, count_routes,
                            make_trees, x_batch)

torch.set_num_threads(1)

# the JAX package's ``models.repvgg`` is shadowed by the function of that
# name in its ``__init__``
jrepvgg = importlib.import_module("myconvnet_tpu.models.repvgg")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dropout_rate=0.2)
CLASSES = 10


@pytest.fixture(scope="module")
def trees():
    return make_trees("tinyrepvgg", TINY, 3)


def _np(tree):
    return {s: {n: np.asarray(v) for n, v in d.items()}
            for s, d in tree.items()}


def test_scopes_match_the_jax_init_tree():
    check_scopes("tinyrepvgg", TINY)


def test_eval_logits_match_jax(trees):
    check_eval("tinyrepvgg", TINY, trees)


def test_train_step_matches_jax_f32(trees, monkeypatch):
    check_train_step("tinyrepvgg", TINY, trees, monkeypatch)


def test_deploy_params_match_jax(trees):
    """Every folded 3x3 and bias within 1e-6 of the leaf's largest, the
    head as it was; the tree's scopes are JAX's."""
    params, state = trees
    want = _np(jrepvgg.deploy_params(params, state))
    model = weights.from_jax(models.get_model("tinyrepvgg", CLASSES, **TINY),
                             params, state)
    got = {s: {n: v.numpy() for n, v in d.items()}
           for s, d in repvgg.deploy_params(model).items()}
    assert set(got) == set(want)
    for scope, d in want.items():
        assert set(got[scope]) == set(d)
        for n, ref in d.items():
            assert got[scope][n].shape == ref.shape
            np.testing.assert_allclose(
                got[scope][n], ref, rtol=1e-6,
                atol=1e-6 * np.abs(ref).max(), err_msg=f"{scope}/{n}")


def test_deploy_forward_matches_jax_and_the_train_form(trees):
    """The deploy form over the folded tree against JAX's
    ``repvgg_deploy`` over JAX's, and against the train form's eval
    logits, each within 1e-4 of max |logit| (float32)."""
    params, state = trees
    x = x_batch()
    jdep = transform(lambda v, train=False: jrepvgg.DEPLOY_FORWARDS[
        "tinyrepvgg"](v, CLASSES, train=train))
    folded = jrepvgg.deploy_params(params, state)

    def apply(p, v):
        with policy_scope(JFULL):
            return jdep.apply(p, {}, None, v, False)[0]

    want = np.asarray(jax.jit(apply)(folded, jnp.asarray(x)))
    model = weights.from_jax(models.get_model("tinyrepvgg", CLASSES, **TINY),
                             params, state).eval()
    dep = repvgg.deploy_model(model, "tinyrepvgg", CLASSES)
    with torch.no_grad():
        got = dep(torch.from_numpy(x)).numpy()
        train_form = model(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(got, train_form, rtol=1e-4, atol=1e-4 * scale)


def test_folded_count_is_jaxs(trees):
    """The train form folds JAX's ``folded_scope_count`` pairs (``conv3``
    /``bn3`` and ``conv1``/``bn1`` a block; ``bnid`` has no conv) and
    keeps its eval logits within 1e-4 of max |logit|."""
    params, state = trees
    model = weights.from_jax(models.get_model("tinyrepvgg", CLASSES, **TINY),
                             params, state).eval()
    x = torch.from_numpy(x_batch())
    with torch.no_grad():
        before = model(x).numpy()
        n = folding.fold_batch_norms(model)
        after = model(x).numpy()
    assert n == jfolding.folded_scope_count(params, state) == 2 * 7
    np.testing.assert_allclose(after, before, rtol=1e-4,
                               atol=1e-4 * np.abs(before).max())


def test_deploy_routing_of_a0(monkeypatch):
    """RepVGG-A0's deploy form under bf16: B4 at the 17 stride-1 blocks,
    cuDNN + B1 (ReLU) at the 5 stride-2 ones; the train form's eval
    forward launches none of them."""
    model = models.get_model("repvgg_a0", 1000)
    init_model(model, torch.Generator().manual_seed(0))
    dep = repvgg.deploy_model(model.eval(), "repvgg_a0", 1000)
    x = torch.from_numpy(x_batch(2, 1)).to(torch.bfloat16)
    calls = count_routes(dep.to(torch.bfloat16), x, monkeypatch)
    assert (calls["b1"], calls["b4"], calls["b5"]) == ({"relu": 5}, 17, 0)
    calls.update(b1={}, b4=0, b5=0)
    with torch.no_grad():
        model.to(torch.bfloat16)(x)
    assert calls == {"b1": {}, "b4": 0, "b5": 0}


@pytest.mark.parametrize("name", [n for n in NEW_NAMES
                                  if "repvgg" in n])
def test_listed_name_builds_with_the_jax_tree(name):
    check_builds(name)


def test_export_of_a0_is_the_deploy_program(tmp_path):
    """``train`` then ``test --export`` of the RepVGG-A0 recipe at 32x32:
    the artifact is the reparameterized deploy program (its graph holds
    ``mcn::conv_fused`` 17 and ``mcn::bn_act`` 5 under bf16, and no BN),
    and on the same rows it gives the in-memory deploy program's bits."""
    config = os.path.join(ROOT, "configs", "imagenet_repvgg_a0.py")
    sets = ["--set", f"input_hw=[{HW},{HW}]", "--set",
            f"augment.out_hw=[{HW},{HW}]", "--set", "synthetic_n=8"]
    ckpt, art = str(tmp_path / "run"), str(tmp_path / "a0.pt2")
    train_entry.main(["--config", config, "--synthetic", "--device", "cpu",
                      "--steps", "1", "--batch", "4", "--out", ckpt, *sets])
    test_entry.main(["--config", config, "--synthetic", "--device", "cpu",
                     "--ckpt", ckpt, "--export", art, *sets])
    meta = serving.artifact_meta(art)
    assert meta["ops"] == {"bn_act": 5, "conv_fused": 17}
    assert meta["input_shape"] == [8, HW, HW, 3]
    held = list(torch.export.load(art).state_dict)
    assert held and not any(k in name for name in held
                            for k in ("bn3", "bn1", "bnid", "moving"))
    params, state = weights.load_jax_checkpoint(ckpt)
    model = weights.from_jax(models.get_model("repvgg_a0", 1000), params,
                             state)
    dep = repvgg.deploy_model(model.eval(), "repvgg_a0", 1000)
    fn = serving.make_inference_fn(dep, None, None, fold_bn=False,
                                   device="cpu", policy=BF16)
    x = np.random.RandomState(0).randn(8, HW, HW, 3).astype(np.float32)
    got = serving.load_inference(art)(x)
    with torch.no_grad():
        want = fn.program(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, want)
