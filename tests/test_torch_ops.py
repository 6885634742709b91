"""Port ops (myconvnet_tpu_torch.ops) against the JAX ops, on the CPU.

Inputs are made with numpy from a seed and fed to both sides.  JAX runs in
float32 with ``precision="highest"`` (this CPU backend otherwise lowers
float32 convs to bf16 passes); the port runs float32 on the CPU.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from myconvnet_tpu.ops import batch_norm as jbn
from myconvnet_tpu.ops import conv as jconv
from myconvnet_tpu.ops import pool as jpool
from myconvnet_tpu_torch.ops import (batch_norm_inference, conv2d,
                                     global_avg_pool, max_pool2d)
from myconvnet_tpu_torch.ops.conv import same_pads

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


# float32 sums of up to 7*7*6 products taken in another order
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(9, 9), (8, 10)])
def test_conv2d_same_matches_jax(k, stride, hw):
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, *hw, 6).astype(np.float32)
    w = (rng.randn(k, k, 6, 5) / np.sqrt(k * k * 6)).astype(np.float32)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                       padding="SAME", precision=lax.Precision.HIGHEST)
    out = conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                 padding="SAME")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("rate", [2, 4, 16])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_dilated_same_matches_jax(rate, stride):
    """PWC-Net's context net: SAME pads from the effective kernel
    (k - 1) * rate + 1, also where that is wider than the frame."""
    rng = np.random.RandomState(rate)
    x = rng.randn(2, 9, 12, 4).astype(np.float32)
    w = (rng.randn(3, 3, 4, 5) / 6.0).astype(np.float32)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                       padding="SAME", dilation=rate,
                       precision=lax.Precision.HIGHEST)
    out = conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                 padding="SAME", dilation=rate)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def test_conv2d_explicit_padding_and_bias():
    rng = np.random.RandomState(3)
    x = rng.randn(1, 11, 11, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 8).astype(np.float32) * 0.2
    b = rng.randn(8).astype(np.float32)
    pads = ((1, 1), (0, 2))
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2,
                       padding=pads, precision=lax.Precision.HIGHEST) + b
    out = conv2d(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(b), stride=2, padding=pads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("size,k,s,want", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (56, 1, 2, (0, 0)),
    (112, 3, 2, (0, 1)), (7, 3, 1, (1, 1))])
def test_same_pads_tf_rule(size, k, s, want):
    assert same_pads(size, k, s) == want


@pytest.mark.parametrize("hw", [(9, 9), (8, 11)])
@pytest.mark.parametrize("padding", ["SAME", ((1, 1), (1, 1))])
def test_max_pool2d_matches_jax(hw, padding):
    x = np.random.RandomState(4).randn(2, *hw, 3).astype(np.float32)
    jpad = padding if padding == "SAME" else ((0, 0), *padding, (0, 0))
    ref = jpool.max_pool2d(jnp.asarray(x), 3, 2, padding=jpad)
    out = max_pool2d(torch.from_numpy(x), 3, 2, padding=padding)
    # a max selects one input: exact
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_max_pool2d_pads_with_minus_inf():
    x = -np.ones((1, 4, 4, 1), np.float32) * 5.0
    out = max_pool2d(torch.from_numpy(x), 3, 2, "SAME")
    assert (out.numpy() == -5.0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_avg_pool_matches_jax(dtype):
    x = np.random.RandomState(5).randn(2, 5, 7, 4).astype(np.float32)
    ref = jpool.global_avg_pool(jnp.asarray(x, dtype))
    out = global_avg_pool(torch.from_numpy(x).to(getattr(torch, dtype)))
    # float32 mean in both, one rounding to the dtype at the end
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=1e-6 if dtype == "float32" else 1e-2,
                               atol=1e-6)


def test_batch_norm_inference_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 3, 16).astype(np.float32)
    g, b = rng.rand(16) + 0.5, rng.randn(16)
    m, v = rng.randn(16), rng.rand(16) + 0.1
    args = [a.astype(np.float32) for a in (g, b, m, v)]
    ref = jbn.batch_norm_inference(jnp.asarray(x),
                                   *map(jnp.asarray, args), 1e-5)
    out = batch_norm_inference(torch.from_numpy(x),
                               *map(torch.from_numpy, args), 1e-5)
    # one rsqrt, a multiply and an add in float32 on each side
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_port_imports_no_jax():
    """No module of the port imports jax or the JAX package."""
    root = pathlib.Path(__file__).resolve().parents[1] / \
        "myconvnet_tpu_torch"
    files = sorted(root.rglob("*.py"))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "myconvnet_tpu"), \
                    f"{f.name} imports {n}"
