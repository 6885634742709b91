"""The port's flash attention and its dispatch against the JAX package, on
the CPU.

On a CPU tensor each of the port's three kernel wrappers (forward, dQ,
dK/dV) runs its plain PyTorch version; the JAX side runs its Pallas kernels
in interpret mode (``interpret=True``) or its einsum reference.  Inputs are
made with numpy from a seed and handed to both.  Tolerances: float32
outputs within 1e-5, gradients within 1e-4 (the same products summed in
another order); bf16 outputs within one bf16 rounding.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu.ops import attention as jatt
from myconvnet_tpu_torch.ops import attention as tatt
from myconvnet_tpu_torch.ops.kernels import flash_attention as tfa

# the package exports the function under the module's name
jfa = importlib.import_module("myconvnet_tpu.ops.pallas.flash_attention")
torch.set_num_threads(1)

# L % block != 0 (block_q 32 on the JAX side, 64-row tiles on the card)
# and ViT-B/16's length at 224
CASES = [(2, 3, 64, 32), (1, 2, 100, 16), (1, 2, 197, 64)]


def _qkv(b, h, l, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, l, d).astype(np.float32) for _ in range(3)]


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


def _jflash(q, k, v, **kw):
    return jfa.flash_attention(q, k, v, block_q=32, interpret=True, **kw)


@pytest.mark.parametrize("shape", CASES)
def test_flash_forward_matches_jax(shape):
    q, k, v = _qkv(*shape, seed=shape[2])
    out = tfa.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(out, np.asarray(_jflash(q, k, v)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jatt.attention_reference(
        q, k, v)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", CASES)
def test_flash_gradients_match_jax(shape):
    """dq, dk, dv of <attention(q, k, v), g> through the port's
    autograd Function (its plain backward on the CPU) against JAX's
    custom_vjp (Pallas dQ and dK/dV kernels, interpreted) and against
    the gradient of the einsum reference."""
    q, k, v = _qkv(*shape, seed=shape[2] + 1)
    g = np.random.RandomState(9).randn(*shape).astype(np.float32)
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    tfa.flash_attention(tq, tk, tv).backward(_t(g))
    got = [t.grad.numpy() for t in (tq, tk, tv)]

    def grads(fn):
        return jax.grad(lambda *a: jnp.vdot(fn(*a), g),
                        argnums=(0, 1, 2))(q, k, v)

    for want in (grads(_jflash), grads(jatt.attention_reference)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=1e-4)


def test_flash_residuals_and_each_backward_kernel_match_jax():
    """Each plain version against the Pallas kernel it stands for: the
    forward's float32 logsumexp, then dQ and dK/dV from the same
    residuals (D = rowsum(dO * O) beside dQ)."""
    b, h, l, d = 1, 2, 70, 16
    q, k, v = _qkv(b, h, l, d, seed=11)
    do = np.random.RandomState(12).randn(b, h, l, d).astype(np.float32)
    flat = [jnp.asarray(a.reshape(b * h, l, d)) for a in (q, k, v, do)]
    scale = d ** -0.5
    jo, jlse = jfa._fwd(*flat[:3], scale, 32, True)
    jdq, jdk, jdv = jfa._bwd(*flat[:3], flat[3], jo, jlse, scale, 32, True)
    o, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(o.numpy().reshape(b * h, l, d), jo,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, 1, l), jlse,
                               rtol=1e-5, atol=1e-5)
    dq, dl = tfa.flash_attention_dq(_t(q), _t(k), _t(v), o, _t(do), lse)
    dk, dv = tfa.flash_attention_dkv(_t(q), _t(k), _t(v), _t(do), lse, dl)
    np.testing.assert_allclose(
        dl.numpy(), (do * o.numpy()).sum(-1), rtol=1e-5, atol=1e-5)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy().reshape(b * h, l, d),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)


def test_flash_bf16_inputs():
    """bf16 in, bf16 out, float32 inside on both sides: one rounding of
    nearly equal float32 values apart (2^-7 of the output's scale)."""
    q, k, v = _qkv(1, 2, 64, 32, seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(_jflash(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (_t(a).bfloat16() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())
    grads = torch.autograd.grad(
        tfa.flash_attention(*(t.requires_grad_() for t in (tq, tk, tv))),
        (tq, tk, tv), torch.ones_like(out))
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_flash_custom_scale():
    q, k, v = _qkv(1, 1, 64, 32, seed=5)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), scale=0.05).numpy()
    np.testing.assert_allclose(out, np.asarray(_jflash(q, k, v,
                                                       scale=0.05)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jatt.attention_reference(
        q, k, v, scale=0.05)), rtol=1e-5, atol=1e-5)


def test_flash_shape_validation():
    q, k, v = (_t(a) for a in _qkv(1, 1, 32, 16, seed=0))
    with pytest.raises(ValueError):
        tfa.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="cross-length"):
        tfa.flash_attention(q, k[:, :, :16], v)


def test_kernel_wrappers_run_plain_versions_only_on_the_cpu():
    """A tensor on another device than the CPU goes to the kernel or
    raises; the wrappers never fall back."""
    q = torch.empty(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no flash_attention"):
        tfa.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="no flash_attention"):
        tfa.flash_attention_dq(q, q, q, q, q, torch.empty(1, 1, 8))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_dq.launches,
              tfa.flash_attention_dkv.launches)
    q, k, v = (_t(a, True) for a in _qkv(1, 1, 8, 16, seed=1))
    tfa.flash_attention(q, k, v).sum().backward()
    assert before == (tfa.flash_attention_fwd.launches,
                      tfa.flash_attention_dq.launches,
                      tfa.flash_attention_dkv.launches)


def test_mha_dropout_reference_path():
    """With JAX's own keep mask handed over, the port's dropout path
    equals JAX's; dropout needs a mask (JAX: a key) and never takes the
    flash kernels."""
    q, k, v = _qkv(1, 2, 48, 16, seed=13)
    rng = jax.random.PRNGKey(0)
    want = jatt.multi_head_attention(q, k, v, dropout_rate=0.5,
                                     dropout_rng=rng, use_flash=False)
    mask = jax.random.bernoulli(rng, 0.5, (1, 2, 48, 48))
    out = tatt.multi_head_attention(_t(q), _t(k), _t(v), dropout_rate=0.5,
                                    dropout_mask=_t(mask), use_flash=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    exact = tatt.multi_head_attention(_t(q), _t(k), _t(v))
    assert not np.allclose(out.numpy(), exact.numpy())
    with pytest.raises(ValueError):
        tatt.multi_head_attention(_t(q), _t(k), _t(v), dropout_rate=0.5,
                                  dropout_mask=_t(mask), use_flash=True)
    with pytest.raises(ValueError, match="dropout_mask"):
        tatt.attention_reference(_t(q), _t(k), _t(v), dropout_rate=0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_dispatch_default_cpu(dtype):
    """CPU tensors take the einsum reference at any dtype (the kernels
    are for bf16 CUDA tensors); in float32 it equals JAX's."""
    q, k, v = _qkv(1, 1, 32, 16, seed=17)
    tq, tk, tv = (_t(a).to(dtype) for a in (q, k, v))
    out = tatt.multi_head_attention(tq, tk, tv)
    torch.testing.assert_close(out, tatt.attention_reference(tq, tk, tv),
                               rtol=0, atol=0)
    if dtype == torch.float32:
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jatt.multi_head_attention(q, k, v)),
            rtol=1e-6, atol=1e-6)
