"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels run in interpret mode (as tests/test_pallas.py
and tests/test_pallas_conv_pair.py run them) and against the XLA
reference.  The CUDA kernels themselves are held against the plain
versions in tests/test_torch_kernels_gpu.py, on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.ops.pallas import affine as jaffine
from myconvnet_tpu.ops.pallas import bn_act as jbn_act
from myconvnet_tpu.ops.pallas import conv_fused as jconv_fused
from myconvnet_tpu.ops.pallas import conv_pair as jconv_pair
from myconvnet_tpu.ops.pallas.normalize_u8 import \
    normalize_u8 as jnormalize_u8
from myconvnet_tpu.ops.pallas.pad_crop_u8 import (
    pad_crop_flip_normalize as jpad_crop,
    reference_pad_crop_flip_normalize as jpad_crop_numpy)
from myconvnet_tpu.ops.pallas import randaugment_ew as jew
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.ops.kernels import (bn_inference_fused,
                                             conv1x1_conv3x3_bn_relu,
                                             conv3x3_bn_relu,
                                             fused_scale_shift_act,
                                             pad_crop_flip_normalize,
                                             reset_launch_counts,
                                             launch_counts)
from myconvnet_tpu_torch.ops.kernels import (affine, bn_act, conv_fused,
                                             conv_pair, normalize_u8,
                                             pad_crop_u8, randaugment_ew)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


ACTS = ["none", "relu", "relu6", "leaky_relu"]
# the same float32 x*a+b on both sides, possibly fused into one FMA by
# XLA: 1 float32 ulp, or 1 bf16 ulp (2**-8 relative) after rounding
BN_ACT_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
              "bfloat16": dict(rtol=2 ** -8, atol=1e-6)}


def _bn_act_inputs(dtype, c=24, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 5, 3, c) * 4).astype(np.float32)
    a = (rng.rand(c) + 0.5).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    x = np.array(jnp.asarray(x, dtype).astype(jnp.float32))  # on grid
    return x, a, b


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_scale_shift_act_plain_matches_pallas(dtype, act):
    x, a, b = _bn_act_inputs(dtype)
    ref = jbn_act.fused_scale_shift_act(jnp.asarray(x, dtype),
                                        jnp.asarray(a), jnp.asarray(b),
                                        act=act, interpret=True)
    reset_launch_counts()
    out = fused_scale_shift_act(_t(x, dtype), torch.from_numpy(a),
                                torch.from_numpy(b), act)
    assert out.dtype == getattr(torch, dtype)
    assert launch_counts()["bn_act"] == 0  # CPU: plain version, no launch
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               **BN_ACT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_inference_fused_plain_matches_pallas(dtype):
    x, _, _ = _bn_act_inputs(dtype, seed=1)
    rng = np.random.RandomState(2)
    g, b = rng.rand(24) + 0.5, rng.randn(24)
    m, v = rng.randn(24), rng.rand(24) + 0.1
    stats = [s.astype(np.float32) for s in (g, b, m, v)]
    ref = jbn_act.bn_inference_fused(jnp.asarray(x, dtype),
                                     *map(jnp.asarray, stats), 1e-5,
                                     act="relu", interpret=True)
    out = bn_inference_fused(_t(x, dtype), *map(torch.from_numpy, stats),
                             1e-5, act="relu")
    # the rsqrt may differ by an ulp between XLA and ATen
    tol = dict(BN_ACT_TOL[dtype], rtol=max(BN_ACT_TOL[dtype]["rtol"], 4e-6))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_bn_act_wrapper_checks():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        fused_scale_shift_act(x, torch.ones(4), torch.zeros(8))
    with pytest.raises(ValueError):
        fused_scale_shift_act(x, torch.ones(8), torch.zeros(8), "gelu")
    with pytest.raises(ValueError):  # no kernel and no plain path there
        fused_scale_shift_act(x.to("meta"), torch.ones(8), torch.zeros(8))


# (n, h, w, cin, cm, cout): a 7x7 map as in stage 4, and odd sizes that
# leave partial tiles
PAIR_SHAPES = [(2, 7, 7, 32, 16, 16), (1, 9, 6, 64, 32, 48),
               (2, 5, 4, 16, 8, 8)]


def _pair_inputs(n, h, w, cin, cm, co, seed=0):
    rng = np.random.RandomState(seed)

    def bf(a):  # values on the bf16 grid, held as float32
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    x = bf(rng.randn(n, h, w, cin))
    w1 = bf(rng.randn(1, 1, cin, cm) / np.sqrt(cin))
    w3 = bf(rng.randn(3, 3, cm, co) / np.sqrt(9 * cm))
    s1 = (rng.rand(cm) + 0.5).astype(np.float32)
    b1 = (rng.randn(cm) * 0.3).astype(np.float32)
    s3 = (rng.rand(co) + 0.5).astype(np.float32)
    b3 = (rng.randn(co) * 0.3).astype(np.float32)
    return x, w1, s1, b1, w3, s3, b3


def _torch_pair_args(args):
    x, w1, s1, b1, w3, s3, b3 = (torch.from_numpy(a) for a in args)
    return (x.bfloat16(), w1.bfloat16(), s1, b1, w3.bfloat16(), s3, b3)


# Both sides take bf16 inputs, sum in float32 and round the intermediate
# to bf16; sums in another order can flip an intermediate by 1 bf16 ulp,
# which moves an output by ~|w3| * 2**-8 before its own bf16 rounding.
# Allowed: 2 bf16 ulps of the output (measured on the CPU: 2.4e-4
# absolute, 0.4% relative at most, against the Pallas kernel).
PAIR_TOL = dict(rtol=2 ** -6, atol=2 ** -7)


@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_conv_pair_plain_matches_pallas(shape):
    args = _pair_inputs(*shape)
    jargs = [jnp.asarray(a, jnp.bfloat16 if i in (0, 1, 4) else
                         jnp.float32) for i, a in enumerate(args)]
    with pltpu.force_tpu_interpret_mode():
        ref = jconv_pair.conv1x1_conv3x3_bn_relu(*jargs)
    xla = jconv_pair.conv_pair_reference(*jargs)
    reset_launch_counts()
    out = conv1x1_conv3x3_bn_relu(*_torch_pair_args(args))
    assert launch_counts()["conv_pair"] == 0
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **PAIR_TOL)
    np.testing.assert_allclose(got, np.asarray(xla, np.float32), **PAIR_TOL)


def test_conv_pair_zero_pads_the_intermediate():
    """A halo pixel outside the image is 0, not relu(bias1): with a large
    bias1 the border outputs differ between the two readings."""
    n, h, w, cin, cm, co = 1, 4, 4, 16, 16, 16
    x = torch.zeros(n, h, w, cin, dtype=torch.bfloat16)
    w1 = torch.zeros(1, 1, cin, cm, dtype=torch.bfloat16)
    w3 = torch.ones(3, 3, cm, co, dtype=torch.bfloat16) / 16
    one_c, one_o = torch.ones(cm), torch.ones(co)
    out = conv1x1_conv3x3_bn_relu(x, w1, one_c, one_c, w3, one_o,
                                  torch.zeros(co)).float()
    # interior pixel sees 9 taps of 1 (x cm/16 = 1), a corner only 4
    assert out[0, 1, 1, 0].item() == 9.0
    assert out[0, 0, 0, 0].item() == 4.0


def test_conv_pair_wrapper_checks_and_routing_helpers():
    args = _torch_pair_args(_pair_inputs(1, 4, 4, 16, 8, 8))
    bad = list(args)
    bad[4] = bad[4][:, :, :4]  # w3 Cm mismatch
    with pytest.raises(ValueError):
        conv1x1_conv3x3_bn_relu(*bad)
    with pytest.raises(ValueError):
        conv1x1_conv3x3_bn_relu(*[a.to("meta") for a in args])
    assert conv_pair.supports(256, 64, 64)
    assert conv_pair.supports(2048, 512, 512)
    assert not conv_pair.supports(32, 32, 32)    # Cin not a multiple of 64
    assert not conv_pair.supports(64, 16, 16)    # Cm not a multiple of 32
    assert not conv_pair.supports(64, 32, 8)     # Cout not a multiple of 16
    assert not conv_pair.supports(4096, 1024, 1024)  # tile > 227 KB


# ---------------------------------------------------------------- inputs

CIFAR_MEAN = (0.5071, 0.4866, 0.4409)
CIFAR_STD = (0.2673, 0.2564, 0.2762)
# float32 on both sides; x * (1 / (255 std)) - mean / std against the JAX
# (x / 255 - mean) / std rounds differently: atol 1e-5 (values are O(2))
INPUT_TOL = dict(rtol=0, atol=1e-5)
# bf16 outputs: the float32 values may differ by an ulp before rounding,
# which can move a bf16 result by 1 bf16 ulp
INPUT_TOL_BF16 = dict(rtol=2 ** -8, atol=1e-5)


def _cifar_cfg(**kw):
    kw = dict(dict(out_hw=(32, 32), area_range=None, pad=4, flip=True,
                   mean=CIFAR_MEAN, std=CIFAR_STD), **kw)
    return jaug.AugmentConfig(**kw), taug.AugmentConfig(**kw)


# per-channel statistics for C = 1 (Fashion-MNIST's) and C = 4
STATS = {1: ((0.2860,), (0.3530,)), 3: (CIFAR_MEAN, CIFAR_STD),
         4: ((0.5071, 0.4866, 0.4409, 0.5), (0.2673, 0.2564, 0.2762, 0.3))}


@pytest.mark.parametrize("out_dtype,shape", [
    pytest.param("float32", (3, 32, 32, 3), id="float32"),
    pytest.param("bfloat16", (3, 32, 32, 3), id="bfloat16"),
    # fashion_mnist_smallnet's input, four channels, an ImageNet eval batch
    *(pytest.param(d, s, id=f"{d}-{'x'.join(map(str, s))}")
      for s in [(4, 28, 28, 1), (2, 32, 32, 4), (2, 224, 224, 3)]
      for d in ("float32", "bfloat16"))])
def test_normalize_u8_plain_matches_pallas_and_augment_eval(out_dtype,
                                                            shape):
    imgs = np.random.RandomState(0).randint(0, 256, shape, dtype=np.uint8)
    mean, std = STATS[shape[-1]]
    reset_launch_counts()
    out = normalize_u8.normalize_u8(torch.from_numpy(imgs), mean, std,
                                    getattr(torch, out_dtype))
    assert launch_counts()["normalize_u8"] == 0
    assert out.dtype == getattr(torch, out_dtype)
    got = out.float().numpy()
    pallas = jnormalize_u8(
        jnp.asarray(imgs), mean, std, out_dtype=jnp.dtype(out_dtype),
        interpret=True)
    tol = INPUT_TOL if out_dtype == "float32" else INPUT_TOL_BF16
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), **tol)
    # augment_eval at the model's size is this kernel, in both packages
    jcfg, tcfg = _cifar_cfg(out_dtype=out_dtype, out_hw=shape[1:3],
                            mean=mean, std=std)
    np.testing.assert_allclose(
        got, np.asarray(jaug.augment_eval(jnp.asarray(imgs), jcfg),
                        np.float32), **tol)
    np.testing.assert_array_equal(
        taug.augment_eval(torch.from_numpy(imgs), tcfg).float().numpy(), got)


@pytest.mark.parametrize("shape,pad,flips", [
    pytest.param((8, 32, 32, 3), 4, True, id="shape0-4"),
    pytest.param((5, 9, 7, 2), 3, True, id="shape1-3"),
    # fashion_mnist_smallnet's (pad 2, no flip), four channels, ImageNet's
    pytest.param((4, 28, 28, 1), 2, False, id="4x28x28x1-2-noflip"),
    pytest.param((2, 32, 32, 4), 4, True, id="2x32x32x4-4"),
    pytest.param((2, 224, 224, 3), 4, True, id="2x224x224x3-4")])
def test_pad_crop_plain_matches_pallas_and_numpy(shape, pad, flips):
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, shape, dtype=np.uint8)
    n, c = shape[0], shape[-1]
    offsets = rng.randint(-pad, pad + 1, (n, 2)).astype(np.int32)
    offsets[0] = (-pad, pad)  # the corners of the offset range
    offsets[1] = (pad, -pad)
    flip = (np.arange(n) % 2 * flips).astype(np.int32)
    mean, std = STATS[c] if c != 2 else (CIFAR_MEAN[:c], CIFAR_STD[:c])
    reset_launch_counts()
    got = pad_crop_flip_normalize(
        torch.from_numpy(imgs), torch.from_numpy(offsets),
        torch.from_numpy(flip), mean, std, pad=pad).numpy()
    assert launch_counts()["pad_crop_u8"] == 0
    pallas = jpad_crop(
        jnp.asarray(imgs), jnp.asarray(offsets), jnp.asarray(flip), mean,
        std, pad=pad, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **INPUT_TOL)
    np.testing.assert_allclose(
        got, jpad_crop_numpy(
            imgs, offsets, flip, mean, std, pad=pad), **INPUT_TOL)


def test_augment_train_matches_jax_at_jax_draws():
    """The JAX augment_train (its bilinear matmuls at integer boxes,
    clamp=False) against the port's kernel application, fed the draws JAX
    made from the same key: pad_crop_boxes' layout and the flips."""
    imgs = np.random.RandomState(2).randint(0, 256, (16, 32, 32, 3),
                                            dtype=np.uint8)
    jcfg, tcfg = _cifar_cfg()
    key = jax.random.key(7)
    k_geom = jax.random.split(key, 3)[0]  # as augment_train splits it
    boxes, flip, clamp = jaug._sample_geometry(k_geom, 16, (32, 32), jcfg)
    assert clamp is False and np.asarray(flip).any()
    want = np.asarray(jaug.augment_train(key, jnp.asarray(imgs), jcfg))
    got = taug.augment_train(torch.from_numpy(imgs),
                             torch.from_numpy(np.array(boxes)),
                             torch.from_numpy(np.array(flip)), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **INPUT_TOL)


def test_input_wrapper_checks():
    x = torch.zeros(2, 4, 4, 3, dtype=torch.uint8)
    with pytest.raises(TypeError):
        normalize_u8.normalize_u8(x.float(), CIFAR_MEAN, CIFAR_STD)
    with pytest.raises(ValueError):
        normalize_u8.normalize_u8(x, CIFAR_MEAN[:2], CIFAR_STD[:2])
    with pytest.raises(ValueError):
        normalize_u8.normalize_u8(x.to("meta"), CIFAR_MEAN, CIFAR_STD)
    off, flip = torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2)
    with pytest.raises(ValueError):
        pad_crop_flip_normalize(x, off[:1], flip, CIFAR_MEAN, CIFAR_STD)
    with pytest.raises(TypeError):
        pad_crop_flip_normalize(x, off.float(), flip, CIFAR_MEAN, CIFAR_STD)
    with pytest.raises(TypeError):
        pad_crop_flip_normalize(x, off, flip, CIFAR_MEAN, CIFAR_STD,
                                out_dtype=torch.float16)


# the redesigned input kernels' planners: the aims of the redesign
# (CIFAR's batch, fashion_mnist_smallnet's, an ImageNet batch), then the
# card tests' odd shapes
INPUT_PLAN_SHAPES = [(128, 32, 32, 3), (128, 28, 28, 1), (256, 224, 224, 3),
                     (3, 5, 7, 3), (2, 4, 4, 8), (8, 224, 224, 3),
                     (2, 32, 32, 4), (3, 17, 13, 4), (5, 11, 3, 1),
                     (1, 1, 1, 1), (4, 1, 1, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", INPUT_PLAN_SHAPES)
def test_normalize_u8_plan_gives_each_thread_one_channel_phase(shape,
                                                               aligned,
                                                               dtype):
    """A numpy model of the launch (thread g at position g mod period,
    steps g // period + i qstep) touches every step exactly once, each
    thread's steps start at one channel, the grid is at most one wave, no
    larger than the work needs, and its indices fit 32 bits."""
    total, c = int(np.prod(shape)), shape[-1]
    p = normalize_u8.plan(total, c, dtype, aligned)
    step = 16 // torch.empty((), dtype=dtype).element_size() \
        if aligned else 1
    assert p["path"] == ("vector" if aligned else "scalar")
    assert p["step"] == step and p["nvec"] == total // step
    assert p["period"] * np.gcd(c, step) == c
    g = np.arange(p["threads"] * p["blocks"], dtype=np.int64)
    assert len(g) < 2 ** 31 and len(g) >= p["period"]
    assert p["threads"] == normalize_u8.THREADS
    assert p["blocks"] <= normalize_u8.SMS * normalize_u8.BLOCKS_SM
    assert (p["blocks"] - 1) * p["threads"] < max(p["nvec"], p["period"])
    qstep = len(g) // p["period"]
    pos, q0 = g % p["period"], g // p["period"]
    live = q0 < qstep
    visits = ((q0[live, None] + qstep * np.arange(
        -(-p["nvec"] // (qstep * p["period"])) + 1)[None, :])
        * p["period"] + pos[live, None])
    seen = visits[visits < p["nvec"]]
    assert len(seen) == p["nvec"]
    assert (np.sort(seen) == np.arange(p["nvec"])).all()
    phase = (visits * step) % c
    assert ((phase == (pos[live, None] * step) % c)
            | (visits >= p["nvec"])).all()
    assert total - p["nvec"] * step < step   # the tail, a thread each


def _band_cover(p, h, wc, e0):
    """Output elements of one band of p's plan that starts at element e0
    of y, as the kernel's threads write them: aligned vectors k = q period
    + pos, thread t at positions t mod period (threads >= period: q = t //
    period + i qstep) or t + i threads (q = 0, 1, ...), each lane of a
    vector at its q = 0 column and rpp rows further a step of q; then the
    ragged elements, a thread each.  One band of ``rows`` rows."""
    vec, period, rpp, threads = p["vec"], p["period"], p["rpp"], \
        p["threads"]
    length = min(p["rows"], h) * wc
    a0 = min(length, (vec - e0 % vec) % vec)
    nv = (length - a0) // vec
    t = np.arange(threads)
    if threads >= period:
        qstep = threads // period
        live = t < qstep * period
        pos, q = t[live] % period, t[live] // period
        q = (q[:, None] + qstep * np.arange(-(-nv // period) // qstep + 2)
             [None, :])
        pos = np.broadcast_to(pos[:, None], q.shape)
    else:
        pos = np.arange(period)         # thread pos % threads takes it
        q = np.arange(-(-nv // period) + 1)
        pos, q = np.broadcast_arrays(pos[:, None], q[None, :])
    k = q * period + pos
    keep = k < nv
    lanes = a0 + k[keep][:, None] * vec + np.arange(vec)[None, :]
    first = a0 + pos[keep][:, None] * vec + np.arange(vec)[None, :]
    qk = q[keep][:, None]
    assert (lanes // wc == first // wc + qk * rpp).all()
    assert (lanes % wc == first % wc).all()
    rest = np.r_[np.arange(a0), np.arange(a0 + nv * vec, length)]
    assert len(rest) <= threads
    return np.r_[lanes.ravel(), rest], length


# shapes at which blocks walk several bands, in each staging mode (the
# card tests force both there)
BAND_WALK_SHAPES = [(64, 224, 224, 3), (1024, 28, 28, 1), (600, 32, 32, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INPUT_PLAN_SHAPES + BAND_WALK_SHAPES
                         + [(1, 3, 80000, 3)])
def test_pad_crop_plan_covers_every_element_once(shape, dtype):
    """The bands of a plan cover each image's rows once, its items are at
    most one wave of blocks (which walk them, item b, b + blocks, ...),
    its shared memory is within a block's 227 KB and holds the band's
    rows, its indices fit 32 bits, and a numpy model of the kernel's
    threads writes every element of a band exactly once at each 16-byte
    alignment the band can start at."""
    n, h, w, c = shape
    p = pad_crop_u8.plan(n, h, w, c, dtype)
    wc = w * c
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    assert p["vec"] == vec and p["period"] * np.gcd(wc, vec) == wc
    assert p["rpp"] * np.gcd(wc, vec) == vec
    assert p["threads"] <= pad_crop_u8.MAX_THREADS and p["threads"] >= 32
    if p["period"] <= pad_crop_u8.MAX_THREADS:
        assert p["threads"] % p["period"] == 0   # every thread has work
    assert p["bands"] * p["rows"] >= h > (p["bands"] - 1) * p["rows"]
    assert p["items"] == n * p["bands"]
    assert 1 <= p["blocks"] <= max(1, p["items"])
    assert p["blocks"] <= pad_crop_u8.SMS * pad_crop_u8._blocks_sm(
        p["threads"], p["smem"])
    assert p["smem"] <= pad_crop_u8.SMEM_BLOCK
    table = -(-8 * c // 16) * 16
    buffers = 2 if p["items"] > p["blocks"] else 1   # blocks walk bands
    if p["mode"] == "direct":
        assert table + 2 * (wc + 16) > pad_crop_u8.SMEM_BLOCK
    else:
        assert p["smem"] >= table + buffers * (p["rows"] * wc + 16)
    assert 3 * h * wc < 2 ** 30 and p["rows"] * wc < 2 ** 31
    items = np.concatenate([np.arange(b, p["items"], p["blocks"])
                            for b in range(p["blocks"])])
    assert (np.sort(items) == np.arange(p["items"])).all()
    if n * h * wc > 2 ** 22:
        return  # the model at the card tests' sizes only
    for e0 in range(vec):
        cover, length = _band_cover(p, h, wc, e0)
        assert (np.sort(cover) == np.arange(length)).all(), e0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["copy", "direct"])
@pytest.mark.parametrize("shape", BAND_WALK_SHAPES)
def test_pad_crop_plan_makes_blocks_walk_bands(shape, mode, dtype):
    """A forced staging mode keeps its mode and a one-wave grid of blocks
    that each walk several bands, covering every band once; the copy mode
    gives such a block two band buffers."""
    n, h, w, c = shape
    p = pad_crop_u8.plan(n, h, w, c, dtype, mode=mode)
    assert p["mode"] == mode and p["items"] > p["blocks"], p
    assert p["blocks"] <= pad_crop_u8.SMS * pad_crop_u8._blocks_sm(
        p["threads"], p["smem"])
    assert p["bands"] * p["rows"] >= h > (p["bands"] - 1) * p["rows"]
    items = np.concatenate([np.arange(b, p["items"], p["blocks"])
                            for b in range(p["blocks"])])
    assert (np.sort(items) == np.arange(p["items"])).all()
    table = -(-8 * c // 16) * 16
    assert p["smem"] == (table if mode == "direct"
                         else table + 2 * (-(-(p["rows"] * w * c + 16)
                                             // 16) * 16))
    assert pad_crop_u8.launch_args(p)[1] == pad_crop_u8.MODES[mode]


@pytest.mark.parametrize("case,want", [
    (((128, 32, 32, 3), torch.float32), dict(rows=32, blocks=128)),
    (((128, 28, 28, 1), torch.bfloat16), dict(rows=28, blocks=128)),
    (((8, 224, 224, 3), torch.float32), dict(rows=14, blocks=128)),
    (((256, 224, 224, 3), torch.float32), dict(rows=16, items=3584)),
    (((1, 3, 80000, 3), torch.float32), dict(mode="direct"))])
def test_pad_crop_plan_picks_bands(case, want):
    """A block an image where it is small (the recipes' inputs), bands of
    about 11 KB of source rows at ImageNet's size, at least a wave of them
    for a small batch, and no staging for a row wider than shared memory."""
    shape, dtype = case
    p = pad_crop_u8.plan(*shape, dtype)
    assert {k: p[k] for k in want} == want, p
    if "mode" not in want:
        assert p["mode"] == "copy"


# ------------------------------------------------------------ conv_fused


def _fused_inputs(n, hw, c, co, seed=0):
    rng = np.random.RandomState(seed)

    def bf(a):  # values on the bf16 grid, held as float32
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    x = bf(rng.randn(n, hw, hw, c))
    w3 = bf(rng.randn(3, 3, c, co) / np.sqrt(9 * c))
    s = (rng.rand(co) + 0.5).astype(np.float32)
    b = (rng.randn(co) * 0.3).astype(np.float32)
    return x, w3, s, b


def _torch_fused_args(args):
    x, w3, s, b = (torch.from_numpy(a) for a in args)
    return x.bfloat16(), w3.bfloat16(), s, b


# Both sides take bf16 inputs, sum in float32 and apply the epilogue to
# the float32 sum before one bf16 rounding; sums in another order can move
# the output by a bf16 ulp: 2 bf16 ulps allowed, as for conv_pair.
FUSED_TOL = dict(rtol=2 ** -6, atol=2 ** -7)


@pytest.mark.parametrize("hw", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [8, 64])
def test_conv3x3_bn_relu_plain_matches_pallas(hw, c):
    args = _fused_inputs(2, hw, c, c)
    jargs = [jnp.asarray(a, jnp.bfloat16 if i < 2 else jnp.float32)
             for i, a in enumerate(args)]
    # both images in one Pallas block: with one image of 1x1, the
    # kernel's row shift (up to W + 1 = 2 rows) exceeds its block of 1 row
    # and the Pallas kernel fails to trace (a limit of the TPU kernel)
    with pltpu.force_tpu_interpret_mode():
        ref = jconv_fused.conv3x3_bn_relu(*jargs, images_per_block=2)
    xla = jconv_fused.conv3x3_bn_relu_reference(*jargs)
    reset_launch_counts()
    out = conv3x3_bn_relu(*_torch_fused_args(args))
    assert launch_counts()["conv_fused"] == 0
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), **FUSED_TOL)
    np.testing.assert_allclose(got, np.asarray(xla, np.float32), **FUSED_TOL)


def test_conv3x3_bn_relu_1x1_reads_only_the_centre_tap():
    """At H = W = 1 eight of the nine taps read padding: the output with
    random off-centre taps equals the output with them zeroed, bit for
    bit, and equals the centre tap's 1x1 conv."""
    x, w3, s, b = _torch_fused_args(_fused_inputs(4, 1, 64, 32, seed=3))
    centre = torch.zeros_like(w3)
    centre[1, 1] = w3[1, 1]
    out = conv3x3_bn_relu(x, w3, s, b)
    torch.testing.assert_close(out, conv3x3_bn_relu(x, centre, s, b),
                               rtol=0, atol=0)
    one = torch.relu((x.float()[:, 0, 0] @ w3.float()[1, 1]) * s + b)
    torch.testing.assert_close(out[:, 0, 0].float(),
                               one.bfloat16().float(), **FUSED_TOL)


def test_conv_fused_wrapper_checks():
    x, w3, s, b = _torch_fused_args(_fused_inputs(1, 4, 16, 8))
    with pytest.raises(ValueError):  # w3 Cin mismatch
        conv3x3_bn_relu(x, w3[:, :, :8], s, b)
    with pytest.raises(ValueError):  # scale length
        conv3x3_bn_relu(x, w3, s[:4], b)
    with pytest.raises(ValueError):  # no kernel and no plain path there
        conv3x3_bn_relu(*[a.to("meta") for a in (x, w3, s, b)])
    assert conv_fused.supports(8) and conv_fused.supports(512)
    assert not conv_fused.supports(12) and not conv_fused.supports(0)


# The planner of the conv_fused kernel: (n, h, w, c, cout) -> tile, split.
# CIFAR-100 ResNet-18's four eval shapes (batch 128) with the blocks the
# 64x64-tile grid alone gives (128, 64, 32, 16) lifted to 128 each;
# ImageNet ResNet-18's stride-1 sites at batch 8 and 1; the card tests' odd
# shapes.
CIFAR_FUSED = [(128, 8, 8, 64, 64), (128, 4, 4, 128, 128),
               (128, 2, 2, 256, 256), (128, 1, 1, 512, 512)]
IMAGENET_FUSED = [(b, hw, hw, c, c) for b in (8, 1)
                  for hw, c in ((56, 64), (28, 128), (14, 256), (7, 512))]
ODD_FUSED = [(3, 1, 1, 8, 16), (3, 2, 2, 8, 24), (2, 5, 7, 40, 72),
             (1, 9, 3, 16, 130), (3, 5, 7, 512, 72), (4, 1, 1, 8, 64),
             (4, 1, 1, 512, 64), (2, 4, 4, 16, 16)]
# VGG-16's 12 conv_fused sites at its eval batch of 512: eight shapes over
# its five maps (224 down to 14)
VGG_FUSED = [(512, 224, 224, 64, 64), (512, 112, 112, 64, 128),
             (512, 112, 112, 128, 128), (512, 56, 56, 128, 256),
             (512, 56, 56, 256, 256), (512, 28, 28, 256, 512),
             (512, 28, 28, 512, 512), (512, 14, 14, 512, 512)]


@pytest.mark.parametrize("shape", CIFAR_FUSED + IMAGENET_FUSED + ODD_FUSED
                         + VGG_FUSED)
def test_conv_fused_plan_holds_its_rules(shape):
    """Every plan: a box of at most 64 output pixels inside the map and the
    batch, whole images where the map has 64 pixels or fewer; a split among
    1, 2, 4, 8 that divides the stage count (taps that read only padding
    skipped, 64 channels a stage); a grid within one wave of the card
    (132 SMs x 3 blocks of 66,624 bytes of shared memory, 396 blocks); no
    split larger than needed for 7/8 of the SMs."""
    n, h, w, c, co = shape
    p = conv_fused.plan(*shape)
    g, th, tw = p["g"], p["th"], p["tw"]
    assert 1 <= g <= n and 1 <= th <= h and 1 <= tw <= w
    assert g * th * tw <= conv_fused.TILE_PIXELS
    if h * w <= conv_fused.TILE_PIXELS:
        assert (th, tw) == (h, w)
    taps = (3 if h > 1 else 1) * (3 if w > 1 else 1)
    assert p["stages"] == taps * -(-c // 64)
    assert p["split"] in conv_fused.SPLITS
    assert p["stages"] % p["split"] == 0
    tiles = -(-n // g) * -(-h // th) * -(-w // tw) * -(-co // 64)
    assert p["tiles"] == tiles and p["blocks"] == tiles * p["split"]
    assert (conv_fused.SMS, conv_fused.BLOCKS_PER_SM,
            conv_fused.ONE_WAVE) == (132, 3, 396)
    assert p["split"] == 1 or p["blocks"] <= conv_fused.ONE_WAVE
    if p["split"] > 1:  # half the split would not have been enough
        assert tiles * p["split"] // 2 < conv_fused.WANT


@pytest.mark.parametrize("shape", CIFAR_FUSED)
def test_conv_fused_plan_fills_the_card_at_cifar_maps(shape):
    """At CIFAR's four maps the split lifts each grid to 128 blocks (1, 2,
    4 and 8 ranks over 128, 64, 32 and 16 tiles), a wave at most."""
    p = conv_fused.plan(*shape)
    assert p["blocks"] == 128
    assert p["split"] == {8: 1, 4: 2, 2: 4, 1: 8}[shape[1]]


@pytest.mark.parametrize("shape", VGG_FUSED)
def test_conv_fused_plan_at_vgg_maps_stays_in_32_bit_launch_ranges(shape):
    """At VGG's maps the grid alone is many waves (split 1; 401,408 blocks
    of 32x2-pixel windows at 224x224x64), and every quantity the kernel
    keeps in a 32-bit int stays in range: the block index, the tile's
    image, row and column (its TMA box coordinates) and the channel
    offsets.  At the first map the output has 1.64e9 elements, below
    2^31, in 3.3 GB of bf16, above it: the store's offset is computed in
    size_t (``csrc/conv_fused.cu:235``) and the tensor maps take 64-bit
    byte strides."""
    n, h, w, c, co = shape
    p = conv_fused.plan(*shape)
    assert p["split"] == 1 and p["g"] == 1
    assert p["blocks"] == n * -(-h // p["th"]) * -(-w // p["tw"]) \
        * -(-co // 64) < 2 ** 31 - 1
    if h == 224:
        assert (p["th"], p["tw"], p["blocks"]) == (2, 32, 401_408)
        assert n * h * w * co < 2 ** 31 < 2 * n * h * w * co
    assert max(n, h, w, c, co) < 2 ** 15     # TMA coordinates and offsets
    assert h * w * c * 2 < 2 ** 31           # an image's bytes (a stride)


def test_conv_fused_plan_takes_a_forced_split_and_rejects_others():
    """``split`` forces a split that divides the stages (72 at 5x7x512) and
    raises on one that does not (9 at 5x7x40) or is not a cluster size."""
    for split in conv_fused.SPLITS:
        assert conv_fused.plan(3, 5, 7, 512, 72, split)["split"] == split
    with pytest.raises(ValueError):
        conv_fused.plan(2, 5, 7, 40, 72, 2)
    with pytest.raises(ValueError):
        conv_fused.plan(3, 5, 7, 512, 72, 3)
    x, w3, s, b = _torch_fused_args(_fused_inputs(1, 4, 16, 8))
    with pytest.raises(ValueError):  # 9 stages: no split of 2
        conv3x3_bn_relu(x, w3, s, b, split=2)
    torch.testing.assert_close(conv3x3_bn_relu(x, w3, s, b, split=1),
                               conv3x3_bn_relu(x, w3, s, b), rtol=0, atol=0)


# ------------------------------------------------------ RandAugment (B7, B8)

# XLA on the CPU fuses the Pallas shear's multiply-adds into FMAs (shift =
# s * y + t and both taps; an exact emulation of that matches it bit for
# bit), where the port rounds each product and sum as the Pallas source
# writes them: measured up to 8.3e-7 on [0, 1] images, 2e-6 allowed
SHEAR_TOL = dict(rtol=0, atol=2e-6)
SLOPES = np.array([-0.3, -0.12, 0.0, 0.3], np.float32)


def _img01(n, h, w, seed):
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("hw", [(20, 24), (33, 17)])
def test_shear_rows_plain_matches_pallas(hw):
    """Slopes up to +-max_abs_slope with offsets that push rows past both
    edges; H = 33 spans two of the Pallas kernel's 32-row blocks."""
    x = _img01(4, *hw, seed=0)
    offset = np.array([2.5, -3.25, 0.0, -7.0], np.float32)
    want = jaffine.shear_rows(jnp.asarray(x), jnp.asarray(SLOPES),
                              jnp.asarray(offset), max_abs_slope=0.3,
                              fill=0.25, interpret=True)
    reset_launch_counts()
    got = affine.shear_rows(torch.from_numpy(x), torch.from_numpy(SLOPES),
                            torch.from_numpy(offset), max_abs_slope=0.3,
                            fill=0.25)
    assert launch_counts()["shear_rows"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SHEAR_TOL)


@pytest.mark.parametrize("op", ["shear_x", "shear_y", "rotate"])
def test_shear_and_rotate_plain_match_pallas(op):
    """The centred shears at slopes up to +-0.3 and the three-shear
    rotation at up to +-30 degrees; the column shear is the kernel along
    the rows (no transpose)."""
    x = _img01(4, 20, 24, seed=1)
    if op == "rotate":
        arg = SLOPES * np.float32(np.pi / 6 / 0.3)  # +-30 degrees
        kw = dict(max_abs_radians=np.pi / 6)
    else:
        arg, kw = SLOPES, dict(max_abs_slope=0.3)
    want = getattr(jaffine, op)(jnp.asarray(x), jnp.asarray(arg),
                                interpret=True, **kw)
    got = getattr(affine, op)(torch.from_numpy(x), torch.from_numpy(arg),
                              **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SHEAR_TOL)
    np.testing.assert_array_equal(got[2].numpy(), x[2])  # angle 0
    if op == "shear_y":  # the column shear is the row shear transposed
        t = affine.shear_x(torch.from_numpy(x).transpose(1, 2).contiguous(),
                           torch.from_numpy(arg))
        torch.testing.assert_close(got, t.transpose(1, 2), rtol=0, atol=0)


# Slopes and offsets at which slope * y + offset is an exact integer k for
# one row y: an FMA (XLA's fused multiply-add on the CPU) gives k, the
# port's separate roundings k - 1 ulp, so floor(shift) differs by a whole
# pixel there (found by searching the two numpy roundings below)
INTEGER_SHIFTS = [(0.09784692525863647, -0.07631617784500122, 11),
                  (0.29273349046707153, -0.46366745233535767, 5),
                  (0.25677502155303955, -2.621950387954712, 18),
                  (-0.15562570095062256, 1.6456369161605835, 17)]


def _shift_fma(s, y, t):
    """One rounding of the exact s * y + t (s * y is exact in float64)."""
    return np.float32(np.float64(s) * y + np.float64(t))


def _shift_rounded_apart(s, y, t):
    """The port's arithmetic: the product rounded, then the sum."""
    return np.float32(np.float32(s) * np.float32(y)) + np.float32(t)


def test_shear_rows_at_integer_shifts_matches_pallas():
    """Where the two roundings put floor(shift) a pixel apart, the bilinear
    weights move with it (frac = 1 - 1 ulp instead of 0), so the output
    moves by about an ulp, not by a pixel: JAX's row is the image moved by
    exactly k pixels, the port's differs from it by up to 2.4e-7 on [0, 1]
    images, within SHEAR_TOL."""
    slope = np.array([s for s, _, _ in INTEGER_SHIFTS], np.float32)
    offset = np.array([t for _, t, _ in INTEGER_SHIFTS], np.float32)
    for s, t, y in INTEGER_SHIFTS:
        fused, apart = (_shift_fma(s, y, t),
                        _shift_rounded_apart(np.float32(s), y,
                                             np.float32(t)))
        assert fused == np.floor(fused) and np.floor(apart) == fused - 1
    x = _img01(4, 20, 24, seed=4)
    want = np.asarray(jaffine.shear_rows(
        jnp.asarray(x), jnp.asarray(slope), jnp.asarray(offset),
        max_abs_slope=0.3, fill=0.25, interpret=True))
    got = affine.shear_rows(torch.from_numpy(x), torch.from_numpy(slope),
                            torch.from_numpy(offset), max_abs_slope=0.3,
                            fill=0.25).numpy()
    np.testing.assert_allclose(got, want, **SHEAR_TOL)
    worst = 0.0
    for i, (s, t, y) in enumerate(INTEGER_SHIFTS):
        k = int(_shift_fma(s, y, t))
        moved = np.full_like(x[i, y], 0.25)  # the fill outside the frame
        lo, hi = max(0, -k), min(24, 24 - k)
        moved[lo:hi] = x[i, y, lo + k:hi + k]
        np.testing.assert_array_equal(want[i, y], moved)
        worst = max(worst, float(np.abs(got[i, y] - want[i, y]).max()))
    assert 0.0 < worst <= 2.5e-7


def test_affine_wrapper_checks():
    x = torch.zeros(2, 6, 5, 3)
    s = torch.zeros(2)
    with pytest.raises(TypeError):
        affine.shear_rows(x.double(), s, s)
    with pytest.raises(ValueError):
        affine.shear_rows(x, s[:1], s)
    with pytest.raises(ValueError):
        affine.shear_rows(x, s, s, axis=3)
    with pytest.raises(ValueError):  # no kernel and no plain path there
        affine.shear_rows(x.to("meta"), s.to("meta"), s.to("meta"))
    with pytest.raises(ValueError, match="90 degrees"):
        affine.rotate(x, s, max_abs_radians=np.pi / 2)
    # a slope far outside the Pallas bound: every source out of the frame
    out = affine.shear_rows(x + 1.0, torch.full((2,), 1e9), s, fill=0.5)
    assert (out[:, 1:] == 0.5).all()


# one image per magnitude: |m| = 0.3, 0.3, 1 and 0, and a signed one
EW_MAGS = np.array([0.3, -0.3, 1.0, 0.0], np.float32)


@pytest.mark.parametrize("op", list(jew.PALLAS_POOL))
def test_apply_layer_plain_matches_pallas(op):
    """Each op of PALLAS_POOL forced for a batch of 20x24 images, against
    the Pallas kernel in interpret mode; the third image's channels are
    flat (autocontrast leaves them)."""
    x = _img01(4, 20, 24, seed=2)
    x[2, ..., 1] = 0.4
    idx = np.full(4, jew.PALLAS_POOL.index(op), np.int32)
    want = np.asarray(jew.apply_layer(jnp.asarray(x), jnp.asarray(idx),
                                      jnp.asarray(EW_MAGS), interpret=True))
    reset_launch_counts()
    got = randaugment_ew.apply_layer(torch.from_numpy(x),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(EW_MAGS)).numpy()
    assert launch_counts()["randaugment_ew"] == 0
    # the gray mean is summed in another order; XLA rounds the Pallas
    # posterize's last division by an ulp off its own op_posterize (which
    # the port equals bit for bit, test_torch_randaugment.py): 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_apply_layer_plain_picks_each_images_op():
    x = _img01(8, 9, 7, seed=3)
    idx = np.arange(8, dtype=np.int32)
    mag = np.linspace(-1, 1, 8).astype(np.float32)
    want = np.asarray(jew.apply_layer(jnp.asarray(x), jnp.asarray(idx),
                                      jnp.asarray(mag), interpret=True))
    got = randaugment_ew.apply_layer(torch.from_numpy(x),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(mag)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert randaugment_ew.PALLAS_POOL == jew.PALLAS_POOL
    with pytest.raises(TypeError):
        randaugment_ew.apply_layer(torch.from_numpy(x),
                                   torch.from_numpy(mag),
                                   torch.from_numpy(mag))
    with pytest.raises(ValueError):
        randaugment_ew.apply_layer(torch.from_numpy(x),
                                   torch.from_numpy(idx[:2]),
                                   torch.from_numpy(mag))


# ------------------------------------------------------------ correlation


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,shape", [(0, (1, 3, 4, 5)), (1, (2, 4, 5, 3)),
                                     (3, (1, 5, 4, 6))])
def test_correlation_plain_version_is_the_definition(d, shape, dtype):
    """The plain version against the definition written as loops:
    out[n, y, x, dy * nd + dx] = mean_c f1[y, x, c] * f2[y+dy-d, x+dx-d, c]
    with zeros outside the frame, float32 whatever the inputs' dtype; the
    wrappers run it for CPU tensors and count no launch."""
    from myconvnet_tpu_torch.ops.kernels import correlation as corr
    rng = np.random.RandomState(d)
    f1, f2 = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
              .to(dtype) for _ in range(2))
    a, b = f1.float().numpy(), f2.float().numpy()
    n, h, w, c = shape
    nd = 2 * d + 1
    want = np.zeros((n, h, w, nd * nd), np.float32)
    for dy in range(nd):
        for dx in range(nd):
            for y in range(h):
                for x in range(w):
                    yy, xx = y + dy - d, x + dx - d
                    if 0 <= yy < h and 0 <= xx < w:
                        want[:, y, x, dy * nd + dx] = \
                            (a[:, y, x] * b[:, yy, xx]).sum(-1) / c
    reset_launch_counts()
    got = corr.correlation_fwd(f1, f2, d)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    g = torch.from_numpy(rng.randn(n, h, w, nd * nd).astype(np.float32))
    d1 = corr.correlation_bwd_f1(g, f1, f2, d)
    d2 = corr.correlation_bwd_f2(g, f1, f2, d)
    assert d1.dtype == d2.dtype == dtype and d1.shape == d2.shape == shape
    # the centre channel's share of d_f1 is g * f2 / C at the same pixel
    k0 = d * nd + d
    only = torch.zeros_like(g)
    only[..., k0] = g[..., k0]
    np.testing.assert_allclose(
        corr.correlation_bwd_f1(only, f1, f2, d).float().numpy(),
        (g[..., k0:k0 + 1] * f2.float() / c).to(dtype).float().numpy(),
        rtol=1e-5, atol=1e-6)
    counts = launch_counts()
    assert counts["correlation_fwd"] == counts["correlation_bwd_f1"] \
        == counts["correlation_bwd_f2"] == 0


# ------------------------------------------------------------- planners
# The shear and correlation kernels' Python planners (pure Python: the
# card tests hold their copies of the kernels' constants against
# ``kernel_facts()``).

SHEAR_PATHS = [
    # (shape, axis, 16-byte aligned base) -> path
    (((1024, 224, 224, 3), 2, True), "fast"),
    (((3, 21, 17, 3), 2, True), "staged"),     # 51 floats a row
    (((1024, 224, 224, 3), 2, False), "staged"),
    (((2, 4, 40000, 3), 2, True), "direct"),   # a row of 480 KB
    (((1024, 224, 224, 3), 1, True), "fast"),
    (((3, 21, 17, 3), 1, True), "staged"),
    (((1024, 224, 224, 3), 1, False), "staged"),
    (((2, 8, 8, 100), 1, True), "staged"),     # 4 C over a TMA box
    (((2, 8, 8, 300), 1, True), "direct"),     # C over a box
]


@pytest.mark.parametrize("case,path", SHEAR_PATHS)
def test_shear_plan_picks_its_path(case, path):
    assert affine.plan(*case)["path"] == path


SHEAR_SHAPES = [(1024, 224, 224, 3), (256, 224, 224, 3), (3, 21, 17, 3),
                (4, 20, 24, 3), (2, 8, 8, 1), (2, 5, 9, 64), (1, 3, 4000, 3),
                (2, 7, 13, 200)]


@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("shape", SHEAR_SHAPES)
def test_shear_plan_holds_its_rules(shape, axis):
    """Every plan fits a block's shared memory; a block's chunk is whole
    rows of about CHUNK_BYTES (one row at least) and the grid covers the
    rows; a column strip is at most a TMA box wide (4-float groups on the
    fast path), with threads that split evenly into rows of groups."""
    n, h, w, c = shape
    p = affine.plan(shape, axis)
    if p["path"] == "direct":
        return
    assert p["smem"] <= affine.SMEM_MAX
    if axis == 2:
        row_bytes = 4 * w * c
        assert 1 <= p["rows"] <= n * h
        assert p["rows"] == 1 or p["rows"] * row_bytes <= affine.CHUNK_BYTES
        assert p["smem"] == p["rows"] * row_bytes + 16
        assert p["blocks"] == -(-(n * h) // p["rows"])
        groups = w * c // 4 if p["path"] == "fast" else w * c
        assert p["threads"] <= affine.ROW_THREADS
        assert p["threads"] % min(groups, affine.ROW_THREADS) == 0
    else:
        txc = p["tx"] * c
        assert 1 <= p["tx"] <= 32 and txc <= affine.MAX_BOX
        groups = txc // 4 if p["path"] == "fast" else txc
        if p["path"] == "fast":
            assert txc % 4 == 0 and (w * c) % 4 == 0
        assert p["threads"] % groups == 0 and p["threads"] <= 1024
        assert p["smem"] == affine.BOX_ROWS * txc * 4 + 16


CORR_PATHS = [
    # (shape, d, dtype, aligned) -> (path, the forward's segment pixels)
    (((32, 96, 128, 32), 4, torch.bfloat16, True), ("tma", 72)),
    (((32, 48, 64, 256), 4, torch.bfloat16, True), ("tma", 72)),
    (((32, 24, 32, 96), 4, torch.bfloat16, True), ("tma", 40)),
    (((32, 6, 8, 196), 4, torch.bfloat16, True), ("staged", 16)),
    (((3, 7, 37, 7), 1, torch.bfloat16, True), ("staged", 40)),
    (((32, 96, 128, 32), 4, torch.bfloat16, False), ("staged", 72)),
    (((32, 96, 128, 32), 4, torch.float32, True), ("cuda_cores", None)),
    (((2, 8, 8, 264), 2, torch.bfloat16, True), ("cuda_cores", None)),
]


@pytest.mark.parametrize("mode", ["fwd", "bwd_f1", "bwd_f2"])
@pytest.mark.parametrize("case,want", CORR_PATHS)
def test_correlation_plan_picks_its_path(case, want, mode):
    """The path by dtype, C and alignment; the segment (the other map's
    pixels a block stages for one displacement row) is the shortest of the
    kernel's that holds the tile's min(64, W) pixels and 2d more; panels of
    32 channels where C <= 32 comes by TMA."""
    from myconvnet_tpu_torch.ops.kernels import correlation as corr
    p = corr.plan(mode, *case)
    assert p["path"] == want[0]
    if want[1] is not None:
        (_, _, w, _), d = case[0], case[1]
        assert p["seg"] == corr.seg_rows(mode, w, d) >= min(64, w) + 2 * d
        assert p["pw"] == (32 if want[0] == "tma" and case[0][3] <= 32
                           else 64)
        if mode == "fwd":
            assert p["seg"] == want[1]


# the flow recipes' sites at batch 32, d = 4: (shape, mode) -> (segment
# pixels, panel channels, reuse, slots, aux slots, ty, blocks an SM)
CORR_SITE_PLANS = {
    (32, 96, 128, 32): {"fwd": (72, 32, False, 4, 2, 4, 3),
                        "bwd_f1": (80, 32, False, 4, 2, 4, 3),
                        "bwd_f2": (80, 32, True, 11, 4, 4, 3)},
    (32, 48, 64, 64): {"fwd": (72, 64, False, 3, 2, 4, 3),
                       "bwd_f1": (80, 64, False, 3, 2, 4, 3),
                       "bwd_f2": (80, 64, False, 4, 4, 4, 3)},
    (32, 24, 32, 96): {"fwd": (40, 64, False, 4, 2, 1, 2),
                       "bwd_f1": (48, 64, False, 4, 2, 1, 2),
                       "bwd_f2": (48, 64, False, 4, 4, 1, 2)},
    (32, 12, 16, 128): {"fwd": (40, 64, False, 4, 2, 2, 2),
                        "bwd_f1": (48, 64, False, 4, 2, 2, 2),
                        "bwd_f2": (48, 64, False, 4, 4, 2, 2)},
    (32, 6, 8, 196): {"fwd": (16, 64, False, 3, 2, 1, 2),
                      "bwd_f1": (16, 64, True, 11, 2, 2, 1),
                      "bwd_f2": (16, 64, True, 11, 4, 2, 1)},
    (32, 48, 64, 256): {"fwd": (72, 64, False, 3, 2, 4, 1),
                        "bwd_f1": (80, 64, False, 4, 2, 4, 1),
                        "bwd_f2": (80, 64, False, 4, 4, 4, 1)}}


@pytest.mark.parametrize("mode", ["fwd", "bwd_f1", "bwd_f2"])
@pytest.mark.parametrize("shape", sorted(CORR_SITE_PLANS))
def test_correlation_plan_at_the_recipe_sites(shape, mode):
    from myconvnet_tpu_torch.ops.kernels import correlation as corr
    p = corr.plan(mode, shape, 4)
    assert (p["seg"], p["pw"], p["reuse"], p["slots"], p["aux_slots"],
            p["ty"], p["blocks_per_sm"]) == CORR_SITE_PLANS[shape][mode]
    assert p["smem"] <= corr.SMEM_MAX


@pytest.mark.parametrize("mode", ["fwd", "bwd_f1", "bwd_f2"])
@pytest.mark.parametrize("shape,d", [
    ((2, 96, 128, 32), 4), ((3, 7, 37, 7), 1), ((2, 5, 9, 21), 3),
    ((1, 3, 3, 4), 4), ((2, 9, 33, 16), 0), ((1, 10, 40, 5), 4),
    ((2, 16, 16, 256), 2), ((1, 2, 130, 64), 4)])
def test_correlation_plan_holds_its_rules(shape, d, mode):
    """Every tensor-core plan fits a block's shared memory; its ring is one
    of those that fit with the most blocks an SM (registers: max_blocks;
    shared memory), reusing rows where that costs no block; a ring that
    keeps rows has the window's nd rows and one more; ty is the most rows
    a block whose grid fills its waves within 0.02 of the best of TY; the
    blocks cover the map in 64-pixel tiles of ty rows."""
    from myconvnet_tpu_torch.ops.kernels import correlation as corr
    n, h, w, c = shape
    nd = 2 * d + 1
    p = corr.plan(mode, shape, d)
    seg, pw = p["seg"], p["pw"]
    assert seg in corr.SEG_ROWS[mode] and seg >= min(64, w) + 2 * d
    assert pw == (32 if c <= 32 and p["path"] == "tma" else 64)
    assert p["smem"] == corr.smem_bytes(mode, c, d, seg, p["slots"],
                                        p["aux_slots"], pw) <= corr.SMEM_MAX
    assert p["blocks_per_sm"] == corr.blocks_per_sm(mode, c, p["smem"])
    a = p["aux_slots"]
    assert a == corr.AUX_SLOTS[mode]
    fits = [(corr.blocks_per_sm(mode, c, corr.smem_bytes(mode, c, d, seg, s,
                                                         a, pw)), r)
            for r, s in ((True, nd + 2), (True, nd + 1), (False, 4),
                         (False, 3), (False, 2))
            if corr.smem_bytes(mode, c, d, seg, s, a, pw) <= corr.SMEM_MAX]
    assert (p["blocks_per_sm"], p["reuse"]) == max(fits)
    assert p["slots"] >= nd + 1 if p["reuse"] else p["slots"] in (2, 3, 4)
    assert p["blocks"] == n * -(-h // p["ty"]) * -(-w // corr.TILE)
    wave = corr.SMS * p["blocks_per_sm"]
    fill = {t: corr.wave_fill(n * -(-h // t) * -(-w // corr.TILE), wave)
            for t in corr.TY}
    best = max(fill.values())
    assert fill[p["ty"]] >= best - 0.02
    assert all(fill[t] < best - 0.02 for t in corr.TY if t > p["ty"])


# The RandAugment layer's planner (B8): one pass over a cluster's shared
# memory where an image fits, else two passes.
RA_PATHS = [
    # (shape, 16-byte aligned base, forced path) -> (path, blocks a cluster)
    (((1024, 224, 224, 3), True, None), ("one_pass", 8)),
    (((256, 224, 224, 3), True, None), ("one_pass", 8)),
    (((2, 128, 128, 3), True, None), ("one_pass", 2)),
    (((2, 160, 200, 3), True, None), ("one_pass", 4)),
    (((3, 21, 17, 4), True, None), ("one_pass", 1)),
    (((2, 512, 512, 3), True, None), ("two_pass", None)),   # > 8 blocks
    (((3, 21, 17, 3), True, None), ("two_pass", None)),     # 4071 bytes
    (((3, 21, 17, 1), True, None), ("two_pass", None)),
    (((1024, 224, 224, 3), False, None), ("two_pass", None)),
    (((1024, 224, 224, 3), True, "two_pass"), ("two_pass", None)),
    (((3, 21, 17, 4), True, "one_pass"), ("one_pass", 1)),
]


@pytest.mark.parametrize("case,want", RA_PATHS)
def test_randaugment_plan_picks_its_path(case, want):
    p = randaugment_ew.plan(*case)
    assert (p["path"], p.get("k")) == want


@pytest.mark.parametrize("case", [((2, 512, 512, 3), True),
                                  ((3, 21, 17, 3), True),
                                  ((1024, 224, 224, 3), False)])
def test_randaugment_plan_refuses_an_impossible_one_pass(case):
    with pytest.raises(ValueError, match="no one-pass plan"):
        randaugment_ew.plan(*case, path="one_pass")
    with pytest.raises(ValueError, match="path is one of"):
        randaugment_ew.plan(*case, path="three_pass")
    with pytest.raises(ValueError, match="channels"):
        randaugment_ew.plan(case[0][:3] + (2,))


RA_PLAN_SHAPES = [(1024, 224, 224, 3), (2, 128, 128, 3), (2, 130, 130, 3),
                  (2, 160, 200, 3), (3, 21, 17, 4), (3, 20, 17, 3),
                  (3, 24, 17, 1), (1, 3, 5, 4), (2, 250, 250, 3),
                  (2, 512, 512, 3), (3, 21, 17, 3), (5, 33, 31, 1)]


@pytest.mark.parametrize("shape", RA_PLAN_SHAPES)
def test_randaugment_plan_holds_its_rules(shape):
    """One pass: k is the smallest cluster whose slices fit the shared
    memory that leaves MIN_BLOCKS_SM blocks an SM; every slice starts at a
    pixel and a 16-byte boundary, none is empty, and the k slices cover
    the image exactly once.  Two passes: a partial for every
    STATS_PIXELS pixels, at most MAX_APPLY_BLOCKS apply blocks, float4
    loads exactly when every image starts 16-byte aligned."""
    n, h, w, c = shape
    e = h * w * c
    room = (randaugment_ew.SMEM_SM // randaugment_ew.MIN_BLOCKS_SM
            - randaugment_ew.SMEM_RESERVED)
    p = randaugment_ew.plan(shape)
    if p["path"] == "one_pass":
        k, s = p["k"], p["slice"]
        assert p["smem"] == randaugment_ew.HEADER_BYTES + 4 * s <= room
        covered = np.zeros(e, np.int32)
        for r in range(k):
            lo, hi = r * s, min((r + 1) * s, e)
            assert hi > lo and lo % c == 0 and (4 * lo) % 16 == 0
            assert (hi - lo) % 4 == 0
            covered[lo:hi] += 1
        assert (covered == 1).all()
        unit = np.lcm(4, c)
        for q in [q for q in randaugment_ew.CLUSTERS if q < k]:
            assert randaugment_ew.HEADER_BYTES + 4 * (
                -(-e // (unit * q)) * unit) > room
    else:
        unit = np.lcm(4, c)   # no cluster of 8 has whole-pixel slices
        assert e % 4 or randaugment_ew.HEADER_BYTES + 4 * (
            -(-e // (unit * 8)) * unit) > room
        assert p["vec"] == (e % 4 == 0)
        assert p["stats_blocks"] == -(-(h * w) // randaugment_ew.STATS_PIXELS)
        assert 1 <= p["apply_blocks"] <= randaugment_ew.MAX_APPLY_BLOCKS
        assert p["scratch_bytes"] == n * p["stats_blocks"] * 48


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("hw", [(20, 24), (21, 17), (64, 48)])
def test_image_stats_gray_mean_is_the_float64_mean_of_lumas(c, hw):
    """A numpy model of the gray mean (each luma rounded to float32 as
    gray() rounds it, summed in float64, divided by H * W in float64,
    rounded once) equals image_stats bit for bit, and for the channel
    counts JAX takes (1, 3) JAX's _image_stats within 1e-6; min and max
    exactly."""
    x = np.random.RandomState(c).rand(4, *hw, c).astype(np.float32)
    r, g, b = (x[..., 0],) * 3 if c == 1 else (x[..., 0], x[..., 1],
                                                 x[..., 2])
    f32 = np.float32
    luma = (r * f32(0.299) + g * f32(0.587)) + b * f32(0.114)
    assert luma.dtype == np.float32
    want = (luma.astype(np.float64).sum(axis=(1, 2))
            / np.float64(hw[0] * hw[1])).astype(np.float32)
    got = randaugment_ew.image_stats(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:, 1], want)
    np.testing.assert_array_equal(got[:, 2:2 + c], x.min(axis=(1, 2)))
    np.testing.assert_array_equal(got[:, 2 + c:], x.max(axis=(1, 2)))
    if c in (1, 3):
        jax_stats = np.asarray(jew._image_stats(jnp.asarray(x)))
        np.testing.assert_allclose(got[:, 1], jax_stats[:, 1], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[:, 2:], jax_stats[:, 2:])


# bn_act (B1) at the served ResNet-50's sites (batch 8) and the CIFAR
# ResNet-18's (batch 128), and channel counts off the rule
BN_ACT_SITES = [(8, 112, 112, 64), (8, 56, 56, 128), (8, 28, 28, 128),
                (8, 28, 28, 256), (8, 14, 14, 256), (8, 14, 14, 512),
                (8, 7, 7, 512), (128, 16, 16, 64), (128, 4, 4, 128),
                (128, 2, 2, 256), (128, 1, 1, 512)]


def _bn_act_visits(p, nvec, unroll=4):
    """The vectors each thread of plan p visits, as the channel-group
    kernel's loops walk them: [threads of the grid, visits], -1 past
    the work."""
    gid = np.arange(p["threads"] * p["blocks"], dtype=np.int64)
    stride = len(gid)
    steps = -(-nvec // stride)
    v = gid[:, None] + stride * np.arange(max(steps, unroll))[None, :]
    return np.where(v < nvec, v, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_ACT_SITES + [(2, 5, 3, 24),
                                                 (3, 7, 7, 2048)])
def test_bn_act_plan_gives_each_thread_one_channel_group(shape, dtype):
    """At every site a numpy model of the launch touches every 16-byte
    vector exactly once, each thread's vectors start at one channel, the
    grid is at most one wave and no more blocks than the work needs."""
    rows, c = int(np.prod(shape[:-1])), shape[-1]
    p = bn_act.plan(rows, c, dtype)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    assert p["path"] == "group" and p["vec"] == vec
    group, nvec = c // vec, rows * c // vec
    assert p["group"] == group and p["threads"] <= bn_act.MAX_THREADS
    assert (p["threads"] * p["blocks"]) % group == 0
    assert p["blocks"] <= bn_act.SMS * max(1, bn_act.THREADS_SM
                                           // p["threads"])
    assert (p["blocks"] - 1) * p["threads"] < nvec
    visits = _bn_act_visits(p, nvec)
    seen = visits[visits >= 0]
    assert len(seen) == nvec and (np.sort(seen) == np.arange(nvec)).all()
    gid = np.arange(len(visits))[:, None]
    assert ((visits % group == gid % group) | (visits < 0)).all()


@pytest.mark.parametrize("case,path", [
    ((100, 7, torch.bfloat16, True), "scalar"),       # C % 8 != 0
    ((100, 24, torch.float32, False), "scalar"),      # misaligned base
    ((10, 8200, torch.float32, True), "vector"),      # 2050 groups
    ((10, 16384, torch.bfloat16, True), "vector"),    # 2048 groups
    ((10, 8192, torch.bfloat16, True), "group"),      # 1024 groups
    ((10, 24, torch.bfloat16, True), "group")])       # 3 groups
def test_bn_act_plan_falls_back_where_no_group_fits(case, path):
    """A channel group a thread needs C % vec == 0, an aligned base and a
    block of a multiple of C / vec threads (at most 1024); else a channel
    index a vector, or an element a step."""
    p = bn_act.plan(*case)
    assert p["path"] == path
    if path == "group":
        assert p["threads"] % p["group"] == 0
        assert p["threads"] <= bn_act.MAX_THREADS
