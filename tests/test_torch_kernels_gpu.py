"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs CUDA and skips without it.  The file imports only
torch, numpy and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""

import os

import numpy as np
import pytest
import torch

from myconvnet_tpu_torch import models, recipes, serving, weights
from myconvnet_tpu_torch.core.precision import BF16
from myconvnet_tpu_torch.data.mix import MixDraws
from myconvnet_tpu_torch.models.resnet import Bottleneck
from myconvnet_tpu_torch.ops import kernels
from myconvnet_tpu_torch.ops import attention
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.ops.kernels import (affine, bn_act, conv_fused,
                                             conv_pair, correlation,
                                             normalize_u8, pad_crop_u8,
                                             randaugment_ew)
from myconvnet_tpu_torch.ops.kernels import flash_attention as fa
from myconvnet_tpu_torch.train.trainer import StepDraws
from myconvnet_tpu_torch.weights import random_jax_params

pytestmark = pytest.mark.gpu

ACTS = ["none", "relu", "relu6", "leaky_relu"]
# separately rounded multiply and add on both sides: bit-exact
BN_ACT_TOL = dict(rtol=0, atol=0)
# the kernel sums in another order than cuDNN, which can flip the bf16
# intermediate by an ulp: 2 bf16 ulps of the output allowed
PAIR_TOL = dict(rtol=2 ** -6, atol=2 ** -7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels do not run on the CPU")
    torch.backends.cudnn.allow_tf32 = False  # plain versions: true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_grid(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c", [24, 7])  # vector and scalar paths
def test_bn_act_kernel_matches_plain(cuda, dtype, act, c):
    rng = np.random.RandomState(c)
    x = torch.from_numpy((rng.randn(2, 5, 3, c) * 4).astype(np.float32))
    x = x.to(cuda, dtype)
    a = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
    before = bn_act.fused_scale_shift_act.launches
    out = bn_act.fused_scale_shift_act(x, a, b, act)
    torch.cuda.synchronize()
    assert bn_act.fused_scale_shift_act.launches == before + 1
    ref = bn_act.scale_shift_act_reference(x, a, b, act)
    torch.testing.assert_close(out, ref, **BN_ACT_TOL)


# every bn_act site of the served ResNet-50 (batch 8) and of the CIFAR
# ResNet-18's eval forward (batch 128)
BN_ACT_SITES = [(8, 112, 112, 64), (8, 56, 56, 128), (8, 28, 28, 128),
                (8, 28, 28, 256), (8, 14, 14, 256), (8, 14, 14, 512),
                (8, 7, 7, 512), (128, 16, 16, 64), (128, 4, 4, 128),
                (128, 2, 2, 256), (128, 1, 1, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_ACT_SITES + [
    (3, 2, 16384),    # bf16: 2048 channel groups, no grid holds them
    (3, 2, 8200)])    # f32: 2050; bf16: C % 8 != 0
def test_bn_act_kernel_at_the_sites_matches_plain(cuda, shape, dtype):
    """Each planned path at each site, all four activations, bit for bit;
    one launch a call."""
    rng = np.random.RandomState(len(shape) + shape[-1])
    c = shape[-1]
    x = torch.from_numpy((rng.randn(*shape) * 4).astype(np.float32))
    x = x.to(cuda, dtype)
    a = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
    for act in ACTS:
        before = bn_act.fused_scale_shift_act.launches
        out = bn_act.fused_scale_shift_act(x, a, b, act)
        torch.cuda.synchronize()
        assert bn_act.fused_scale_shift_act.launches == before + 1
        ref = bn_act.scale_shift_act_reference(x, a, b, act)
        torch.testing.assert_close(out, ref, **BN_ACT_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_act_kernel_takes_a_misaligned_view(cuda, dtype):
    """A contiguous view 2 or 4 bytes past a 16-byte boundary takes the
    element-a-step path, and a and b as views of a larger tensor."""
    rng = np.random.RandomState(9)
    shape, c = (8, 14, 14, 256), 256
    n = int(np.prod(shape))
    buf = torch.from_numpy(rng.randn(n + 1).astype(np.float32)).to(cuda,
                                                                   dtype)
    x = buf[1:].view(shape)
    assert x.data_ptr() % 16
    ab = torch.from_numpy((rng.rand(2 * c + 1) + 0.5).astype(np.float32))
    a, b = ab[1:c + 1].to(cuda), ab[c + 1:].to(cuda)
    assert bn_act.plan(n // c, c, dtype, aligned=False)["path"] == "scalar"
    out = bn_act.fused_scale_shift_act(x, a, b, "relu")
    ref = bn_act.scale_shift_act_reference(x, a, b, "relu")
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **BN_ACT_TOL)


def test_bn_act_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        bn_act.fused_scale_shift_act(x, torch.ones(8), torch.zeros(8))
    x = torch.zeros(8, 4, device=cuda).t()
    with pytest.raises(ValueError):
        bn_act.fused_scale_shift_act(x, torch.ones(8), torch.zeros(8))


def _pair_args(shape, dev, seed=0):
    n, h, w, cin, cm, co = shape
    rng = np.random.RandomState(seed)
    x = _bf16_grid(rng.randn(n, h, w, cin))
    w1 = _bf16_grid(rng.randn(cm, 1, 1, cin) / np.sqrt(cin))
    w3 = _bf16_grid(rng.randn(co, 3, 3, cm) / np.sqrt(9 * cm))
    vec = [torch.from_numpy(v.astype(np.float32)) for v in (
        rng.rand(cm) + 0.5, rng.randn(cm) * 0.3,
        rng.rand(co) + 0.5, rng.randn(co) * 0.3)]
    # weights as nn.Conv keeps them: OIHW channels_last, seen as HWIO
    return (x.to(dev, torch.bfloat16),
            w1.to(dev, torch.bfloat16).permute(1, 2, 3, 0),
            vec[0].to(dev), vec[1].to(dev),
            w3.to(dev, torch.bfloat16).permute(1, 2, 3, 0),
            vec[2].to(dev), vec[3].to(dev))


# the five conv_pair sites of the served ResNet-50 at batch 8 and at 1
PAIR_SITES = [(8, 56, 56, 64, 64, 64), (8, 56, 56, 256, 64, 64),
              (8, 28, 28, 512, 128, 128), (8, 14, 14, 1024, 256, 256),
              (8, 7, 7, 2048, 512, 512)]


# ... and at ResNet-50's eval batch of 1024 on its training path
# (validation and test.main): many waves of blocks, 1.64 GB of input at
# [1024, 56, 56, 256]
@pytest.mark.parametrize("shape", PAIR_SITES + [
    (1,) + s[1:] for s in PAIR_SITES] + [
    (1024,) + s[1:] for s in PAIR_SITES] + [
    (2, 7, 7, 64, 32, 32),       # one whole-image tile, Cm = 32
    (1, 9, 6, 64, 32, 48),       # partial tiles, Cout not a multiple of 32
    (2, 14, 14, 128, 64, 64),
    (1, 30, 17, 64, 32, 16),     # partial tiles in both directions
    (2, 20, 23, 128, 64, 64),    # W no multiple of the 14-pixel tile
    (3, 11, 9, 64, 32, 32),
    (1, 9, 6, 64, 64, 64),       # partial tiles split over a cluster
    (2, 14, 14, 64, 128, 128),   # 8 blocks per tile, 16 channels each
    (1, 3, 40, 64, 512, 32),     # two phase-1 passes per block
    (1, 7, 7, 128, 512, 512),    # stage 4 Cm: > 48 KB of shared memory
    (1, 14, 14, 2048, 512, 1024),   # the largest Cm supports() takes
    # DeepLabv3+'s undilated bottlenecks at 513 x 513 (odd maps, partial
    # tiles) at batch 2 and its recipe batch of 16, and at the 0.75 scale
    # of a 512 frame (even maps)
    (2, 129, 129, 64, 64, 64), (2, 129, 129, 256, 64, 64),
    (2, 65, 65, 512, 128, 128), (2, 33, 33, 1024, 256, 256),
    (16, 129, 129, 256, 64, 64), (16, 33, 33, 1024, 256, 256),
    (1, 96, 96, 256, 64, 64), (1, 24, 24, 1024, 256, 256)] + [
    # the ArcFace ResNet-50 embedding at 112 x 112 (maps of 28², 14², 7²
    # and 4², where the SAME halo covers most of a tile), served at 8 and
    # at the recipe's eval batch of 512
    (n, hw, hw, cin, cm, cm) for n in (8, 512) for hw, cin, cm in (
        (28, 64, 64), (28, 256, 64), (14, 512, 128), (7, 1024, 256),
        (4, 2048, 512))])
def test_conv_pair_kernel_matches_plain(cuda, shape):
    args = _pair_args(shape, cuda)
    before = conv_pair.conv1x1_conv3x3_bn_relu.launches
    out = conv_pair.conv1x1_conv3x3_bn_relu(*args)
    torch.cuda.synchronize()
    assert conv_pair.conv1x1_conv3x3_bn_relu.launches == before + 1
    ref = conv_pair.conv_pair_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), **PAIR_TOL)


def test_conv_pair_kernel_zero_pads_the_intermediate(cuda):
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16, device=cuda)
    w1 = torch.zeros(1, 1, 64, 32, dtype=torch.bfloat16, device=cuda)
    w3 = torch.full((3, 3, 32, 16), 1 / 32, dtype=torch.bfloat16,
                    device=cuda)
    one32, one16 = torch.ones(32, device=cuda), torch.ones(16, device=cuda)
    out = conv_pair.conv1x1_conv3x3_bn_relu(x, w1, one32, one32, w3, one16,
                                            torch.zeros(16, device=cuda))
    assert out[0, 1, 1, 0].item() == 9.0
    assert out[0, 0, 0, 0].item() == 4.0


# ResNet-50 pair shapes (n, h, w, cin) whose plan has fewer blocks than the
# H100's 132 SMs, and its blocks.  A block takes most of an SM's shared
# memory, so the card runs 132, 66, 30 or 15 clusters of 1, 2, 4 or 8
# blocks at once: at each of these shapes every grid of a block per SM
# needs a second wave of clusters, and ran 1.4-1.8x slower than the plan
# (chip_smoke.py's conv_pair plan sweep, NVIDIA H100 80GB HBM3, 700 W).
ONE_WAVE_PLANS = {(8, 56, 56, 64): 128, (8, 56, 56, 256): 128,
                  (8, 28, 28, 512): 128, (8, 14, 14, 1024): 96,
                  (1, 56, 56, 64): 112, (1, 56, 56, 256): 112,
                  (1, 28, 28, 512): 112, (1, 14, 14, 1024): 56}


def test_conv_pair_plans_fit_resnet50(cuda):
    """Every ResNet-50 pair shape at batch 1 and 8 gets a plan that fits
    the card's shared memory and runs its clusters in one wave, with at
    least one block per SM where the channel counts allow, or the blocks
    recorded for it in ONE_WAVE_PLANS."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n in (1, 8):
        for hw, cin, cm in ((56, 64, 64), (56, 256, 64), (28, 512, 128),
                            (14, 1024, 256), (7, 2048, 512)):
            p = conv_pair.plan(n, hw, hw, cin, cm, cm)
            assert 0 < p["smem"] <= 232448 and p["cs"] in (1, 2, 4, 8)
            tiles = n * -(-hw // p["th"]) * -(-hw // p["tw"])
            assert tiles <= p["clusters_at_once"]
            if (n, hw, hw, cin) in ONE_WAVE_PLANS:
                assert tiles * p["cs"] == ONE_WAVE_PLANS[(n, hw, hw, cin)]
            else:
                assert tiles * p["cs"] >= sms or p["cs"] == 8 \
                    or cm % (32 * p["cs"]) != 0


@pytest.mark.parametrize("tile", [(14, 14, 1), (7, 14, 2), (5, 7, 4),
                                  (3, 4, 8), (1, 14, 8)])
def test_conv_pair_kernel_at_a_given_tile_matches_plain(cuda, tile):
    """A launch geometry given by the caller (as the plan sweep gives it)
    computes the same numbers as the planner's."""
    args = _pair_args((2, 14, 14, 256, 128, 128), cuda)
    assert [conv_pair.plan(2, 14, 14, 256, 128, 128, tile=tile)[k]
            for k in ("th", "tw", "cs")] == list(tile)
    out = conv_pair.conv1x1_conv3x3_bn_relu(*args, tile=tile)
    ref = conv_pair.conv_pair_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **PAIR_TOL)


# launch geometries of one shape, some with passes of a single 64x64 tile
# (where two warpgroups sharing the K steps would add their sums in
# another order): every geometry gives the planner's bits
GEOMETRY_CASES = [
    ((8, 24, 24, 64, 64, 64), [(3, 12, 1), (4, 12, 1), (6, 12, 1),
                               (12, 12, 1), (6, 8, 1)]),
    ((16, 12, 12, 512, 128, 128), [(3, 12, 1), (6, 12, 2), (3, 12, 2)]),
    ((16, 6, 6, 1024, 256, 256), [(3, 6, 4), (6, 6, 1), (6, 6, 2)]),
    ((8, 7, 7, 2048, 512, 512), [(7, 7, 1), (7, 7, 8)])]


@pytest.mark.parametrize("shape,tiles", GEOMETRY_CASES, ids=str)
def test_conv_pair_bits_do_not_depend_on_the_launch_geometry(cuda, shape,
                                                             tiles):
    """Each output is summed in one order whatever the tile, the cluster
    or the batch: a given geometry, and an image launched alone, give the
    bits of the planner's launch over the batch."""
    args = _pair_args(shape, cuda)
    want = conv_pair.conv1x1_conv3x3_bn_relu(*args)
    for tile in tiles:
        got = conv_pair.conv1x1_conv3x3_bn_relu(*args, tile=tile)
        assert torch.equal(got, want), tile
    for i in (0, shape[0] - 1):
        alone = conv_pair.conv1x1_conv3x3_bn_relu(
            args[0][i:i + 1].contiguous(), *args[1:])
        assert torch.equal(alone, want[i:i + 1]), i


@pytest.mark.parametrize("tile", [(15, 14, 1), (7, 15, 1), (7, 14, 3),
                                  (7, 14, 16), (14, 14, 8)])
def test_conv_pair_kernel_rejects_a_tile_it_cannot_run(cuda, tile):
    """Larger than the map, a cluster size other than 1, 2, 4 or 8, or
    fewer than 16 channels a cluster rank (Cm = 64 over 8)."""
    args = _pair_args((1, 14, 14, 64, 64, 64), cuda)
    with pytest.raises(RuntimeError):
        conv_pair.conv1x1_conv3x3_bn_relu(*args, tile=tile)


def test_conv_pair_kernel_rejects_what_it_does_not_take(cuda):
    args = list(_pair_args((1, 7, 7, 64, 32, 32), cuda))
    with pytest.raises(ValueError):  # Cin = 96 is not streamed 64 at a time
        conv_pair.conv1x1_conv3x3_bn_relu(
            *_pair_args((1, 7, 7, 96, 32, 32), cuda))
    args[0] = args[0].float()
    with pytest.raises(TypeError):
        conv_pair.conv1x1_conv3x3_bn_relu(*args)


def test_resnet50_forward_on_card_matches_host(cuda):
    """A narrow ResNet-50 through both kernels on the card against the
    same module on the host, where the wrappers run their plain versions."""
    def build(device):
        model = models.resnet50(10, width=16)
        params, state = random_jax_params(model, seed=0)
        return serving.make_inference_fn(model, params, state,
                                         device=device, policy=BF16)

    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    fn = build(cuda)
    pairs = sum(isinstance(m, Bottleneck) and m.pair
                for m in fn.model.modules())
    kernels.reset_launch_counts()
    card = fn(x).cpu().numpy()
    torch.cuda.synchronize()
    # the stride-1 blocks whose channels the kernel takes run the pair
    # (stages 2-4 at width 16); every other conv + ReLU is a bn_act
    # epilogue
    assert kernels.launch_counts() == {
        **{name: 0 for name in kernels.WRAPPERS},
        "conv_pair": pairs, "bn_act": 7 + 2 * (13 - pairs)}
    host = build("cpu")(x).numpy()
    assert np.isfinite(card).all()
    assert np.abs(card - host).max() / np.abs(host).max() < 0.05


# ------------------------------------------- CIFAR input and conv_fused

CIFAR_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "cifar100_resnet18.py")
CIFAR_MEAN = (0.5071, 0.4866, 0.4409)
CIFAR_STD = (0.2673, 0.2564, 0.2762)
# the kernels round like their plain versions (a product, a correctly
# rounded reciprocal and quotient for the fold, then a separate multiply
# and add): bit-exact
INPUT_TOL = dict(rtol=0, atol=0)
# conv_fused sums in another order than cuDNN: 2 bf16 ulps, as conv_pair
FUSED_TOL = PAIR_TOL
INPUT_SHAPES = [(128, 32, 32, 3),   # the recipe's batch
                (3, 5, 7, 3),       # 315 elements: vector body + tail
                (2, 4, 4, 8),
                (128, 28, 28, 1),   # fashion_mnist_smallnet's input
                (8, 224, 224, 3)]   # bands of rows (pad_crop_u8)


def _stats(dev, c):
    return (torch.tensor(CIFAR_MEAN[:c] if c == 3 else [0.25] * c,
                         device=dev),
            torch.tensor(CIFAR_STD[:c] if c == 3 else [0.5] * c,
                         device=dev))


def _images(shape, dev, seed=0, offset=0):
    """uint8 images; ``offset`` > 0 returns a contiguous view that starts
    ``offset`` images into a larger buffer (unaligned for odd sizes)."""
    rng = np.random.RandomState(seed)
    n, *rest = shape
    buf = torch.from_numpy(rng.randint(0, 256, (n + offset, *rest),
                                       dtype=np.uint8)).to(dev)
    return buf[offset:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INPUT_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_normalize_u8_kernel_matches_plain(cuda, dtype, shape, offset):
    x = _images(shape, cuda, offset=offset)
    mean, std = _stats(cuda, shape[-1])
    before = normalize_u8.normalize_u8.launches
    out = normalize_u8.normalize_u8(x, mean, std, dtype)
    torch.cuda.synchronize()
    assert normalize_u8.normalize_u8.launches == before + 1
    ref = normalize_u8.normalize_u8_reference(x, mean, std, dtype)
    assert out.dtype == dtype
    torch.testing.assert_close(out, ref, **INPUT_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INPUT_SHAPES)
def test_pad_crop_kernel_matches_plain(cuda, dtype, shape):
    x = _images(shape, cuda, seed=1)
    n, pad = shape[0], 4
    rng = np.random.RandomState(2)
    off = rng.randint(-pad, pad + 1, (n, 2)).astype(np.int32)
    off[0] = (-pad, pad)  # the ends of the offset range
    off[-1] = (pad, -pad)
    flip = torch.from_numpy(np.arange(n) % 2 == 0).to(cuda)
    off = torch.from_numpy(off).to(cuda)
    mean, std = _stats(cuda, shape[-1])
    before = pad_crop_u8.pad_crop_flip_normalize.launches
    out = pad_crop_u8.pad_crop_flip_normalize(x, off, flip, mean, std,
                                              pad=pad, out_dtype=dtype)
    torch.cuda.synchronize()
    assert pad_crop_u8.pad_crop_flip_normalize.launches == before + 1
    ref = pad_crop_u8.pad_crop_reference(x, off, flip, mean, std, pad=pad,
                                         out_dtype=dtype)
    torch.testing.assert_close(out, ref, **INPUT_TOL)


def _pad_crop_case(shape, dev, off, flip, offset=0, dtype=torch.float32):
    """pad_crop_u8's kernel (one launch) against its plain version, bit for
    bit; ``off`` [N, 2] and ``flip`` [N] numpy arrays, the plain version
    padded by the largest shift; the images start ``offset`` bytes into a
    buffer."""
    size = int(np.prod(shape))
    buf = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, size + offset, dtype=np.uint8)).to(dev)
    x = buf[offset:].view(shape)
    mean, std = _stats(dev, shape[-1])
    pad = int(np.abs(off).max())
    off = torch.from_numpy(off.astype(np.int32)).to(dev)
    flip = torch.from_numpy(np.asarray(flip, bool)).to(dev)
    before = pad_crop_u8.pad_crop_flip_normalize.launches
    out = pad_crop_u8.pad_crop_flip_normalize(x, off, flip, mean, std,
                                              pad=pad, out_dtype=dtype)
    torch.cuda.synchronize()
    assert pad_crop_u8.pad_crop_flip_normalize.launches == before + 1
    ref = pad_crop_u8.pad_crop_reference(x, off, flip, mean, std, pad=pad,
                                         out_dtype=dtype)
    torch.testing.assert_close(out, ref, **INPUT_TOL)


def _shifts(n, pad, seed=4):
    return np.random.RandomState(seed).randint(-pad, pad + 1, (n, 2))


def _force_mode(monkeypatch, mode):
    """pad_crop_u8 launched with its planner's plan at staging ``mode``
    ("copy" or "direct") in place of its own pick."""
    monkeypatch.setattr(pad_crop_u8, "_launch_plan", lambda *a: (
        pad_crop_u8.launch_args(pad_crop_u8.plan(*a, mode=mode))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 32, 3), (8, 9, 7, 1),
                                   (8, 224, 224, 3)])
def test_pad_crop_kernel_moves_images_out_of_the_frame(cuda, dtype, shape):
    """Shifts of |s| >= H or W (and far beyond) write shift[c] over the
    whole image, or over every row or column they move out."""
    _, h, w, _ = shape
    off = np.array([(h, 0), (-h, 0), (0, w), (0, -w), (h + 5, -w - 9),
                    (h - 1, 1 - w), (-2 * h - 1, 7), (3, 2 * w + 1)])
    _pad_crop_case(shape, cuda, off, np.arange(8) % 3 == 0, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flipped", [False, True])
@pytest.mark.parametrize("shape", INPUT_SHAPES)
def test_pad_crop_kernel_flips_all_or_none(cuda, dtype, flipped, shape):
    n = shape[0]
    _pad_crop_case(shape, cuda, _shifts(n, 4), np.full(n, flipped),
                   dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INPUT_SHAPES + [(2, 32, 32, 4)])
def test_pad_crop_kernel_takes_a_misaligned_view(cuda, dtype, shape):
    """Images that start a byte into a buffer: no band's span starts on a
    16-byte boundary unless its row offset makes up for it."""
    n = shape[0]
    _pad_crop_case(shape, cuda, _shifts(n, 2), np.arange(n) % 2 == 1,
                   offset=1, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pad", [((128, 28, 28, 1), 2),
                                       ((4, 28, 28, 1), 2),
                                       ((2, 32, 32, 4), 4),
                                       ((3, 17, 13, 4), 3),
                                       ((5, 11, 3, 1), 1)])
def test_pad_crop_kernel_at_one_and_four_channels(cuda, dtype, shape, pad):
    n = shape[0]
    _pad_crop_case(shape, cuda, _shifts(n, pad), np.arange(n) % 2 == 0,
                   dtype=dtype)


# plans in which blocks walk several bands (items > blocks): bands of
# ImageNet-sized rows, and whole small images beyond a wave of blocks
BAND_WALK_SHAPES = [(64, 224, 224, 3), (1024, 28, 28, 1), (600, 32, 32, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["copy", "direct"])
@pytest.mark.parametrize("shape", [(128, 32, 32, 3), (4, 28, 28, 1),
                                   (8, 224, 224, 3), (3, 5, 7, 3)]
                         + BAND_WALK_SHAPES)
def test_pad_crop_kernel_stages_each_way(cuda, monkeypatch, dtype, mode,
                                        shape):
    """Each staging mode forced (cp.async copies, or none), on aligned and
    misaligned bases, with shifts in range and images moved wholly or
    partly out of the frame; at BAND_WALK_SHAPES each block walks several
    bands (two staging buffers in turn, the next band's offsets loaded a
    band ahead)."""
    if shape in BAND_WALK_SHAPES:
        p = pad_crop_u8.plan(*shape, dtype, mode=mode)
        assert p["items"] > p["blocks"], p
    _force_mode(monkeypatch, mode)
    n, h, w, _ = shape
    off = _shifts(n, 4)
    off[::7] = (h, 0)
    off[3::7] = (0, -w)
    off[5::11] = (-h - 3, w + 2)
    off[6::13] = (h - 1, 1 - w)
    for offset in (0, 1):
        _pad_crop_case(shape, cuda, off, np.arange(n) % 3 == 0,
                       offset=offset, dtype=dtype)


def test_pad_crop_kernel_reads_rows_wider_than_shared_memory(cuda):
    """A row of 240 KB does not fit a block: the planner reads x directly."""
    shape = (1, 3, 80000, 3)
    assert pad_crop_u8.plan(*shape, torch.float32)["mode"] == "direct"
    _pad_crop_case(shape, cuda, np.array([(1, -3)]), [True])


# (the planner's shapes: the aims of the redesign and the tests' odd ones)
INPUT_PLAN_SHAPES = INPUT_SHAPES + BAND_WALK_SHAPES + [
    (256, 224, 224, 3), (2, 32, 32, 4), (3, 17, 13, 4)]


def test_input_planners_match_the_built_kernels(cuda):
    """normalize_u8's and pad_crop_u8's planners count on the card's SMs
    and on no more blocks an SM than the built kernels hold, so every plan
    is at most one wave."""
    f = normalize_u8.kernel_facts()
    assert (f["sms"], f["threads"], f["unroll"]) == (
        normalize_u8.SMS, normalize_u8.THREADS, normalize_u8.UNROLL)
    assert min(f["blocks_per_sm_f32"], f["blocks_per_sm_bf16"]) >= \
        normalize_u8.BLOCKS_SM, f
    for shape in INPUT_PLAN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            p = pad_crop_u8.plan(*shape, dtype)
            f = pad_crop_u8.kernel_facts(p["mode"], p["threads"], p["smem"])
            assert f["sms"] == pad_crop_u8.SMS
            assert f["max_threads"] == pad_crop_u8.MAX_THREADS
            held = min(f["blocks_per_sm_f32"], f["blocks_per_sm_bf16"])
            assert p["blocks"] <= f["sms"] * held, (shape, p, f)
            assert held >= pad_crop_u8._blocks_sm(p["threads"], p["smem"])


def _fused_args(shape, dev, seed=0):
    n, h, w, c, co = shape
    rng = np.random.RandomState(seed)
    x = _bf16_grid(rng.randn(n, h, w, c))
    w3 = _bf16_grid(rng.randn(co, 3, 3, c) / np.sqrt(9 * c))
    s = torch.from_numpy((rng.rand(co) + 0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(co) * 0.3).astype(np.float32))
    # the weight as nn.Conv keeps it: OIHW channels_last, seen as HWIO
    return (x.to(dev, torch.bfloat16),
            w3.to(dev, torch.bfloat16).permute(1, 2, 3, 0), s.to(dev),
            b.to(dev))


FUSED_SHAPES = [
    (128, 8, 8, 64, 64),      # ResNet-18 at 32x32: stage 1
    (128, 4, 4, 128, 128),    # stage 2
    (128, 2, 2, 256, 256),    # stage 3
    (128, 1, 1, 512, 512),    # stage 4: the centre tap alone
    (3, 1, 1, 8, 16),
    (3, 2, 2, 8, 24),         # Cout not a multiple of the 64-wide tile
    (2, 5, 7, 40, 72),        # C not a multiple of the 64-wide stage
    (1, 9, 3, 16, 130),
    # ImageNet ResNet-18's stride-1 sites at batch 8 and 1: windows of
    # one image, and maps whose tiles overhang the image
    (8, 56, 56, 64, 64), (8, 28, 28, 128, 128), (8, 14, 14, 256, 256),
    (8, 7, 7, 512, 512),
    (1, 56, 56, 64, 64), (1, 28, 28, 128, 128), (1, 14, 14, 256, 256),
    (1, 7, 7, 512, 512),
    # VGG-16's eight site shapes over its five maps, at batch 2; and the
    # first at its eval batch of 512, whose output (1.64e9 elements) needs
    # 64-bit offsets
    (2, 224, 224, 64, 64), (2, 112, 112, 64, 128), (2, 112, 112, 128, 128),
    (2, 56, 56, 128, 256), (2, 56, 56, 256, 256), (2, 28, 28, 256, 512),
    (2, 28, 28, 512, 512), (2, 14, 14, 512, 512), (512, 224, 224, 64, 64),
    # DeepLabv3+'s decoder/refine1 (304 input channels: 5 chunks of 64 a
    # tap, the last partial) and refine2 at 513 x 513, batch 2 and 16
    (2, 129, 129, 304, 256), (2, 129, 129, 256, 256),
    (16, 129, 129, 304, 256)]


def test_conv_fused_planner_matches_the_built_kernel(cuda):
    """The planner's copy of the kernel's launch facts (ring stages, shared
    memory a block, blocks an SM holds, SMs) equals what the built kernel
    and the card give, and every plan's clusters fit in one wave of the
    clusters the card holds at once."""
    facts = conv_fused.kernel_facts()
    assert (facts["stages"], facts["smem"], facts["blocks_per_sm"],
            facts["sms"]) == (conv_fused.STAGES, conv_fused.BLOCK_SMEM,
                              conv_fused.BLOCKS_PER_SM, conv_fused.SMS)
    for shape in FUSED_SHAPES + [(3, 5, 7, 512, 72)]:
        p = conv_fused.plan(*shape)
        if p["split"] > 1:
            assert p["tiles"] <= facts["clusters_at_once"][p["split"]], shape


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_conv_fused_kernel_matches_plain(cuda, shape):
    args = _fused_args(shape, cuda)
    before = conv_fused.conv3x3_bn_relu.launches
    out = conv_fused.conv3x3_bn_relu(*args)
    torch.cuda.synchronize()
    assert conv_fused.conv3x3_bn_relu.launches == before + 1
    ref = conv_fused.conv3x3_bn_relu_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), **FUSED_TOL)


@pytest.mark.parametrize("split", conv_fused.SPLITS)
def test_conv_fused_kernel_at_each_split_matches_plain(cuda, split):
    """Every cluster size, forced through the planner's argument, at a
    shape whose 72 stages (9 taps x 8 chunks of 64 channels) each divides:
    the same output within the tolerance, and the same launch count."""
    args = _fused_args((3, 5, 7, 512, 72), cuda, seed=4)
    assert conv_fused.plan(3, 5, 7, 512, 72, split)["split"] == split
    before = conv_fused.conv3x3_bn_relu.launches
    out = conv_fused.conv3x3_bn_relu(*args, split=split)
    torch.cuda.synchronize()
    assert conv_fused.conv3x3_bn_relu.launches == before + 1
    ref = conv_fused.conv3x3_bn_relu_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), **FUSED_TOL)


@pytest.mark.parametrize("c", [8, 512])
def test_conv_fused_kernel_1x1_reads_only_the_centre_tap(cuda, c):
    x, w3, s, b = _fused_args((4, 1, 1, c, 64), cuda, seed=3)
    centre = torch.zeros_like(w3)
    centre[1, 1] = w3[1, 1]
    out = conv_fused.conv3x3_bn_relu(x, w3, s, b)
    torch.testing.assert_close(
        out, conv_fused.conv3x3_bn_relu(x, centre, s, b), rtol=0, atol=0)


def test_cifar_kernels_reject_what_they_do_not_take(cuda):
    x, w3, s, b = _fused_args((2, 4, 4, 16, 16), cuda)
    with pytest.raises(TypeError):
        conv_fused.conv3x3_bn_relu(x.float(), w3, s, b)
    with pytest.raises(ValueError):  # C = 12: rows not 16-byte vectors
        conv_fused.conv3x3_bn_relu(*_fused_args((2, 4, 4, 12, 16), cuda))
    with pytest.raises(ValueError):
        conv_fused.conv3x3_bn_relu(x.transpose(1, 2), w3, s, b)
    img = _images((2, 4, 4, 3), cuda)
    mean, std = _stats(cuda, 3)
    with pytest.raises(TypeError):
        normalize_u8.normalize_u8(img.float(), mean, std)
    with pytest.raises(ValueError):
        normalize_u8.normalize_u8(img.transpose(1, 2), mean, std)
    off = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    flip = torch.zeros(2, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        pad_crop_u8.pad_crop_flip_normalize(img, off, flip[:1], mean, std)
    with pytest.raises(ValueError):
        pad_crop_u8.pad_crop_flip_normalize(img.transpose(1, 2), off, flip,
                                            mean, std)


# B4's order of a sum over K: each block of a cluster sums its stages (tap,
# 64-channel chunk) in order, then the ranks' partials are added in rank
# order, so an output's bits are a function of the split alone.  The
# planner picks the split by the grid's output tiles, that is by the
# batch: a short batch may take another split than a full one.  The
# CIFAR-100 ResNet-18's sites at its batch, and VGG-16's map sizes at 8.
BITS_SHAPES = [(128, 8, 8, 64, 64), (128, 4, 4, 128, 128),
               (128, 2, 2, 256, 256), (128, 1, 1, 512, 512),
               (8, 112, 112, 128, 128), (8, 56, 56, 256, 256),
               (8, 28, 28, 512, 512), (8, 14, 14, 512, 512)]
# the largest difference between two splits' outputs, as a fraction of
# the output's largest: measured 2.56e-3 at VGG-16's 14² x 512 (255 of
# 301,056 outputs differ), 3.6e-6 at CIFAR's 4² (1 of 6,144), 0 at 1²
# (NVIDIA H100 80GB HBM3, 700 W; ROADMAP C)
SPLIT_REL = 2 ** -8


def _gap(a, b):
    """(outputs that differ, max |a - b| / max |b|)."""
    d = (a.float() - b.float()).abs()
    return int((d > 0).sum()), float(d.max() / b.float().abs().max())


@pytest.mark.parametrize("shape", BITS_SHAPES, ids=str)
def test_conv_fused_bits_depend_only_on_the_split(cuda, shape):
    """A batch's last 3 images launched alone against the same images
    inside the batch: at every split the planner may take, bit for bit;
    between splits within SPLIT_REL of the largest output; under the
    planner's own choice, the bits of the split it takes at each batch."""
    n, h, w, c, co = shape
    args = _fused_args(shape, cuda, seed=5)
    tail = (args[0][-3:].contiguous(), *args[1:])
    p = conv_fused.plan(*shape)
    p_alone = conv_fused.plan(3, h, w, c, co)
    splits = [s for s in conv_fused.SPLITS if p["stages"] % s == 0
              and (s == 1 or p_alone["tiles"] * s <= conv_fused.ONE_WAVE)]
    full, alone = {}, {}
    for s in splits:
        alone[s] = conv_fused.conv3x3_bn_relu(*tail, split=s)
        if s == 1 or p["tiles"] * s <= conv_fused.ONE_WAVE:
            full[s] = conv_fused.conv3x3_bn_relu(*args, split=s)
            assert torch.equal(alone[s], full[s][-3:]), s
    gaps = {s: _gap(alone[s], alone[1]) for s in splits}
    own = conv_fused.conv3x3_bn_relu(*args)
    own_alone = conv_fused.conv3x3_bn_relu(*tail)
    tail_gap = _gap(own_alone, own[-3:])
    print(f"conv_fused {shape}: stages {p['stages']}, splits {splits}, "
          f"planner {p['split']} at {n}, {p_alone['split']} at 3; "
          f"(outputs that differ, max gap / max output) from split 1: "
          f"{gaps}; the tail alone against inside the batch: {tail_gap} "
          f"of {own_alone.numel()}")
    assert torch.equal(own, full[p["split"]])
    assert torch.equal(own_alone, alone[p_alone["split"]])
    assert max(g for _, g in gaps.values()) <= SPLIT_REL, gaps
    assert tail_gap[1] <= SPLIT_REL, tail_gap


def test_convnet_predict_tail_batch_has_the_full_batchs_bits(cuda):
    """``ConvNet.predict`` pads a short tail batch to the full one, so the
    CIFAR-100 ResNet-18 (bf16: B2, five B4 and four B1 launches a forward)
    gives a tail image the bits it gets inside a full batch; the tail run
    unpadded takes other B4 splits."""
    cfg = recipes.load_config(CIFAR_CONFIG)
    net, _, val_set = recipes.build_classifier(cfg, True, device=cuda)
    params, state = random_jax_params(net.trainer.model, 0)
    weights.from_jax(net.trainer.model, params, state)
    x = val_set.source.images[:192]
    kernels.reset_launch_counts()
    tail = net.predict(x, batch_size=128)[128:]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["normalize_u8"], counts["conv_fused"],
            counts["bn_act"]) == (2, 10, 8)
    inside = net.predict(x[64:], batch_size=128)[64:]
    np.testing.assert_array_equal(tail, inside)
    alone = net.predict(x[128:], batch_size=64)
    rel = np.abs(alone - inside).max() / np.abs(inside).max()
    print(f"ResNet-18 tail run unpadded: max|diff|/max|logit| {rel:.3g}")
    assert rel < 0.05


def test_evaluate_tail_batch_has_the_full_batchs_bits(cuda):
    """``Trainer.evaluate`` pads a short tail batch to the first batch's
    size (as JAX does), so over 192 images at batch 128 the CIFAR-100
    ResNet-18 (bf16: B2, five B4 and four B1 launches a forward) gives the
    64-image tail the logits its images get inside a full batch, bit for
    bit."""
    from myconvnet_tpu_torch.data.pipeline import ArraySource, DataSet
    from myconvnet_tpu_torch.eval.evaluators import AccuracyEvaluator
    cfg = recipes.load_config(CIFAR_CONFIG)
    net, _, val_set = recipes.build_classifier(cfg, True, device=cuda)
    params, state = random_jax_params(net.trainer.model, 0)
    weights.from_jax(net.trainer.model, params, state)
    x = val_set.source.images[:192]
    y = val_set.source.labels[:192]
    trainer = net.trainer
    trainer.evaluator = AccuracyEvaluator()
    seen = []
    update = trainer.evaluator.update
    trainer.evaluator.update = lambda out, t: (seen.append(out.clone()),
                                               update(out, t))
    kernels.reset_launch_counts()
    trainer.evaluate(DataSet(ArraySource(x, y)).eval_iter(128, cuda))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["normalize_u8"], counts["conv_fused"],
            counts["bn_act"]) == (2, 10, 8)
    assert [len(o) for o in seen] == [128, 64]
    inside = trainer.eval_batch(torch.from_numpy(x[64:]).to(cuda),
                                torch.from_numpy(y[64:]).to(cuda))[0][64:]
    assert torch.equal(seen[1], inside)


def test_image_route_normalizes_on_the_card_once_a_request(cuda):
    """An image body on the served ResNet-50 (bf16, batch 8): decoded to
    uint8 on the host, one normalize_u8 launch a request on the card, the
    logits within 0.05 of max |logit| of the same route on the host (plain
    versions)."""
    import io

    from PIL import Image

    from myconvnet_tpu_torch import serving_http
    config = os.path.join(os.path.dirname(__file__), "..", "configs",
                          "imagenet_resnet50.py")
    model = models.get_model("resnet50", 1000)
    params, state = random_jax_params(model, 0)

    def server(device):
        return serving_http.ModelServer([serving_http.build_route(
            "cls", "classify", config, params=params, state=state, batch=8,
            device=device)])

    rng = np.random.RandomState(0)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (300, 400, 3), np.uint8)).save(
        buf, "JPEG")
    card, host = server(cuda), server("cpu")
    route = card.routes["cls"]
    x = card._decode_body(route, buf.getvalue(), "image/jpeg")
    assert x.dtype == np.uint8 and x.shape == (1, 224, 224, 3)
    kernels.reset_launch_counts()
    for _ in range(3):
        out = card.predict("cls", buf.getvalue(), "image/jpeg")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["normalize_u8"] == 3, counts
    assert (counts["conv_pair"], counts["bn_act"]) == (39, 21)
    assert len(out["predictions"][0]) == 5
    logits = card._execute(route, x)
    want = host._execute(host.routes["cls"], x)
    rel = np.abs(logits - want).max() / np.abs(want).max()
    assert rel < 0.05, rel


# the routes at their shapes (chip_smoke.py's routes phase): the recipe,
# the model builder, the kernel launches of one device call and the card's
# agreement with the same route on the host (plain versions)
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
ROUTE_CASES = {
    "segment": ("voc_deeplabv3plus.py",
                {"conv_pair": 11, "conv_fused": 2, "bn_act": 18}),
    "translate": ("pix2pix.py", {"bn_act": 13}),
    "flow": ("chairs_pwcnet.py", {"correlation_fwd": 5})}


def _route_model(kind, cfg):
    from myconvnet_tpu_torch import recipes_gan
    kw = cfg.get("model_kwargs", {})
    if kind == "segment":
        return models.get_model(cfg["model"], cfg["num_classes"],
                                input_hw=(513, 513), **kw)
    if kind == "translate":
        return recipes_gan.gan_generator(cfg)
    return models.FLOW_MODELS[cfg["model"]](0, **kw)


@pytest.mark.parametrize("kind", sorted(ROUTE_CASES))
def test_route_kernel_path_matches_plain_at_the_route_shapes(cuda, kind):
    """A route at full width (bf16, route batch 4): one JSON request of one
    image is one device call with exactly its kernels' launches, and its
    outputs agree with the same route on the host (route batch 1, every
    wrapper's plain version): segment confidences within 0.05 and at most
    5% of the classes differing, translate outputs and flows within 0.05
    of their largest."""
    import json

    from myconvnet_tpu_torch import serving_http
    config, per_call = ROUTE_CASES[kind]
    cfg = recipes.load_config(os.path.join(CONFIGS, config))
    params, state = random_jax_params(_route_model(kind, cfg), 0)

    def route(device, batch):
        return serving_http.build_route(kind, kind, cfg, params=params,
                                        state=state, batch=batch,
                                        device=device)
    card = serving_http.ModelServer([route(cuda, 4)])
    host = serving_http.ModelServer([route("cpu", 1)])
    h, w, c = card.routes[kind].input_shape[1:]
    x = np.random.RandomState(1).rand(1, h, w, c).astype(np.float32)
    card.predict(kind, json.dumps({"instances": x.tolist()}).encode())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = card._execute(card.routes[kind], x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts == {k: per_call.get(k, 0) for k in kernels.WRAPPERS}
    want = host._execute(host.routes[kind], x)
    if kind == "segment":
        assert np.abs(got[1] - want[1]).max() <= 0.05
        assert (got[0] != want[0]).mean() <= 0.05
        assert got[0].dtype == np.int32 and got[0].shape == (1, h, w)
    else:
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_host_library_builds_from_a_fresh_directory(cuda, tmp_path):
    """The port's host library builds with g++ into an empty
    ``build/host/``-like directory in a subprocess and gathers a batch."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from myconvnet_tpu_torch.data import native_loader as nl\n"
        "nl.BUILD_DIR = Path(sys.argv[1])\n"
        "info = nl.backend()\n"
        "assert info['built'].startswith(sys.argv[1]), info\n"
        "pool = np.arange(60, dtype=np.uint8).reshape(10, 2, 3)\n"
        "idx = np.array([9, 0, 4])\n"
        "assert (nl.gather_batch(pool, idx) == pool[idx]).all()\n"
        "print(info)\n")
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          cwd=root, env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    print(proc.stdout.strip())


def test_resnet18_eval_on_card_matches_host(cuda):
    """Full-width ResNet-18 at 32x32 through both kernels on the card
    against the same module on the host (plain versions): 5 conv_fused
    and 4 bn_act launches a forward."""
    def build(device):
        model = models.resnet18(100)
        params, state = random_jax_params(model, seed=0)
        return serving.make_inference_fn(model, params, state,
                                         device=device, policy=BF16)

    x = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)
    fn = build(cuda)
    kernels.reset_launch_counts()
    card = fn(x).cpu().numpy()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["conv_fused"] == 5 and counts["bn_act"] == 4
    host = build("cpu")(x).numpy()
    assert np.isfinite(card).all()
    assert np.abs(card - host).max() / np.abs(host).max() < 0.05


def test_train_step_on_card_matches_host(cuda):
    """Step 1 of the recipe at width 16, batch 16, with the same weights,
    batch and draws on the card and on the host: the loss within 2e-2 and
    each gradient's norm within 5e-2 (plus 1e-3 of the largest), as in
    chip_smoke.py; one pad_crop_u8 launch a step."""
    cfg = recipes.load_config(CIFAR_CONFIG)
    cfg["model_kwargs"] = {"width": 16}
    card, train_set, _ = recipes.build_trainer(cfg, True, device=cuda)
    host, _, _ = recipes.build_trainer(cfg, True,
                                       device=torch.device("cpu"))
    params, state = random_jax_params(card.model, 0)
    for t in (card, host):
        weights.from_jax(t.model, params, state)
    xs, ys = train_set.source.get_batch(np.arange(16))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    draws = card.sample(16, (32, 32))
    before = pad_crop_u8.pad_crop_flip_normalize.launches
    loss_card = float(card.loss_and_grads(x.to(cuda), y.to(cuda), draws)[0])
    assert pad_crop_u8.pad_crop_flip_normalize.launches == before + 1
    on_host = StepDraws(draws.boxes.cpu(), draws.flip.cpu(),
                        MixDraws(*(t.cpu() for t in draws.mix)))
    loss_host = float(host.loss_and_grads(x, y, on_host)[0])
    assert abs(loss_card - loss_host) <= 2e-2 * abs(loss_host)
    norms = [(float(pc.grad.float().norm()), float(ph.grad.norm()))
             for (_, pc, _), (_, ph, _) in zip(
                 weights.param_views(card.model),
                 weights.param_views(host.model))]
    biggest = max(h for _, h in norms)
    assert all(abs(c - h) <= 5e-2 * h + 1e-3 * biggest for c, h in norms)


# ------------------------------------------------------- flash attention

VIT_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                          "imagenet_vit_b16.py")
# [B, H, L, D]: L % 64 != 0, ViT-B/16 at 224 and 384, every head-dim class
FLASH_SHAPES = [(2, 3, 100, 16), (1, 2, 197, 64), (4, 12, 197, 64),
                (2, 4, 577, 64), (1, 2, 64, 128), (3, 2, 33, 32),
                (2, 2, 130, 48), (1, 2, 70, 80), (1, 2, 40, 96),
                (1, 1, 65, 112), (1, 1, 1, 64)]
# the kernels round P and dS to bf16 before the second product and sum in
# another order: the output within 2 bf16 ulps of max |O|, gradients
# within 2^-6 of their max, the float32 lse and D within 2^-16 of theirs
FLASH_GRAD_TOL, FLASH_STAT_TOL = 2 ** -6, 2 ** -16


def _flash_inputs(shape, dev, seed=0):
    """q, k, v as views of a packed [B, L, 3, H, D] qkv, and dO."""
    b, h, l, d = shape
    rng = np.random.RandomState(seed)
    qkv = _bf16_grid(rng.randn(b, l, 3, h, d)).to(dev, torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    do = _bf16_grid(rng.randn(b, h, l, d)).to(dev, torch.bfloat16)
    return q, k, v, do


def _assert_within(out, ref, tol):
    out, ref = out.detach().float(), ref.detach().float()
    err = float((out - ref).abs().max())
    assert bool(torch.isfinite(out).all())
    assert err <= tol * float(ref.abs().max()), (err, tol)


def _out_tol(ref):
    top = float(ref.detach().float().abs().max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7) / top


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernels_match_plain(cuda, shape):
    """Each kernel against its plain version, from the plain version's
    residuals (lse, D), so each is held on its own."""
    q, k, v, do = _flash_inputs(shape, cuda)
    before = [fn.launches for fn in (fa.flash_attention_fwd,
                                     fa.flash_attention_dq,
                                     fa.flash_attention_dkv)]
    out, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
    dq, dl = fa.flash_attention_dq(q, k, v, o_ref, do, lse_ref)
    dq_ref, dl_ref = fa.flash_dq_reference(q, k, v, o_ref, do, lse_ref)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse_ref, dl_ref)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse_ref, dl_ref)
    torch.cuda.synchronize()
    assert [fn.launches for fn in (fa.flash_attention_fwd,
                                   fa.flash_attention_dq,
                                   fa.flash_attention_dkv)] == \
        [n + 1 for n in before]
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    _assert_within(out, o_ref, _out_tol(o_ref))
    _assert_within(lse, lse_ref, FLASH_STAT_TOL)
    _assert_within(dl, dl_ref, FLASH_STAT_TOL)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _assert_within(got, ref, FLASH_GRAD_TOL)


@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("length", [1, 65, 197, 577])
def test_flash_forward_matches_plain(cuda, d, length):
    """The forward at every head-dim class and at L = 1, one past a tile,
    ViT-B/16's 197 and 577: the output, lse, lse finite on the padded rows
    up to Lpad, and the backward kernels fed from this forward's lse."""
    q, k, v, do = _flash_inputs((2, 3, length, d), cuda, seed=2)
    out, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
    torch.cuda.synchronize()
    _assert_within(out, o_ref, _out_tol(o_ref))
    _assert_within(lse, lse_ref, FLASH_STAT_TOL)
    lpad = -(-length // fa.TILE) * fa.TILE
    padded = lse.as_strided((2, 3, lpad), lse.stride())
    assert bool(torch.isfinite(padded).all())
    dq, dl = fa.flash_attention_dq(q, k, v, out, do, lse)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, dl)
    dq_ref, dl_ref = fa.flash_dq_reference(q, k, v, out, do, lse_ref)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse_ref, dl_ref)
    torch.cuda.synchronize()
    _assert_within(dl, dl_ref, FLASH_STAT_TOL)
    _assert_within(dv, dv_ref, FLASH_GRAD_TOL)
    if length == 1:
        # one key: P = 1 whatever the scores, so dS, dQ and dK are zero up
        # to round-off (2^-16 of dV's scale)
        for got in (dq, dk):
            assert float(got.float().abs().max()) <= FLASH_STAT_TOL * float(
                dv_ref.float().abs().max())
    else:
        for got, ref in ((dq, dq_ref), (dk, dk_ref)):
            _assert_within(got, ref, FLASH_GRAD_TOL)


@pytest.mark.parametrize("shape", [(4, 12, 197, 64), (2, 3, 130, 128),
                                   (1, 2, 70, 80)])
def test_flash_backward_kernels_are_deterministic(cuda, shape):
    """dQ (with D) and dK/dV twice on the same inputs: bit-equal, since
    every sum runs in a fixed order (no atomics)."""
    q, k, v, do = _flash_inputs(shape, cuda, seed=5)
    out, lse = fa.flash_attention_fwd(q, k, v)
    first = fa.flash_attention_dq(q, k, v, out, do, lse)
    first += fa.flash_attention_dkv(q, k, v, do, lse, first[1])
    second = fa.flash_attention_dq(q, k, v, out, do, lse)
    second += fa.flash_attention_dkv(q, k, v, do, lse, second[1])
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkv",
                                    "conv_fused", "conv_pair", "corr_fwd",
                                    "corr_bwd_f1", "corr_bwd_f2",
                                    "randaugment_ew"])
def test_kernels_launch_from_a_fresh_thread(cuda, kernel):
    """The kernels that encode tensor maps or launch clusters, launched
    from a thread that has made no CUDA call (as autograd's backward
    thread or a server's worker may be), give what they give on the main
    thread."""
    import threading

    q, k, v, do = _flash_inputs((2, 3, 100, 64), cuda, seed=6)
    out, lse = fa.flash_attention_fwd(q, k, v)
    dl = fa.flash_attention_dq(q, k, v, out, do, lse)[1]
    fused = _fused_args((2, 4, 4, 64, 64), cuda, seed=6)
    pair = _pair_args((2, 8, 8, 64, 64, 64), cuda, seed=6)
    f1, f2, grad = _corr_inputs((2, 6, 40, 32), 4, torch.bfloat16, cuda, 6)
    ew = _ew_inputs((4, 128, 128, 3), "random", cuda, seed=6)
    fn = {"flash_fwd": lambda: fa.flash_attention_fwd(q, k, v)[0],
          "flash_dq": lambda: fa.flash_attention_dq(q, k, v, out, do,
                                                    lse)[0],
          "flash_dkv": lambda: fa.flash_attention_dkv(q, k, v, do, lse,
                                                      dl)[0],
          "conv_fused": lambda: conv_fused.conv3x3_bn_relu(*fused),
          "conv_pair": lambda: conv_pair.conv1x1_conv3x3_bn_relu(*pair),
          "corr_fwd": lambda: correlation.correlation_fwd(f1, f2, 4),
          "corr_bwd_f1": lambda: correlation.correlation_bwd_f1(grad, f1,
                                                                f2, 4),
          "corr_bwd_f2": lambda: correlation.correlation_bwd_f2(grad, f1,
                                                                f2, 4),
          "randaugment_ew": lambda: randaugment_ew.apply_layer(*ew)
          }[kernel]
    want = fn()
    got = {}

    def run():
        try:
            got["out"] = fn()
            torch.cuda.synchronize()
        except Exception as e:  # the assertion below reports it
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    torch.testing.assert_close(got["out"], want, rtol=0, atol=0)


@pytest.mark.parametrize("packed", [True, False])
def test_flash_autograd_matches_plain_autograd(cuda, packed):
    """The autograd Function (forward kernel, then dQ and dK/dV) against
    torch's autograd through the plain version, with strided views of a
    packed qkv or contiguous tensors."""
    q, k, v, do = _flash_inputs((2, 12, 197, 64), cuda, seed=1)
    if not packed:
        q, k, v = (t.contiguous() for t in (q, k, v))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_reference(*plain)
    want = torch.autograd.grad(ref, plain, do.float())
    _assert_within(out, ref, _out_tol(ref))
    for g, w in zip(got, want):
        _assert_within(g, w, FLASH_GRAD_TOL)


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, do = _flash_inputs((1, 2, 40, 64), cuda)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention_fwd(q.float(), k.float(), v.float())
    x = torch.zeros(1, 2, 40, 40, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="cross-length"):
        fa.flash_attention(q, k[:, :, :20], v)


def test_mha_dispatch_takes_the_kernel_for_bf16_cuda(cuda):
    q, k, v, _ = _flash_inputs((1, 2, 50, 32), cuda)
    before = fa.flash_attention_fwd.launches
    out = attention.multi_head_attention(q, k, v)
    assert fa.flash_attention_fwd.launches == before + 1
    ref = attention.attention_reference(q, k, v)
    _assert_within(out, ref, _out_tol(ref))
    attention.multi_head_attention(q.float(), k.float(), v.float())
    assert fa.flash_attention_fwd.launches == before + 1


def test_vit_train_step_on_card_matches_host(cuda):
    """Step 1 of the ViT recipe (RandAugment off) with ViT-Ti/16 at batch
    4, the same weights, batch, draws and drop-path masks on the card and
    on the host: loss within 2e-2, each gradient's norm within 5e-2 (plus
    1e-3 of the largest), as chip_smoke.py holds ViT-B/16; 12 launches of
    each flash kernel."""
    cfg = recipes.apply_overrides(recipes.load_config(VIT_CONFIG), [
        "augment.randaugment=None", "model=vit_ti16"])
    card, train_set, _ = recipes.build_trainer(cfg, True, device=cuda)
    host, _, _ = recipes.build_trainer(cfg, True,
                                       device=torch.device("cpu"))
    params, state = random_jax_params(card.model, 0)
    for t in (card, host):
        weights.from_jax(t.model, params, state)
    xs, ys = train_set.source.get_batch(np.arange(4))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    draws = card.sample(4, tuple(xs.shape[1:3]))
    kernels.reset_launch_counts()
    loss_card = float(card.loss_and_grads(x.to(cuda), y.to(cuda), draws)[0])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert [counts[k] for k in ("flash_attention_fwd", "flash_attention_dq",
                                "flash_attention_dkv")] == [12, 12, 12]
    on_host = StepDraws(draws.boxes.cpu(), draws.flip.cpu(),
                        MixDraws(*(t.cpu() for t in draws.mix)),
                        [{s: m.cpu() for s, m in d.items()}
                         for d in draws.masks])
    loss_host = float(host.loss_and_grads(x, y, on_host)[0])
    assert abs(loss_card - loss_host) <= 2e-2 * abs(loss_host)
    norms = [(float(pc.grad.float().norm()), float(ph.grad.norm()))
             for (_, pc, _), (_, ph, _) in zip(
                 weights.param_views(card.model),
                 weights.param_views(host.model))]
    biggest = max(h for _, h in norms)
    assert all(abs(c - h) <= 5e-2 * h + 1e-3 * biggest for c, h in norms)


# MAE-B16's two flash sites at a batch of 4: the encoder on the kept
# quarter of the tokens (1 + 49), the decoder's 16 heads of 32 on all 197
MAE_FLASH_SHAPES = [(4, 12, 50, 64), (4, 16, 197, 32)]


@pytest.mark.parametrize("shape", MAE_FLASH_SHAPES)
def test_flash_kernels_at_maes_shapes(cuda, shape):
    """The forward, dQ and dK/dV at MAE's encoder and decoder shapes
    against their plain versions, at the tolerances above."""
    test_flash_kernels_match_plain(cuda, shape)


MAE_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                          "cifar10_mae.py")


def test_tinymae_bf16_step_on_card_matches_plain_attention(cuda,
                                                           monkeypatch):
    """A bf16 ``tinymae`` step (configs/cifar10_mae.py under bf16) on the
    card through the flash kernels (one launch of each kernel a block: 2
    encoder blocks, 1 decoder block), against the same step with the
    attention on its plain path: the loss within 2e-2, each gradient's
    norm within 5e-2 (plus 1e-3 of the largest)."""
    import importlib

    from myconvnet_tpu_torch import recipes_ssl
    vit = importlib.import_module("myconvnet_tpu_torch.models.vit")
    cfg = recipes.apply_overrides(recipes.load_config(MAE_CONFIG), [
        "precision=bf16", "augment.out_hw=[8,8]", "synthetic_n=8"])
    trainer, train_set, _ = recipes_ssl.build_ssl(cfg, True, device=cuda)
    params, _ = random_jax_params(trainer.model, 0)
    weights.from_jax(trainer.model, params, {})
    x = torch.from_numpy(train_set.source.get_batch(np.arange(4))[0])
    draws = trainer.sample(4, (32, 32))

    def step():
        trainer.optimizer.zero_grad()
        loss = trainer.loss(x.to(cuda), draws)["loss"]
        loss.backward()
        return float(loss.detach()), [float(p.grad.float().norm())
                             for _, p, _ in weights.param_views(
                                 trainer.model)]

    kernels.reset_launch_counts()
    loss_card, norms_card = step()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert [counts[k] for k in ("flash_attention_fwd", "flash_attention_dq",
                                "flash_attention_dkv")] == [3, 3, 3]
    plain = attention.multi_head_attention
    monkeypatch.setattr(vit, "multi_head_attention",
                        lambda *a, **kw: plain(*a, **dict(kw,
                                                          use_flash=False)))
    loss_plain, norms_plain = step()
    assert kernels.launch_counts()["flash_attention_fwd"] == 3
    assert abs(loss_card - loss_plain) <= 2e-2 * abs(loss_plain)
    biggest = max(norms_plain)
    assert all(abs(c - h) <= 5e-2 * h + 1e-3 * biggest
               for c, h in zip(norms_card, norms_plain))


# ------------------------------------------------ RandAugment (B7, B8)

# the ViT recipe's batch at 224x224, and an odd shape (a scalar tail in
# randaugment_ew: 21 * 17 * 3 elements an image, not a multiple of 4)
RA_SHAPES = [(1024, 224, 224, 3), (3, 21, 17, 3)]
# both kernels round each product, sum and quotient as their plain
# versions do: bit-exact expected, 1 float32 ulp allowed
RA_TOL = dict(rtol=2 ** -23, atol=2 ** -30)


def _rand01(shape, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev)


@pytest.mark.parametrize("shape", RA_SHAPES)
@pytest.mark.parametrize("axis", [2, 1])
def test_shear_kernel_matches_plain(cuda, shape, axis):
    """Slopes spread over +-0.3 with the centring offset plus a shift of
    up to 3 pixels, so rows leave the frame at both ends."""
    x = _rand01(shape, cuda)
    n = shape[0]
    slope = torch.linspace(-0.3, 0.3, n, device=cuda)
    offset = affine._centered(slope, shape[3 - axis]) \
        + torch.linspace(3.0, -3.0, n, device=cuda)
    before = affine.shear_rows.launches
    out = affine.shear_rows(x, slope, offset, fill=0.5, axis=axis)
    torch.cuda.synchronize()
    assert affine.shear_rows.launches == before + 1
    ref = affine.shear_reference(x, slope, offset, fill=0.5, axis=axis)
    torch.testing.assert_close(out, ref, **RA_TOL)


def test_shear_kernel_at_integer_shifts_matches_plain(cuda):
    """Slopes and offsets where slope * y + offset is an exact integer
    under an FMA and one ulp under it as the kernel rounds (the CPU test's
    inputs): kernel and plain version round alike, bit for bit."""
    cases = [(0.09784692525863647, -0.07631617784500122),
             (0.29273349046707153, -0.46366745233535767),
             (0.25677502155303955, -2.621950387954712),
             (-0.15562570095062256, 1.6456369161605835)]
    x = _rand01((4, 20, 24, 3), cuda, seed=3)
    slope = torch.tensor([c[0] for c in cases], device=cuda)
    offset = torch.tensor([c[1] for c in cases], device=cuda)
    for axis in (2, 1):
        out = affine.shear_rows(x, slope, offset, fill=0.25, axis=axis)
        ref = affine.shear_reference(x, slope, offset, fill=0.25,
                                     axis=axis)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("axis", [2, 1])
def test_shear_kernel_at_steep_slopes_matches_plain(cuda, axis):
    """|slope| = 3: a column strip's source rows overflow the 96-row box,
    so it reads its taps from device memory; rows shear whole rows out of
    the frame."""
    x = _rand01((4, 40, 72, 3), cuda, seed=4)
    slope = torch.tensor([3.0, -3.0, 2.5, -0.5], device=cuda)
    offset = affine._centered(slope, x.shape[3 - axis])
    out = affine.shear_rows(x, slope, offset, fill=0.5, axis=axis)
    ref = affine.shear_reference(x, slope, offset, fill=0.5, axis=axis)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **RA_TOL)


@pytest.mark.parametrize("shape,axis,path", [
    ((2, 12, 20, 3), 2, "staged"), ((2, 12, 20, 3), 1, "staged"),
    ((1, 2, 20000, 3), 2, "direct"), ((2, 8, 8, 300), 1, "direct"),
    ((2, 70, 9, 100), 1, "staged")])
def test_shear_kernel_paths_match_plain(cuda, shape, axis, path):
    """The paths the planner picks besides the recipe's: a base 4 bytes
    past a 16-byte boundary (plain loads into the same buffers), rows too
    long for shared memory and strips wider than a TMA box (reads from
    device memory), 100 channels (a strip of two columns)."""
    numel = int(np.prod(shape))
    buf = _rand01((numel + 1,), cuda, seed=5)
    x = buf[1:].view(shape) if path == "staged" and shape[3] == 3 \
        else buf[:numel].view(shape)
    assert affine.plan(shape, axis, x.data_ptr() % 16 == 0)["path"] == path
    slope = torch.linspace(-0.3, 0.3, shape[0], device=cuda)
    offset = affine._centered(slope, shape[3 - axis]) + 1.5
    out = affine.shear_rows(x, slope, offset, fill=0.5, axis=axis)
    ref = affine.shear_reference(x, slope, offset, fill=0.5, axis=axis)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **RA_TOL)


@pytest.mark.parametrize("shape", RA_SHAPES)
def test_rotate_kernels_match_plain(cuda, shape):
    x = _rand01(shape, cuda, seed=1)
    angles = torch.linspace(-np.pi / 6, np.pi / 6, shape[0], device=cuda)
    before = affine.shear_rows.launches
    out = affine.rotate(x, angles, max_abs_radians=np.pi / 6)
    torch.cuda.synchronize()
    assert affine.shear_rows.launches == before + 3
    a, b = torch.tan(angles / 2.0), -torch.sin(angles)
    ref = x
    for slope, axis in ((a, 2), (b, 1), (a, 2)):
        offset = affine._centered(slope, ref.shape[3 - axis])
        ref = affine.shear_reference(ref, slope, offset, axis=axis)
    torch.testing.assert_close(out, ref, **RA_TOL)


# randaugment_ew at the recipe's batch and at odd shapes, with each path
# its planner can give them: 1071, 357 and 1428 floats an image (only the
# last a whole number of float4s), clusters of 2 with a shorter last slice
# and of 4
RA_EW_CASES = [((1024, 224, 224, 3), "one_pass"),
               ((1024, 224, 224, 3), "two_pass"),
               ((3, 21, 17, 3), "two_pass"), ((3, 21, 17, 1), "two_pass"),
               ((3, 21, 17, 4), "one_pass"), ((3, 21, 17, 4), "two_pass"),
               ((2, 130, 130, 3), "one_pass"), ((2, 160, 200, 3), "one_pass")]


def _ew_inputs(shape, op, dev, seed=2):
    """[0, 1] images with a flat channel in image 0, the op forced for the
    batch (or random per image) as int64, magnitudes over [-1, 1]."""
    x = _rand01(shape, dev, seed=seed)
    x[0, ..., shape[3] // 2] = 0.25  # a flat channel: autocontrast leaves it
    n = shape[0]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    if op == "random":
        idx = torch.randint(0, 8, (n,), generator=g, device=dev)
    else:
        idx = torch.full((n,), randaugment_ew.PALLAS_POOL.index(op),
                         device=dev, dtype=torch.int64)
    mag = torch.rand(n, generator=g, device=dev) * 2 - 1
    return x, idx, mag


@pytest.mark.parametrize("shape,path", RA_EW_CASES)
@pytest.mark.parametrize("op", list(randaugment_ew.PALLAS_POOL) + ["random"])
def test_randaugment_ew_kernel_matches_plain(cuda, shape, path, op):
    """Each op of PALLAS_POOL forced for the whole batch, and a random op
    per image, on each path; one counted launch a layer."""
    x, idx, mag = _ew_inputs(shape, op, cuda)
    before = randaugment_ew.apply_layer.launches
    out = randaugment_ew.apply_layer(x, idx, mag, path=path)
    torch.cuda.synchronize()
    assert randaugment_ew.apply_layer.launches == before + 1
    ref = randaugment_ew.apply_layer_reference(x, idx, mag)
    torch.testing.assert_close(out, ref, **RA_TOL)


@pytest.mark.parametrize("shape,path", RA_EW_CASES[:3])
def test_randaugment_ew_kernel_is_deterministic(cuda, shape, path):
    """Two runs bit-equal: the statistics combine in fixed orders."""
    x, idx, mag = _ew_inputs(shape, "random", cuda, seed=7)
    first = randaugment_ew.apply_layer(x, idx, mag, path=path)
    second = randaugment_ew.apply_layer(x, idx, mag, path=path)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("path,kernels", [("one_pass", 1), ("two_pass", 2)])
def test_randaugment_ew_launches_one_kernel_a_layer(cuda, path, kernels):
    """torch.profiler sees one CUDA kernel for a layer on the one-pass path
    (the int64 op index and float32 magnitudes are read as they come, no
    conversion, no statistics pass) and two on the two-pass path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, idx, mag = _ew_inputs((64, 224, 224, 3), "random", cuda, seed=8)
    randaugment_ew.apply_layer(x, idx, mag, path=path)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        randaugment_ew.apply_layer(x, idx, mag, path=path)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    assert len(names) == kernels, names
    assert all("ra_" in name for name in names), names


def test_randaugment_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(2, 8, 8, 3, device=cuda)
    s = torch.zeros(2, device=cuda)
    with pytest.raises(TypeError):
        affine.shear_rows(x.half(), s, s)
    with pytest.raises(ValueError):
        affine.shear_rows(x.transpose(1, 2), s, s)
    idx = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        randaugment_ew.apply_layer(x.double(), idx, s)
    with pytest.raises(ValueError):
        randaugment_ew.apply_layer(x.transpose(1, 2), idx, s)
    with pytest.raises(ValueError, match="channels"):
        randaugment_ew.apply_layer(x[..., :2].contiguous(), idx, s)
    odd = torch.zeros(2, 21, 17, 3, device=cuda)
    with pytest.raises(ValueError, match="no one-pass plan"):
        randaugment_ew.apply_layer(odd, idx, s, path="one_pass")


POLICIES = {"fast": dict(randaugment=(2, 9)),
            "pallas": dict(randaugment=(2, 9), randaugment_backend="pallas"),
            "canonical": dict(randaugment=(2, 9),
                              randaugment_ops="canonical"),
            "autoaugment": dict(autoaugment="imagenet")}
# launches of (shear_rows, randaugment_ew) a batch
POLICY_LAUNCHES = {"fast": (0, 0), "pallas": (0, 2), "canonical": (10, 0),
                   "autoaugment": (7, 0)}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_policy_on_card_matches_host(cuda, policy):
    """augment_train of 4 images, 64x64 crops of 80x80, with the same
    draws on the card (kernels) and on the host (plain versions): the
    crop matmuls differ by float32 round-off, which posterize, solarize
    and equalize can turn into a whole level at a rare pixel: 1e-4 on
    all but 1% of the elements."""
    cfg = taug.AugmentConfig(out_hw=(64, 64), **POLICIES[policy])
    g = torch.Generator(device=cuda).manual_seed(4)
    boxes, flip = taug.sample_geometry(g, 4, (80, 80), cfg)
    draws = taug.sample_policy(g, 4, cfg)
    x = _images((4, 80, 80, 3), cuda, seed=5)
    kernels.reset_launch_counts()
    card = taug.augment_train(x, boxes, flip, cfg, policy=draws)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["shear_rows"], counts["randaugment_ew"]) == \
        POLICY_LAUNCHES[policy]
    host = taug.augment_train(x.cpu(), boxes.cpu(), flip.cpu(), cfg,
                              policy=type(draws)(*(t.cpu() for t in draws)))
    diff = (card.cpu() - host).abs()
    assert torch.isfinite(card).all()
    assert float((diff > 1e-4).float().mean()) <= 0.01


# ------------------------------------------------------------ correlation

# the recipes' sites at batch 2 (PWC-Net levels 2 to 6, FlowNetC at 1/8) and
# odd shapes: ragged W, C not a multiple of 4 or 16, a window larger than
# the frame, d from 0 to the kernel's limit; (shape, d)
CORR_CASES = [((2, 96, 128, 32), 4), ((2, 48, 64, 64), 4),
              ((2, 24, 32, 96), 4), ((2, 12, 16, 128), 4),
              ((2, 6, 8, 196), 4), ((2, 48, 64, 256), 4),
              ((3, 7, 37, 7), 1), ((2, 5, 9, 21), 3), ((1, 3, 3, 4), 4),
              ((2, 9, 33, 16), 0), ((1, 10, 40, 5), 4), ((2, 16, 16, 16), 2),
              # the tensor-core kernels' paths and edges (bf16; float32
              # takes the CUDA-core kernels): blocks of 4 output rows on a
              # map of 3 (H < TY) with 8-pixel segments and rows kept in the
              # ring; 4 rows a block with rows reloaded; 2 rows a block and
              # 32-channel panels at W = 40; rows kept by TMA at C = 256 on
              # 8 pixels; ragged tiles at W = 37 and 70; two 64-pixel tiles
              # with 256 channels; 196 channels staged by 8-byte copies, 7
              # by plain loads
              ((396, 3, 8, 16), 4), ((132, 12, 64, 64), 4),
              ((132, 16, 40, 32), 4), ((2, 6, 8, 256), 4),
              ((2, 20, 37, 64), 2), ((2, 5, 128, 256), 1),
              ((2, 5, 37, 196), 3), ((2, 9, 70, 7), 0)]
# float32 sums in another order: 2^-18 of max |volume|; gradients rounded
# to the inputs' dtype: the same for float32, 2 bf16 ulps of the largest
# gradient for bf16 (``_out_tol``); both relative to the reference's max
CORR_TOL = 2 ** -18


def _corr_inputs(shape, d, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    f1, f2 = (torch.randn(shape, generator=g).to(dtype).to(dev)
              for _ in range(2))
    grad = torch.randn((*shape[:3], (2 * d + 1) ** 2), generator=g).to(dev)
    return f1, f2, grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,d", CORR_CASES)
def test_correlation_kernels_match_plain(cuda, shape, d, dtype):
    f1, f2, grad = _corr_inputs(shape, d, dtype, cuda)
    out = correlation.correlation_fwd(f1, f2, d)
    ref = correlation.correlation_reference(f1, f2, d)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _assert_within(out, ref, CORR_TOL)
    d1 = correlation.correlation_bwd_f1(grad, f1, f2, d)
    d2 = correlation.correlation_bwd_f2(grad, f1, f2, d)
    r1, r2 = correlation.correlation_bwd_reference(grad, f1, f2, d)
    torch.cuda.synchronize()
    for got, want in ((d1, r1), (d2, r2)):
        assert got.dtype == dtype and got.shape == want.shape
        _assert_within(got, want, CORR_TOL if dtype == torch.float32
                       else _out_tol(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_correlation_autograd_matches_plain_autograd(cuda, dtype):
    """correlation_volume under autograd: three launches, the gradients of
    a random cotangent as the plain version's; a feature map that needs no
    gradient gets no backward launch."""
    from myconvnet_tpu_torch.ops.correlation import correlation_volume
    f1, f2, grad = _corr_inputs((2, 11, 19, 12), 3, dtype, cuda, seed=1)
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    kernels.reset_launch_counts()
    out = correlation_volume(a, b, max_displacement=3)
    (out * grad).sum().backward()
    counts = kernels.launch_counts()
    assert (counts["correlation_fwd"], counts["correlation_bwd_f1"],
            counts["correlation_bwd_f2"]) == (1, 1, 1)
    r1, r2 = correlation.correlation_bwd_reference(grad, f1, f2, 3)
    for got, want in ((a.grad, r1), (b.grad, r2)):
        _assert_within(got, want, CORR_TOL if dtype == torch.float32
                       else _out_tol(want))
    kernels.reset_launch_counts()
    correlation_volume(a, f2, max_displacement=3).sum().backward()
    assert kernels.launch_counts()["correlation_bwd_f2"] == 0
    assert kernels.launch_counts()["correlation_bwd_f1"] == 1


@pytest.mark.parametrize("shape,d", [((2, 9, 37, 32), 4), ((2, 6, 8, 196), 2)])
def test_correlation_kernels_take_misaligned_bases(cuda, shape, d):
    """bf16 maps whose base is 2 bytes past a 16-byte boundary: no TMA, no
    8-byte copies; the tensor-core kernels stage them by plain loads."""
    f1, f2, grad = _corr_inputs(shape, d, torch.bfloat16, cuda, seed=2)
    n = f1.numel()
    a = torch.empty(2 * n + 1, dtype=torch.bfloat16, device=cuda)
    m1, m2 = a[1:n + 1].view(shape), a[n + 1:].view(shape)
    m1.copy_(f1)
    m2.copy_(f2)
    assert m1.data_ptr() % 8 and m2.data_ptr() % 8
    assert correlation.plan("fwd", shape, d, torch.bfloat16,
                            aligned=False)["path"] == "staged"
    _assert_within(correlation.correlation_fwd(m1, m2, d),
                   correlation.correlation_reference(f1, f2, d), CORR_TOL)
    r1, r2 = correlation.correlation_bwd_reference(grad, f1, f2, d)
    _assert_within(correlation.correlation_bwd_f1(grad, m1, m2, d), r1,
                   _out_tol(r1))
    _assert_within(correlation.correlation_bwd_f2(grad, m1, m2, d), r2,
                   _out_tol(r2))


def test_shear_and_correlation_planners_match_the_built_kernels(cuda):
    """The planners' copies of the kernels' constants and shared-memory
    layouts equal what the built kernels give: the shear's strip, box and
    chunk; for every correlation plan of the recipe sites and of
    CORR_CASES, the bytes a block asks for (within what the card allows),
    at least the planned blocks an SM, and the SMs."""
    facts = affine.kernel_facts()
    assert (facts["tile_rows"], facts["box_rows"], facts["max_box"],
            facts["chunk_bytes"], facts["row_threads"]) == (
        affine.TILE_ROWS, affine.BOX_ROWS, affine.MAX_BOX,
        affine.CHUNK_BYTES, affine.ROW_THREADS)
    sites = [((32, 96, 128, 32), 4), ((32, 48, 64, 64), 4),
             ((32, 24, 32, 96), 4), ((32, 12, 16, 128), 4),
             ((32, 6, 8, 196), 4), ((32, 48, 64, 256), 4)]
    for shape, d in sites + CORR_CASES:
        for mode in correlation.MODES:
            p = correlation.plan(mode, shape, d)
            if p["path"] == "cuda_cores":
                continue
            f = correlation.kernel_facts(mode, shape[3], d, p["seg"],
                                         p["pw"], p["slots"],
                                         p["aux_slots"])
            assert f["smem"] == p["smem"] <= f["smem_max"], (shape, mode)
            assert f["blocks_per_sm"] >= p["blocks_per_sm"], (shape, mode)
            assert (f["sms"], f["max_channels"]) == (
                correlation.SMS, correlation.MAX_TC_CHANNELS)


def test_randaugment_and_bn_act_planners_match_the_built_kernels(cuda):
    """randaugment_ew's planner copies of the kernel's constants equal the
    built kernel's, and every one-pass plan of the recipe's and the tests'
    shapes gets at least MIN_BLOCKS_SM blocks an SM and clusters on the
    card; bn_act's planner assumes the card's SMs and no more threads an
    SM than its kernel holds, and the kernel's four loads a thread."""
    shapes = [s for s, _ in RA_EW_CASES] + [(256, 224, 224, 3),
                                            (2, 128, 128, 3)]
    for shape in shapes:
        p = randaugment_ew.plan(shape)
        if p["path"] != "one_pass":
            continue
        f = randaugment_ew.kernel_facts(shape[3], p["k"], p["smem"])
        assert (f["threads"], f["header_bytes"], f["stats_pixels"],
                f["record_bytes"], f["max_apply_blocks"]) == (
            randaugment_ew.THREADS, randaugment_ew.HEADER_BYTES,
            randaugment_ew.STATS_PIXELS, randaugment_ew.RECORD_BYTES,
            randaugment_ew.MAX_APPLY_BLOCKS), shape
        assert f["blocks_per_sm"] >= randaugment_ew.MIN_BLOCKS_SM, shape
        assert f["clusters"] >= 1, shape
    f = bn_act.kernel_facts()
    assert f["sms"] == bn_act.SMS and f["unroll"] == 4
    for key in ("blocks_per_sm_f32", "blocks_per_sm_bf16"):
        assert f[key] * 256 >= bn_act.THREADS_SM, f


def test_correlation_kernel_reads_views_and_rejects_what_it_does_not_take(
        cuda):
    f1, f2, _ = _corr_inputs((2, 8, 8, 8), 2, torch.float32, cuda)
    nchw = f2.permute(0, 3, 1, 2).contiguous()      # an NHWC view of NCHW
    got = correlation.correlation_fwd(f1, nchw.permute(0, 2, 3, 1), 2)
    assert torch.equal(got, correlation.correlation_fwd(f1, f2, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        correlation.correlation_fwd(f1.half(), f2.half(), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        correlation.correlation_fwd(f1, f2.bfloat16(), 2)
    with pytest.raises(ValueError, match="one shape"):
        correlation.correlation_fwd(f1, f2[:, :4], 2)
    with pytest.raises(ValueError, match="<= 4"):
        correlation.correlation_fwd(f1, f2, 5)
    with pytest.raises(ValueError, match="does not fit"):
        correlation.correlation_bwd_f1(f1, f1, f2, 2)


# the GAN generators' eval sites of B1: DCGAN at 32x32 (base 256, batch
# 128; ReLU) and the pix2pix U-Net at 256x256 with 8 levels (batch 16; six
# leaky ReLU encoder sites, seven ReLU decoder sites)
GAN_ACT_SITES = [(128, 4, 4, 256), (128, 8, 8, 128), (128, 16, 16, 64),
                 (16, 64, 64, 128), (16, 32, 32, 256), (16, 16, 16, 512),
                 (16, 8, 8, 512), (16, 4, 4, 512), (16, 2, 2, 512),
                 (16, 128, 128, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GAN_ACT_SITES)
def test_bn_act_kernel_at_the_gan_sites_matches_plain(cuda, shape, dtype):
    """Each of the 16 GAN sites' shapes (10 distinct; the U-Net's
    decoder repeats the encoder's but for 128²x64), ReLU and leaky ReLU,
    bit for bit; one launch a call."""
    rng = np.random.RandomState(shape[1] + shape[-1])
    c = shape[-1]
    x = torch.from_numpy((rng.randn(*shape) * 4).astype(np.float32))
    x = x.to(cuda, dtype)
    a = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
    for act in ("relu", "leaky_relu"):
        before = bn_act.fused_scale_shift_act.launches
        out = bn_act.fused_scale_shift_act(x, a, b, act)
        torch.cuda.synchronize()
        assert bn_act.fused_scale_shift_act.launches == before + 1
        ref = bn_act.scale_shift_act_reference(x, a, b, act)
        torch.testing.assert_close(out, ref, **BN_ACT_TOL)


@pytest.mark.parametrize("shape", [(128, 32, 32, 3), (16, 256, 256, 3)])
def test_normalize_u8_kernel_at_the_gan_inputs_matches_plain(cuda, shape):
    """The GAN recipes' rescale to [-1, 1] (mean = std = 0.5, float32 out)
    at DCGAN's and pix2pix's train batches, bit for bit."""
    x = _images(shape, cuda, seed=5)
    half = torch.full((3,), 0.5, device=cuda)
    out = normalize_u8.normalize_u8(x, half, half, torch.float32)
    ref = normalize_u8.normalize_u8_reference(x, half, half, torch.float32)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **INPUT_TOL)
    assert float(out.min()) >= -1.0 and float(out.max()) <= 1.0


def test_unet_eval_on_card_matches_host(cuda):
    """The U-Net at 256x256 with 8 levels (base 8, bf16, batch 2) on the
    card, B1 at its 13 sites, against the same module on the host: within
    0.05 of max |output|."""
    from myconvnet_tpu_torch.models.gan import UNetGenerator
    model = UNetGenerator(image_size=256, base_features=8)
    weights.from_jax(model, *random_jax_params(model, 1)).eval()
    x = torch.from_numpy(np.tanh(np.random.RandomState(2).randn(
        2, 256, 256, 3)).astype(np.float32)).bfloat16()
    with torch.no_grad():
        host = model(x).float()
        kernels.reset_launch_counts()
        got = model.to(cuda)(x.to(cuda)).float().cpu()
    assert kernels.launch_counts()["bn_act"] == 13
    err = float((got - host).abs().max())
    assert err <= 0.05 * float(host.abs().max()), err


# ------------------------------------------------ the kernels as custom ops

def _op_cases(cuda):
    """(op, its module's direct launch, args) of the five ops at a served
    shape each."""
    g = torch.Generator(device=cuda).manual_seed(7)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    def vec(c):
        return torch.rand(c, generator=g, device=cuda) + 0.5
    return {
        "bn_act": (torch.ops.mcn.bn_act.default, bn_act.launch_cuda,
                   (rnd(8, 14, 14, 256), vec(256), vec(256) - 1.0,
                    "relu")),
        "conv_pair": (torch.ops.mcn.conv_pair.default, conv_pair.launch_cuda,
                      (rnd(8, 14, 14, 1024), rnd(1, 1, 1024, 256) * 0.03,
                       vec(256), vec(256) - 1.0, rnd(3, 3, 256, 256) * 0.02,
                       vec(256), vec(256) - 1.0)),
        "conv_fused": (torch.ops.mcn.conv_fused.default,
                       conv_fused.launch_cuda,
                       (rnd(4, 33, 33, 304), rnd(3, 3, 304, 256) * 0.02,
                        vec(256), vec(256) - 1.0, None)),
        "flash_attention_fwd": (
            torch.ops.mcn.flash_attention_fwd.default, fa.launch_fwd_cuda,
            (rnd(8, 12, 197, 64), rnd(8, 12, 197, 64),
             rnd(8, 12, 197, 64), 0.125)),
        "correlation_fwd": (
            torch.ops.mcn.correlation_fwd.default, correlation.launch_fwd_cuda,
            (rnd(4, 96, 128, 32), rnd(4, 96, 128, 32), 4))}


# each op's name is its wrapper's in kernels.WRAPPERS
@pytest.mark.parametrize("name", ["bn_act", "conv_fused", "conv_pair",
                                  "correlation_fwd", "flash_attention_fwd"])
def test_op_cuda_implementation_gives_the_direct_launchs_bits(cuda, name):
    """Each op's CUDA implementation is the kernel's launch: the same bits
    as the direct launch, one counted launch each, and no plain version."""
    op, direct, args = _op_cases(cuda)[name]
    kernels.reset_launch_counts()
    got = op(*args)
    want = direct(*args)
    torch.cuda.synchronize()
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert g.stride() == w.stride() and torch.equal(g, w)
    assert kernels.launch_counts() == {
        **{n: 0 for n in kernels.WRAPPERS}, name: 2}


# the public wrapper of each op: (module, op attribute, call)
_WRAPPER_CALLS = {
    "bn_act": (bn_act, "_OP", bn_act.fused_scale_shift_act),
    "conv_pair": (conv_pair, "_OP", conv_pair.conv1x1_conv3x3_bn_relu),
    "conv_fused": (conv_fused, "_OP", lambda x, w3, s, b, split:
                   conv_fused.conv3x3_bn_relu(x, w3, s, b, split=split)),
    "flash_attention_fwd": (fa, "_FWD_OP", fa.flash_attention_fwd),
    "correlation_fwd": (correlation, "_FWD_OP", correlation.correlation_fwd)}


@pytest.mark.parametrize("name", sorted(_WRAPPER_CALLS))
def test_wrapper_launches_without_the_op_on_the_card(cuda, monkeypatch,
                                                     name):
    """Outside a torch.export trace a wrapper launches its kernel directly
    on CUDA tensors: the op (the dispatcher's host time a launch) is not
    called, and the bits are the op's."""
    op, _, args = _op_cases(cuda)[name]
    want = op(*args)
    module, attr, call = _WRAPPER_CALLS[name]

    def no_op(*a):
        raise AssertionError(f"{name}: the eager path called the op")
    monkeypatch.setattr(module, attr, no_op)
    kernels.reset_launch_counts()
    got = call(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        **{n: 0 for n in kernels.WRAPPERS}, name: 1}
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert torch.equal(g, w)


def test_resnet_exported_on_the_card_runs_the_kernels(cuda, tmp_path):
    """A width-16 bf16 ResNet-50 exported on cuda, loaded and run: the
    eager program's bits, and the same launches (10 conv_pair, 13 bn_act,
    the graph's mcn:: nodes)."""
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)

    def trees():
        model = models.resnet50(10, width=16)
        return model, *random_jax_params(model, seed=0)
    path = str(tmp_path / "r50.pt2")
    serving.export_inference(*trees(), x, path, device=cuda, policy=BF16)
    meta = serving.artifact_meta(path)
    assert meta["device"] == "cuda" and meta["ops"] == {
        "bn_act": 13, "conv_pair": 10}
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        serving.load_inference(path, "cpu")
    fn = serving.load_inference(path)
    eager = serving.make_inference_fn(*trees(), device=cuda, policy=BF16)
    want_counts = {**{n: 0 for n in kernels.WRAPPERS}, "conv_pair": 10,
                   "bn_act": 13}
    kernels.reset_launch_counts()
    want = eager(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == want_counts
    kernels.reset_launch_counts()
    got = fn(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == want_counts
    assert got.device.type == "cuda" and torch.equal(got, want)


# ------------------------------------ the segmenters and the rest of the zoo

def _sites_on_card(model, x, cuda):
    """The bf16 eval forward of ``model`` on ``x`` on the host (plain
    versions) and on the card: (host output, card output, the card's
    launches by wrapper)."""
    model = model.eval()
    with torch.no_grad():
        host = model(x).float()
        kernels.reset_launch_counts()
        got = model.to(cuda)(x.to(cuda)).float().cpu()
    return host, got, kernels.launch_counts()


def test_unet_b4_sites_on_card_match_host(cuda):
    """U-Net at full width (base 64, depth 4; 64 x 64, batch 2, bf16,
    eval): its 17 B4 sites and the C = 3 first conv's B1 on the card, the
    logits within 0.05 of the host's plain path's largest; each B4 site
    alone against ``conv3x3_bn_relu``'s plain version at FUSED_TOL."""
    from myconvnet_tpu_torch.models.unet import UNet
    model = UNet(21)
    weights.from_jax(model, *random_jax_params(model, 3))
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, 64, 64, 3).astype(np.float32)).bfloat16()
    host, got, counts = _sites_on_card(model, x, cuda)
    assert counts["conv_fused"] == 17 and counts["bn_act"] == 1
    err = float((got - host).abs().max())
    assert err <= 0.05 * float(host.abs().max()), err
    convs = [m for m in model.modules() if hasattr(m, "conv1")]
    for dc in convs:
        for i, fused in zip((1, 2), dc.fused):
            if not fused:
                continue
            conv, bn = getattr(dc, f"conv{i}"), getattr(dc, f"bn{i}")
            c = conv.weight.shape[1]
            xi = _bf16_grid(np.random.RandomState(c).randn(
                2, 16, 16, c)).to(cuda, torch.bfloat16)
            a, b = bn.scale_shift()
            w = conv.w.to(torch.bfloat16)
            out = conv_fused.conv3x3_bn_relu(xi, w, a, b)
            ref = conv_fused.conv3x3_bn_relu_reference(xi, w, a, b)
            torch.testing.assert_close(out.float(), ref.float(), **FUSED_TOL)


@pytest.mark.parametrize("shape", [(8, 56, 56, 16, 64), (8, 13, 13, 64, 256)])
def test_squeezenet_expand3x3_matches_plain(cuda, shape):
    """SqueezeNet's expand3x3 (fire2's 16 -> 64 at 56 x 56, fire9's 64 ->
    256 at 13 x 13): B4 with the conv's bias as the epilogue at scale 1
    (``conv_epilogue(conv, None)``), against the plain version at
    FUSED_TOL and against relu(conv + bias) through cuDNN in float32 at
    2 bf16 ulps."""
    from myconvnet_tpu_torch.nn import Conv, conv_epilogue
    n, h, w, c, co = shape
    conv = Conv(c, co, 3, bias=True)
    rng = np.random.RandomState(c)
    with torch.no_grad():
        conv.w.copy_(_bf16_grid(rng.randn(3, 3, c, co) / np.sqrt(9 * c)))
        conv.bias.copy_(torch.from_numpy(
            (0.3 * rng.randn(co)).astype(np.float32)))
    conv = conv.to(cuda)
    a, b = conv_epilogue(conv, None)
    assert bool((a == 1).all())
    x = _bf16_grid(rng.randn(n, h, w, c)).to(cuda, torch.bfloat16)
    wb = conv.w.to(torch.bfloat16)
    before = conv_fused.conv3x3_bn_relu.launches
    out = conv_fused.conv3x3_bn_relu(x, wb, a, b)
    torch.cuda.synchronize()
    assert conv_fused.conv3x3_bn_relu.launches == before + 1
    ref = conv_fused.conv3x3_bn_relu_reference(x, wb, a, b)
    torch.testing.assert_close(out.float(), ref.float(), **FUSED_TOL)
    with torch.no_grad():
        plain = torch.relu(conv(x.float()))
    torch.testing.assert_close(out.float(), plain, **PAIR_TOL)


@pytest.mark.parametrize("shape", [(4, 129, 129, 128), (4, 33, 33, 728)])
def test_xception_depthwise_bn_relu_goes_through_b1(cuda, shape):
    """Xception's depthwise -> BN -> ReLU in eval under bf16 (entry2's
    first at 129 x 129, a middle block's at 33 x 33): a cuDNN depthwise
    conv and one B1 launch, bit for bit the plain scale-shift-ReLU of
    the same conv output."""
    from myconvnet_tpu_torch.models import blocks
    from myconvnet_tpu_torch.models.xception import SepConv
    n, h, w, c = shape
    sep = SepConv(c, c, relu_first=True, relu_after=False)
    weights.from_jax(sep, *random_jax_params(sep, c))
    sep = sep.to(cuda).eval()
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
    before = bn_act.fused_scale_shift_act.launches
    with torch.no_grad():
        y = blocks.conv_bn_relu(sep.dw, sep.bn_dw, x)
        torch.cuda.synchronize()
        assert bn_act.fused_scale_shift_act.launches == before + 1
        a, b = sep.bn_dw.scale_shift()
        ref = bn_act.scale_shift_act_reference(
            sep.dw(x, add_bias=False).contiguous(), a, b, "relu")
    torch.testing.assert_close(y, ref, **BN_ACT_TOL)


# RetinaNet's head layers at a 512 input (P3-P7: 64² to 4², 256 -> 256,
# batch 2) and the depth decoder's three widest sites at the recipe's
# width (up5's conv_post at 224 x 288, 16 -> 16; up5's conv_pre at
# 112 x 144, 32 -> 16; up4's conv_pre at 56 x 72, 64 -> 32; batch 2)
HEAD_SHAPES = [(2, s, s, 256, 256) for s in (64, 32, 16, 8, 4)]
DEPTH_DECODER_SHAPES = [(2, 224, 288, 16, 16), (2, 112, 144, 32, 16),
                        (2, 56, 72, 64, 32)]


@pytest.mark.parametrize("shape", HEAD_SHAPES + DEPTH_DECODER_SHAPES)
def test_detection_and_depth_b4_sites_match_plain(cuda, shape):
    """B4 at RetinaNet's weight-tied head levels with the conv's bias as
    its epilogue at scale 1 (relu(conv + bias), ``conv_epilogue(conv,
    None)``) and at the depth decoder's maps: the plain version at
    FUSED_TOL, relu(conv + bias) through cuDNN in float32 at 2 bf16 ulps,
    one launch."""
    from myconvnet_tpu_torch.nn import Conv, conv_epilogue
    n, h, w, c, co = shape
    conv = Conv(c, co, 3, bias=True)
    rng = np.random.RandomState(c + h)
    with torch.no_grad():
        conv.w.copy_(_bf16_grid(rng.randn(3, 3, c, co) / np.sqrt(9 * c)))
        conv.bias.copy_(torch.from_numpy(
            (0.3 * rng.randn(co)).astype(np.float32)))
    conv = conv.to(cuda)
    a, b = conv_epilogue(conv, None)
    x = _bf16_grid(rng.randn(n, h, w, c)).to(cuda, torch.bfloat16)
    wb = conv.w.to(torch.bfloat16)
    before = conv_fused.conv3x3_bn_relu.launches
    out = conv_fused.conv3x3_bn_relu(x, wb, a, b)
    torch.cuda.synchronize()
    assert conv_fused.conv3x3_bn_relu.launches == before + 1
    ref = conv_fused.conv3x3_bn_relu_reference(x, wb, a, b)
    torch.testing.assert_close(out.float(), ref.float(), **FUSED_TOL)
    with torch.no_grad():
        plain = torch.relu(conv(x.float()))
    torch.testing.assert_close(out.float(), plain, **PAIR_TOL)


def test_retinanet_head_on_card_matches_host(cuda):
    """tinyretina's weight-tied heads and RetinaNet's routing in eval under
    bf16 on the card: (cls, loc) within 0.05 of the host's plain path's
    largest."""
    from myconvnet_tpu_torch import models
    model = models.DETECTORS["tinyretina"](21, width=32)
    weights.from_jax(model, *random_jax_params(model, 5))
    x = torch.from_numpy(np.random.RandomState(6).randn(
        2, 128, 128, 3).astype(np.float32)).bfloat16()
    with torch.no_grad():
        host = model.eval().to(torch.bfloat16)(x)
        card = model.to(cuda)(x.to(cuda))
    for h_, c_ in zip(host, card):
        err = float((c_.float().cpu() - h_.float()).abs().max())
        assert err <= 0.05 * float(h_.float().abs().max()), err
