"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs CUDA and skips without it.  The file imports only
torch, numpy and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""

import numpy as np
import pytest
import torch

from myconvnet_tpu_torch import models, serving
from myconvnet_tpu_torch.core.precision import BF16
from myconvnet_tpu_torch.models.resnet import Bottleneck
from myconvnet_tpu_torch.ops import kernels
from myconvnet_tpu_torch.ops.kernels import bn_act, conv_pair
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


@pytest.mark.parametrize("shape", [
    (2, 7, 7, 64, 32, 32),       # one whole-image tile
    (1, 9, 6, 64, 32, 48),       # partial tiles, Cout not a multiple of 32
    (2, 14, 14, 128, 64, 64),
    (1, 30, 17, 64, 32, 16),     # partial tiles in both directions
    (1, 56, 56, 64, 64, 64),     # stage 1 geometry, 4 blocks per tile
    (1, 9, 6, 64, 64, 64),       # partial tiles split over a cluster
    (2, 14, 14, 64, 128, 128),   # 8 blocks per tile, 16 channels each
    (1, 3, 40, 64, 512, 32),     # two phase-1 passes per block
    (1, 7, 7, 128, 512, 512)])   # stage 4 Cm: > 48 KB of shared memory
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


def test_conv_pair_plans_fit_resnet50(cuda):
    """Every ResNet-50 pair shape at batch 1 and 8 gets a plan that fits
    the card's shared memory and gives at least one block per SM where the
    channel counts allow."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n in (1, 8):
        for hw, cin, cm in ((56, 64, 64), (56, 256, 64), (28, 512, 128),
                            (14, 1024, 256), (7, 2048, 512)):
            p = conv_pair.plan(n, hw, hw, cin, cm, cm)
            assert 0 < p["smem"] <= 232448 and p["cs"] in (1, 2, 4, 8)
            tiles = n * -(-hw // p["th"]) * -(-hw // p["tw"])
            assert tiles * p["cs"] >= sms or p["cs"] == 8 \
                or cm % (32 * p["cs"]) != 0


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
    assert kernels.launch_counts() == {"conv_pair": pairs,
                                       "bn_act": 7 + 2 * (13 - pairs)}
    host = build("cpu")(x).numpy()
    assert np.isfinite(card).all()
    assert np.abs(card - host).max() / np.abs(host).max() < 0.05
