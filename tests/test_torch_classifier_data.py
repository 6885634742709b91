"""The data side of the SmallNet, VGG and DenseNet recipes against the JAX
package, on the CPU: the CIFAR-10, SVHN and (Fashion-)MNIST subsets and
their readers, the recipes' split rule, the average pool and the bf16
crop-resize.

Tolerances: the synthetic arrays and the readers' arrays equal JAX's bit
for bit; ``avg_pool2d`` and its gradient within 1e-6 (float32 sums of at
most 9 terms in another order); the bf16 crop-resize within one bf16 rounding of its
intermediate (2^-7 relative of the largest value, as pixels up to 255
round to a bf16 step of 1), with the share of elements that differ
reported by the test and bounded at 1%.
"""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.ops import pool as jpool
from myconvnet_tpu.recipes import common as jcommon
from myconvnet_tpu.subsets import cifar10 as jcifar10
from myconvnet_tpu.subsets import mnist as jmnist
from myconvnet_tpu.subsets import svhn as jsvhn
from myconvnet_tpu_torch import nn, recipes
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.ops import pool
from myconvnet_tpu_torch.subsets import cifar10, mnist, svhn

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
SUBSETS = {"cifar10": (cifar10, jcifar10), "svhn": (svhn, jsvhn),
           "mnist": (mnist, jmnist)}


@pytest.mark.parametrize("name", list(SUBSETS))
@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_subsets_equal_jax(name, split):
    mine, theirs = SUBSETS[name]
    a = mine.make_source(None, split, synthetic=True, synthetic_n=300)
    b = theirs.make_source(None, split, synthetic=True, synthetic_n=300)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.images.dtype == np.uint8 and a.labels.dtype == np.int32
    assert a.images.shape[1:] == (*mine.IMAGE_HW, 3)
    assert len(np.unique(a.labels)) == mine.NUM_CLASSES
    assert (mine.MEAN, mine.STD) == (theirs.MEAN, theirs.STD)


def test_cifar10_reader_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "cifar-10-batches-py"
    root.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(root / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (4, 3072),
                                              dtype=np.uint8),
                         b"labels": list(rng.randint(0, 10, 4))}, f)
    for split in ("train", "test"):
        a = cifar10.read_subset(str(tmp_path), split)
        b = jcifar10.read_subset(str(tmp_path), split)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert a[0].shape == (4, 32, 32, 3)
    with pytest.raises(FileNotFoundError, match="synthetic"):
        cifar10.read_subset(str(tmp_path / "nowhere"))


def test_svhn_reader_equals_jax(tmp_path):
    from scipy.io import savemat
    rng = np.random.RandomState(1)
    for split in ("train", "test"):
        savemat(str(tmp_path / f"{split}_32x32.mat"),
                {"X": rng.randint(0, 256, (32, 32, 3, 5), dtype=np.uint8),
                 "y": np.array([[10], [1], [2], [10], [9]], np.uint8)})
    for split in ("train", "val"):
        a = svhn.read_subset(str(tmp_path), split)
        b = jsvhn.read_subset(str(tmp_path), split)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert list(a[1]) == [0, 1, 2, 0, 9]   # label 10 is the digit 0
    with pytest.raises(ValueError, match="extra"):
        svhn.read_subset(str(tmp_path), "extra")


@pytest.mark.parametrize("gz", [False, True])
def test_idx_reader_equals_jax(tmp_path, gz):
    rng = np.random.RandomState(2)
    for names, n in ((("train-images-idx3-ubyte",
                       "train-labels-idx1-ubyte"), 6),
                     (("t10k-images-idx3-ubyte",
                       "t10k-labels-idx1-ubyte"), 3)):
        for name, arr in ((names[0], rng.randint(0, 256, (n, 28, 28))),
                          (names[1], rng.randint(0, 10, n))):
            arr = arr.astype(np.uint8)
            blob = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
                ">" + "I" * arr.ndim, *arr.shape) + arr.tobytes()
            path = tmp_path / (name + (".gz" if gz else ""))
            with (gzip.open if gz else open)(path, "wb") as f:
                f.write(blob)
    for split in ("train", "test"):
        a = mnist.read_subset(str(tmp_path), split)
        b = jmnist.read_subset(str(tmp_path), split)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert a[0].shape == (3, 28, 28, 3)   # gray repeated into RGB


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100", "svhn", "mnist",
                                     "fashion_mnist", "imagenet"])
def test_make_sources_split_rule(dataset, monkeypatch):
    """"val" reads "test" for cifar*, *mnist and svhn, as JAX's
    make_sources (``common.py:143-146``); Fashion-MNIST sources carry the
    class names."""
    asked = {}

    def record(pkg):
        def make_source(data_dir, split, **kw):
            asked.setdefault(pkg, []).append(split)
            return type("Src", (), {})()
        return make_source

    held = ("cifar" in dataset or dataset.endswith("mnist")
            or dataset == "svhn")
    assert recipes.split_name(dataset, "val") == ("test" if held else "val")
    assert recipes.split_name(dataset, "train") == "train"
    cfg = {"dataset": dataset, "data_dir": "somewhere"}
    mod = {"fashion_mnist": "mnist"}.get(dataset, dataset)
    monkeypatch.setattr(getattr(recipes, mod), "make_source",
                        record("torch"))
    monkeypatch.setattr(getattr(jcommon, mod), "make_source", record("jax"))
    ours = recipes.make_sources(cfg, False)
    jcommon.make_sources(cfg, False)
    assert asked["torch"] == asked["jax"] == ["train",
                                              "test" if held else "val"]
    if dataset == "fashion_mnist":
        assert ours[0].class_names == jmnist.FASHION_CLASS_NAMES
        assert mnist.FASHION_CLASS_NAMES == jmnist.FASHION_CLASS_NAMES


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (3, 1), (2, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_avg_pool_matches_jax(padding, window, stride, dtype):
    """Odd and even sizes, windows 2 and 3: SAME divides by the valid
    count (TF's count_include_pad=False)."""
    x = np.random.RandomState(window + stride).randn(2, 7, 6, 5).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jpool.avg_pool2d(jnp.asarray(x, jdt), window, stride,
                                       padding), np.float32)
    got = nn.avg_pool(torch.from_numpy(x).to(dtype), window, stride,
                      padding)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    if padding == "SAME":
        inc = pool.avg_pool2d(torch.from_numpy(x), window, stride, padding,
                              count_include_pad=True).numpy()
        np.testing.assert_allclose(inc, np.asarray(jpool.avg_pool2d(
            jnp.asarray(x), window, stride, padding,
            count_include_pad=True)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (3, 1), (2, 1)])
def test_avg_pool_gradient_matches_jax(padding, window, stride):
    """The gradient of <avg_pool2d(x), g> for a seeded cotangent g, odd and
    even sizes, against ``jax.grad`` within 1e-6: each input gathers the
    cotangents of the windows that hold it, each over its window's count
    (the valid count under SAME); DenseNet's transitions take it through
    the VALID 2x2 pool."""
    rng = np.random.RandomState(10 * window + stride)
    x = rng.randn(2, 7, 6, 5).astype(np.float32)
    out_shape = jpool.avg_pool2d(jnp.asarray(x), window, stride,
                                 padding).shape
    g = rng.randn(*out_shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jpool.avg_pool2d(
        v, window, stride, padding) * g))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (nn.avg_pool(xt, window, stride, padding) * torch.from_numpy(g)
     ).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("area_range", [(0.08, 1.0), None])
def test_bf16_crop_resize_matches_jax(area_range):
    """The bf16 interpolation (uint8 pixels and bilinear weights rounded
    to bf16, each product summed in float32, the intermediate rounded to
    bf16) against JAX's with the same boxes and flips: within one bf16
    step of the intermediate, on at most 1% of the elements (where the two
    float32 sums round to different bf16 neighbours); the float32 path
    rounds elsewhere, so bf16 differs from it."""
    rng = np.random.RandomState(4)
    x = rng.randint(0, 256, (4, 40, 48, 3), dtype=np.uint8)
    boxes = np.array([[2.5, 3.25, 30.0, 33.5], [0.0, 0.0, 40.0, 48.0],
                      [10.0, 7.75, 17.3, 21.9], [-3.0, 4.0, 40.0, 48.0]],
                     np.float32)
    flip = np.array([True, False, True, False])
    clamp = area_range is not None
    want = np.asarray(jaug.batched_crop_resize(
        jnp.asarray(x), jnp.asarray(boxes), (32, 32), jnp.asarray(flip),
        clamp=clamp, interp_dtype=jnp.bfloat16))
    got = taug.batched_crop_resize(
        torch.from_numpy(x), torch.from_numpy(boxes), (32, 32),
        torch.from_numpy(flip), clamp=clamp,
        interp_dtype="bfloat16").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    diff = np.abs(got - want)
    share = float((diff > 0).mean())
    print(f"bf16 crop-resize: {share:.2%} of the elements differ from "
          f"JAX's, max |diff| {diff.max():.3g}")
    assert diff.max() <= 2 ** -7 * 256 and share <= 0.01
    f32 = taug.batched_crop_resize(
        torch.from_numpy(x), torch.from_numpy(boxes), (32, 32),
        torch.from_numpy(flip), clamp=clamp).numpy()
    assert np.abs(f32 - got).max() > 0


def test_fashion_recipe_reads_its_class_names():
    cfg = recipes.load_config(os.path.join(CONFIGS,
                                           "fashion_mnist_smallnet.py"))
    train, val = recipes.make_sources(cfg, True)
    assert train.class_names[9] == "ankle boot"
    assert train.images.shape[1:] == (28, 28, 3)
    np.testing.assert_array_equal(
        val.images, jmnist.synthetic_subset(512, 1)[0])
