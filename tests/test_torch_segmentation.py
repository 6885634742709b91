"""The port's segmentation pieces against the JAX package, on the CPU.

Per-pixel cross-entropy with the ignore label and label smoothing (1e-6
relative), the poly schedule (one float32 ulp, 2^-23 relative), the nearest
crop of masks and the paired train and eval chains on handed-over boxes and
flips (masks equal, images at the crop-resize tolerance of
``tests/test_torch_data.py``, 1e-5), the synthetic VOC pairs (bit-equal),
the confusion counts (equal) and the scores made from them (1e-12, JAX's
formulas in float64), and the multi-scale and sliding-window protocols over
a small strided model (1e-5). Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.eval import evaluators as jev
from myconvnet_tpu.eval import seg_inference as jseg
from myconvnet_tpu.subsets import voc as jvoc
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu.train import optim as joptim
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.eval import evaluators as tev
from myconvnet_tpu_torch.eval import seg_inference as tseg
from myconvnet_tpu_torch.ops.conv import conv2d
from myconvnet_tpu_torch.subsets import voc as tvoc
from myconvnet_tpu_torch.train import losses as tlosses
from myconvnet_tpu_torch.train import optim as toptim

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


C = 21


def _labels(rng, shape, ignore_frac=0.2):
    y = rng.randint(0, C, shape).astype(np.int32)
    y[rng.rand(*shape) < ignore_frac] = 255
    return y


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("ignore", [255, None])
def test_pixel_cross_entropy_matches_jax(smoothing, ignore):
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 9, 7, C)).astype(np.float32)
    y = _labels(rng, (2, 9, 7)) if ignore is not None \
        else rng.randint(0, C, (2, 9, 7)).astype(np.int32)
    want = float(jlosses.pixel_cross_entropy(
        jnp.asarray(logits), jnp.asarray(y), ignore_label=ignore,
        label_smoothing=smoothing))
    got = float(tlosses.pixel_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(y), ignore_label=ignore,
        label_smoothing=smoothing))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pixel_cross_entropy_with_every_pixel_ignored_is_zero():
    logits = torch.randn(1, 4, 4, C)
    y = torch.full((1, 4, 4), 255, dtype=torch.int32)
    assert float(tlosses.pixel_cross_entropy(logits, y)) == 0.0
    assert float(jlosses.pixel_cross_entropy(
        jnp.asarray(logits.numpy()), jnp.asarray(y.numpy()))) == 0.0


@pytest.mark.parametrize("kind", ["poly", "polynomial"])
@pytest.mark.parametrize("end_lr,power", [(0.0, 0.9), (1e-4, 2.0)])
def test_poly_schedule_matches_jax(kind, end_lr, power):
    """At every step of a short horizon and past it, within one float32
    ulp (XLA's float32 power is not correctly rounded; numpy's is).
    Against the JAX schedule called eagerly: under ``jax.jit`` XLA
    multiplies by the reciprocal of ``total_steps`` instead of dividing,
    which moves t by an ulp, and (1 - t) near the end magnifies that."""
    cfg = dict(kind=kind, lr=0.007, total_steps=300, end_lr=end_lr,
               power=power)
    want = joptim.make_schedule(cfg)
    got = toptim.make_schedule(cfg)
    for step in list(range(0, 301)) + [350, 1000]:
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))),
                                   rtol=2 ** -23, atol=0, err_msg=str(step))


def _boxes(rng, n, hw, scale=(0.5, 2.0)):
    """Crop boxes over the frame, some past its edges."""
    h, w = hw
    side = rng.uniform(*scale, (n, 2)) * np.array([h, w])
    y0 = rng.uniform(-0.2 * h, 0.8 * h, n)
    x0 = rng.uniform(-0.2 * w, 0.8 * w, n)
    return np.stack([y0, x0, side[:, 0], side[:, 1]], 1).astype(np.float32)


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("flip", [False, True])
def test_batched_crop_nearest_equals_jax(clamp, flip):
    rng = np.random.RandomState(1)
    masks = _labels(rng, (6, 23, 31))
    boxes = _boxes(rng, 6, (23, 31))
    boxes[0] = [0, 0, 23, 31]               # the whole frame
    boxes[1] = [-3, 2, 23, 31]              # integer pad-crop offsets
    fl = rng.rand(6) < 0.5 if flip else None
    want = jaug.batched_crop_nearest(
        jnp.asarray(masks), jnp.asarray(boxes), (17, 40),
        None if fl is None else jnp.asarray(fl), clamp=clamp)
    got = taug.batched_crop_nearest(
        torch.from_numpy(masks), torch.from_numpy(boxes), (17, 40),
        None if fl is None else torch.from_numpy(fl), clamp=clamp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not clamp:
        assert (got.numpy() == 255).any()


def _aug_cfg(**kw):
    base = dict(out_hw=(33, 29), area_range=(0.5, 2.0),
                aspect_range=(0.9, 1.1), flip=True)
    base.update(kw)
    return jaug.AugmentConfig(**base), taug.AugmentConfig(**base)


@pytest.mark.parametrize("mode", ["resized", "pad_crop", "bf16_interp"])
def test_augment_train_pair_matches_jax_at_its_draws(mode, monkeypatch):
    """JAX's geometry draw replaced by handed-over boxes and flips; the
    port's application of the same: the image within 1e-5 (the
    crop-resize), the mask equal."""
    rng = np.random.RandomState(2)
    n, hw = 4, (40, 36)
    x = rng.randint(0, 256, (n, *hw, 3)).astype(np.uint8)
    masks = _labels(rng, (n, *hw))
    kw = {"resized": {}, "pad_crop": dict(area_range=None, pad=4),
          "bf16_interp": dict(interp_dtype="bfloat16")}[mode]
    jcfg, tcfg = _aug_cfg(**kw)
    clamp = mode != "pad_crop"
    boxes = _boxes(rng, n, hw) if clamp else np.concatenate(
        [rng.randint(-4, 5, (n, 2)), np.tile(hw, (n, 1))], 1).astype(
            np.float32)
    flip = np.array([True, False, True, False])
    monkeypatch.setattr(jaug, "_sample_geometry", lambda *a: (
        jnp.asarray(boxes), jnp.asarray(flip), clamp))
    wx, wy = jaug.augment_train_pair(jax.random.PRNGKey(0), jnp.asarray(x),
                                     jnp.asarray(masks), jcfg)
    gx, gy = taug.augment_train_pair(
        torch.from_numpy(x), torch.from_numpy(masks),
        torch.from_numpy(boxes), torch.from_numpy(flip), tcfg)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    if not clamp:
        assert (gy.numpy() == 255).any()


@pytest.mark.parametrize("hw", [(40, 36), (33, 29)])
def test_augment_eval_pair_matches_jax(hw):
    """The whole frame resized, at another size and at out_hw itself (the
    resize runs there too, as in JAX)."""
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (3, *hw, 3)).astype(np.uint8)
    masks = _labels(rng, (3, *hw))
    jcfg, tcfg = _aug_cfg()
    wx, wy = jaug.augment_eval_pair(jnp.asarray(x), jnp.asarray(masks), jcfg)
    gx, gy = taug.augment_eval_pair(torch.from_numpy(x),
                                    torch.from_numpy(masks), tcfg)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    alone, none = taug.augment_eval_pair(torch.from_numpy(x), None, tcfg)
    assert none is None and torch.equal(alone, gx)


@pytest.mark.parametrize("split", ["train", "val"])
def test_voc_synthetic_pairs_equal_jax(split):
    port = tvoc.make_source(None, split, synthetic=True, synthetic_n=5)
    ref = jvoc.make_source(None, split, synthetic=True, synthetic_n=5)
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.images.shape == (5, 96, 96, 3)
    assert port.labels.dtype == np.int32
    big = tvoc.synthetic_subset(2, (64, 48), 7)
    ref_big = jvoc.synthetic_subset(2, (64, 48), 7)
    for a, b in zip(big, ref_big):
        np.testing.assert_array_equal(a, b)
    assert (tvoc.NUM_CLASSES, tvoc.IGNORE_LABEL, tvoc.RAW_HW) == (
        jvoc.NUM_CLASSES, jvoc.IGNORE_LABEL, jvoc.RAW_HW)


def test_voc_corpus_reader_is_refused():
    """A directory without the VOCdevkit layout is refused by name."""
    with pytest.raises(FileNotFoundError, match="ImageSets/Segmentation"):
        tvoc.make_source("/nonexistent", "train")


@pytest.mark.parametrize("ignore", [255, None])
def test_confusion_matrix_and_scores_match_jax(ignore):
    """Counts equal (labels outside [0, C) count nowhere, as JAX's zero
    one-hot rows); mIoU and pixel accuracy against JAX's formulas run in
    float64, per-class IoU against the JAX evaluator's numpy, 1e-12; the
    evaluator's score against JAX's (float32 there) at 1e-6."""
    rng = np.random.RandomState(4)
    pred = rng.randint(0, C, (2, 13, 11)).astype(np.int32)
    y = _labels(rng, (2, 13, 11)) if ignore is not None \
        else rng.randint(0, C, (2, 13, 11)).astype(np.int32)
    y[0, 0, :3] = (-1, 21, 300)       # outside [0, C)
    pred[y == 3] = 3                  # one class predicted perfectly
    y[y == 7] = 8                     # one class absent from the truth
    want = np.asarray(jev.confusion_matrix(jnp.asarray(pred),
                                           jnp.asarray(y), C, ignore))
    got = tev.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(y),
                               C, ignore)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    with jax.enable_x64(True):
        cm64 = jnp.asarray(want, jnp.float64)
        miou = float(jev.miou_from_confusion(cm64))
        acc = float(jev.pixel_accuracy_from_confusion(cm64))
    np.testing.assert_allclose(tev.miou_from_confusion(got.numpy()), miou,
                               rtol=1e-12)
    np.testing.assert_allclose(
        tev.pixel_accuracy_from_confusion(got.numpy()), acc, rtol=1e-12)

    logits = rng.randn(2, 13, 11, C).astype(np.float32)
    jeval = jev.MeanIoUEvaluator(C, ignore)
    teval = tev.MeanIoUEvaluator(C, ignore)
    for ev, lg, yy in ((jeval, logits, y), (teval, torch.from_numpy(logits),
                                            torch.from_numpy(y))):
        ev.update(lg, yy)
        ev.update(pred if ev is jeval else torch.from_numpy(pred), yy)
    np.testing.assert_array_equal(teval._cm, jeval._cm.astype(np.int64))
    np.testing.assert_allclose(teval.per_class_iou(), jeval.per_class_iou(),
                               rtol=1e-12, equal_nan=True)
    assert np.isnan(teval.per_class_iou()[7])
    np.testing.assert_allclose(teval.score(), jeval.score(), rtol=1e-6)
    np.testing.assert_allclose(teval.pixel_accuracy(),
                               jeval.pixel_accuracy(), rtol=1e-6)
    teval.reset()
    assert teval.score() == 0.0 and teval._cm.sum() == 0


# a small strided model: 3x3 stride-2 conv to 5 classes (SAME: asymmetric
# padding on even sides), so its logits come back at half size and the
# protocols resize them
W_SMALL = np.random.RandomState(5).randn(3, 3, 3, 5).astype(np.float32)
B_SMALL = np.random.RandomState(6).randn(5).astype(np.float32)


def _jax_forward(x):
    y = jax.lax.conv_general_dilated(
        x, jnp.asarray(W_SMALL), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")
    return y + jnp.asarray(B_SMALL)


def _port_forward(x):
    return conv2d(x, torch.from_numpy(W_SMALL), torch.from_numpy(B_SMALL),
                  stride=2)


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("scales", [(0.75, 1.0, 1.25), (0.5, 1.5)])
def test_multiscale_logits_match_jax(scales, flip):
    x = np.random.RandomState(7).randn(2, 24, 30, 3).astype(np.float32)
    want = np.asarray(jseg.multiscale_logits(_jax_forward, jnp.asarray(x),
                                             scales=scales, flip=flip))
    got = tseg.multiscale_logits(_port_forward, torch.from_numpy(x),
                                 scales=scales, flip=flip).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("tile,overlap", [((16, 16), 1 / 3), ((20, 12), 0.5),
                                          ((40, 40), 1 / 3)])
def test_sliding_window_logits_match_jax(tile, overlap):
    x = np.random.RandomState(8).randn(2, 33, 29, 3).astype(np.float32)
    want = jseg.sliding_window_logits(_jax_forward, x, tile,
                                      overlap=overlap)
    got = tseg.sliding_window_logits(_port_forward, torch.from_numpy(x),
                                     tile, overlap=overlap).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    for size, t, s in ((33, 16, 10), (29, 29, 9), (10, 4, 3)):
        assert tseg._tile_starts(size, t, s) == jseg._tile_starts(size, t, s)


def test_predict_segmentation_follows_the_jax_protocol():
    """Raw uint8 frames / 255, normalized, multi-scale + flip: the class
    map of the JAX protocol's steps run by hand."""
    rng = np.random.RandomState(9)
    x = rng.randint(0, 256, (2, 24, 30, 3)).astype(np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    xn = jaug.normalize(jnp.asarray(x.astype(np.float32) / 255.0), mean, std)
    want = np.asarray(jnp.argmax(jseg.multiscale_logits(
        _jax_forward, xn, scales=(0.75, 1.0), flip=True), -1))
    got = tseg.predict_segmentation(_port_forward, torch.from_numpy(x),
                                    mean, std, scales=(0.75, 1.0),
                                    flip=True)
    np.testing.assert_array_equal(got.numpy(), want)
