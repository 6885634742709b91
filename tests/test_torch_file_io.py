"""Reading image files: the port's file sources, recipes and entry points
against the JAX package's, on the CPU.

Corpora are built by copying the committed fixtures of
``tests/fixtures/torch_io/`` (written by :func:`write_fixtures`; remake
them with ``python tests/test_torch_file_io.py``) into temporary
ImageNet, VOCdevkit and pix2pix layouts.  Held against JAX:

* ``FileSource`` in "cover" mode (the host library's JPEG batch path, and
  Pillow's for a batch with a PNG), "native_crop" (centred, and with
  ``rand_crop`` from a seed) and with VOC masks: uint8 images and int32
  masks bit for bit;
* ``read_subset`` of ``imagenet``, ``voc`` (its three roots) and ``pairs``
  (both layouts): the same paths, labels and class names, and the same
  batches over 3 shuffled epochs of ``DataSet.train_iter`` at one seed;
* the ResNet-50 recipe on a file corpus (width 8, 32x32 crops of 40x40):
  ``train.main`` and ``test.main`` end to end, and the train-mode loss and
  every gradient of the first file batch at float32 within 1e-4 (plus
  1e-4 of each leaf's largest), the bounds of ``test_torch_train.py``;
* ``generate --input``: the same raw inputs; ``--ema`` samples with the
  EMA;
* calibration: temperature and ECE within 1e-5, the same
  ``calibration.json`` keys;
* the image route: the decoded uint8 equal to JAX's pixels before its
  normalize, and normalized by B2's plain version within 1e-6 of JAX's
  ``(x - mean) / std``;
* ``Trainer.evaluate`` over a split with a short tail: JAX's score, every
  eval batch at the first batch's size.
"""

from __future__ import annotations

import importlib.util
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.data import pipeline as jpipe
from myconvnet_tpu.data.pipeline import DataSet as JDataSet
from myconvnet_tpu.eval import calibration as jcal
from myconvnet_tpu.eval import evaluators as jev
from myconvnet_tpu.subsets import imagenet as jimagenet
from myconvnet_tpu.subsets import pairs as jpairs
from myconvnet_tpu.subsets import voc as jvoc
from myconvnet_tpu.train import losses as jlosses
from myconvnet_tpu_torch import generate, models, recipes, recipes_gan
from myconvnet_tpu_torch import serving_http, weights
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.data import pipeline as tpipe
from myconvnet_tpu_torch.data.pipeline import ArraySource, DataSet
from myconvnet_tpu_torch.eval import calibration as tcal
from myconvnet_tpu_torch.eval import evaluators as tev
from myconvnet_tpu_torch.ops.kernels import normalize_u8 as b2
from myconvnet_tpu_torch.subsets import imagenet, pairs, voc
from myconvnet_tpu_torch.train import losses

from test_torch_convnet import _smallnets

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_io")
# name: (width, height, mode, save options)
IMAGENET = {"img_500x375.jpg": (500, 375, "RGB", {}),
            "img_375x500.jpg": (375, 500, "RGB", {}),
            "img_500x333.jpg": (500, 333, "RGB", {}),
            "img_640x480.jpg": (640, 480, "RGB", {}),
            "img_500x500.jpg": (500, 500, "RGB", {}),
            "img_281x500.jpg": (281, 500, "RGB", {}),
            "img_gray_500x375.jpg": (500, 375, "L", {}),
            "img_progressive_400x300.jpg": (400, 300, "RGB",
                                            {"progressive": True})}
VOC = {"2007_000032": (500, 281), "2007_000039": (500, 375),
       "2007_000063": (375, 500), "2007_000068": (500, 333)}
PAIRS = ("pair_0.jpg", "pair_1.jpg")
QUALITY = 85
VOC_CLASSES = 21


def voc_palette() -> list[int]:
    """The VOC colour map (class c's RGB from its bits), 256 entries."""
    pal = []
    for c in range(256):
        r = g = b = 0
        for k in range(8):
            r |= ((c >> 0) & 1) << (7 - k)
            g |= ((c >> 1) & 1) << (7 - k)
            b |= ((c >> 2) & 1) << (7 - k)
            c >>= 3
        pal += [r, g, b]
    return pal


def picture(rng, w: int, h: int) -> np.ndarray:
    """float32 [h, w, 3] in [0, 1]: two gradients, a sinusoid texture,
    five rectangles of flat colour, fine stripes in three of them and a
    light grain (so a file holds about as many bits a pixel as a photo)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    fy, fx = rng.uniform(0.02, 0.15, 2)
    img = np.stack([x / w, y / h, 0.5 + 0.25 * np.sin(fx * x + fy * y)], -1)
    for i in range(5):
        y0, x0 = rng.randint(0, h - h // 4), rng.randint(0, w - w // 4)
        hh, ww = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
        img[y0:y0 + hh, x0:x0 + ww] = rng.uniform(0, 1, 3)
        if i % 2 == 0:
            a = rng.uniform(0, np.pi)
            f = rng.uniform(0.5, 1.2)
            stripes = 0.15 * np.sin(f * (np.cos(a) * x + np.sin(a) * y))
            img[y0:y0 + hh, x0:x0 + ww] += \
                stripes[y0:y0 + hh, x0:x0 + ww, None]
    return img + rng.normal(0.0, 0.03, img.shape).astype(np.float32)


def to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_fixtures(root: str = FIXTURES, seed: int = 0) -> list[str]:
    """Write every fixture under ``root``; returns the paths written."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    written = []

    def save(img, rel, **kw):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        img.save(path, **kw)
        written.append(path)

    for name, (w, h, mode, opts) in IMAGENET.items():
        img = Image.fromarray(to_u8(picture(rng, w, h)))
        save(img.convert(mode), os.path.join("imagenet", name),
             quality=QUALITY, **opts)
    pal = voc_palette()
    for stem, (w, h) in VOC.items():
        img = picture(rng, w, h) * 0.3
        mask = np.zeros((h, w), np.uint8)
        for _ in range(3):
            c = rng.randint(1, VOC_CLASSES)
            y0, x0 = rng.randint(4, h // 2), rng.randint(4, w // 2)
            hh, ww = rng.randint(h // 6, h // 2), rng.randint(w // 6, w // 2)
            mask[y0 - 3:y0 + hh + 3, x0 - 3:x0 + ww + 3] = 255
            mask[y0:y0 + hh, x0:x0 + ww] = c
            img[y0:y0 + hh, x0:x0 + ww] = np.asarray(pal[3 * c:3 * c + 3],
                                                     np.float32) / 255.0
        save(Image.fromarray(to_u8(img)),
             os.path.join("voc", "JPEGImages", f"{stem}.jpg"),
             quality=QUALITY)
        m = Image.frombytes("P", (w, h), mask.tobytes())
        m.putpalette(pal)
        save(m, os.path.join("voc", "SegmentationClass", f"{stem}.png"))
    for name in PAIRS:
        target = picture(rng, 256, 256)
        edges = np.abs(np.diff(target.mean(-1), axis=0, prepend=0.0)) + \
            np.abs(np.diff(target.mean(-1), axis=1, prepend=0.0))
        source = np.repeat((edges > 0.12)[..., None], 3, -1) * 1.0
        both = np.concatenate([source, target], axis=1)
        save(Image.fromarray(to_u8(both)), os.path.join("pairs", name),
             quality=QUALITY)
    return written




# ------------------------------------------------------------- corpora


def _fixture(*parts):
    return os.path.join(FIXTURES, *parts)


def imagenet_corpus(root, per_class=(4, 2), classes=3, png=True):
    """``root/{train,val}/<class>/*.JPEG`` copied from the fixtures, the
    fixtures in turn; with ``png`` one train file of the last class a PNG
    (its batches go through Pillow)."""
    from PIL import Image
    names = sorted(IMAGENET)
    k = 0
    for split, n in zip(("train", "val"), per_class):
        for c in range(classes):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                shutil.copy(_fixture("imagenet", names[k % len(names)]),
                            os.path.join(d, f"img_{i:03d}.JPEG"))
                k += 1
    if png:
        d = os.path.join(root, "train", f"n{classes - 1:08d}")
        Image.open(_fixture("imagenet", names[0])).save(
            os.path.join(d, "img_zz.png"))
    return str(root)


VOC_ROOTS = {"VOC2012": "VOC2012", "VOCdevkit": "VOCdevkit/VOC2012",
             "flat": "."}


def voc_corpus(root, layout="VOCdevkit", splits=(("train", 6), ("val", 3))):
    """A VOC layout under ``root`` whose split lists name the fixture pairs
    in turn (an id may repeat)."""
    base = os.path.join(root, VOC_ROOTS[layout])
    for sub in ("JPEGImages", "SegmentationClass"):
        shutil.copytree(_fixture("voc", sub), os.path.join(base, sub),
                        dirs_exist_ok=True)
    lists = os.path.join(base, "ImageSets", "Segmentation")
    os.makedirs(lists, exist_ok=True)
    stems = sorted(VOC)
    for split, n in splits:
        with open(os.path.join(lists, f"{split}.txt"), "w") as f:
            f.write("\n".join(stems[i % len(stems)] for i in range(n)) + "\n")
    return str(root)


def pairs_corpus(root, layout="combined", n=(4, 2)):
    """pix2pix pairs: ``root/{split}/*.jpg`` combined, or name-matched
    ``root/{A,B}/{split}/`` halves (PNG)."""
    from PIL import Image
    for split, count in zip(("train", "val"), n):
        for i in range(count):
            src = _fixture("pairs", PAIRS[i % len(PAIRS)])
            if layout == "combined":
                d = os.path.join(root, split)
                os.makedirs(d, exist_ok=True)
                shutil.copy(src, os.path.join(d, f"{i:03d}.jpg"))
                continue
            arr = np.asarray(Image.open(src).convert("RGB"))
            for side, half in (("A", arr[:, :256]), ("B", arr[:, 256:])):
                d = os.path.join(root, side, split)
                os.makedirs(d, exist_ok=True)
                Image.fromarray(half).save(os.path.join(d, f"{i:03d}.png"))
    return str(root)


# ------------------------------------------------------------ fixtures


def _fixture_cases():
    cases = {f"imagenet/{n}": (w, h, m) for n, (w, h, m, _) in
             IMAGENET.items()}
    for stem, (w, h) in VOC.items():
        cases[f"voc/JPEGImages/{stem}.jpg"] = (w, h, "RGB")
        cases[f"voc/SegmentationClass/{stem}.png"] = (w, h, "P")
    cases.update({f"pairs/{n}": (512, 256, "RGB") for n in PAIRS})
    return cases


FIXTURE_CASES = _fixture_cases()


@pytest.mark.parametrize("rel", list(FIXTURE_CASES))
def test_fixture_is_the_listed_image(rel):
    from PIL import Image
    img = Image.open(_fixture(*rel.split("/")))
    w, h, mode = FIXTURE_CASES[rel]
    assert img.size == (w, h) and img.mode == mode
    assert bool(img.info.get("progressive")) == ("progressive" in rel)
    arr = np.asarray(img)
    if mode == "P":
        labels = set(np.unique(arr).tolist())
        assert 255 in labels and 0 in labels
        assert max(labels - {255}) < VOC_CLASSES
    else:
        assert arr.std() > 20
    assert sum(os.path.getsize(p) for p in _all_fixtures()) < 1 << 20


def _all_fixtures():
    return [os.path.join(d, f) for d, _, fs in os.walk(FIXTURES) for f in fs]


def test_write_fixtures_writes_every_listed_file(tmp_path):
    written = write_fixtures(str(tmp_path))
    assert sorted(os.path.relpath(p, tmp_path) for p in written) == \
        sorted(os.path.relpath(p, FIXTURES) for p in _all_fixtures())


# -------------------------------------------------------- file sources


def _equal_batches(port_src, jax_src, index_sets):
    for idx in index_sets:
        got, want = port_src.get_batch(idx), jax_src.get_batch(idx)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("case", ["cover_jpeg", "cover_with_png",
                                  "native_crop", "native_crop_rand"])
def test_file_source_matches_jax(tmp_path, case):
    root = imagenet_corpus(tmp_path)
    paths, labels, _ = jimagenet.read_subset(root, "train")
    idx_sets = [np.arange(4), np.array([11, 3, 12, 0]), np.array([12])]
    kw = {}
    if case.startswith("native_crop"):
        kw = dict(decode_mode="native_crop",
                  rand_crop=case.endswith("rand"), seed=9)
    raw_hw = (96, 128) if case.startswith("native") else (40, 48)
    if case == "cover_jpeg":
        idx_sets = [np.arange(4), np.array([11, 3, 7, 0])]
        assert not any(paths[i].endswith(".png") for s in idx_sets
                       for i in s)
    else:
        assert paths[12].endswith(".png")
    port = tpipe.FileSource(paths, labels, raw_hw, workers=3, **kw)
    want = jpipe.FileSource(paths, labels, raw_hw, workers=3, **kw)
    try:
        x, y = _equal_batches(port, want, idx_sets)
    finally:
        port.close()
    assert x.dtype == np.uint8 and y.dtype == np.int32
    assert x.shape[1:] == (*raw_hw, 3)


def test_file_source_masks_match_jax(tmp_path):
    """VOC pairs: images (Pillow's cover-resize) and int32 masks (libpng's
    raw palette indices, Pillow NEAREST) bit for bit; 255 stays."""
    imgs, masks = jvoc.read_subset(voc_corpus(tmp_path), "train")
    port = tpipe.FileSource(imgs, masks, (64, 80), workers=2, mask_hw=(64, 80))
    want = jpipe.FileSource(imgs, masks, (64, 80), workers=2, mask_hw=(64, 80))
    try:
        x, y = _equal_batches(port, want, [np.arange(4), np.array([5, 1])])
    finally:
        port.close()
    assert y.dtype == np.int32 and y.shape == (2, 64, 80)
    assert 255 in y and set(np.unique(y)) - {255} <= set(range(VOC_CLASSES))


def test_file_source_refuses_an_unknown_decode_mode():
    with pytest.raises(ValueError, match="decode_mode"):
        tpipe.FileSource(["a.jpg"], [0], (8, 8), decode_mode="warp")


@pytest.mark.parametrize("fn", ["decode_image", "decode_image_native",
                                "decode_image_warp"])
def test_decode_functions_match_jax(fn):
    path = _fixture("imagenet", "img_500x333.jpg")
    for raw_hw in ((64, 96), (400, 600)):
        np.testing.assert_array_equal(getattr(tpipe, fn)(path, raw_hw),
                                      getattr(jpipe, fn)(path, raw_hw))


def test_decode_without_pillow_names_the_file(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    path = _fixture("imagenet", "img_500x333.jpg")
    with pytest.raises(ImportError, match="img_500x333.jpg"):
        tpipe.decode_image(path, (8, 8))


def test_array_source_gathers_the_same_bytes():
    rng = np.random.RandomState(0)
    src = ArraySource(rng.randint(0, 256, (20, 5, 6, 3), np.uint8),
                      rng.randint(0, 9, 20).astype(np.int32))
    idx = np.array([3, 19, 0, 3])
    x, y = src.get_batch(idx)
    np.testing.assert_array_equal(x, src.images[idx])
    np.testing.assert_array_equal(y, src.labels[idx])
    jx, jy = jpipe.ArraySource(src.images, src.labels).get_batch(idx)
    np.testing.assert_array_equal(x, jx)


# ------------------------------------------------------------- subsets


def _epochs_equal(port_src, jax_src, batch, seed=5, epochs=3):
    got = [tuple(t.numpy() for t in b) for b in
           DataSet(port_src, seed=seed).train_iter(batch, "cpu",
                                                   epochs=epochs)]
    want = list(JDataSet(jax_src, seed=seed).train_iter(
        batch, epochs=epochs, prefetch=0))
    assert len(got) == len(want) == epochs * (len(jax_src) // batch)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_imagenet_subset_matches_jax(tmp_path):
    root = imagenet_corpus(tmp_path)
    for split in ("train", "val"):
        got, want = imagenet.read_subset(root, split), \
            jimagenet.read_subset(root, split)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == np.int32
    assert len(got[0]) == 6 and got[2] == [f"n{c:08d}" for c in range(3)]
    port = imagenet.make_source(root, "train", raw_hw=(24, 32), workers=2)
    _epochs_equal(port, jimagenet.make_source(root, "train", raw_hw=(24, 32)),
                  batch=4)
    with pytest.raises(FileNotFoundError, match="no 'test' directory"):
        imagenet.read_subset(root, "test")


@pytest.mark.parametrize("layout", list(VOC_ROOTS))
def test_voc_subset_matches_jax(tmp_path, layout):
    root = voc_corpus(tmp_path, layout)
    for split in ("train", "val"):
        assert voc.read_subset(root, split) == jvoc.read_subset(root, split)
    port = voc.make_source(root, "train", raw_hw=(40, 48), workers=2)
    _epochs_equal(port, jvoc.make_source(root, "train", raw_hw=(40, 48)),
                  batch=2)


@pytest.mark.parametrize("layout", ["combined", "two_dir"])
def test_pairs_subset_matches_jax(tmp_path, layout):
    root = pairs_corpus(tmp_path, layout)
    for split in ("train", "val"):
        assert pairs.read_subset(root, split) == \
            jpairs.read_subset(root, split)
    port = pairs.make_source(root, "train", raw_hw=(32, 32), workers=2)
    assert port.combined == (layout == "combined")
    _epochs_equal(port, jpairs.make_source(root, "train", raw_hw=(32, 32)),
                  batch=2)


def test_pairs_unpaired_reading_is_refused_by_name(tmp_path):
    root = pairs_corpus(tmp_path, "two_dir")
    with pytest.raises(ValueError, match="paired=False"):
        pairs.read_subset(root, "train", paired=False)


def test_make_sources_read_each_layout_like_jax(tmp_path):
    """The recipes' sources on a data_dir: the same files (ImageNet at the
    recipe's raw_hw, VOC at 512 x 512 with its masks, pix2pix pairs at
    the recipe's image_size)."""
    inet = imagenet_corpus(tmp_path / "inet")
    cfg = {"dataset": "imagenet", "data_dir": inet, "raw_hw": [40, 40]}
    for t, j in zip(recipes.make_sources(cfg, False),
                    jrecipes.make_sources(cfg, False)):
        assert isinstance(t, tpipe.FileSource)
        assert (t.paths, t.labels, t.raw_hw) == (j.paths, j.labels, j.raw_hw)
    cfg = {"dataset": "voc", "data_dir": voc_corpus(tmp_path / "voc")}
    for t, j in zip(recipes.make_sources(cfg, False),
                    jrecipes.make_sources(cfg, False)):
        assert (t.paths, t.labels, t.raw_hw, t.mask_hw) == \
            (j.paths, j.labels, j.raw_hw, j.mask_hw) and t.raw_hw == (512, 512)
    gan = recipes.apply_overrides(
        recipes.load_config(os.path.join(CONFIGS, "pix2pix.py")),
        ["image_size=32", f"data_dir={pairs_corpus(tmp_path / 'p')}"])
    for split in ("train", "val"):
        src = recipes_gan.gan_source(gan, False, split)
        want = jpairs.make_source(gan["data_dir"], split, raw_hw=(32, 32))
        assert src.items == want.items and src.raw_hw == (32, 32)
        for a, b in zip(src.get_batch([0, 1]), want.get_batch([0, 1])):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------- ResNet-50 on files

R50 = os.path.join(CONFIGS, "imagenet_resnet50.py")
R50_SETS = ["model_kwargs.width=8", "input_hw=[32,32]",
            "augment.out_hw=[32,32]", "raw_hw=[40,40]"]


def test_resnet50_recipe_trains_and_tests_from_files(tmp_path):
    """``train.main --data_dir`` on an ImageNet layout (2 steps of 8 as 2
    microbatches, a validation) and ``test.main`` on its checkpoint."""
    root = imagenet_corpus(tmp_path / "corpus", per_class=(4, 3))
    out = str(tmp_path / "run")
    common = ["--config", R50, "--device", "cpu", "--data_dir", root,
              *[a for kv in R50_SETS for a in ("--set", kv)]]
    net = train_entry.main(common + [
        "--steps", "2", "--batch", "8", "--val_every", "2", "--set",
        "accum_steps=2", "--set", "log_every=1", "--out", out])
    assert net.trainer.step == 2
    with open(os.path.join(out, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_losses = [r["loss"] for r in rows if "loss" in r]
    assert len(train_losses) == 2 and np.isfinite(train_losses).all()
    assert any("val_accuracy" in r for r in rows)
    score, restored = test_entry.main(common + ["--ckpt", out, "--batch",
                                                "4"])
    assert 0.0 <= score <= 1.0 and restored.trainer.step == 2


def _jax_resnet50():
    return transform(lambda x, train: jmodels.resnet50(
        x, 1000, train=train, width=8))


def test_resnet50_step_one_on_a_file_batch_matches_jax(tmp_path):
    """The first train batch of the file corpus (the DataSet's seed-0
    order), read by each package's source, through each package's eval
    input chain and ResNet-50 at width 8 in train mode at float32, with
    the recipe's label smoothing: the inputs within 1e-6, the loss within
    1e-4, every gradient and BN statistic within 1e-4 (plus 1e-4 of each
    leaf's largest)."""
    root = imagenet_corpus(tmp_path, per_class=(4, 1))
    cfg = recipes.apply_overrides(recipes.load_config(R50), R50_SETS)
    (tsrc,), (jsrc,) = (recipes.make_sources(cfg, False, ("train",)),
                        jrecipes.make_sources(cfg, False, ("train",)))
    idx = next(tpipe.batch_indices(len(tsrc), 8, shuffle=True, seed=0))
    np.testing.assert_array_equal(
        idx, next(jpipe.batch_indices(len(jsrc), 8, shuffle=True, seed=0)))
    (x, y), (jx, jy) = tsrc.get_batch(idx), jsrc.get_batch(idx)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    from myconvnet_tpu.data import augment as jaug
    aug = taug.AugmentConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in cfg["augment"].items()})
    jin = np.asarray(jaug.augment_eval(
        jnp.asarray(x), jaug.AugmentConfig(**aug._asdict())))
    tin = taug.augment_eval(torch.from_numpy(x), aug)
    np.testing.assert_allclose(tin.numpy(), jin, rtol=0, atol=1e-6)

    model = models.get_model("resnet50", 1000, width=8)
    params, state = weights.random_jax_params(model, 0)
    fn = _jax_resnet50()

    def loss_fn(p):
        with policy_scope(JFULL):
            logits, new_state = fn.apply(p, state, jax.random.PRNGKey(0),
                                         jnp.asarray(jin), True)
        return jlosses.softmax_cross_entropy(
            logits, jnp.asarray(y), label_smoothing=0.1), new_state

    (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    weights.from_jax(model, params, state).train()
    loss = losses.softmax_cross_entropy(model(torch.from_numpy(jin.copy())),
                                        torch.from_numpy(y),
                                        label_smoothing=0.1)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    grads = {}
    for path, p, view in weights.param_views(model):
        scope, name = path.rsplit("/", 1)
        grads.setdefault(scope, {})[name] = view(p.grad).numpy()
    for got, want, what in ((grads, jgrads, "grad"),
                            (weights.to_jax(model)[1], jstate, "bn state")):
        assert set(got) == set(want)
        for scope in want:
            for name, ref in want[scope].items():
                ref = np.asarray(ref)
                np.testing.assert_allclose(
                    got[scope][name], ref, rtol=1e-4,
                    atol=1e-4 * max(np.abs(ref).max(), 1e-30),
                    err_msg=f"{what} {scope}/{name}")


# -------------------------------------------------------------- generate

PIX2PIX = os.path.join(CONFIGS, "pix2pix.py")
PIX2PIX_SETS = ["image_size=32", "generator_kwargs.base_features=8",
                "generator_kwargs.n_levels=5",
                "discriminator_kwargs.base_features=8",
                "discriminator_kwargs.n_layers=2", "synthetic_n=8"]


def _input_dir(root):
    """Five images of three kinds and sizes, and a text file (skipped)."""
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    for i, name in enumerate(["b.jpg", "a.png", "c.jpeg", "e.jpg", "d.JPG"]):
        src = _fixture("imagenet", sorted(IMAGENET)[i])
        Image.open(src).save(os.path.join(root, name))
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("not an image")
    return str(root)


def _jax_generate_inputs(monkeypatch, directory, n, size):
    """The raw inputs JAX's ``generate.py --input`` translates: its main,
    with the GAN build, restore, sampler and PNG writer replaced by stubs
    that record what reaches them."""
    from typing import NamedTuple

    from myconvnet_tpu import recipes as jr
    from myconvnet_tpu.ckpt import checkpoint as jckpt
    from myconvnet_tpu.utils import images as jimages

    class State(NamedTuple):
        g_params: dict

    seen = {}

    def sampler(state, x):
        seen["x"] = np.asarray(x)
        return np.zeros(x.shape, np.uint8)

    monkeypatch.setattr(jr, "build_gan",
                        lambda cfg, synthetic: (State({}), None, None,
                                                "pix2pix"))
    monkeypatch.setattr(jckpt, "restore_checkpoint",
                        lambda path, target: target)
    monkeypatch.setattr(jr, "make_gan_sampler", lambda cfg: sampler)
    monkeypatch.setattr(jimages, "make_grid",
                        lambda a, **kw: seen.setdefault("grid", a))
    monkeypatch.setattr(jimages, "save_png", lambda path, grid: None)
    spec = importlib.util.spec_from_file_location(
        "jax_generate_entry", os.path.join(ROOT, "generate.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", [
        "generate.py", "--config", PIX2PIX, "--ckpt", "unused", "--input",
        directory, "--n", str(n), "--set", f"image_size={size}"])
    module.main()
    return seen["grid"][:, :, :size], seen["x"]


@pytest.mark.parametrize("n", [3, 10])
def test_generate_input_reads_the_images_jax_reads(tmp_path, monkeypatch, n):
    directory = _input_dir(tmp_path / "in")
    raw, x = _jax_generate_inputs(monkeypatch, directory, n, 24)
    got = generate.load_inputs(directory, n, 24)
    assert got.dtype == np.uint8 and got.shape == (min(n, 5), 24, 24, 3)
    np.testing.assert_array_equal(got, raw)
    np.testing.assert_array_equal(got.astype(np.float32) / 127.5 - 1.0, x)
    with pytest.raises(SystemExit, match="no images"):
        generate.load_inputs(str(tmp_path), 3, 24)


def test_generate_input_and_ema_end_to_end(tmp_path, monkeypatch):
    """pix2pix trained 2 steps with the generator's EMA; ``generate
    --input`` writes the directory's images beside their translations,
    and ``--ema`` translates the same inputs with the EMA in place of the
    parameters (other outputs)."""
    from myconvnet_tpu_torch.utils import images as timages
    out = str(tmp_path / "run")
    common = ["--config", PIX2PIX, "--device", "cpu",
              *[a for kv in PIX2PIX_SETS + ["g_optimizer.ema_decay=0.5"]
                for a in ("--set", kv)]]
    train_entry.main(common + ["--synthetic", "--steps", "2", "--batch",
                               "4", "--out", out])
    directory = _input_dir(tmp_path / "in")
    grids = []
    real = timages.make_grid
    monkeypatch.setattr(timages, "make_grid",
                        lambda a, **kw: grids.append(a) or real(a, **kw))
    args = common + ["--ckpt", out, "--input", directory, "--n", "4"]
    generate.main(args + ["--out", str(tmp_path / "a.png")])
    generate.main(args + ["--ema", "--out", str(tmp_path / "b.png")])
    assert os.path.exists(tmp_path / "a.png")
    raw = generate.load_inputs(directory, 4, 32)
    plain, ema = grids
    assert plain.shape == ema.shape == (4, 32, 64, 3)
    np.testing.assert_array_equal(plain[:, :, :32], raw)
    np.testing.assert_array_equal(ema[:, :, :32], raw)
    assert not np.array_equal(plain[:, :, 32:], ema[:, :, 32:])


# ----------------------------------------------------------- calibration


@pytest.mark.parametrize("scale", [0.3, 3.0, 20.0])
def test_calibration_matches_jax(scale):
    rng = np.random.RandomState(int(scale * 10))
    logits = (rng.randn(300, 10) * scale).astype(np.float32)
    labels = rng.randint(0, 10, 300)
    labels[:150] = logits[:150].argmax(-1)
    t, j = tcal.fit_temperature(logits, labels), \
        jcal.fit_temperature(logits, labels)
    assert abs(t - j) <= 1e-5 * max(1.0, abs(j))
    for temp in (1.0, j):
        assert abs(tcal.expected_calibration_error(
            logits, labels, temperature=temp)
            - jcal.expected_calibration_error(
                logits, labels, temperature=temp)) <= 1e-5
    np.testing.assert_allclose(
        float(tcal.nll(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.tensor(2.0))),
        float(jcal.nll(jnp.asarray(logits), jnp.asarray(labels), 2.0)),
        rtol=1e-6)


def test_test_calibrate_writes_calibration_json(tmp_path, capsys):
    out = str(tmp_path / "run")
    common = ["--config", os.path.join(CONFIGS, "cifar10_smallnet.py"),
              "--synthetic", "--device", "cpu", "--set",
              "model_kwargs.width=4", "--set", "synthetic_n=40"]
    train_entry.main(common + ["--steps", "2", "--batch", "16", "--out",
                               out])
    _, net = test_entry.main(common + ["--ckpt", out, "--batch", "16",
                                       "--calibrate"])
    with open(os.path.join(out, "calibration.json")) as f:
        record = json.load(f)
    assert set(record) == {"temperature", "ece_raw", "ece_calibrated"}
    assert "temperature:" in capsys.readouterr().out
    logits, labels = [], []
    (val,) = recipes.make_sources(net_cfg(common), True, ("val",))
    for x, y in DataSet(val).eval_iter(16, "cpu"):
        logits.append(net.predict(x, batch_size=16))
        labels.append(y.numpy())
    logits, labels = np.concatenate(logits), np.concatenate(labels)
    assert len(labels) == 40
    want = jcal.fit_temperature(logits, labels)
    assert abs(record["temperature"] - want) <= 1e-5 * max(1.0, want)
    assert abs(record["ece_raw"] - jcal.expected_calibration_error(
        logits, labels)) <= 1e-5
    assert abs(record["ece_calibrated"] - jcal.expected_calibration_error(
        logits, labels, temperature=want)) <= 1e-5


def net_cfg(argv):
    sets = [argv[i + 1] for i, a in enumerate(argv) if a == "--set"]
    return recipes.apply_overrides(recipes.load_config(argv[1]), sets)


# ------------------------------------------------------------ image route


@pytest.mark.parametrize("fmt,mode", [("PNG", "RGB"), ("JPEG", "RGB"),
                                      ("PNG", "L"), ("PNG", "RGBA")])
def test_image_route_decodes_and_normalizes_like_jax(fmt, mode):
    from PIL import Image

    from myconvnet_tpu import serving_http as jhttp
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    rng = np.random.RandomState(3)
    img = Image.fromarray(rng.randint(0, 256, (37, 51, 4), np.uint8),
                          "RGBA").convert(mode)
    buf = io.BytesIO()
    img.save(buf, fmt)
    route = serving_http.Route("cls", "classify", None, (2, 24, 20, 3),
                               mean=mean, std=std)
    jroute = jhttp.Route(name="cls", kind="classify", fn=None,
                         input_shape=(2, 24, 20, 3), mean=mean, std=std)
    got = serving_http.ModelServer([route])._decode_body(
        route, buf.getvalue(), f"image/{fmt.lower()}")
    want = jhttp.ModelServer([jroute])._decode_body(
        jroute, buf.getvalue(), f"image/{fmt.lower()}")
    assert got.dtype == np.uint8 and got.shape == (1, 24, 20, 3)
    np.testing.assert_array_equal(got, np.rint(want * 255.0))
    np.testing.assert_array_equal(got.astype(np.float32) / 255.0, want)
    normalized = b2.normalize_u8(torch.from_numpy(got), mean, std).numpy()
    np.testing.assert_allclose(normalized, (want - mean) / std, rtol=0,
                               atol=1e-6)


def test_image_route_serves_through_the_device_normalize(monkeypatch):
    """``predict`` of an image body hands the route's program the uint8
    image normalized by ``normalize_u8`` (on a CPU tensor its plain
    version), once a request; a JSON body keeps the host normalize."""
    from PIL import Image
    calls = []
    real = b2.normalize_u8

    def spy(x, mean, std, out_dtype=torch.float32):
        calls.append(tuple(x.shape))
        return real(x, mean, std, out_dtype)

    monkeypatch.setattr(serving_http, "normalize_u8", spy)
    seen = []
    mean = np.asarray((0.5, 0.4, 0.3), np.float32)
    std = np.asarray((0.2, 0.25, 0.3), np.float32)

    def fn(x):
        seen.append(x.clone())
        return torch.zeros((len(x), 7))

    route = serving_http.Route("cls", "classify", fn, (4, 16, 16, 3),
                               mean=mean, std=std, topk=3)
    server = serving_http.ModelServer([route])
    buf = io.BytesIO()
    Image.fromarray(np.full((16, 16, 3), 200, np.uint8)).save(buf, "PNG")
    out = server.predict("cls", buf.getvalue(), "image/png")
    assert calls == [(1, 16, 16, 3)] and len(out["predictions"]) == 1
    np.testing.assert_allclose(seen[0][0].numpy(),
                               np.broadcast_to((200 / 255 - mean) / std,
                                               (16, 16, 3)), atol=1e-6)
    assert not seen[0][1:].any()   # the fixed batch's zero padding
    body = json.dumps({"instances": np.full((2, 16, 16, 3), 0.5).tolist()})
    server.predict("cls", body.encode())
    assert len(calls) == 1
    np.testing.assert_allclose(seen[1][0].numpy(),
                               np.broadcast_to((0.5 - mean) / std,
                                               (16, 16, 3)), atol=1e-6)


# --------------------------------------------------------- padded tail


def test_evaluate_pads_the_tail_and_scores_like_jax(monkeypatch):
    """A 10-image split at batch 4 (a tail of 2): every eval batch runs at
    4 images, the tail's outputs are sliced back, and the accuracy equals
    JAX's ``ConvNet.evaluate`` (which pads the same way)."""
    jnet, tnet = _smallnets()
    rng = np.random.RandomState(5)
    x = rng.randint(0, 256, (10, 20, 20, 3), np.uint8)
    y = jnet.predict(x, batch_size=10).argmax(-1).astype(np.int32)
    y[::3] = (y[::3] + 1) % 4
    sizes = []
    trainer = tnet.trainer
    real = trainer.eval_batch

    def spy(xb, yb):
        sizes.append(len(xb))
        return real(xb, yb)

    monkeypatch.setattr(trainer, "eval_batch", spy)
    got = tnet.evaluate(DataSet(ArraySource(x, y)), tev.AccuracyEvaluator(),
                        batch_size=4)
    want = jnet.evaluate(JDataSet(jpipe.ArraySource(x, y)),
                         jev.AccuracyEvaluator(), batch_size=4)
    assert sizes == [4, 4, 4]
    assert got == pytest.approx(want, abs=0) and got == pytest.approx(0.6)


if __name__ == "__main__":
    for p in write_fixtures(sys.argv[1] if len(sys.argv) > 1 else FIXTURES):
        print(p, os.path.getsize(p))
