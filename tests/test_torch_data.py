"""The port's data path against the JAX package, on the CPU.

CIFAR-100 arrays (synthetic and from a pickle in the corpus's format),
batch order, the prefetching iterators, the augmentation samplers'
bounds, and MixUp/CutMix applied with the draws JAX makes from a key
(``data/mix.py:93-116``).
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.data import mix as jmix
from myconvnet_tpu.data import pipeline as jpipeline
from myconvnet_tpu.subsets import cifar100 as jcifar100
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.data import mix as tmix
from myconvnet_tpu_torch.data import pipeline as tpipeline
from myconvnet_tpu_torch.subsets import cifar100 as tcifar100

torch.set_num_threads(1)


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_subset_equals_jax(split):
    port = tcifar100.make_source(None, split, synthetic=True, synthetic_n=96)
    ref = jcifar100.make_source(None, split, synthetic=True, synthetic_n=96)
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.images.dtype == np.uint8 and port.labels.dtype == np.int32


@pytest.mark.parametrize("coarse", [False, True])
def test_read_subset_reads_the_corpus_pickle_like_jax(tmp_path, coarse):
    """A two-image file in the cifar-100-python layout (rows of 3072
    bytes, channel-major) reads to the same NHWC arrays in both."""
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (2, 3072)).astype(np.uint8)
    root = tmp_path / "cifar-100-python"
    root.mkdir()
    with open(root / "test", "wb") as f:
        pickle.dump({b"data": data, b"fine_labels": [3, 97],
                     b"coarse_labels": [1, 19]}, f)
    port = tcifar100.read_subset(str(tmp_path), "val", coarse=coarse)
    ref = jcifar100.read_subset(str(tmp_path), "val", coarse=coarse)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    assert port[0].shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(port[0][1, 0, 0], data[1, [0, 1024, 2048]])
    with pytest.raises(FileNotFoundError):
        tcifar100.read_subset(str(tmp_path), "train")


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
def test_batch_indices_order_equals_jax(shuffle, drop):
    kw = dict(shuffle=shuffle, seed=3, drop_remainder=drop, epochs=2)
    port = list(tpipeline.batch_indices(50, 16, **kw))
    ref = list(jpipeline.batch_indices(50, 16, **kw))
    assert len(port) == len(ref) == (6 if drop else 8)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        next(tpipeline.batch_indices(8, 16, shuffle=True, seed=0))


def test_data_set_iterators_yield_the_jax_batches():
    images, labels = tcifar100.synthetic_subset(40, seed=2)
    port = tpipeline.DataSet(tpipeline.ArraySource(images, labels))
    ref = jpipeline.DataSet(jpipeline.ArraySource(images, labels))
    cpu = torch.device("cpu")
    it = port.train_iter(16, cpu, epochs=2)
    got = list(it)
    want = list(ref.train_iter(16, epochs=2, prefetch=0))
    assert len(got) == len(want) == 4
    for (x, y), (xr, yr) in zip(got, want):
        assert x.dtype == torch.uint8 and x.device == cpu
        np.testing.assert_array_equal(x.numpy(), xr)
        np.testing.assert_array_equal(y.numpy(), yr)
    it.close()
    got = list(port.eval_iter(16, cpu))
    assert [len(x) for x, _ in got] == [16, 16, 8]  # short tail, no drop
    np.testing.assert_array_equal(
        np.concatenate([y.numpy() for _, y in got]), labels)


def test_prefetcher_close_releases_an_endless_iterator():
    images, labels = tcifar100.synthetic_subset(32, seed=0)
    ds = tpipeline.DataSet(tpipeline.ArraySource(images, labels))
    it = ds.train_iter(8, torch.device("cpu"))  # epochs=None: endless
    next(it)
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetcher_surfaces_a_worker_error():
    def broken():
        yield np.zeros((2, 4, 4, 3), np.uint8), np.zeros(2, np.int32)
        raise RuntimeError("source failed")

    it = tpipeline.Prefetcher(broken(), torch.device("cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


# ------------------------------------------------------------ samplers


def _cfg(**kw):
    return taug.AugmentConfig(**dict(dict(out_hw=(32, 32), area_range=None,
                                          pad=4, flip=True), **kw))


def test_pad_crop_sampler_bounds():
    """As tests/test_augment.py:57-62 holds the JAX sampler: integer
    offsets in [-4, 4] that vary, the frame size, flips near half."""
    g = torch.Generator().manual_seed(0)
    boxes, flip = taug.sample_geometry(g, 4096, (32, 32), _cfg())
    b = boxes.numpy()
    assert (np.abs(b[:, :2]) <= 4.0).all() and b[:, 0].std() > 1.0
    np.testing.assert_array_equal(b[:, :2], np.round(b[:, :2]))
    assert set(np.unique(b[:, :2])) == set(range(-4, 5))
    assert (b[:, 2:] == 32.0).all()
    assert flip.dtype == torch.bool and abs(flip.float().mean() - 0.5) < 0.03
    _, no_flip = taug.sample_geometry(g, 64, (32, 32), _cfg(flip=False))
    assert not no_flip.any()


@pytest.mark.parametrize("kw", [dict(contrast=0.4),
                                dict(brightness=0.4)])
def test_unported_augment_modes_raise(kw):
    """Colour jitter is ported: the samplers take such a config and
    augment_train wants its factors.  What still raises is the bf16
    interpolation."""
    g = torch.Generator().manual_seed(0)
    cfg = _cfg(**kw)
    boxes, flip = taug.sample_geometry(g, 2, (32, 32), cfg)
    factors = taug.config_jitter(g, 2, cfg)
    x = torch.zeros(2, 32, 32, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="config_jitter"):
        taug.augment_train(x, boxes, flip, cfg)
    assert taug.augment_train(x, boxes, flip, cfg, jitter=factors).shape \
        == (2, 32, 32, 3)
    with pytest.raises(NotImplementedError, match="float32"):
        taug.augment_train(x, boxes, flip,
                           _cfg(interp_dtype="bfloat16", **kw),
                           jitter=factors)


def _jax_jitter_draws(key, n, brightness=0.0, contrast=0.0, saturation=0.0,
                      hue=0.0):
    """The factors ``jaug.color_jitter`` draws from ``key``
    (``data/augment.py:284-302``), as the port's JitterDraws."""
    k_b, k_c, k_s, k_h = jax.random.split(key, 4)

    def uniform(k, lo, hi, on):
        if not on:
            return None
        return torch.from_numpy(np.array(jax.random.uniform(
            k, (n, 1, 1, 1), minval=lo, maxval=hi))).reshape(n)

    hue_draw = None
    if hue > 0.0:   # JAX draws the hue with shape (n, 1, 1)
        hue_draw = torch.from_numpy(np.array(jax.random.uniform(
            k_h, (n, 1, 1), minval=-hue, maxval=hue))).reshape(n)
    return taug.JitterDraws(
        uniform(k_b, -brightness, brightness, brightness > 0.0),
        uniform(k_c, 1.0 - contrast, 1.0 + contrast, contrast > 0.0),
        uniform(k_s, 1.0 - saturation, 1.0 + saturation, saturation > 0.0),
        hue_draw)


JITTER = dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1)


@pytest.mark.parametrize("terms", [["brightness"], ["contrast"],
                                   ["saturation"], ["hue"], list(JITTER)])
def test_color_jitter_matches_jax_at_its_draws(terms):
    """Each of the four terms and all together, at the factors JAX draws
    from its key: within 1e-5."""
    kw = {k: JITTER[k] for k in terms}
    x = np.random.RandomState(0).rand(5, 8, 6, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jaug.color_jitter(key, jnp.asarray(x), **kw)
    draws = _jax_jitter_draws(key, 5, **kw)
    assert [f for f in draws._fields if getattr(draws, f) is not None] \
        == terms
    got = taug.color_jitter(torch.from_numpy(x), draws)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert not np.allclose(got.numpy(), x, atol=1e-3)


def test_jitter_sampler_ranges_and_identity():
    g = torch.Generator().manual_seed(0)
    d = taug.sample_jitter(g, 4096, **JITTER)
    for name, lo, hi in (("brightness", -0.4, 0.4), ("contrast", 0.6, 1.4),
                         ("saturation", 0.6, 1.4), ("hue", -0.1, 0.1)):
        t = getattr(d, name)
        assert t.shape == (4096,) and lo <= float(t.min()) < lo + 0.01
        assert hi - 0.01 < float(t.max()) <= hi
    assert taug.sample_jitter(g, 4) is None
    assert taug.config_jitter(g, 4, _cfg()) is None
    x = torch.rand(2, 4, 4, 3)
    assert taug.color_jitter(x, None) is x
    same = taug.color_jitter(x, taug.JitterDraws(
        torch.zeros(2), torch.ones(2), torch.ones(2), torch.zeros(2)))
    np.testing.assert_allclose(same.numpy(), x.numpy(), atol=1e-6)


def test_augment_train_with_jitter_matches_jax():
    """The ResNet-50 recipe's chain (random-resized crop, flip, colour
    jitter, normalize) with the draws JAX's augment_train makes from its
    key (``augment.py:358-366``): within 1e-5."""
    cfg = dict(out_hw=(32, 32), area_range=(0.08, 1.0), flip=True,
               brightness=0.4, contrast=0.4, saturation=0.4, hue=0.0)
    jcfg, tcfg = jaug.AugmentConfig(**cfg), taug.AugmentConfig(**cfg)
    x = np.random.RandomState(7).randint(0, 256, (6, 40, 40, 3),
                                         dtype=np.uint8)
    key = jax.random.PRNGKey(8)
    want = jaug.augment_train(key, jnp.asarray(x), jcfg)
    k_geom, k_color, _ = jax.random.split(key, 3)
    boxes, flip, _ = jaug._sample_geometry(k_geom, 6, (40, 40), jcfg)
    draws = _jax_jitter_draws(k_color, 6, brightness=0.4, contrast=0.4,
                              saturation=0.4)
    got = taug.augment_train(torch.from_numpy(x),
                             torch.from_numpy(np.array(boxes)),
                             torch.from_numpy(np.array(flip)), tcfg,
                             jitter=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [dict(randaugment=(2, 9.0)),
                                dict(autoaugment="imagenet")])
def test_policy_modes_sample_and_apply(kw):
    """RandAugment and AutoAugment on the CIFAR pad-crop chain: drawn by
    sample_policy, applied between the crop and the normalize (through
    the crop matmuls, where the pad_crop_u8 kernel would normalize)."""
    g = torch.Generator().manual_seed(0)
    cfg = _cfg(**kw)
    boxes, flip = taug.sample_geometry(g, 4, (32, 32), cfg)
    draws = taug.sample_policy(g, 4, cfg)
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    out = taug.augment_train(x, boxes, flip, cfg, policy=draws)
    plain = taug.augment_train(x, boxes, flip, _cfg())
    assert out.shape == (4, 32, 32, 3) and torch.isfinite(out).all()
    assert not torch.equal(out, plain)
    assert taug.sample_policy(g, 4, _cfg()) is None


def test_eval_resize_raises():
    """The eval crop-resize interpolates in float32 only."""
    x = torch.zeros(1, 40, 40, 3, dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="float32"):
        taug.augment_eval(x, _cfg(interp_dtype="bfloat16"))


def test_normalize_matches_jax():
    x = np.random.RandomState(0).rand(2, 4, 4, 3).astype(np.float32)
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    np.testing.assert_allclose(
        taug.normalize(torch.from_numpy(x), mean, std).numpy(),
        np.asarray(jaug.normalize(jnp.asarray(x), mean, std)),
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ MixUp / CutMix


def jax_mix_draws(key, n, cfg, device="cpu"):
    """The draws ``mixup_cutmix`` makes from ``key`` (mix.py:93-116 and
    _rect_mask_sized's centres), as the port's MixDraws."""
    k_perm, k_mlam, k_clam, k_rect, k_switch, k_apply = \
        jax.random.split(key, 6)
    ones = jnp.ones((n,))
    lam_mix = (jax.random.beta(k_mlam, cfg.mixup_alpha, cfg.mixup_alpha,
                               (n,)) if cfg.mixup_alpha > 0.0 else ones)
    lam_cut = (jax.random.beta(k_clam, cfg.cutmix_alpha, cfg.cutmix_alpha,
                               (n,)) if cfg.cutmix_alpha > 0.0 else ones)
    if cfg.mixup_alpha > 0.0 and cfg.cutmix_alpha > 0.0:
        use_cut = jax.random.bernoulli(k_switch, cfg.switch_prob, (n,))
    else:
        use_cut = jnp.full((n,), cfg.mixup_alpha <= 0.0)
    k_cy, k_cx = jax.random.split(k_rect)
    centre = jnp.stack([jax.random.uniform(k_cy, (n,)),
                        jax.random.uniform(k_cx, (n,))], axis=1)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return tmix.MixDraws(
        perm=t(jax.random.permutation(k_perm, n)).long(),
        lam_mix=t(lam_mix).float(), lam_cut=t(lam_cut).float(),
        use_cut=t(use_cut).bool(), centre=t(centre).float(),
        apply=t(jax.random.bernoulli(k_apply, cfg.prob, (n,))).bool())


MIX_CONFIGS = {
    # the CIFAR-100 recipe: MixUp only, half the samples mixed
    "recipe": dict(mixup_alpha=0.2, cutmix_alpha=0.0, prob=0.5),
    "cutmix": dict(mixup_alpha=0.0, cutmix_alpha=1.0, prob=1.0),
    "both": dict(mixup_alpha=0.2, cutmix_alpha=1.0, prob=0.8,
                 label_smoothing=0.1),
}


@pytest.mark.parametrize("name", sorted(MIX_CONFIGS))
@pytest.mark.parametrize("soft", [False, True])
def test_mixup_cutmix_matches_jax_at_jax_draws(name, soft):
    kw = MIX_CONFIGS[name]
    rng = np.random.RandomState(5)
    n, classes = 16, 10
    x = rng.randn(n, 8, 8, 3).astype(np.float32)
    labels = rng.randint(0, classes, n).astype(np.int32)
    if soft:
        labels = np.eye(classes, dtype=np.float32)[labels] * 0.9 + 0.01
    key = jax.random.key(11)
    want_x, want_y = jmix.mixup_cutmix(key, jnp.asarray(x),
                                       jnp.asarray(labels), classes,
                                       jmix.MixConfig(**kw))
    cfg = tmix.MixConfig(**kw)
    got_x, got_y = tmix.mixup_cutmix(torch.from_numpy(x),
                                     torch.from_numpy(labels), classes, cfg,
                                     jax_mix_draws(key, n, cfg))
    # float32 elementwise on both sides: 1e-6
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-6, atol=1e-6)


def test_sample_mix_draws_are_in_range():
    cfg = tmix.MixConfig(mixup_alpha=0.2, cutmix_alpha=1.0, prob=0.5)
    d = tmix.sample_mix(np.random.default_rng(0), 2048, cfg,
                        torch.device("cpu"))
    np.testing.assert_array_equal(np.sort(d.perm.numpy()), np.arange(2048))
    for lam in (d.lam_mix, d.lam_cut):
        assert (lam >= 0).all() and (lam <= 1).all()
    assert ((d.centre >= 0) & (d.centre < 1)).all()
    assert abs(d.apply.float().mean() - 0.5) < 0.05
    assert abs(d.use_cut.float().mean() - 0.5) < 0.05
    # MixUp-only and CutMix-only configs fix the switch
    only_mix = tmix.sample_mix(np.random.default_rng(1), 64,
                               tmix.MixConfig(cutmix_alpha=0.0),
                               torch.device("cpu"))
    assert not only_mix.use_cut.any() and (only_mix.lam_cut == 1).all()
