"""The port's RandAugment and AutoAugment against the JAX package, on the
CPU.

Every op of the pool, RandAugment in both backends over three pools,
AutoAugment and the training chain with RandAugment, on the same seeded
numpy images.  JAX's draws are made from its keys, with its key splits
(``augment.py:358``, ``randaugment.py:286-289``, ``:299-302``,
``:374-390``), and handed to the port's application.  JAX's Pallas
kernels (the affine shears, the elementwise layer) run in interpret mode,
as its own tests run them.

Tolerances: 1e-6 on [0, 1] floats for the elementwise ops and the folds
(sums in another order, or XLA fusing the Pallas shear's multiply-adds
into FMAs on the CPU where the port rounds each, measured 2.4e-7 for the
shears at these sizes); equalize and posterize bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.data import randaugment as jra
from myconvnet_tpu_torch import recipes
from myconvnet_tpu_torch.data import augment as taug
from myconvnet_tpu_torch.data import randaugment as tra
from myconvnet_tpu_torch.ops.kernels import launch_counts, \
    reset_launch_counts

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=1e-6)
EXACT = {"equalize", "posterize"}
# |m| in {0, 0.3, 1}, one image each
MAGS = np.array([0.0, 0.3, 1.0], np.float32)


def _img(n, h, w, seed):
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


def _jax(fn, *args, **kw):
    """A JAX call with float32 convs and dots in float32 (this CPU lowers
    them to bf16 passes by default; op_sharpness's conv passes no
    precision)."""
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*args, **kw))


def test_pools_and_tables_equal_jax():
    assert set(tra.POOL) == set(jra.POOL)
    assert tra.SIGNED == jra.SIGNED
    assert tra.CANONICAL_OPS == jra.CANONICAL_OPS
    assert tra.FAST_OPS == tra.DEFAULT_OPS == jra.DEFAULT_OPS
    assert tra.AUTOAUGMENT_IMAGENET == jra.AUTOAUGMENT_IMAGENET


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("name", sorted(jra.POOL))
def test_pool_op_matches_jax(name, sign):
    """Each op at |m| = 0, 0.3 and 1 on 20x24 images (H not a multiple of
    the Pallas shear's 32-row block)."""
    x = _img(3, 20, 24, seed=len(name))
    mag01 = (sign * MAGS)[:, None, None, None]
    want = _jax(jra.POOL[name], jnp.asarray(x), jnp.asarray(mag01))
    got = tra.POOL[name](torch.from_numpy(x), torch.from_numpy(mag01))
    assert got.dtype == torch.float32 and got.shape == x.shape
    if name in EXACT:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_equalize_keeps_flat_and_single_level_channels():
    """PIL's no-op cases: a single level, and a histogram whose last bin
    holds all but fewer than 255 pixels."""
    x = np.full((2, 12, 10, 3), 77 / 255, np.float32)
    x[1, :, :, 1] = np.linspace(0, 1, 120, dtype=np.float32).reshape(12, 10)
    x[1, 0, 0, 2] = 0.0
    want = _jax(jra.op_equalize, jnp.asarray(x), None)
    got = tra.op_equalize(torch.from_numpy(x), None).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], x[0])


# ------------------------------------------------------- JAX's draws


def jax_ra_draws(key, n, num_layers, num_ops):
    """The draws rand_augment makes from ``key`` (randaugment.py:286-289,
    :299-302: the same splits in both backends)."""
    ops, signs = [], []
    for _ in range(num_layers):
        k_op, k_sign, key = jax.random.split(key, 3)
        ops.append(np.asarray(jax.random.randint(k_op, (n,), 0, num_ops)))
        signs.append(np.where(np.asarray(
            jax.random.bernoulli(k_sign, 0.5, (n,))), 1.0, -1.0))
    return tra.RandAugmentDraws(torch.from_numpy(np.stack(ops)).long(),
                                torch.from_numpy(np.stack(signs)).float())


def jax_aa_draws(key, n, table):
    """The draws auto_augment makes from ``key`` (randaugment.py:374-390)."""
    k_sp, key = jax.random.split(key)
    sp = jax.random.randint(k_sp, (n,), 0, len(table))
    runs, signs = [], []
    for col in (0, 1):
        probs = jnp.asarray([row[col][1] for row in table], jnp.float32)
        k_apply, k_sign, key = jax.random.split(key, 3)
        runs.append(np.asarray(jax.random.bernoulli(k_apply, probs[sp])))
        signs.append(np.where(np.asarray(
            jax.random.bernoulli(k_sign, 0.5, (n,))), 1.0, -1.0))
    return tra.AutoAugmentDraws(torch.from_numpy(np.array(sp)).long(),
                                torch.from_numpy(np.stack(runs)),
                                torch.from_numpy(np.stack(signs)).float())


POOLS = {"fast": (jra.FAST_OPS, "xla"),
         "canonical": (jra.CANONICAL_OPS, "xla"),
         "pallas_pool_xla": (tra.PALLAS_POOL, "xla"),
         "pallas": (tra.PALLAS_POOL, "pallas")}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_rand_augment_matches_jax_at_jax_draws(pool):
    """Two layers at magnitude 9 on 3 images of 20x24 (the shape of the
    op tests, whose compiled JAX ops it reuses); both backends draw the
    same positions in ``ops``, the pallas one maps them into
    PALLAS_POOL."""
    ops, backend = POOLS[pool]
    n = 3
    x = _img(n, 20, 24, seed=3)
    key = jax.random.key(7)
    want = _jax(jra.rand_augment, key, jnp.asarray(x), num_layers=2,
                magnitude=9.0, ops=ops, backend=backend, interpret=True)
    draws = jax_ra_draws(key, n, 2, len(ops))
    reset_launch_counts()
    got = tra.rand_augment(torch.from_numpy(x), draws, magnitude=9.0,
                           ops=ops, backend=backend).numpy()
    assert not any(launch_counts().values())  # CPU: plain versions
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.array_equal(got, x)


@pytest.mark.parametrize("table", ["imagenet", "custom"])
def test_auto_augment_matches_jax_at_jax_draws(table):
    policy = ("imagenet" if table == "imagenet" else
              ((("invert", 1.0, None), ("shear_y", 0.5, 7)),
               (("rotate", 0.7, 4), ("equalize", 1.0, None))))
    n = 3
    x = _img(n, 20, 24, seed=4)
    key = jax.random.key(5)
    want = _jax(jra.auto_augment, key, jnp.asarray(x), policy=policy)
    draws = jax_aa_draws(key, n, tra.policy_table(policy))
    got = tra.auto_augment(torch.from_numpy(x), draws, policy=policy)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_augment_train_with_randaugment_matches_jax():
    """The ViT chain (random-resized crop 40x40 -> 20x24, flip, x / 255,
    RandAugment (2, 9), normalize) from one key: JAX's geometry and
    RandAugment draws (``augment.py:358-359``) handed to the port, within
    1e-5 as the chain without RandAugment (test_torch_train_vit.py)."""
    cfg = dict(out_hw=(20, 24), area_range=(0.08, 1.0), flip=True,
               randaugment=(2, 9))
    jcfg, tcfg = jaug.AugmentConfig(**cfg), taug.AugmentConfig(**cfg)
    x = np.random.RandomState(8).randint(0, 256, (3, 40, 40, 3), np.uint8)
    key = jax.random.PRNGKey(9)
    want = _jax(jaug.augment_train, key, jnp.asarray(x), jcfg)
    k_geom, _, k_ra = jax.random.split(key, 3)
    boxes, flip, _ = jaug._sample_geometry(k_geom, 3, (40, 40), jcfg)
    draws = jax_ra_draws(k_ra, 3, 2, len(jra.FAST_OPS))
    got = taug.augment_train(torch.from_numpy(x),
                             torch.from_numpy(np.array(boxes)),
                             torch.from_numpy(np.array(flip)), tcfg,
                             policy=draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ the port's draws


def test_samplers_draw_in_range_on_the_generator_device():
    g = torch.Generator().manual_seed(0)
    d = tra.sample_randaugment(g, 4096, num_layers=2, num_ops=12)
    assert d.op.shape == d.sign.shape == (2, 4096)
    assert d.op.min() == 0 and d.op.max() == 11
    assert set(d.sign.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(d.sign.mean())) < 0.05
    a = tra.sample_autoaugment(g, 8192, "imagenet")
    assert a.subpolicy.min() == 0 and a.subpolicy.max() == 24
    probs = torch.tensor([[row[c][1] for row in jra.AUTOAUGMENT_IMAGENET]
                          for c in (0, 1)])
    want = probs.gather(1, a.subpolicy.expand(2, -1)).mean(1)
    assert torch.allclose(a.run.float().mean(1), want, atol=0.02)
    assert not a.run[0][a.subpolicy == 12].any()  # probability 0.0


def test_named_pools_and_overrides_parse():
    """``randaugment_ops="canonical"`` and a list override both reach the
    sampler (recipes.make_augment turns lists into tuples)."""
    cfg = recipes.apply_overrides({"augment": {"randaugment": [2, 9]}}, [
        "augment.randaugment_ops=canonical"])
    aug = recipes.make_augment(cfg["augment"])
    g = torch.Generator().manual_seed(1)
    assert aug.randaugment == (2, 9)
    d = taug.sample_policy(g, 64, aug)
    assert int(d.op.max()) == len(jra.CANONICAL_OPS) - 1
    cfg = recipes.apply_overrides(cfg, [
        "augment.randaugment_ops=['invert','posterize']",
        "augment.randaugment_backend=pallas"])
    aug = recipes.make_augment(cfg["augment"])
    assert aug.randaugment_ops == ("invert", "posterize")
    d = taug.sample_policy(g, 64, aug)
    assert set(d.op.unique().tolist()) == {0, 1}
    with pytest.raises(ValueError, match="named pools"):
        taug.sample_policy(g, 2, aug._replace(randaugment_ops="Canonical"))
    with pytest.raises(ValueError, match="lane-crossing"):
        taug.sample_policy(g, 2, aug._replace(randaugment_ops="canonical"))
    with pytest.raises(ValueError, match="not both"):
        taug.sample_policy(g, 2, aug._replace(autoaugment="imagenet"))
    with pytest.raises(ValueError, match="registered"):
        taug.sample_policy(g, 2, aug._replace(randaugment=None,
                                              autoaugment="cifar10"))
    with pytest.raises(KeyError):
        tra.rand_augment(torch.zeros(1, 4, 4, 3),
                         tra.RandAugmentDraws(torch.zeros(1, 1).long(),
                                              torch.ones(1, 1)),
                         ops=("histogram_magic",))


def test_augment_train_needs_the_policy_draws():
    cfg = taug.AugmentConfig(out_hw=(8, 8), area_range=None,
                             autoaugment="imagenet")
    x = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    boxes = torch.tensor([[0.0, 0.0, 8.0, 8.0]] * 2)
    flip = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="draws"):
        taug.augment_train(x, boxes, flip, cfg)
    draws = taug.sample_policy(torch.Generator().manual_seed(0), 2, cfg)
    with pytest.raises(ValueError, match="RandAugment draws"):
        taug.augment_train(x, boxes, flip, cfg._replace(
            autoaugment=None, randaugment=(1, 9)), policy=draws)
    out = taug.augment_train(x, boxes, flip, cfg, policy=draws)
    assert out.shape == (2, 8, 8, 3) and torch.isfinite(out).all()
