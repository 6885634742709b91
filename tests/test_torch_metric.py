"""The port's metric-learning task against the JAX package, on the CPU.

The losses (ArcFace, CosFace, the pairwise distances, batch-hard triplet
in both forms), the PK sampler, the retrieval evaluator, ``tinyembed``'s
forward, one step of ``configs/faces_arcface_r50.py`` (ResNet-50 at width
8) and of ``configs/cifar10_triplet.py`` (SmallNet at width 8) through
``recipes.build_trainer``, the entry points, the ``embed`` artifact and
route against JAX's, and the refusals.  Inputs are seeded numpy; weights
are made in the JAX layout and loaded through ``weights.from_jax``; the
crop and flip draws of a JAX step come from its key.  Tolerances: the
losses within 1e-6 (relative) and their gradients within 1e-5 of the
largest; the sampler's indices and the retrieval scores exactly; float32
forwards within 1e-5 of their largest; a recipe step's loss within 1e-5,
its gradients and the parameters after the update within 1e-4 of each
leaf's largest, each ReLU's derivative taken where JAX's pre-activation
is positive (a disagreement must lie within 1e-5 of 0); bf16 embeddings
within 0.05 of their largest.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu import serving as jserving
from myconvnet_tpu import serving_http as jhttp
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.data.pipeline import pk_batch_indices as jpk
from myconvnet_tpu.eval.retrieval import RetrievalEvaluator as JRetrieval
from myconvnet_tpu.models import embedding as jemb
from myconvnet_tpu.models.base import ConvNet as JConvNet
from myconvnet_tpu.models.folding import fold_batch_norms as jfold
from myconvnet_tpu.train import metric_losses as jml
from myconvnet_tpu_torch import (models, recipes, serving, serving_http,
                                 weights)
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.core.precision import BF16
from myconvnet_tpu_torch.data.pipeline import (ArraySource, DataSet,
                                               pk_batch_indices)
from myconvnet_tpu_torch.eval.retrieval import RetrievalEvaluator
from myconvnet_tpu_torch.train import metric_losses as tml
from myconvnet_tpu_torch.train.trainer import StepDraws
from test_torch_seg_family import (KINK, masks_by_site, spy_draws,
                                   spy_relus, traced_step)
from test_torch_zoo import assert_trees_close, grad_tree

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCFACE = os.path.join(ROOT, "configs", "faces_arcface_r50.py")
TRIPLET = os.path.join(ROOT, "configs", "cifar10_triplet.py")
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return {s: {n: np.asarray(v) for n, v in d.items()}
            for s, d in tree.items()}


# ----------------------------------------------------------------- losses


def _check_loss(port_fn, jax_fn, x, *args):
    """Value within 1e-6 (relative) and gradient within 1e-5 of its
    largest, of ``fn(x, *args)`` in both packages."""
    xt = torch.tensor(x, requires_grad=True)
    got = port_fn(xt, *(_t(a) for a in args))
    got.backward()
    want, jgrad = jax.value_and_grad(
        lambda v: jax_fn(v, *(jnp.asarray(a) for a in args)))(
            jnp.asarray(x))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-5 * max(np.abs(jgrad).max(), 1e-30))
    return xt.grad.numpy()


def _cosines(seed=0):
    """Cosines [6, 5] with a target column at exactly 1 and at exactly -1,
    one at the easy-margin boundary cos(pi - 0.5), and one at 0."""
    rng = np.random.RandomState(seed)
    cos = rng.uniform(-1, 1, (6, 5)).astype(np.float32)
    labels = np.array([1, 2, 0, 3, 4, 1], np.int64)
    cos[0, 1], cos[1, 2] = 1.0, -1.0
    cos[2, 0] = np.float32(math.cos(math.pi - 0.5))
    cos[3, 3] = 0.0
    return cos, labels


@pytest.mark.parametrize("name,kw", [
    ("arcface", dict(s=64.0, m=0.5)), ("arcface", dict(s=30.0, m=0.3)),
    ("cosface", dict(s=30.0, m=0.35))])
def test_margin_losses_match_jax(name, kw):
    cos, labels = _cosines()
    port = getattr(tml, f"{name}_loss")
    ref = getattr(jml, f"{name}_loss")
    grad = _check_loss(lambda c, y: port(c, y, **kw),
                       lambda c, y: ref(c, y, **kw), cos, labels)
    assert np.isfinite(grad).all()


@pytest.mark.parametrize("squared", [False, True])
def test_pairwise_distances_match_jax(squared):
    rng = np.random.RandomState(1)
    emb = rng.randn(7, 5).astype(np.float32)
    # the diagonal's gradient (1 / 2e-6 under the square root, through the
    # maximum's tie at 0) cancels to 0 in exact arithmetic and to rounding
    # of 5e5 in float32: weighted 0, as the triplet loss's masks do
    w = rng.rand(7, 7).astype(np.float32) * (1 - np.eye(7, dtype=np.float32))
    _check_loss(
        lambda e, w_: (tml.pairwise_distances(e, squared=squared)
                       * w_).sum(),
        lambda e, w_: (jml.pairwise_distances(e, squared=squared)
                       * w_).sum(), emb, w)


def _tied_embeddings():
    """Unit embeddings where anchor 0's two positives (rows 1, 2) sit at
    exactly the same distance, as do its two nearest negatives (rows 3,
    4); class 3 has a single example (no positive: left out)."""
    c, s = np.float32(0.8), np.float32(0.6)
    c2, s2 = np.float32(0.6), np.float32(0.8)
    e = np.zeros((8, 4), np.float32)
    e[0] = [1, 0, 0, 0]
    e[1] = [c, s, 0, 0]
    e[2] = [c, -s, 0, 0]
    e[3] = [c2, 0, s2, 0]
    e[4] = [c2, 0, -s2, 0]
    rng = np.random.RandomState(2)
    e[5:] = rng.randn(3, 4)
    labels = np.array([0, 0, 0, 1, 1, 2, 2, 3], np.int64)
    return e, labels


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("margin", [0.3, 1.0])
def test_batch_hard_triplet_matches_jax_with_ties(soft, margin):
    """Ties of the hardest positive and the hardest negative split their
    gradient evenly in both packages (``amax``/``amin``)."""
    e, labels = _tied_embeddings()
    grad = _check_loss(
        lambda x, y: tml.batch_hard_triplet_loss(x, y, margin=margin,
                                                 soft=soft),
        lambda x, y: jml.batch_hard_triplet_loss(x, y, margin=margin,
                                                 soft=soft), e, labels)
    if not soft and margin == 1.0:
        # the tied positives take the anchor's pull in equal halves
        assert grad[1, 1] == -grad[2, 1] != 0


def test_triplet_loss_without_valid_anchors_is_zero():
    e = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    for labels in ([0, 1, 2, 3], [5, 5, 5, 5]):
        got = tml.batch_hard_triplet_loss(torch.from_numpy(e),
                                          torch.tensor(labels))
        want = jml.batch_hard_triplet_loss(jnp.asarray(e),
                                           jnp.asarray(labels))
        assert float(got) == float(want) == 0.0


# -------------------------------------------------------- sampler, scores


def test_pk_batch_indices_equal_jax():
    """Equal index batches over three epochs, a class with fewer than K
    examples drawn with replacement."""
    labels = np.repeat(np.arange(9), [6, 6, 2, 7, 5, 9, 3, 4, 8])
    np.random.RandomState(4).shuffle(labels)
    got = list(pk_batch_indices(labels, 4, 3, seed=7, epochs=3))
    want = list(jpk(labels, 4, 3, seed=7, epochs=3))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pk_dataset_batches_and_checks():
    images = np.arange(40 * 2 * 2 * 3, dtype=np.uint8).reshape(40, 2, 2, 3)
    labels = np.arange(40) % 5
    ds = DataSet(ArraySource(images, labels), seed=3, pk=(2, 4))
    it = ds.train_iter(8, CPU, epochs=1)
    batches = list(it)
    assert len(batches) == 2
    for (x, y), idx in zip(batches, jpk(labels, 2, 4, seed=3, epochs=1)):
        np.testing.assert_array_equal(x.numpy(), images[idx])
        assert len(set(y.tolist())) == 2
    with pytest.raises(ValueError, match="batch_size=6"):
        ds.train_iter(6, CPU)


def _retrieval_inputs(seed=5):
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(7), [5, 4, 1, 6, 3, 2, 5])
    emb = rng.randn(len(labels), 8).astype(np.float32)
    emb[labels == 3] += 2.0 * rng.randn(8).astype(np.float32)
    order = rng.permutation(len(labels))
    return emb[order], labels[order]


@pytest.mark.parametrize("k", [1, 3])
def test_retrieval_evaluator_equals_jax(k):
    """Recall@K, mAP@R and the report over two batches, a class with one
    example among them (a query that cannot be matched)."""
    emb, labels = _retrieval_inputs()
    ours, theirs = RetrievalEvaluator(k), JRetrieval(k)
    for part in (slice(0, 13), slice(13, None)):
        ours.update(torch.from_numpy(emb[part]),
                    torch.from_numpy(labels[part]))
        theirs.update(emb[part], labels[part])
    assert ours.name == theirs.name == f"recall@{k}"
    assert ours.score() == theirs.score()
    for kk in (1, 2, 4, 30):
        assert ours.recall_at(kk) == theirs.recall_at(kk)
    assert ours.mean_average_precision() == theirs.mean_average_precision()
    assert ours.mean_average_precision(2) == theirs.mean_average_precision(2)
    assert ours.report() == theirs.report()
    with pytest.raises(ValueError, match=r"\[N, D\] embeddings"):
        ours.update(torch.zeros(2, 3, 4), torch.zeros(2))


def test_retrieval_evaluator_one_example_gallery():
    ours, theirs = RetrievalEvaluator(), JRetrieval()
    ours.update(np.ones((1, 4), np.float32), np.array([0]))
    theirs.update(np.ones((1, 4), np.float32), np.array([0]))
    assert ours.score() == theirs.score() == 0.0
    assert ours.report() == theirs.report()


# ----------------------------------------------------------------- model


@pytest.mark.parametrize("head", ["arcface", "triplet"])
@pytest.mark.parametrize("train", [True, False])
def test_tinyembed_forward_matches_jax(head, train, monkeypatch):
    """``tinyembed`` (SmallNet at width 8, 32-d) in train mode (JAX's
    dropout masks handed over by site) and eval mode: cosines or unit
    embeddings within 1e-5 of the largest; the scopes are JAX's."""
    classes = 8
    model = models.tinyembed(classes, head=head)
    jfn = transform(lambda x, train: jemb.tinyembed(x, classes, train=train,
                                                    head=head))
    jp, js = jax.eval_shape(lambda: jfn.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), True))
    params, state = weights.random_jax_params(model, 6)
    assert set(params) == set(jp) and set(state) == set(js)
    assert ("margin_head" in params) == (head != "triplet")
    x = np.random.RandomState(7).randn(4, 32, 32, 3).astype(np.float32)
    drawn = spy_draws(monkeypatch)
    with policy_scope(JFULL):
        want, _ = jfn.apply(params, state, jax.random.PRNGKey(3),
                            jnp.asarray(x), train)
    want = np.asarray(want)
    weights.from_jax(model, params, state).train(train)
    masks = masks_by_site(model, 4, drawn) if train else None
    with torch.no_grad():
        got = model(torch.from_numpy(x), masks).numpy()
    assert got.shape == want.shape == (
        (4, classes) if train and head == "arcface" else (4, 32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if not (train and head == "arcface"):
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-6)


# --------------------------------------------------------- recipe steps


def _recipe(config, **over):
    cfg = recipes.load_config(config)
    cfg.update(over)
    return cfg


STEPS = {
    "arcface": (ARCFACE, dict(
        model_kwargs=dict(backbone="resnet50", embed_dim=16, head="arcface",
                          backbone_kwargs=dict(width=8)),
        num_classes=1000, input_hw=(64, 64), raw_hw=(72, 72),
        augment=dict(out_hw=(64, 64), area_range=None, flip=True,
                     mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)),
        batch_size=8, accum_steps=1, synthetic_n=8, precision="f32"), 8),
    "triplet": (TRIPLET, dict(
        model_kwargs=dict(backbone="smallnet", embed_dim=16, head="triplet",
                          backbone_kwargs=dict(width=8, dropout_rate=0.0)),
        pk=(4, 2), batch_size=8, synthetic_n=64), 8),
}


def _jax_loss(cfg):
    head = cfg["model_kwargs"]["head"]
    if head == "triplet":
        return lambda e, y: jml.batch_hard_triplet_loss(
            e, y, margin=cfg["triplet_margin"])
    return lambda c, y: jml.arcface_loss(c, y, s=cfg["margin_s"],
                                         m=cfg["margin_m"])


@pytest.mark.parametrize("case", list(STEPS))
def test_recipe_step_matches_jax(case, monkeypatch):
    """One step of the recipe at float32 through ``build_trainer`` with
    the crop and flip of JAX's key: the loss, every gradient and the
    parameters after the recipe's optimizer (momentum for ArcFace, Adam
    with decoupled decay for triplet), and the BN moving statistics."""
    config, over, n = STEPS[case]
    cfg = _recipe(config, **over)
    trainer, train_set, _ = recipes.build_trainer(cfg, True, device=CPU)
    params, state = weights.random_jax_params(trainer.model, 11)
    x, y = train_set.source.get_batch(np.arange(n))
    if case == "triplet":
        y = np.repeat(np.arange(4), 2)   # a PK batch: 4 classes x 2
        x = train_set.source.images[[int(np.flatnonzero(
            train_set.source.labels == c)[i]) for c in range(4)
            for i in range(2)]]
    jcfg = jrecipes.make_augment(cfg["augment"])
    key = jax.random.PRNGKey(12)
    k_aug, k_model = jax.random.split(key)
    boxes, flip, _ = jaug._sample_geometry(jax.random.split(k_aug, 3)[0], n,
                                           x.shape[1:3], jcfg)
    xa = jaug.augment_train(k_aug, jnp.asarray(x), jcfg)
    jfn = transform(lambda v, train: jemb.embedding_net(
        v, cfg["num_classes"], train=train, **cfg["model_kwargs"]))
    jloss_fn = _jax_loss(cfg)
    relus = spy_relus(monkeypatch)

    def jax_loss(p):
        relus.clear()
        with policy_scope(JFULL):
            out, new_state = jfn.apply(p, state, k_model, xa, True)
        return jloss_fn(out, jnp.asarray(y)), (new_state, list(relus))

    (jloss, (jstate, jzs)), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(params)
    jopt = jrecipes.make_optimizer(cfg["optimizer"])
    jparams, _ = jopt.update(jgrads, jopt.init(params), params,
                             jnp.asarray(0, jnp.int32))
    draws = StepDraws(_t(boxes), _t(flip), None,
                      [{}] if case == "triplet" else None)

    def port_step():
        t, _, _ = recipes.build_trainer(cfg, True, device=CPU)
        weights.from_jax(t.model, params, state)
        loss, _, _ = t.loss_and_grads(torch.from_numpy(x),
                                      torch.from_numpy(y), draws)
        grads = grad_tree(t.model)
        t.optimizer.step(0)
        return t, loss, grads

    _, zs = traced_step(port_step, None, monkeypatch)
    assert [tuple(z.shape) for z in zs] == [tuple(z.shape) for z in jzs]
    keeps = []
    for z, jz in zip(zs, jzs):
        jz = torch.from_numpy(np.array(jz))
        differ = (z > 0) != (jz > 0)
        if differ.any():
            assert z[differ].abs().max() <= KINK * z.abs().max()
        keeps.append(jz > 0)
    (t, loss, grads), _ = traced_step(port_step, keeps, monkeypatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_trees_close(grads, _np_tree(jgrads), 1e-4, "grad",
                       zero_leaves=True)
    got_p, got_s = weights.to_jax(t.model)
    assert_trees_close(got_p, _np_tree(jparams), 1e-4, "params")
    assert_trees_close(got_s, _np_tree(jstate), 1e-4, "bn state")


# ---------------------------------------------------------- entry points


def _tiny_arcface(tmp_path):
    cfg = _recipe(ARCFACE, **STEPS["arcface"][1])
    cfg.update(precision="bf16", synthetic_n=16, total_steps=2,
               log_every=1, input_hw=(32, 32), raw_hw=(40, 40),
               augment=dict(cfg["augment"], out_hw=(32, 32)))
    path = tmp_path / "arcface.json"
    path.write_text(json.dumps(cfg))
    return str(path), cfg


def test_arcface_entry_points_and_embed_artifact(tmp_path, capsys):
    """train.main, test.main (retrieval recall and the report),
    ``test --export`` (an embed artifact of unit-norm rows), and ``serve
    --artifact --images`` over it."""
    config, cfg = _tiny_arcface(tmp_path)
    out = str(tmp_path / "run")
    common = ["--config", config, "--synthetic", "--device", "cpu"]
    net = train_entry.main(common + ["--out", out])
    assert net.trainer.step == 2
    score, restored = test_entry.main(common + ["--ckpt", out, "--report"])
    text = capsys.readouterr().out
    assert "recall@1:" in text and "mAP@R:" in text and 0 <= score <= 1
    art = str(tmp_path / "emb.pt2")
    assert test_entry.main(common + ["--ckpt", out, "--export", art]) == art
    meta = serving.artifact_meta(art)
    assert meta["kind"] == "embed" and meta["input_shape"] == [8, 32, 32, 3]
    fn = serving.load_inference(art, "cpu")
    rows = np.random.RandomState(0).randn(8, 32, 32, 3).astype(np.float32)
    emb = fn(rows).numpy()
    assert emb.shape == (8, 16)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-2)
    mem = serving.make_inference_fn(restored.model, None, None, device="cpu",
                                    policy=BF16)
    assert torch.equal(fn(rows), mem.program(torch.from_numpy(rows)))
    images = tmp_path / "images"
    images.mkdir()
    from PIL import Image
    for i in range(3):
        Image.fromarray(np.random.RandomState(i).randint(
            0, 255, (40, 40, 3), np.uint8)).save(images / f"{i}.png")
    from myconvnet_tpu_torch import serve
    rows = serve.main(["--artifact", art, "--images", str(images),
                       "--config", config, "--device", "cpu"])
    assert [r[0] for r in rows] == ["0.png", "1.png", "2.png"]
    for _, e in rows:
        assert e.shape == (16,) and abs(np.linalg.norm(e) - 1) < 1e-5


EMB_HW, EMB_BATCH = 32, 2
EMB_KW = dict(backbone="resnet50", embed_dim=16, head="arcface",
              backbone_kwargs=dict(width=16))
EMB_CFG = dict(task="metric", model="embedding_net", model_kwargs=EMB_KW,
               num_classes=10, input_hw=(EMB_HW, EMB_HW),
               augment=dict(out_hw=(EMB_HW, EMB_HW), mean=(0.5, 0.5, 0.5),
                            std=(0.5, 0.5, 0.5)), precision="bf16")


@pytest.fixture(scope="module")
def embed_arts(tmp_path_factory):
    """The port's and JAX's embed artifacts of one set of weights (bf16,
    ResNet-50 at width 16 under the ArcFace head), with the routes."""
    tmp = tmp_path_factory.mktemp("embed")
    model = models.embedding_net(10, input_hw=(EMB_HW, EMB_HW), **EMB_KW)
    p, s = weights.random_jax_params(model, 0)
    sample = np.zeros((EMB_BATCH, EMB_HW, EMB_HW, 3), np.float32)
    port_path, jax_path = str(tmp / "emb.pt2"), str(tmp / "emb")
    fn = serving.make_inference_fn(model, p, s, device="cpu", policy=BF16)
    serving.export_fn(fn.program, fn.model, sample, port_path, kind="embed",
                      policy=BF16, device="cpu")
    jnet = JConvNet(jemb.embedding_net, input_shape=(EMB_HW, EMB_HW, 3),
                    num_classes=10, precision="bf16", **EMB_KW)
    jp, js = jfold(p, s, 1e-5)
    jserving.export_inference(jnet._transformed, jp, js, sample, jax_path,
                              fold_bn=False)
    config = tmp / "emb.py"
    config.write_text(f"config = {EMB_CFG!r}\n")
    return dict(port=port_path, jax=jax_path, trees=(p, s),
                config=str(config))


def test_embed_artifact_matches_jax(embed_arts):
    rows = np.random.RandomState(1).randn(EMB_BATCH, EMB_HW, EMB_HW,
                                          3).astype(np.float32)
    got = serving.load_inference(embed_arts["port"], "cpu")(rows).numpy()
    want = np.asarray(jserving.load_inference(embed_arts["jax"])(rows),
                      np.float32)
    assert got.shape == want.shape == (EMB_BATCH, 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.05 * np.abs(want).max())


@pytest.mark.parametrize("body", ["json", "image"])
def test_embed_route_matches_jax(embed_arts, body):
    """The embed routes of both packages over the artifacts of the same
    weights (JSON rows in [0, 1], and a PNG body through B2's plain
    version): unit-norm embeddings within 0.05 of the largest; the route
    built in memory from the trees replies as the artifact route does."""
    import io

    from PIL import Image
    port = serving_http.ModelServer([serving_http.artifact_route(
        "face", "embed", embed_arts["port"], embed_arts["config"],
        device="cpu")])
    theirs = jhttp.ModelServer([jhttp.build_route(
        "face", "embed", embed_arts["jax"], config=embed_arts["config"])])
    x = np.random.RandomState(2).rand(1, EMB_HW, EMB_HW, 3).astype(
        np.float32)
    if body == "image":
        buf = io.BytesIO()
        Image.fromarray((x[0] * 255).astype(np.uint8)).save(buf, "PNG")
        req, ctype = buf.getvalue(), "image/png"
    else:
        req, ctype = json.dumps({"instances": x.tolist()}).encode(), \
            "application/json"
    got = np.asarray(port.predict("face", req, ctype)["embeddings"])
    want = np.asarray(theirs.predict("face", req, ctype)["embeddings"])
    assert got.shape == want.shape == (1, 16)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=0.05 * np.abs(want).max())
    p, s = embed_arts["trees"]
    mem = serving_http.ModelServer([serving_http.build_route(
        "face", "embed", EMB_CFG, params=p, state=s, batch=EMB_BATCH,
        device="cpu")])
    assert mem.predict("face", req, ctype) == port.predict("face", req,
                                                             ctype)


# -------------------------------------------------------------- refusals


@pytest.mark.parametrize("over,match", [
    (dict(pk=None), "identity-balanced batches"),
    (dict(pk=(4, 4)), r"must multiply to batch_size=64"),
    (dict(pk=(64, 1)), "K >= 2"),
    (dict(model="resnet18"), "unknown metric model"),
    (dict(model_kwargs=dict(head="softmax")), "unknown metric_head")],
    ids=["no-pk", "pk-product", "pk-k1", "model", "head"])
def test_metric_refusals(over, match):
    cfg = _recipe(TRIPLET, **over)
    with pytest.raises(ValueError, match=match):
        recipes.build_trainer(cfg, True, device=CPU)


def test_embed_route_refuses_another_task():
    with pytest.raises(ValueError, match="serves a metric recipe"):
        serving_http.build_route("e", "embed", dict(task="classification"),
                                 params={}, state={}, device="cpu")


@pytest.mark.parametrize("tag", ["embedding", "features"])
def test_convnet_features_and_predict_match_jax(tag):
    """The metric recipe's ``ConvNet`` (``tinyembed``, ArcFace head):
    ``features(tag="embedding")`` gives the unit-norm embeddings JAX's
    ConvNet tags ``embedding``, ``features`` the backbone's map, and
    ``predict`` of raw images the embeddings through the eval chain; each
    within 1e-5 of the largest."""
    cfg = _recipe(TRIPLET, model="tinyembed", model_kwargs=dict(
        head="arcface"), num_classes=8)
    net, _, _ = recipes.build_metric(cfg, True, device=CPU)
    params, state = weights.random_jax_params(net.trainer.model, 9)
    weights.from_jax(net.trainer.model, params, state)
    jnet = JConvNet(jemb.tinyembed, input_shape=(32, 32, 3), num_classes=8,
                    augment=jrecipes.make_augment(cfg["augment"]),
                    head="arcface")
    jnet.build()
    jnet.state = jnet.state._replace(params=params, model_state=state)
    x = np.random.RandomState(10).randn(5, 32, 32, 3).astype(np.float32)
    want = np.asarray(jnet.features(x, batch_size=5, tag=tag))
    got = net.features(x, batch_size=3, tag=tag)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    u8 = np.random.RandomState(11).randint(0, 256, (5, 32, 32, 3), np.uint8)
    got, want = net.predict(u8, batch_size=5), jnet.predict(u8, batch_size=5)
    assert got.shape == want.shape == (5, 32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
