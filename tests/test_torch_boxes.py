"""The port's box ops, NMS, anchor matching and detection losses against
the JAX package, on the CPU.

Inputs are made with numpy from a seed: random xyxy boxes in [0, 1],
scores with exact ties (drawn from a few levels) or rounded to bf16,
candidate counts that are not a multiple of NMS's 128-wide block, and
more survivors than ``max_out``; anchors are tinydet's grid (756) and
SSD300's (8732); ground truth is padded to M rows with label -1.

Tolerances: the box ops and anchors within 1e-6 (float32 rounding of the
same formulas); NMS and batched NMS indices and ``valid`` equal to JAX's,
element for element, for the blocked ("jacobi") and the sequential form;
matching (boxes, labels, positives, ignore band) equal; the multibox and
focal losses and their gradients with respect to the logits and the
regression outputs within 1e-5 relative of JAX's (plus 1e-5 of the
largest gradient: a float32 sum over thousands of anchors in another
order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from myconvnet_tpu.models import ssd as jssd
from myconvnet_tpu.ops import boxes as jboxes
from myconvnet_tpu.train import detection as jdet
from myconvnet_tpu_torch.models import ssd as tssd
from myconvnet_tpu_torch.ops import boxes
from myconvnet_tpu_torch.train import detection as det

# the packages' __init__ binds "retinanet" to the model function
jretina = importlib.import_module("myconvnet_tpu.models.retinanet")
tretina = importlib.import_module("myconvnet_tpu_torch.models.retinanet")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


def rand_boxes(rng, n, lo=0.05, hi=0.5):
    xy = rng.uniform(0.0, 0.7, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    a, b = rand_boxes(rng, 37), rand_boxes(rng, 23)
    b[3] = b[3, [2, 3, 0, 1]]   # a degenerate box (x2 < x1)
    np.testing.assert_allclose(boxes.box_area(t(a)).numpy(),
                               np.asarray(jboxes.box_area(a)), atol=1e-6)
    np.testing.assert_allclose(boxes.box_iou(t(a), t(b)).numpy(),
                               np.asarray(jboxes.box_iou(a, b)), atol=1e-6)
    np.testing.assert_allclose(
        boxes.aligned_giou(t(a[:23]), t(b)).numpy(),
        np.asarray(jboxes.aligned_giou(a[:23], b)), atol=1e-6)
    anchors = rand_boxes(rng, 23)
    enc = boxes.encode_boxes(t(a[:23]), t(anchors)).numpy()
    np.testing.assert_allclose(
        enc, np.asarray(jboxes.encode_boxes(a[:23], anchors)), rtol=1e-6,
        atol=1e-6)
    deltas = rng.randn(23, 4).astype(np.float32)
    np.testing.assert_allclose(
        boxes.decode_boxes(t(deltas), t(anchors)).numpy(),
        np.asarray(jboxes.decode_boxes(deltas, anchors)), rtol=1e-6,
        atol=1e-6)
    # decode inverts encode
    np.testing.assert_allclose(
        boxes.decode_boxes(t(enc), t(anchors)).numpy(), a[:23], atol=1e-5)


def test_box_op_gradients_split_ties_as_jax():
    """``jnp.maximum``'s tie rule: two boxes that just touch (zero
    overlap width) give the overlap half a gradient."""
    a = np.asarray([[0.1, 0.1, 0.4, 0.4]], np.float32)
    b = np.asarray([[0.4, 0.2, 0.6, 0.5]], np.float32)   # touching
    want = np.asarray(jax.grad(lambda u: jboxes.aligned_giou(u, b).sum())(
        a))
    x = t(a).requires_grad_(True)
    boxes.aligned_giou(x, t(b)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("spec,fn,clip", [
    ("SSD300_SPEC", "ssd_anchors", True),
    ("SSD512_SPEC", "ssd_anchors", True),
    ("RETINA512_SPEC", "retina_anchors", False)])
def test_anchor_grids_equal_jax(spec, fn, clip):
    mine = getattr(boxes, fn)(getattr(boxes, spec), clip)
    theirs = getattr(jboxes, fn)(getattr(jboxes, spec), clip)
    assert getattr(boxes, spec) == getattr(jboxes, spec)
    np.testing.assert_array_equal(mine, theirs)


def test_model_anchor_specs_equal_jax():
    assert tssd.TINYDET_SPEC == jssd.TINYDET_SPEC
    assert tretina.TINYRETINA_SPEC == jretina.TINYRETINA_SPEC
    assert len(boxes.ssd_anchors(boxes.SSD300_SPEC)) == tssd.NUM_ANCHORS
    np.testing.assert_array_equal(
        boxes.retina_anchors(tretina.TINYRETINA_SPEC),
        jboxes.retina_anchors(jretina.TINYRETINA_SPEC))


def nms_case(kind, seed):
    """(boxes [n, 4], scores [n], labels [n]) of one case."""
    rng = np.random.RandomState(seed)
    n = {"ties": 300, "bf16": 200, "many": 517, "few": 40}[kind]
    bx = rand_boxes(rng, n, 0.02, 0.3 if kind != "many" else 0.08)
    if kind == "ties":
        scores = rng.choice([0.9, 0.7, 0.5, 0.3, 0.1], n).astype(np.float32)
    elif kind == "bf16":
        scores = torch.from_numpy(rng.rand(n).astype(np.float32)).to(
            torch.bfloat16).float().numpy()
    else:
        scores = rng.rand(n).astype(np.float32)
    labels = rng.randint(1, 4, n).astype(np.int32)
    return bx, scores, labels


CASES = ["ties", "bf16", "many", "few"]


@pytest.mark.parametrize("method", ["jacobi", "sequential"])
@pytest.mark.parametrize("kind", CASES)
def test_nms_matches_jax(kind, method):
    bx, scores, labels = nms_case(kind, 1)
    for thr, max_out, score_thr in ((0.45, 100, -np.inf), (0.3, 50, 0.2),
                                    (0.6, 64, 0.5)):
        ji, jv = jboxes.nms(bx, scores, thr, max_out, score_thr, method)
        ti, tv = boxes.nms(t(bx), t(scores), thr, max_out, score_thr,
                           method)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        ji, jv = jboxes.batched_nms(bx, scores, labels, thr, max_out,
                                    score_thr)
        if method == "sequential":   # JAX's batched form is the blocked
            ji, jv = jboxes.nms(bx + labels[:, None] * 4.0, scores, thr,
                                max_out, score_thr, "sequential")
        ti, tv = boxes.batched_nms(t(bx), t(scores), t(labels), thr, max_out,
                                   score_thr, method)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_more_survivors_than_max_out_and_short_inputs():
    bx, scores, _ = nms_case("many", 2)
    ti, tv = boxes.nms(t(bx), t(scores), 0.5, 100)
    assert bool(tv.all())    # more than 100 survive: every slot valid
    ji, jv = jboxes.nms(bx[:30], scores[:30], 0.5, 100)
    ti, tv = boxes.nms(t(bx[:30]), t(scores[:30]), 0.5, 100)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not bool(tv[30:].any())


@pytest.mark.parametrize("kind", CASES)
def test_blocked_and_sequential_keep_the_same_detections(kind):
    bx, scores, labels = nms_case(kind, 3)
    a_i, a_v = boxes.batched_nms(t(bx), t(scores), t(labels), 0.45, 100,
                                 0.05)
    b_i, b_v = boxes.batched_nms(t(bx), t(scores), t(labels), 0.45, 100,
                                 0.05, "sequential")
    np.testing.assert_array_equal(a_v.numpy(), b_v.numpy())
    np.testing.assert_array_equal(a_i[a_v].numpy(), b_i[b_v].numpy())


def test_nms_batch_equals_each_image_and_syncs_once_a_sweep():
    """The blocked fixpoint over a batch gives each image's JAX answer,
    and asks the host once a sweep for the whole batch (no more syncs
    than the images' own runs together)."""
    cases = [nms_case(k, 4 + i) for i, k in enumerate(["ties", "bf16",
                                                       "few"])]
    n = min(len(c[0]) for c in cases)
    bx = np.stack([c[0][:n] for c in cases])
    sc = np.stack([c[1][:n] for c in cases])
    boxes.reset_sync_count()
    ti, tv = boxes.nms_batch(t(bx), t(sc), 0.45, 20)
    batch_syncs = boxes.sync_count()
    alone = 0
    for i in range(3):
        ji, jv = jboxes.nms(bx[i], sc[i], 0.45, 20)
        np.testing.assert_array_equal(ti[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))
        boxes.reset_sync_count()
        boxes.nms(t(bx[i]), t(sc[i]), 0.45, 20)
        alone += boxes.sync_count()
    assert 0 < batch_syncs <= alone
    boxes.reset_sync_count()
    boxes.nms_batch(t(bx), t(sc), 0.45, 20, method="sequential")
    assert boxes.sync_count() == 0


def gt_case(seed, b=3, m=6):
    rng = np.random.RandomState(seed)
    gtb = np.stack([rand_boxes(rng, m, 0.1, 0.5) for _ in range(b)])
    gtl = rng.randint(1, 21, (b, m)).astype(np.int32)
    gtl[:, -2:] = -1    # padding
    gtl[-1] = -1        # an image without ground truth
    return gtb, gtl


@pytest.mark.parametrize("band", [False, True])
def test_matching_equals_jax(band):
    anchors = boxes.ssd_anchors(tssd.TINYDET_SPEC)
    gtb, gtl = gt_case(5)
    gtb[0, 1] = anchors[100]     # a ground truth exactly on an anchor
    if band:
        want = jax.vmap(lambda b, l: jdet.match_anchors_band(
            anchors, b, l, 0.5, 0.4))(gtb, gtl)
        got = det.match_anchors_band(t(anchors), t(gtb), t(gtl), 0.5, 0.4)
    else:
        want = jax.vmap(lambda b, l: jdet.match_anchors(anchors, b, l,
                                                        0.5))(gtb, gtl)
        got = det.match_anchors(t(anchors), t(gtb), t(gtl), 0.5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2].any()) and not bool(got[2][-1].any())


def _grads(fn, *args):
    xs = [t(a).requires_grad_(True) for a in args]
    loss, metrics = fn(*xs)
    loss.backward()
    return float(loss.detach()), metrics, [x.grad.numpy() for x in xs]


def check_loss(jfn, tfn, cls, loc, gtb, gtl, anchors):
    (jl, jm), jg = jax.value_and_grad(
        lambda c, lo: jfn(c, lo, gtb, gtl, anchors), argnums=(0, 1),
        has_aux=True)(cls, loc)
    loss, metrics, grads = _grads(
        lambda c, lo: tfn(c, lo, t(gtb), t(gtl), t(anchors)), cls, loc)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    for k in ("loc_loss", "cls_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-7)
    assert int(metrics["n_pos"]) == int(jm["n_pos"])
    for g, w in zip(grads, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_multibox_loss_and_gradients_match_jax():
    """With ties in the negatives' CE (repeated logits rows) the double
    argsort's stable order decides which negatives are mined."""
    anchors = boxes.ssd_anchors(tssd.TINYDET_SPEC)
    a = len(anchors)
    gtb, gtl = gt_case(6)
    rng = np.random.RandomState(7)
    cls = rng.randn(3, a, 21).astype(np.float32)
    cls[:, 200:400] = cls[:, 200:201]   # exact ties among negatives
    loc = rng.randn(3, a, 4).astype(np.float32) * 0.5
    check_loss(jdet.multibox_loss, det.multibox_loss, cls, loc, gtb, gtl,
               anchors)


@pytest.mark.parametrize("kind", ["smooth_l1", "giou"])
def test_focal_loss_and_gradients_match_jax(kind):
    anchors = boxes.retina_anchors(tretina.TINYRETINA_SPEC)
    a = len(anchors)
    gtb, gtl = gt_case(8)
    rng = np.random.RandomState(9)
    cls = (rng.randn(3, a, 20) - 3.0).astype(np.float32)
    loc = rng.randn(3, a, 4).astype(np.float32) * 0.5

    def jfn(c, lo, b, lab, an):
        return jdet.focal_det_loss(c, lo, b, lab, an, loc_loss_kind=kind)

    def tfn(c, lo, b, lab, an):
        return det.focal_det_loss(c, lo, b, lab, an, loc_loss_kind=kind)

    check_loss(jfn, tfn, cls, loc, gtb, gtl, anchors)
