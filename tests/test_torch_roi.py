"""The port's two-stage and anchor-free detection ops against the JAX
package, on the CPU, on handed-in inputs and draws.

RoIAlign one level and over a pyramid (degenerate, padded and out-of-frame
RoIs; the crops' dtype under bf16 maps; the chunking), the level rule,
proposals, the RoI subsample, the RPN and RoI-head losses, FCOS's points,
targets, loss and post-process, the two-stage post-process and the flip
TTA.  The random priorities are JAX's own draws handed to the port.  The
discrete outputs are held on inputs whose decisions are shown, in the
test, to lie a stated margin from their thresholds and ties (sorted scores
apart, IoUs away from the NMS and matching thresholds).

Tolerances: crops within 1e-5 of the largest (float32 products summed in
another order), bit for bit across chunkings; levels, indices, labels,
``pos``, ``valid`` and matched rows equal; boxes within 1e-6, scores within
1e-6, regression targets and centerness within 1e-5; losses within 1e-5
relative and their gradients within 1e-5 of the largest.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu.eval import det_tta as jtta
from myconvnet_tpu.ops import boxes as jboxes
from myconvnet_tpu.ops import roi as jroi
from myconvnet_tpu.train import fcos as jfcos
from myconvnet_tpu.train import rcnn as jrcnn
from myconvnet_tpu_torch.eval import det_tta
from myconvnet_tpu_torch.models.faster_rcnn import TINYFRCNN_RPN_SPEC
from myconvnet_tpu_torch.ops import boxes, roi
from myconvnet_tpu_torch.train import fcos, rcnn

# the model modules, shadowed by their factories in the packages' __init__
jfcos_model = importlib.import_module("myconvnet_tpu.models.fcos")
fcos_model = importlib.import_module("myconvnet_tpu_torch.models.fcos")
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last."""
    torch.set_num_threads(1)


CLASSES = 21
ANCHORS = boxes.retina_anchors(TINYFRCNN_RPN_SPEC)   # 1008


def _t(a):
    return torch.from_numpy(np.array(a))


def rand_boxes(rng, shape, lo=0.0, hi=0.7, wmin=0.05, wmax=0.4):
    xy = rng.uniform(lo, hi, (*shape, 2))
    wh = rng.uniform(wmin, wmax, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def gt_batch(seed, b=3, m=5):
    rng = np.random.RandomState(seed)
    bx = rand_boxes(rng, (b, m), wmin=0.1)
    lab = rng.randint(1, CLASSES, (b, m)).astype(np.int32)
    lab[:, -1] = -1
    lab[-1] = -1          # an image with no ground truth
    return bx, lab


def margin(values, thresholds):
    """The least distance of ``values`` to any of ``thresholds``."""
    v = np.asarray(values, np.float64).reshape(-1)
    return min(np.abs(v - t).min() for t in thresholds)


# --------------------------------------------------------------- RoIAlign


def roi_cases(seed, b=2, p=9):
    rng = np.random.RandomState(seed)
    rois = rand_boxes(rng, (b, p), lo=-0.1, hi=0.8, wmin=0.02, wmax=0.5)
    rois[0, 0] = [0.6, 0.6, 0.4, 0.5]       # degenerate: hi <= lo
    rois[0, 1] = 0.0                        # a padded slot
    rois[1, 2] = [-0.2, 0.9, 1.3, 1.4]      # out of frame
    return rois


@pytest.mark.parametrize("hw", [(9, 11), (16, 16)])
def test_roi_align_matches_jax_and_chunking_moves_no_bit(hw, monkeypatch):
    rng = np.random.RandomState(1)
    feats = rng.randn(2, *hw, 6).astype(np.float32)
    rois = roi_cases(2)
    for out_size, samples in ((7, 2), (5, 2), (3, 1)):
        want = np.asarray(jax.jit(lambda f, r: jroi.roi_align(
            f, r, out_size, samples, chunk=4))(feats, rois))
        got = roi.roi_align(_t(feats), _t(rois), out_size, samples)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        # every chunking the same bits: one RoI a product, and all nine
        monkeypatch.setattr(roi, "ROI_ALIGN_BYTES", 1)
        for chunk in (1, 2, 4):
            assert torch.equal(roi.roi_align(_t(feats), _t(rois), out_size,
                                             samples, chunk=chunk), got)
        monkeypatch.undo()
    # the weights: convex rows, clamped to the border
    w = roi._pooled_axis_weights(_t(rois[..., 0]), _t(rois[..., 2]), 11, 7)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(
        jax.vmap(lambda lo, hi: jroi._pooled_axis_weights(lo, hi, 11, 7))(
            rois[..., 0], rois[..., 2])), atol=1e-7)


def test_levels_and_multilevel_align_match_jax_in_both_dtypes():
    rng = np.random.RandomState(3)
    rois = roi_cases(4, p=12)
    rois[1, 3] = [0.0, 0.0, 1.0, 1.0]       # image-sized: the top level
    rois[1, 4] = [0.5, 0.5, 0.52, 0.52]     # tiny: the bottom level
    lv = roi.assign_levels(_t(rois), 3).numpy()
    np.testing.assert_array_equal(lv, np.asarray(jroi.assign_levels(
        rois, 3)))
    assert set(lv.reshape(-1)) == {0, 1, 2}
    feats = [rng.randn(2, s, s, 8).astype(np.float32) for s in (16, 8, 4)]
    for dtype in (jnp.float32, jnp.bfloat16):
        jf = [jnp.asarray(f, dtype) for f in feats]
        want = jax.jit(lambda fs, r: jroi.multilevel_roi_align(
            fs, r, 5, chunk=4))(jf, rois)
        tf = [torch.from_numpy(np.array(f.astype(jnp.float32))).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
            for f in jf]
        got = roi.multilevel_roi_align(tf, _t(rois), 5)
        # the crops float32 as JAX's einsum promotes a bf16 map
        assert str(want.dtype) == "float32" and got.dtype == torch.float32
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# -------------------------------------------------------------- proposals


def rpn_outputs(seed, b=2):
    """Objectness at a permutation of well-separated logits and small
    deltas on the tiny RPN grid."""
    rng = np.random.RandomState(seed)
    a = len(ANCHORS)
    obj = np.stack([rng.permutation(np.linspace(-4.0, 4.0, a))
                    for _ in range(b)]).astype(np.float32)
    deltas = (0.2 * rng.randn(b, a, 4)).astype(np.float32)
    return obj, deltas


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_proposals_match_jax(seed):
    obj, deltas = rpn_outputs(seed)
    kw = dict(pre_topk=256, post_count=240, nms_iou=0.7)
    want = jax.jit(jax.vmap(lambda o, d: jroi.generate_proposals(
        o, d, jnp.asarray(ANCHORS), **kw)))(obj, deltas)
    # the margins: sorted scores apart, and every IoU among the top 256
    # candidates away from the NMS threshold
    scores = np.sort(1 / (1 + np.exp(-obj.astype(np.float64))), 1)[:, ::-1]
    assert np.diff(scores[:, :257], axis=1).max() < -1e-5
    dec = np.asarray(jboxes.decode_boxes(deltas, ANCHORS[None],
                                         variances=(1.0, 1.0)))
    for i in range(len(obj)):
        top = np.clip(dec[i][np.argsort(-obj[i], kind="stable")[:256]], 0, 1)
        iou = np.asarray(jboxes.box_iou(top, top))
        assert margin(iou[np.triu_indices(256, 1)], [0.7]) > 1e-5
    for method in ("jacobi", "sequential"):
        got = roi.generate_proposals(_t(obj), _t(deltas), _t(ANCHORS),
                                     method=method, **kw)
        valid = np.asarray(want[2])
        np.testing.assert_array_equal(got[2].numpy(), valid)
        assert valid.any() and not valid.all()
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=1e-6)


def sample_inputs(seed, b=3, p=40, m=5):
    rng = np.random.RandomState(seed)
    gtb, gtl = gt_batch(seed + 10, b, m)
    # proposals around the ground truth and at random
    near = gtb[:, rng.randint(0, m, p // 2)] + rng.uniform(
        -0.08, 0.08, (b, p // 2, 4)).astype(np.float32)
    props = np.concatenate([near, rand_boxes(rng, (b, p - p // 2))], 1)
    valid = rng.rand(b, p) < 0.85
    props = props * valid[..., None]
    return props.astype(np.float32), valid, gtb, gtl


@pytest.mark.parametrize("seed", [0, 1])
def test_match_and_sample_rois_match_jax(seed):
    props, pvalid, gtb, gtl = sample_inputs(seed)
    b, p = pvalid.shape
    m = gtb.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    rand = np.stack([np.asarray(jax.random.uniform(k, (p + m,)))
                     for k in keys])
    assert min(len(set(r)) for r in rand) == p + m    # no tied priorities
    cand = np.concatenate([props, gtb], 1)
    iou = np.asarray(jax.vmap(jboxes.box_iou)(cand, gtb))
    assert margin(iou[np.broadcast_to(gtl[:, None] >= 0, iou.shape)],
                  [0.5]) > 1e-5
    kw = dict(num_samples=32, fg_fraction=0.25)
    want = jax.jit(jax.vmap(lambda k, pr, v, gb, gl:
                            jroi.match_and_sample_rois(k, pr, v, gb, gl,
                                                       **kw)))(
        keys, props, pvalid, gtb, gtl)
    got = roi.match_and_sample_rois(_t(rand), _t(props), _t(pvalid),
                                    _t(gtb), _t(gtl), **kw)
    for i in (1, 3, 4, 5):   # labels, pos, valid, matched rows
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5)
    pos = got[3].numpy()
    assert pos[:-1].any(1).all() and not pos[-1].any()
    assert (pos.sum(1) <= 8).all() and got[4].numpy().any(1).all()
    assert got[1].dtype == torch.int32 and got[5].dtype == torch.int32


# ----------------------------------------------------------------- losses


def _grads(fn, *args):
    args = [_t(a).requires_grad_() if a.dtype == np.float32 else _t(a)
            for a in args]
    loss, metrics = fn(*args)
    loss.backward()
    return loss.detach(), metrics, [a.grad for a in args if a.requires_grad]


def test_rpn_loss_matches_jax_at_its_draws():
    rng = np.random.RandomState(5)
    b, a = 3, len(ANCHORS)
    logits = rng.randn(b, a).astype(np.float32)
    loc = (0.3 * rng.randn(b, a, 4)).astype(np.float32)
    gtb, gtl = gt_batch(6, b)
    iou = np.asarray(jboxes.box_iou(ANCHORS, gtb[0]))
    assert margin(iou, [0.7, 0.3]) > 1e-5
    key = jax.random.PRNGKey(7)
    rand = np.stack([np.asarray(jax.random.uniform(k, (a,)))
                     for k in jax.random.split(key, b)])
    kw = dict(num_samples=64, pos_iou=0.7, neg_iou=0.3)

    def jloss(lg, lc):
        return jrcnn.rpn_loss(key, lg, lc, gtb, gtl, jnp.asarray(ANCHORS),
                              **kw)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(
        logits, loc)
    loss, m, grads = _grads(lambda r, lg, lc: rcnn.rpn_loss(
        r, lg, lc, _t(gtb), _t(gtl), _t(ANCHORS), **kw), rand, logits, loc)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("rpn_obj", "rpn_reg"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert int(m["rpn_pos"]) == int(jm["rpn_pos"]) > 0
    # the random priorities are the draws: another draw samples others
    for g, w in zip(grads[1:], jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_roi_head_loss_matches_jax():
    rng = np.random.RandomState(8)
    b, s = 2, 24
    cls = rng.randn(b, s, CLASSES).astype(np.float32)
    reg = (0.5 * rng.randn(b, s, CLASSES, 4)).astype(np.float32)
    labels = rng.randint(0, CLASSES, (b, s)).astype(np.int32)
    pos = labels > 0
    valid = rng.rand(b, s) < 0.9
    pos &= valid
    targets = (rng.randn(b, s, 4) * pos[..., None]).astype(np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda c, r: jrcnn.roi_head_loss(c, r, labels, targets, pos, valid),
        (0, 1), has_aux=True))(cls, reg)
    loss, m, grads = _grads(lambda c, r: rcnn.roi_head_loss(
        c, r, _t(labels), _t(targets), _t(pos), _t(valid)), cls, reg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("roi_cls", "roi_reg", "roi_acc"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    for g, w in zip(grads, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


# ------------------------------------------------------------------- FCOS


def test_fcos_points_equal_jax():
    for spec in (fcos_model.FCOS512_SPEC, fcos_model.TINYFCOS_SPEC):
        for g, w in zip(fcos_model.fcos_points(spec),
                        jfcos_model.fcos_points(spec)):
            np.testing.assert_array_equal(g, w)
    assert len(fcos_model.fcos_points(fcos_model.FCOS512_SPEC)[0]) == 5456


def fcos_gt(seed, b=3, m=6):
    gtb, gtl = gt_batch(seed, b, m)
    gtb[0, 1] = gtb[0, 0]     # equal areas: the first wins
    gtl[0, 2] = 0             # label 0 is not a candidate
    return gtb, gtl


@pytest.mark.parametrize("seed", [0, 1])
def test_fcos_targets_match_jax(seed):
    pts, ranges, _ = fcos_model.fcos_points(fcos_model.TINYFCOS_SPEC)
    gtb, gtl = fcos_gt(seed)
    # the margins: no point on a box's side, no distance on a band edge
    d = np.concatenate([pts[:, None, :] - gtb[:, None, :, :2],
                        gtb[:, None, :, 2:] - pts[:, None, :]], -1)
    assert margin(d, [0.0]) > 1e-5
    assert margin(d.max(-1), [4 / 16, 4 / 8]) > 1e-5
    want = jax.jit(jax.vmap(lambda gb, gl: jfcos.fcos_targets(
        pts, ranges, gb, gl)))(gtb, gtl)
    got = fcos.fcos_targets(_t(pts), _t(ranges), _t(gtb), _t(gtl))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=1e-5)
    assert got[3].numpy()[:-1].any(1).all() and not got[3][-1].any()


def fcos_heads(seed, b=3, n=336):
    rng = np.random.RandomState(seed)
    cls = (rng.randn(b, n, CLASSES - 1) - 2.0).astype(np.float32)
    ctr = rng.randn(b, n).astype(np.float32)
    dists = rng.uniform(0.01, 0.3, (b, n, 4)).astype(np.float32)
    return cls, ctr, dists


def test_fcos_loss_and_its_gradient_match_jax():
    pts, ranges, _ = fcos_model.fcos_points(fcos_model.TINYFCOS_SPEC)
    gtb, gtl = fcos_gt(2)
    cls, ctr, dists = fcos_heads(3)
    kw = dict(alpha=0.25, gamma=2.0, reg_weight=1.5)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda c, t, d: jfcos.fcos_loss(c, t, d, pts, ranges, gtb, gtl,
                                        **kw), (0, 1, 2), has_aux=True))(
        cls, ctr, dists)
    loss, m, grads = _grads(lambda c, t, d: fcos.fcos_loss(
        c, t, d, _t(pts), _t(ranges), _t(gtb), _t(gtl), **kw),
        cls, ctr, dists)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("cls_loss", "reg_loss", "ctr_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert int(m["n_pos"]) == int(jm["n_pos"]) > 0
    for g, w in zip(grads, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    # bf16 heads: the loss is float32 all the same, as JAX's
    lb, _ = fcos.fcos_loss(_t(cls).bfloat16(), _t(ctr).bfloat16(),
                           _t(dists).bfloat16(), _t(pts), _t(ranges),
                           _t(gtb), _t(gtl), **kw)
    assert lb.dtype == torch.float32


# ------------------------------------------------------------ post-process


def check_detections(got, want, method):
    valid = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), valid)
    assert valid.any() and not valid.all()
    for g, w in zip(got[:3], want[:3]):
        g, w = g.numpy(), np.asarray(w)
        if method == "jacobi":   # the rows past valid agree too
            np.testing.assert_allclose(g, w, atol=1e-6)
        np.testing.assert_allclose(g[valid], w[valid], atol=1e-6)
    assert got[2].dtype == torch.int32 and got[1].dtype == torch.float32


def test_fcos_postprocess_equals_jax():
    pts, _, _ = fcos_model.fcos_points(fcos_model.TINYFCOS_SPEC)
    cls, ctr, dists = fcos_heads(4)
    kw = dict(score_threshold=0.1, iou_threshold=0.45, max_detections=200,
              pre_nms_topk=150)
    want = jax.jit(jfcos.make_fcos_postprocess(jnp.asarray(pts), CLASSES,
                                               **kw))(cls, ctr, dists)
    for method in ("jacobi", "sequential"):
        got = fcos.make_fcos_postprocess(_t(pts), CLASSES, nms_method=method,
                                         **kw)(_t(cls), _t(ctr), _t(dists))
        check_detections(got, want, method)


class _Out:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_rcnn_postprocess_equals_jax():
    rng = np.random.RandomState(9)
    b, s = 2, 40
    rois = rand_boxes(rng, (b, s))
    valid = rng.rand(b, s) < 0.8
    rois = rois * valid[..., None]
    cls = (rng.randn(b, s, CLASSES) * 2.0).astype(np.float32)
    reg = (0.3 * rng.randn(b, s, CLASSES, 4)).astype(np.float32)
    kw = dict(score_threshold=0.3, iou_threshold=0.5, max_detections=60,
              pre_nms_topk=300)
    want = jax.jit(lambda r, v, c, g: jrcnn.make_rcnn_postprocess(
        CLASSES, **kw)(_Out(rois=r, roi_valid=v, roi_cls=c, roi_reg=g)))(
        rois, valid, cls, reg)
    for method in ("jacobi", "sequential"):
        got = rcnn.make_rcnn_postprocess(CLASSES, nms_method=method, **kw)(
            _Out(rois=_t(rois), roi_valid=_t(valid), roi_cls=_t(cls),
                 roi_reg=_t(reg)))
        check_detections(got, want, method)


# -------------------------------------------------------------- flip TTA


def test_flip_tta_equals_jax():
    """A detector whose outputs read the image's first row: its flip
    sees other pixels, so the merge meets boxes of both passes."""
    rng = np.random.RandomState(10)
    b, d = 2, 12
    base = rand_boxes(rng, (b, d), wmin=0.1)
    base[:, d // 2:] = jtta.flip_boxes_x(base[:, :d // 2]) + 0.01
    scores = rng.uniform(0.1, 0.9, (b, d)).astype(np.float32)
    labels = rng.randint(1, 4, (b, d)).astype(np.int32)
    valid = rng.rand(b, d) < 0.4
    images = rng.rand(b, 6, 8, 1).astype(np.float32)

    def jpredict(_, x):
        shift = 0.01 * x[:, 0, :4, 0]
        return (base + shift[:, None, :], scores + 0.05 * x[:, 0, 4:5, 0],
                labels, valid)

    def predict(x):
        shift = 0.01 * x[:, 0, :4, 0]
        return (_t(base) + shift[:, None, :],
                _t(scores) + 0.05 * x[:, 0, 4:5, 0], _t(labels), _t(valid))

    np.testing.assert_allclose(det_tta.flip_boxes_x(_t(base)).numpy(),
                               np.asarray(jtta.flip_boxes_x(base)))
    for max_det in (None, 20):
        want = jax.jit(jtta.make_flip_tta(jpredict, iou_threshold=0.5,
                                          max_detections=max_det))(
            None, images)
        got = det_tta.make_flip_tta(predict, iou_threshold=0.5,
                                    max_detections=max_det)(_t(images))
        v = np.asarray(want[3])
        np.testing.assert_array_equal(got[3].numpy(), v)
        assert v.any() and not v.all()
        np.testing.assert_array_equal(got[2].numpy()[v],
                                      np.asarray(want[2])[v])
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy()[v], np.asarray(w)[v],
                                       atol=1e-6)
