"""Faster R-CNN and tinyfrcnn: ResNet + FPN, a weight-tied RPN, proposals,
RoIAlign and the two-FC box head, NHWC.

Port of ``myconvnet_tpu/models/faster_rcnn.py``: the RPN grid specs
(``:48-61``), ``FRCNNOut`` (``:64``), the RPN over P3-P6 (``_rpn_heads``,
``:81``: one ``rpn`` scope, relu(3x3 conv + bias), then 1x1 ``obj`` and
``loc`` convs from N(0, 0.01), 3 ratio anchors a cell), the box head
(``_box_head``, ``:96``: crops flattened in HWC order, ``fc1`` and ``fc2``
of ``fc_dim`` with ReLU, ``cls`` from N(0, 0.01) and per-class ``reg``
from N(0, 0.001)), the shared second half (``_two_stage``, ``:111``) and
the trunks (``_frcnn512_trunk``, ``:160``: the ResNet backbone, RetinaNet's
``FPN`` at 3 levels and P6 = ``max_pool2d(P5, 1, 2)``; ``_tiny_trunk``,
``:179``, RetinaNet's :func:`~myconvnet_tpu_torch.models.retinanet.tiny_trunk`).

``forward(x, gt_boxes=None, gt_labels=None, roi_rand=None,
nms_method="jacobi")``: proposals come from the detached RPN outputs
(``ops.roi.generate_proposals``: 1000 of the top 2000 at IoU 0.7 in train
mode, 300 in eval); in train mode with ground truth the second stage takes
``num_samples`` RoIs of ``match_and_sample_rois`` at the caller's
priorities ``roi_rand`` [B, post_train + M] (JAX draws them from the
frame key), else the proposals themselves.  RoIAlign pools float32 crops
from P3-P5 (``ops.roi``); the box head reads them in the input's dtype,
as JAX's dense casts to the policy's compute dtype.  ``nms_method``
"sequential" is the proposal NMS ``torch.export`` traces whole.

Eval mode: the backbone routes as the ResNet-50 eval forward (B5 13, B1
7) and the RPN's relu(conv3x3 + bias) is ``conv3x3_bn_relu`` (B4) with
scale 1 and the bias as its epilogue under bf16, once a level: 4 launches
a forward at P3-P6 (64² to 8² at a 512 input).  The FPN, the RPN's 1x1
convs and the box head's products take no kernel (JAX computes them
outside Pallas too).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from myconvnet_tpu_torch.core.init import normal
from myconvnet_tpu_torch.models.blocks import conv_bn_relu, fuses
from myconvnet_tpu_torch.models.resnet import ResNetBackbone
from myconvnet_tpu_torch.models.retinanet import FPN, tiny_pyramid, \
    tiny_trunk
from myconvnet_tpu_torch.nn import Conv, Dense, relu
from myconvnet_tpu_torch.ops import roi as roi_ops
from myconvnet_tpu_torch.ops.boxes import retina_anchors
from myconvnet_tpu_torch.ops.pool import max_pool2d

RPN_RATIOS = (0.5, 1.0, 2.0)
_A = len(RPN_RATIOS)
# the RPN's anchor grid at 512²: P3-P6, one scale a level, 3 ratios
FRCNN512_RPN_SPEC = tuple(
    (fm, base, (0.0,), RPN_RATIOS)
    for fm, base in ((64, 0.125), (32, 0.25), (16, 0.5), (8, 1.0)))
TINYFRCNN_RPN_SPEC = tuple(
    (fm, base, (0.0,), RPN_RATIOS)
    for fm, base in ((16, 0.2), (8, 0.45), (4, 0.9)))


class FRCNNOut(NamedTuple):
    """What the losses and the post-process take (A RPN anchors, S RoIs:
    ``num_samples`` in train mode, ``post_eval`` in eval; C classes with
    background column 0)."""
    rpn_logits: torch.Tensor   # [B, A]
    rpn_loc: torch.Tensor      # [B, A, 4]
    rois: torch.Tensor         # [B, S, 4] normalized xyxy
    roi_valid: torch.Tensor    # [B, S]
    roi_scores: torch.Tensor   # [B, S] the proposals' scores (eval)
    roi_cls: torch.Tensor      # [B, S, C]
    roi_reg: torch.Tensor      # [B, S, C, 4]
    roi_labels: torch.Tensor   # [B, S] train targets (eval: zeros)
    roi_targets: torch.Tensor  # [B, S, 4]
    roi_pos: torch.Tensor      # [B, S]
    roi_gt: torch.Tensor       # [B, S] matched ground-truth row


class RPNHead(nn.Module):
    """``_rpn_heads``: scope ``rpn``, relu(3x3 conv + bias) then the 1x1
    ``obj`` and ``loc`` convs, one set of weights for every level."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3, bias=True)
        self.obj = Conv(ch, _A, 1, bias=True, w_init=normal(0.01))
        self.loc = Conv(ch, _A * 4, 1, bias=True, w_init=normal(0.01))
        self.fused = fuses(self.conv)

    def forward(self, feats):
        logits, locs = [], []
        for f in feats:
            h = conv_bn_relu(self.conv, None, f, self.fused)
            ob, lc = self.obj(h), self.loc(h)
            b, hh, ww, _ = ob.shape
            logits.append(ob.reshape(b, hh * ww * _A))
            locs.append(lc.reshape(b, hh * ww * _A, 4))
        return torch.cat(logits, 1), torch.cat(locs, 1)


class BoxHead(nn.Module):
    """``_box_head``: scope ``box_head``, [B, S, s, s, C'] crops -> (cls
    [B, S, C], reg [B, S, C, 4])."""

    def __init__(self, cin: int, fc_dim: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = Dense(cin, fc_dim)
        self.fc2 = Dense(fc_dim, fc_dim)
        self.cls = Dense(fc_dim, num_classes, w_init=normal(0.01))
        self.reg = Dense(fc_dim, num_classes * 4, w_init=normal(0.001))

    def forward(self, crops: torch.Tensor):
        b, s = crops.shape[:2]
        h = relu(self.fc1(crops.reshape(b * s, -1)))
        h = relu(self.fc2(h))
        n = self.num_classes
        return (self.cls(h).reshape(b, s, n),
                self.reg(h).reshape(b, s, n, 4))


class _TwoStage(nn.Module):
    """The RPN, proposals, sampling, RoIAlign and box head over a trunk's
    pyramid (``_two_stage``); ``align_levels`` of the levels, the bottom
    ones, feed RoIAlign."""

    def _second_half(self, num_classes, ch, fc_dim, out_size, rpn_spec, *,
                     align_levels, pre_topk, post_train, post_eval, nms_iou,
                     num_samples, fg_fraction, fg_iou, chunk):
        self.rpn = RPNHead(ch)
        self.box_head = BoxHead(ch * out_size * out_size, fc_dim,
                                num_classes)
        self.rpn_spec = rpn_spec
        self.out_size, self.align_levels, self.chunk = \
            out_size, align_levels, chunk
        self.pre_topk, self.post_train, self.post_eval = \
            pre_topk, post_train, post_eval
        self.nms_iou, self.num_samples = nms_iou, num_samples
        self.fg_fraction, self.fg_iou = fg_fraction, fg_iou
        # torch.tensor (not from_numpy) follows a device context: a model
        # made on the meta device keeps its anchors there
        self.register_buffer("anchors", torch.tensor(
            retina_anchors(rpn_spec)), persistent=False)

    def _heads(self, x, feats, gt_boxes, gt_labels, roi_rand, nms_method):
        rpn_logits, rpn_loc = self.rpn(feats)
        if self.anchors.shape[0] != rpn_logits.shape[1]:
            raise ValueError(f"RPN grid {rpn_logits.shape[1]} != anchor "
                             f"spec {self.anchors.shape[0]} — wrong input "
                             "size")
        train = self.training
        props, prop_scores, prop_valid = roi_ops.generate_proposals(
            rpn_logits.detach(), rpn_loc.detach(), self.anchors.float(),
            pre_topk=self.pre_topk,
            post_count=self.post_train if train else self.post_eval,
            nms_iou=self.nms_iou, method=nms_method)
        b = x.shape[0]
        if train and gt_boxes is not None:
            if roi_rand is None:
                raise ValueError("a two-stage train forward with ground "
                                 "truth takes roi_rand, the RoI sample's "
                                 "priorities [B, post_train + M]")
            rois, labels, targets, pos, valid, roi_gt = \
                roi_ops.match_and_sample_rois(
                    roi_rand, props, prop_valid, gt_boxes, gt_labels,
                    num_samples=self.num_samples,
                    fg_fraction=self.fg_fraction, fg_iou=self.fg_iou)
            scores = torch.zeros(valid.shape, device=x.device)
        else:
            rois, valid, scores = props, prop_valid, prop_scores
            s = rois.shape[1]
            labels = torch.zeros(b, s, dtype=torch.int32, device=x.device)
            targets = torch.zeros(b, s, 4, dtype=rois.dtype,
                                  device=x.device)
            pos = torch.zeros(b, s, dtype=torch.bool, device=x.device)
            roi_gt = torch.zeros(b, s, dtype=torch.int32, device=x.device)
        crops = roi_ops.multilevel_roi_align(
            feats[:self.align_levels], rois, out_size=self.out_size,
            chunk=self.chunk)
        roi_cls, roi_reg = self.box_head(crops.to(x.dtype))
        return FRCNNOut(rpn_logits, rpn_loc, rois, valid, scores, roi_cls,
                        roi_reg, labels, targets, pos, roi_gt)


class FasterRCNN(_TwoStage):
    """``faster_rcnn`` on ``_frcnn512_trunk``: ``forward(x, ...)``: x [B,
    512, 512, 3] -> :class:`FRCNNOut` over 16320 RPN anchors."""

    def __init__(self, num_classes: int = 21, *, depth: int = 50,
                 fpn_channels: int = 256, fc_dim: int = 1024,
                 stem: str = "conv7", pre_topk: int = 2000,
                 post_train: int = 1000, post_eval: int = 300,
                 rpn_nms_iou: float = 0.7, num_samples: int = 512,
                 fg_fraction: float = 0.25, fg_iou: float = 0.5,
                 roi_chunk: int = 32):
        super().__init__()
        self.backbone = ResNetBackbone(depth, stem=stem)
        _, c3, c4, c5 = self.backbone.stage_channels
        self.fpn = FPN(c3, c4, c5, fpn_channels, levels=3)
        self._second_half(
            num_classes, fpn_channels, fc_dim, 7, FRCNN512_RPN_SPEC,
            align_levels=3, pre_topk=pre_topk, post_train=post_train,
            post_eval=post_eval, nms_iou=rpn_nms_iou,
            num_samples=num_samples, fg_fraction=fg_fraction, fg_iou=fg_iou,
            chunk=roi_chunk)

    def forward(self, x, gt_boxes=None, gt_labels=None, roi_rand=None,
                nms_method: str = "jacobi") -> FRCNNOut:
        _, c3, c4, c5 = self.backbone.stages(x)
        p3, p4, p5 = self.fpn(c3, c4, c5)
        feats = [p3, p4, p5, max_pool2d(p5, 1, 2)]
        sizes = tuple(f.shape[1] for f in feats)
        want = tuple(s[0] for s in FRCNN512_RPN_SPEC)
        if sizes != want:
            raise ValueError(f"pyramid {sizes} != RPN spec {want} — input "
                             "must be 512x512")
        return self._heads(x, feats, gt_boxes, gt_labels, roi_rand,
                           nms_method)


class TinyFRCNN(_TwoStage):
    """``tinyfrcnn`` on ``_tiny_trunk``: the CPU two-stage detector, 128 x
    128 input, levels 16, 8, 4, 1008 RPN anchors, 5x5 RoIAlign."""

    def __init__(self, num_classes: int = 21, *, width: int = 32,
                 fc_dim: int = 64, pre_topk: int = 256,
                 post_train: int = 128, post_eval: int = 64,
                 num_samples: int = 64, fg_fraction: float = 0.25):
        super().__init__()
        self.backbone, self.fpn = tiny_trunk(width)
        self._second_half(
            num_classes, 2 * width, fc_dim, 5, TINYFRCNN_RPN_SPEC,
            align_levels=3, pre_topk=pre_topk, post_train=post_train,
            post_eval=post_eval, nms_iou=0.7, num_samples=num_samples,
            fg_fraction=fg_fraction, fg_iou=0.5, chunk=64)

    def forward(self, x, gt_boxes=None, gt_labels=None, roi_rand=None,
                nms_method: str = "jacobi") -> FRCNNOut:
        feats = tiny_pyramid(self.backbone, self.fpn, x)
        sizes = tuple(f.shape[1] for f in feats)
        want = tuple(s[0] for s in TINYFRCNN_RPN_SPEC)
        if sizes != want:
            raise ValueError(f"pyramid {sizes} != RPN spec {want} — input "
                             "must be 128x128")
        return self._heads(x, feats, gt_boxes, gt_labels, roi_rand,
                           nms_method)


def faster_rcnn(num_classes: int = 21, **kwargs) -> FasterRCNN:
    return FasterRCNN(num_classes, **kwargs)


def tinyfrcnn(num_classes: int = 21, **kwargs) -> TinyFRCNN:
    return TinyFRCNN(num_classes, **kwargs)


for _fn, _hw, _spec in ((faster_rcnn, (512, 512), FRCNN512_RPN_SPEC),
                        (tinyfrcnn, (128, 128), TINYFRCNN_RPN_SPEC)):
    _fn.input_hw, _fn.rpn_spec, _fn.family = _hw, _spec, "two_stage"
