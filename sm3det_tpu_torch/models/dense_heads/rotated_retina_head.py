"""Rotated RetinaNet head (mmrotate ``RotatedRetinaHead``), NHWC.

Port of ``sm3det_tpu/models/dense_heads/rotated_retina_head.py``, the
RGB / infrared branch of the R1 TriSource variants and the head of the
single-dataset ``RotatedRetinaNet``: ``RotatedRetinaHead`` (four 3x3 conv
+ ReLU layers a tower, then the 3x3 classifier, its bias at the 0.01
prior, and the 3x3 regressor; 9 anchors a cell), the anchor generator and
coder of the retina recipe, ``retina_loss`` (MaxIoU on rotated IoU over
all anchors, sigmoid focal loss, L1 or Smooth L1 on the deltas, or a
decoded-box loss: GWD, KLD, KFIoU or the rotated IoU loss) and
``retina_get_bboxes`` (per-level top-k by best class score, decode,
multi-class rotated NMS), batched over images instead of ``vmap``; and the
circular-smooth-label variant ``CSLRetinaHead`` (4 box parameters and an
angle classifier ``retina_angle_cls`` of ``CSLCoder.coding_len`` bins an
anchor on the regression tower) with ``csl_angle_loss`` (the smooth focal
loss against the coder's labels). JAX has no combined CSL retina loss, and
the port adds none.

The assigner's IoU of every anchor with every gt is
``ops/rotated_iou.box_iou_rotated_chunked``: the rotated IoU kernel's
matrix mode on the card, one launch for the batch. The NMS is
``ops/nms.py::multiclass_nms_rotated`` (the banded mask mode and the keep
scan on the card).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
from torch import nn

from ...core.anchor import RotatedAnchorGenerator
from ...core.bbox.angle_coder import CSLCoder
from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.coders import DeltaXYWHAOBBoxCoder
from ...ops.nms import _take, _topk_scores, multiclass_nms_rotated
from ...ops.rotated_iou import box_iou_rotated_chunked
from ..layers import Conv2d
from ..losses import (gwd_loss, kfiou_loss, kld_loss, l1_loss,
                      rotated_iou_loss, sigmoid_focal_loss, smooth_focal_loss,
                      smooth_l1_loss)

REG_LOSSES = ("l1", "smooth_l1", "gwd", "kld", "kfiou", "riou")

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def build_retina_layers(module: nn.Module, num_classes: int,
                        in_channels: int, feat_channels: int,
                        stacked_convs: int, num_anchors: int, box_dim: int,
                        gen: torch.Generator | None):
    """The layers of a RetinaNet head, as attributes of ``module``:
    ``cls_conv{i}``, ``reg_conv{i}``, ``retina_cls`` and ``retina_reg``
    (the names of the flax head)."""
    for tower in ("cls", "reg"):
        for i in range(stacked_convs):
            setattr(module, f"{tower}_conv{i}", Conv2d(
                in_channels if i == 0 else feat_channels, feat_channels, 3,
                padding=1, gen=gen))
    module.retina_cls = Conv2d(feat_channels, num_anchors * num_classes, 3,
                               padding=1, gen=gen, bias_init=PRIOR_BIAS)
    module.retina_reg = Conv2d(feat_channels, num_anchors * box_dim, 3,
                               padding=1, gen=gen)
    module.stacked_convs = stacked_convs


def retina_forward(module: nn.Module, feats: Sequence[torch.Tensor]):
    """The towers of ``build_retina_layers`` on each level: (cls, reg)
    lists of (B, H, W, A C) and (B, H, W, A box_dim)."""
    cls_scores, bbox_preds = [], []
    for x in feats:
        cf = rf = x
        for i in range(module.stacked_convs):
            cf = torch.relu(getattr(module, f"cls_conv{i}")(cf))
        for i in range(module.stacked_convs):
            rf = torch.relu(getattr(module, f"reg_conv{i}")(rf))
        cls_scores.append(module.retina_cls(cf))
        bbox_preds.append(module.retina_reg(rf))
    return cls_scores, bbox_preds


class RotatedRetinaHead(nn.Module):
    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_anchors: int = 9, gen: torch.Generator | None = None):
        super().__init__()
        build_retina_layers(self, num_classes, in_channels, feat_channels,
                            stacked_convs, num_anchors, 5, gen)

    def forward(self, feats: Sequence[torch.Tensor]):
        return retina_forward(self, feats)


class CSLRetinaHead(nn.Module):
    """The circular-smooth-label variant: the regressor predicts 4 box
    parameters an anchor and ``retina_angle_cls`` (3x3, on the regression
    tower) the angle's ``coding_len`` bins an anchor."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_anchors: int = 9, omega: int = 1,
                 angle_version: str = "le90",
                 gen: torch.Generator | None = None):
        super().__init__()
        build_retina_layers(self, num_classes, in_channels, feat_channels,
                            stacked_convs, num_anchors, 4, gen)
        self.coding_len = CSLCoder(angle_version, omega=omega).coding_len
        self.retina_angle_cls = Conv2d(feat_channels,
                                       num_anchors * self.coding_len, 3,
                                       padding=1, gen=gen)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level: (cls (B, H, W, A C), box (B, H, W, A 4), angle bins
        (B, H, W, A coding_len))."""
        cls_scores, bbox_preds, angle_clses = [], [], []
        for x in feats:
            cf = rf = x
            for i in range(self.stacked_convs):
                cf = torch.relu(getattr(self, f"cls_conv{i}")(cf))
            for i in range(self.stacked_convs):
                rf = torch.relu(getattr(self, f"reg_conv{i}")(rf))
            cls_scores.append(self.retina_cls(cf))
            bbox_preds.append(self.retina_reg(rf))
            angle_clses.append(self.retina_angle_cls(rf))
        return cls_scores, bbox_preds, angle_clses


def csl_angle_loss(angle_cls, angle_targets, pos_weight, coder: CSLCoder,
                   avg_factor=1.0, gamma=2.0, alpha=0.25):
    """The smooth focal loss of CSL logits (..., coding_len) against the
    coder's labels of ``angle_targets`` (...,), each row weighted by
    ``pos_weight`` (...,); the sum over every element / ``avg_factor``."""
    return smooth_focal_loss(angle_cls, coder.encode(angle_targets),
                             gamma=gamma, alpha=alpha,
                             weight=pos_weight[..., None],
                             avg_factor=avg_factor)


@functools.lru_cache(maxsize=None)
def make_retina_anchor_generator(strides=(8, 16, 32, 64, 128)):
    """octave_base_scale 4, 3 scales an octave, ratios (0.5, 1, 2); made
    once (it keeps the grids it has made on a device)."""
    return RotatedAnchorGenerator(strides=strides, ratios=[0.5, 1.0, 2.0],
                                  octave_base_scale=4, scales_per_octave=3)


def make_retina_coder(version="le90"):
    """The retina family's delta coder: every target std 1.0."""
    return DeltaXYWHAOBBoxCoder(
        angle_range=version, target_means=(0.,) * 5,
        target_stds=(1., 1., 1., 1., 1.), edge_swap=True, proj_xy=True)


def retina_loss(cls_scores, bbox_preds, gt_obbs, gt_labels, gt_mask,
                anchor_generator: RotatedAnchorGenerator,
                coder: DeltaXYWHAOBBoxCoder, num_classes: int,
                pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                min_pos_iou: float = 0.0, beta: float = 0.11,
                reg_loss: str = "smooth_l1"):
    """Focal + regression loss over every anchor of a batch: per-level
    outputs in fp32, gts (B, G, 5) with labels and mask (B, G).
    ``reg_loss``: ``"l1"`` or ``"smooth_l1"`` (``beta``) on the deltas,
    or on the boxes decoded from them: ``"gwd"``, ``"kld"``, ``"kfiou"``
    (with Smooth L1 on the centre deltas) or ``"riou"`` (-log of the
    rotated IoU). Returns dict(loss_cls, loss_bbox), each divided by the
    batch's count of positives."""
    if reg_loss not in REG_LOSSES:
        raise ValueError(f"retina reg_loss {reg_loss!r}: one of "
                         f"{REG_LOSSES}")
    dev = cls_scores[0].device
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors = torch.cat(anchor_generator.grid_anchors(featmap_sizes,
                                                      device=dev), dim=0)
    b = cls_scores[0].shape[0]
    flat_cls = torch.cat([s.reshape(b, -1, num_classes) for s in cls_scores],
                         dim=1)
    flat_reg = torch.cat([p.reshape(b, -1, 5) for p in bbox_preds], dim=1)
    ious_all = box_iou_rotated_chunked(
        anchors.expand((b,) + anchors.shape), gt_obbs)
    l_cls = l_reg = 0.0
    n_pos = 0
    for i in range(b):
        gts, mask = gt_obbs[i], gt_mask[i]
        ious = torch.where(mask[None, :], ious_all[i],
                           torch.full_like(ious_all[i], -1.0))
        assigned = max_iou_assign(
            ious, mask, pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
            min_pos_iou=min_pos_iou, match_low_quality=True)
        pos, neg = assigned > 0, assigned == 0
        gt_idx = torch.clamp(assigned.long() - 1, min=0)
        cls_target = torch.where(pos, gt_labels[i][gt_idx].long(),
                                 num_classes)
        l_cls = l_cls + sigmoid_focal_loss(
            flat_cls[i], cls_target, weight=(pos | neg).float(),
            avg_factor=1.0)
        l_reg = l_reg + _reg_loss(reg_loss, flat_reg[i], anchors,
                                  gts[gt_idx], pos, coder, beta)
        n_pos = n_pos + pos.sum()
    total = torch.clamp(torch.as_tensor(n_pos, device=dev).float(), min=1.0)
    return {"loss_cls": l_cls / total, "loss_bbox": l_reg / total}


def _reg_loss(kind, reg, anchors, target_obbs, pos, coder, beta):
    """One image's summed box loss of ``kind`` over its positives."""
    if kind in ("l1", "smooth_l1"):
        targets = coder.encode(anchors, target_obbs)
        w = pos[:, None].float()
        if kind == "l1":
            return l1_loss(reg, targets, weight=w, avg_factor=1.0)
        return smooth_l1_loss(reg, targets, beta=beta, weight=w,
                              avg_factor=1.0)
    decoded = coder.decode(anchors, reg)
    w = pos.float()
    if kind == "gwd":
        return gwd_loss(decoded, target_obbs, weight=w, avg_factor=1.0)
    if kind == "kld":
        return kld_loss(decoded, target_obbs, weight=w, avg_factor=1.0)
    if kind == "kfiou":
        return kfiou_loss(reg, coder.encode(anchors, target_obbs), decoded,
                          target_obbs, weight=w, avg_factor=1.0)
    return rotated_iou_loss(decoded, target_obbs, weight=w, avg_factor=1.0)


def retina_get_bboxes(cls_scores, bbox_preds,
                      anchor_generator: RotatedAnchorGenerator,
                      coder: DeltaXYWHAOBBoxCoder, num_classes: int,
                      img_shape, nms_pre: int = 2000,
                      score_thr: float = 0.05, iou_thr: float = 0.1,
                      max_per_img: int = 2000):
    """Per level the top ``nms_pre`` anchors by their best class score,
    decoded; then multi-class rotated NMS over the candidates of all
    levels. Returns (dets (B, max_per_img, 6), labels, valid)."""
    dev = cls_scores[0].device
    b = cls_scores[0].shape[0]
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors_l = anchor_generator.grid_anchors(featmap_sizes, device=dev)
    cand_boxes, cand_scores = [], []
    for lvl, (cls_s, reg_s) in enumerate(zip(cls_scores, bbox_preds)):
        scores = torch.sigmoid(cls_s.reshape(b, -1, num_classes))
        k = min(nms_pre, scores.shape[1])
        _, top_idx = _topk_scores(scores.amax(dim=-1), k)
        cand_boxes.append(coder.decode(
            anchors_l[lvl][top_idx], _take(reg_s.reshape(b, -1, 5), top_idx)))
        cand_scores.append(_take(scores, top_idx))
    boxes = torch.cat(cand_boxes, dim=1)
    scores = torch.cat(cand_scores, dim=1)
    scores = torch.cat([scores, scores.new_zeros(scores.shape[:2] + (1,))],
                       dim=-1)
    return multiclass_nms_rotated(
        boxes, scores, score_thr=score_thr, iou_thr=iou_thr,
        max_num=max_per_img, pre_nms=min(2000, boxes.shape[1]))
