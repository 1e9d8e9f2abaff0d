"""Horizontal RPN head (mmdet ``RPNHead``), NHWC.

Port of ``sm3det_tpu/models/dense_heads/rpn_head.py``, the SAR branch of
the H2 TriSource variants and the first stage of the horizontal Faster /
Cascade R-CNN: ``RPNHead`` (3x3 conv + ReLU, 1x1 objectness and 1x1
four-delta regression per anchor), ``hbb_rpn_loss`` (MaxIoU on horizontal
IoU, random sampling, BCE + Smooth L1) and ``hbb_rpn_get_proposals``
(per-level top-k and decode, then one NMS over all levels kept apart by a
coordinate offset), batched over images instead of ``vmap``. The NMS is
``ops/nms.py::nms``: the horizontal IoU kernel's mask mode and the keep
scan on the card.
"""

from __future__ import annotations

import torch

from ...core.anchor import AnchorGenerator
from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.coders import DeltaXYWHBBoxCoder
from ...core.bbox.samplers import random_sample
from ...ops.nms import _take, _topk_scores, bbox_overlaps, nms
from ..losses import sigmoid_cross_entropy, smooth_l1_loss
from .oriented_rpn_head import OrientedRPNHead


class RPNHead(OrientedRPNHead):
    """``rpn_conv``, ``rpn_cls`` and ``rpn_reg`` (4 deltas an anchor)."""

    box_dim = 4


def hbb_rpn_loss(sample_keys, cls_scores, bbox_preds, gt_bboxes, gt_mask,
                 anchor_generator: AnchorGenerator, coder: DeltaXYWHBBoxCoder,
                 num_sample: int = 256, pos_fraction: float = 0.5,
                 pos_iou_thr: float = 0.7, neg_iou_thr: float = 0.3,
                 min_pos_iou: float = 0.3):
    """Horizontal RPN loss over a batch: per-level outputs in fp32, gts
    (B, G, 4) xyxy with mask (B, G). ``sample_keys``: (key_pos, key_neg),
    each (B, A) uniform keys of the sampler. The anchors' IoU with the gts
    is the plain ``bbox_overlaps``. Returns dict(loss_rpn_cls,
    loss_rpn_bbox)."""
    dev = cls_scores[0].device
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors = torch.cat(anchor_generator.grid_anchors(featmap_sizes,
                                                      device=dev), dim=0)
    b = cls_scores[0].shape[0]
    flat_cls = torch.cat([s.reshape(b, -1) for s in cls_scores], dim=1)
    flat_reg = torch.cat([p.reshape(b, -1, 4) for p in bbox_preds], dim=1)
    key_pos, key_neg = sample_keys
    l_cls = l_reg = 0.0
    n_valid = 0
    for i in range(b):
        gts, mask = gt_bboxes[i], gt_mask[i]
        ious = bbox_overlaps(anchors, gts)
        ious = torch.where(mask[None, :], ious, torch.full_like(ious, -1.0))
        assigned = max_iou_assign(
            ious, mask, pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
            min_pos_iou=min_pos_iou, match_low_quality=True)
        sample = random_sample(key_pos[i], key_neg[i], assigned, num_sample,
                               pos_fraction)
        inds, pos_m = sample["inds"], sample["pos_mask"]
        valid = pos_m | sample["neg_mask"]
        gt_idx = torch.clamp(assigned[inds].long() - 1, min=0)
        targets = coder.encode(anchors[inds], gts[gt_idx])
        l_cls = l_cls + sigmoid_cross_entropy(
            flat_cls[i][inds], pos_m.float(), weight=valid.float(),
            avg_factor=1.0)
        l_reg = l_reg + smooth_l1_loss(
            flat_reg[i][inds], targets, beta=1.0 / 9.0,
            weight=pos_m[:, None].float(), avg_factor=1.0)
        n_valid = n_valid + valid.sum()
    total = torch.clamp(torch.as_tensor(n_valid, device=dev).float(),
                        min=1.0)
    return {"loss_rpn_cls": l_cls / total, "loss_rpn_bbox": l_reg / total}


def hbb_rpn_get_proposals(cls_scores, bbox_preds,
                          anchor_generator: AnchorGenerator,
                          coder: DeltaXYWHBBoxCoder, img_shape,
                          nms_pre: int = 2000, max_per_img: int = 2000,
                          iou_thr: float = 0.7):
    """Per-level top-k and decode (clipped to ``img_shape`` when given),
    then one NMS over the candidates of all levels, each level shifted by
    ``level * 2 * (max |box| + 1)`` so that levels never suppress each
    other. Returns (proposals (B, max_per_img, 4) xyxy, scores, valid)."""
    dev = cls_scores[0].device
    b = cls_scores[0].shape[0]
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors_l = anchor_generator.grid_anchors(featmap_sizes, device=dev)
    boxes_all, scores_all, levels = [], [], []
    for lvl, (cls_s, reg_s) in enumerate(zip(cls_scores, bbox_preds)):
        scores = torch.sigmoid(cls_s.reshape(b, -1))
        k = min(nms_pre, scores.shape[1])
        top_vals, top_idx = _topk_scores(scores, k)
        boxes_all.append(coder.decode(
            anchors_l[lvl][top_idx], _take(reg_s.reshape(b, -1, 4), top_idx),
            max_shape=img_shape))
        scores_all.append(top_vals)
        levels.append(torch.full((k,), float(lvl), device=dev))
    boxes = torch.cat(boxes_all, dim=1)
    scores = torch.cat(scores_all, dim=1)
    max_coord = boxes.abs().amax(dim=(1, 2)) + 1.0
    shift = torch.cat(levels)[None, :] * 2 * max_coord[:, None]
    _, idx, valid = nms(boxes + shift[..., None], scores, iou_thr,
                        max_out=max_per_img)
    safe = torch.where(idx >= 0, idx, 0)
    out_boxes = torch.where(valid[..., None], _take(boxes, safe), 0.0)
    out_scores = torch.where(valid, _take(scores, safe), 0.0)
    return out_boxes, out_scores, valid
