"""GFL head (Generalized Focal Loss), NHWC.

Port of ``sm3det_tpu/models/dense_heads/gfl_head.py``: ``GFLHead`` (4 stacked
conv3x3 + GroupNorm(32) + ReLU per tower, flax's GroupNorm eps 1e-6),
``integral``, ``gfl_get_bboxes`` (sigmoid, decode with clamp, top
``nms_pre`` per level, ``multiclass_nms``), batched over images instead of
``vmap``, and ``gfl_loss`` (ATSS assignment, QFL + GIoU + DFL), image by
image.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
from torch import nn

from ...core.anchor import AnchorGenerator
from ...core.bbox.assigners import atss_assign
from ...core.bbox.coders import DistancePointBBoxCoder
from ...ops.nms import _topk_scores, bbox_overlaps, multiclass_nms
from ..layers import Conv2d, GroupNorm, Scale
from ..losses import distribution_focal_loss, giou_loss, quality_focal_loss


class GFLHead(nn.Module):
    def __init__(self, num_classes: int = 26, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 reg_max: int = 16,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 gn_groups: int = 32, gen: torch.Generator | None = None):
        super().__init__()
        self.stacked_convs = stacked_convs
        self.n_levels = len(strides)
        for tower in ("cls", "reg"):
            for i in range(stacked_convs):
                cin = in_channels if i == 0 else feat_channels
                setattr(self, f"{tower}_conv{i}", Conv2d(
                    cin, feat_channels, 3, padding=1, bias=False, gen=gen))
                setattr(self, f"{tower}_gn{i}",
                        GroupNorm(gn_groups, feat_channels))
        prior = -math.log((1 - 0.01) / 0.01)
        self.gfl_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                              gen=gen, bias_init=prior)
        self.gfl_reg = Conv2d(feat_channels, 4 * (reg_max + 1), 3,
                              padding=1, gen=gen)
        for i in range(self.n_levels):
            setattr(self, f"scale{i}", Scale(1.0))

    def _tower(self, x, tower):
        for i in range(self.stacked_convs):
            x = getattr(self, f"{tower}_conv{i}")(x)
            x = torch.relu(getattr(self, f"{tower}_gn{i}")(x))
        return x

    def forward(self, feats):
        """feats: list of (B, H, W, C) -> (cls_scores, bbox_preds) lists of
        (B, H, W, num_classes) and (B, H, W, 4 * (reg_max + 1))."""
        cls_scores, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            cls_scores.append(self.gfl_cls(self._tower(x, "cls")))
            bbox_preds.append(getattr(self, f"scale{lvl}")(
                self.gfl_reg(self._tower(x, "reg"))))
        return cls_scores, bbox_preds


def integral(reg_logits, reg_max: int):
    """Distribution -> scalar distances (mmdet ``Integral``)."""
    p = torch.softmax(
        reg_logits.reshape(reg_logits.shape[:-1] + (4, reg_max + 1)), dim=-1)
    proj = torch.arange(reg_max + 1, dtype=p.dtype, device=p.device)
    return torch.sum(p * proj, dim=-1)


def gfl_loss(cls_scores, bbox_preds, gt_bboxes, gt_labels, gt_mask,
             anchor_generator: AnchorGenerator, num_classes: int,
             reg_max: int = 16, strides: Sequence[int] = (8, 16, 32, 64, 128),
             atss_topk: int = 9, loss_weights=(1.0, 2.0, 0.25)):
    """GFL training loss over a batch: per-level head outputs (B, H, W, .)
    in fp32, gts (B, G, 4) xyxy with labels (B, G) and mask (B, G).

    The quality targets (IoU of the decoded boxes with their targets) and
    the box weights (the max class probability) come from detached outputs.
    Returns dict(loss_cls, loss_bbox, loss_dfl).
    """
    dev = cls_scores[0].device
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors_l = anchor_generator.grid_anchors(featmap_sizes, device=dev)
    num_level = [a.shape[0] for a in anchors_l]
    anchors = torch.cat(anchors_l, dim=0)
    centers = torch.stack([(anchors[:, 0] + anchors[:, 2]) / 2,
                           (anchors[:, 1] + anchors[:, 3]) / 2], dim=-1)
    stride_per_anchor = torch.cat([
        torch.full((n,), float(s), device=dev)
        for n, s in zip(num_level, strides)])[:, None]
    b = cls_scores[0].shape[0]
    flat_cls = torch.cat([s.reshape(b, -1, num_classes) for s in cls_scores],
                         dim=1)
    flat_reg = torch.cat([p.reshape(b, -1, 4 * (reg_max + 1))
                          for p in bbox_preds], dim=1)
    coder = DistancePointBBoxCoder()
    centers_s = centers / stride_per_anchor
    l_cls = l_box = l_dfl = 0.0
    n_pos = w_sum = 0.0
    for i in range(b):
        cls_s, reg_s, gts = flat_cls[i], flat_reg[i], gt_bboxes[i]
        ious = bbox_overlaps(anchors, gts)
        assigned, _ = atss_assign(ious, centers, gts, gt_mask[i], num_level,
                                  topk=atss_topk)
        pos = assigned > 0
        gt_idx = torch.clamp(assigned.long() - 1, min=0)
        anchor_labels = torch.where(pos, gt_labels[i][gt_idx].long(),
                                    num_classes)
        target_s = gts[gt_idx] / stride_per_anchor
        decoded = coder.decode(centers_s, integral(reg_s, reg_max))
        q = bbox_overlaps(decoded.detach(), target_s, aligned=True)
        q = torch.where(pos, q, torch.zeros_like(q))
        w = torch.sigmoid(cls_s.detach()).amax(dim=-1)
        w = torch.where(pos, w, torch.zeros_like(w))
        l_cls = l_cls + quality_focal_loss(
            cls_s, anchor_labels, q, beta=2.0, weight=torch.ones_like(w),
            avg_factor=1.0)
        l_box = l_box + giou_loss(decoded, target_s, weight=w,
                                  avg_factor=1.0)
        corner_targets = coder.encode(centers_s, target_s, max_dis=reg_max,
                                      eps=0.1)
        l_dfl = l_dfl + distribution_focal_loss(
            reg_s.reshape(-1, reg_max + 1), corner_targets.reshape(-1),
            weight=torch.repeat_interleave(w, 4) / 4.0, avg_factor=1.0)
        n_pos = n_pos + pos.sum()
        w_sum = w_sum + w.sum()
    total_pos = torch.clamp(torch.as_tensor(n_pos, device=dev).float(),
                            min=1.0)
    total_w = torch.clamp(torch.as_tensor(w_sum, device=dev).float(),
                          min=1e-4)
    return {"loss_cls": loss_weights[0] * l_cls / total_pos,
            "loss_bbox": loss_weights[1] * l_box / total_w,
            "loss_dfl": loss_weights[2] * l_dfl / total_w}


@functools.lru_cache(maxsize=16)
def _level_strides(counts: tuple, strides: tuple, dtype, device):
    """(sum(counts), 1): each candidate's level stride, made once."""
    return torch.cat([torch.full((k, 1), float(st), dtype=dtype,
                                 device=device)
                      for k, st in zip(counts, strides)])


def gfl_get_bboxes(cls_scores, bbox_preds,
                   anchor_generator: AnchorGenerator, num_classes: int,
                   img_shape, reg_max: int = 16,
                   strides: Sequence[int] = (8, 16, 32, 64, 128),
                   nms_pre: int = 1000, score_thr: float = 0.05,
                   iou_thr: float = 0.6, max_per_img: int = 100):
    """Static test-time decode + NMS (mmdet ``GFLHead.get_bboxes``).

    The top ``nms_pre`` anchors of each level by their best class score
    are the candidates; they are decoded together after the selection (the
    integral and the decode work anchor by anchor, so this gives the values
    of decoding every anchor, with a fifth of the launches).

    Returns batched (dets (B, max_per_img, 5) xyxy+score, labels, valid).
    """
    dev = cls_scores[0].device
    b = cls_scores[0].shape[0]
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors_l = anchor_generator.grid_anchors(featmap_sizes, device=dev)
    cand_anchors, cand_reg, cand_scores, counts = [], [], [], []
    for lvl, (cls_s, reg_s) in enumerate(zip(cls_scores, bbox_preds)):
        scores = torch.sigmoid(cls_s.reshape(b, -1, num_classes))
        k = min(nms_pre, scores.shape[1])
        _, top_idx = _topk_scores(scores.max(dim=-1).values, k)
        cand_anchors.append(anchors_l[lvl][top_idx])
        cand_reg.append(torch.gather(
            reg_s.reshape(b, -1, 4 * (reg_max + 1)), 1,
            top_idx[..., None].expand(-1, -1, 4 * (reg_max + 1))))
        cand_scores.append(torch.gather(
            scores, 1, top_idx[..., None].expand(-1, -1, num_classes)))
        counts.append(k)
    a = torch.cat(cand_anchors, dim=1)
    reg = torch.cat(cand_reg, dim=1)
    dist = integral(reg, reg_max) * _level_strides(
        tuple(counts), tuple(strides), reg.dtype, dev)
    centers = torch.stack([(a[..., 0] + a[..., 2]) / 2,
                           (a[..., 1] + a[..., 3]) / 2], dim=-1)
    boxes = DistancePointBBoxCoder().decode(centers, dist,
                                            max_shape=img_shape)
    scores = torch.cat(cand_scores, dim=1)
    pad = torch.zeros(scores.shape[:2] + (1,), dtype=scores.dtype,
                      device=dev)
    return multiclass_nms(boxes, torch.cat([scores, pad], dim=-1),
                          score_thr=score_thr, iou_thr=iou_thr,
                          max_num=max_per_img)
