"""GFL head (Generalized Focal Loss), inference, NHWC.

Port of ``sm3det_tpu/models/dense_heads/gfl_head.py``: ``GFLHead`` (4 stacked
conv3x3 + GroupNorm(32) + ReLU per tower, flax's GroupNorm eps 1e-6),
``integral`` and ``gfl_get_bboxes`` (sigmoid, decode with clamp, top
``nms_pre`` per level, ``multiclass_nms``), batched over images instead of
``vmap``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...core.anchor import AnchorGenerator
from ...core.bbox.coders import DistancePointBBoxCoder
from ...ops.nms import _topk_scores, multiclass_nms
from ..layers import Conv2d, GroupNorm, Scale


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


def gfl_get_bboxes(cls_scores, bbox_preds,
                   anchor_generator: AnchorGenerator, num_classes: int,
                   img_shape, reg_max: int = 16,
                   strides: Sequence[int] = (8, 16, 32, 64, 128),
                   nms_pre: int = 1000, score_thr: float = 0.05,
                   iou_thr: float = 0.6, max_per_img: int = 100):
    """Static test-time decode + NMS (mmdet ``GFLHead.get_bboxes``).

    Returns batched (dets (B, max_per_img, 5) xyxy+score, labels, valid).
    """
    dev = cls_scores[0].device
    b = cls_scores[0].shape[0]
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors_l = anchor_generator.grid_anchors(featmap_sizes, device=dev)
    coder = DistancePointBBoxCoder()
    cand_boxes, cand_scores = [], []
    for lvl, (cls_s, reg_s) in enumerate(zip(cls_scores, bbox_preds)):
        a = anchors_l[lvl]
        scores = torch.sigmoid(cls_s.reshape(b, -1, num_classes))
        dist = integral(reg_s.reshape(b, -1, 4 * (reg_max + 1)), reg_max) \
            * strides[lvl]
        centers = torch.stack([(a[:, 0] + a[:, 2]) / 2,
                               (a[:, 1] + a[:, 3]) / 2], dim=-1)
        boxes = coder.decode(centers[None], dist, max_shape=img_shape)
        k = min(nms_pre, scores.shape[1])
        _, top_idx = _topk_scores(scores.max(dim=-1).values, k)
        cand_boxes.append(torch.gather(
            boxes, 1, top_idx[..., None].expand(-1, -1, 4)))
        cand_scores.append(torch.gather(
            scores, 1, top_idx[..., None].expand(-1, -1, num_classes)))
    boxes = torch.cat(cand_boxes, dim=1)
    scores = torch.cat(cand_scores, dim=1)
    pad = torch.zeros(scores.shape[:2] + (1,), dtype=scores.dtype,
                      device=dev)
    return multiclass_nms(boxes, torch.cat([scores, pad], dim=-1),
                          score_thr=score_thr, iou_thr=iou_thr,
                          max_num=max_per_img)
