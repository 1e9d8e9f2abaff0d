"""Rotated FCOS head, NHWC.

Port of ``sm3det_tpu/models/dense_heads/rotated_fcos_head.py``:

- ``DistanceAnglePointCoder``: a point and (l, t, r, b, theta) <-> an
  oriented box;
- ``RotatedFCOSHead``: two towers of four 3x3 conv (no bias) + GroupNorm +
  ReLU, the 3x3 classifier (bias at the 0.01 prior), the distance
  regressor (ReLU of a per-level ``Scale``, times the stride), the angle
  regressor under one shared ``Scale`` and the centerness (both on the
  regression tower: ``centerness_on_reg``, ``scale_angle``);
- ``fcos_loss``: centre sampling (a point inside a gt's rotated box,
  within 1.5 strides of its centre in the gt's frame, its largest distance
  in the level's regression range; the least-area gt wins), sigmoid focal
  loss, the rotated IoU loss weighted by the centerness target and divided
  by its sum, and the centerness BCE, batched over images instead of
  ``vmap``;
- ``CSLRotatedFCOSHead`` / ``csl_fcos_loss``, the circular-smooth-label
  variant (``separate_angle``): the angle regressor becomes a classifier
  ``fcos_angle_cls`` of ``CSLCoder.coding_len`` bins (no angle ``Scale``);
  the same assignment; -log of the horizontal IoU of the (l, t, r, b)
  boxes around each point, weighted by the centerness target and divided
  by its sum; the smooth focal loss on the angle bins of the positives.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...core.bbox.angle_coder import CSLCoder
from ...core.bbox.assigners import _argmax_first
from ...ops.box_convert import norm_angle
from ...ops.nms import bbox_overlaps
from ..layers import Conv2d, GroupNorm, Scale
from ..losses import _clip, rotated_iou_loss, sigmoid_cross_entropy, \
    sigmoid_focal_loss

INF = 1e8
REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class DistanceAnglePointCoder:
    def __init__(self, angle_version: str = "le90"):
        self.version = angle_version

    def decode(self, points, pred):
        """points (..., 2) + pred (..., 5) = (l, t, r, b, theta) -> OBB."""
        l, t, r, b, theta = (pred[..., i] for i in range(5))
        cos_a, sin_a = torch.cos(theta), torch.sin(theta)
        dw, dh = (r - l) / 2.0, (b - t) / 2.0
        cx = points[..., 0] + cos_a * dw - sin_a * dh
        cy = points[..., 1] + sin_a * dw + cos_a * dh
        return torch.stack([cx, cy, l + r, t + b,
                            norm_angle(theta, self.version)], -1)

    def encode(self, points, obbs):
        """OBB -> (l, t, r, b, theta) of the point in the box's frame."""
        cx, cy, w, h, theta = (obbs[..., i] for i in range(5))
        cos_a, sin_a = torch.cos(theta), torch.sin(theta)
        dx, dy = points[..., 0] - cx, points[..., 1] - cy
        fx = cos_a * dx + sin_a * dy
        fy = -sin_a * dx + cos_a * dy
        return torch.stack([w / 2 + fx, h / 2 + fy, w / 2 - fx, h / 2 - fy,
                            theta], -1)


class RotatedFCOSHead(nn.Module):
    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 gn_groups: int = 32, gen: torch.Generator | None = None):
        super().__init__()
        self.strides, self.stacked_convs = tuple(strides), stacked_convs
        for tower in ("cls", "reg"):
            for i in range(stacked_convs):
                setattr(self, f"{tower}_conv{i}", Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1, bias=False, gen=gen))
                setattr(self, f"{tower}_gn{i}",
                        GroupNorm(gn_groups, feat_channels))
        self.fcos_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                               gen=gen, bias_init=PRIOR_BIAS)
        self.fcos_reg = Conv2d(feat_channels, 4, 3, padding=1, gen=gen)
        self.fcos_angle = Conv2d(feat_channels, 1, 3, padding=1, gen=gen)
        self.fcos_centerness = Conv2d(feat_channels, 1, 3, padding=1,
                                      gen=gen)
        for i in range(len(self.strides)):
            setattr(self, f"scale{i}", Scale(1.0))
        self.scale_angle = Scale(1.0)

    def _tower(self, x, tower):
        for i in range(self.stacked_convs):
            x = torch.relu(getattr(self, f"{tower}_gn{i}")(
                getattr(self, f"{tower}_conv{i}")(x)))
        return x

    def forward(self, feats):
        """Per level: (cls (B, H, W, C), distances (B, H, W, 4), angle
        (B, H, W, 1), centerness (B, H, W, 1))."""
        cls_scores, bbox_preds, angle_preds, centernesses = [], [], [], []
        for lvl, x in enumerate(feats):
            cf, rf = self._tower(x, "cls"), self._tower(x, "reg")
            cls_scores.append(self.fcos_cls(cf))
            bbox_preds.append(torch.relu(getattr(self, f"scale{lvl}")(
                self.fcos_reg(rf))) * self.strides[lvl])
            angle_preds.append(self.scale_angle(self.fcos_angle(rf)))
            centernesses.append(self.fcos_centerness(rf))
        return cls_scores, bbox_preds, angle_preds, centernesses


def _points(cls_scores, strides, device):
    """The level grids' points (P, 2), each point's stride and its level's
    regression range (P,)."""
    pts, stride, lo, hi = [], [], [], []
    for lvl, s in enumerate(cls_scores):
        h, w = s.shape[1:3]
        ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) \
            * strides[lvl]
        xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) \
            * strides[lvl]
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        for lst, v in ((stride, strides[lvl]), (lo, REGRESS_RANGES[lvl][0]),
                       (hi, REGRESS_RANGES[lvl][1])):
            lst.append(torch.full((h * w,), float(v), device=device))
    return (torch.cat(pts), torch.cat(stride), torch.cat(lo), torch.cat(hi))


def _fcos_targets(points, stride_vec, lo, hi, gt_obbs, gt_labels, gt_mask,
                  num_classes, center_sample_radius):
    """FCOS's centre sampling for a batch: (pos (B, P), the class targets
    (B, P), each point's gt (B, P, 5))."""
    cx, cy, w, h, th = (gt_obbs[..., None, :, i] for i in range(5))
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    dx = points[None, :, 0, None] - cx
    dy = points[None, :, 1, None] - cy
    fx = cos_t * dx + sin_t * dy
    fy = -sin_t * dx + cos_t * dy
    left, right = w / 2 + fx, w / 2 - fx
    top, bottom = h / 2 + fy, h / 2 - fy
    inside = (left > 0) & (right > 0) & (top > 0) & (bottom > 0)
    rad = center_sample_radius * stride_vec[None, :, None]
    in_center = (fx.abs() < rad) & (fy.abs() < rad)
    max_dist = torch.maximum(torch.maximum(left, right),
                             torch.maximum(top, bottom))
    in_range = (max_dist >= lo[None, :, None]) & \
        (max_dist <= hi[None, :, None])
    pos_matrix = inside & in_center & in_range & gt_mask[:, None, :]
    areas = torch.where(pos_matrix, w * h, torch.full_like(w * h, INF))
    min_area = areas.amin(-1)
    gt_idx = _argmax_first(-areas, -1)
    pos = min_area < INF
    cls_target = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx),
                             num_classes)
    tgt = torch.gather(gt_obbs, 1, gt_idx[..., None].expand(-1, -1, 5))
    return pos, cls_target, tgt


def _centerness_target(dist_t):
    lr = torch.stack([dist_t[..., 0], dist_t[..., 2]])
    tb = torch.stack([dist_t[..., 1], dist_t[..., 3]])
    return torch.sqrt(torch.clamp(
        (lr.amin(0) / torch.clamp(lr.amax(0), min=1e-6))
        * (tb.amin(0) / torch.clamp(tb.amax(0), min=1e-6)), 0, 1))


def fcos_loss(cls_scores, bbox_preds, angle_preds, centernesses, gt_obbs,
              gt_labels, gt_mask, num_classes: int,
              strides=(8, 16, 32, 64, 128), version: str = "le90",
              center_sample_radius: float = 1.5):
    """The FCOS losses of a batch: per-level outputs in fp32, gts (B, G, 5)
    with labels and mask (B, G). Returns dict(loss_cls, loss_bbox,
    loss_centerness)."""
    dev = cls_scores[0].device
    b, nc = cls_scores[0].shape[0], num_classes
    coder = DistanceAnglePointCoder(version)
    points, stride_vec, lo, hi = _points(cls_scores, strides, dev)
    flat_cls = torch.cat([s.reshape(b, -1, nc) for s in cls_scores], 1)
    flat_reg = torch.cat([p.reshape(b, -1, 4) for p in bbox_preds], 1)
    flat_ang = torch.cat([a.reshape(b, -1, 1) for a in angle_preds], 1)
    flat_ctr = torch.cat([c.reshape(b, -1) for c in centernesses], 1)
    pos, cls_target, tgt = _fcos_targets(
        points, stride_vec, lo, hi, gt_obbs, gt_labels, gt_mask, nc,
        center_sample_radius)
    l_cls = sigmoid_focal_loss(flat_cls.reshape(-1, nc),
                               cls_target.reshape(-1), avg_factor=1.0)
    dist_t = coder.encode(points[None], tgt)
    pred_obb = coder.decode(points[None], torch.cat([flat_reg, flat_ang], -1))
    ctr_t = _centerness_target(dist_t)
    # the IoU loss weighted by the centerness target, divided by its sum
    # (the reference's centerness_denorm), not by the positives
    ctr_w = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))
    l_box = rotated_iou_loss(pred_obb, tgt, weight=ctr_w, avg_factor=1.0)
    l_ctr = sigmoid_cross_entropy(flat_ctr, ctr_t, weight=pos.float(),
                                  avg_factor=1.0)
    total = torch.clamp(pos.sum().float(), min=1.0)
    denorm = torch.clamp(ctr_w.sum().detach(), min=1e-6)
    return {"loss_cls": l_cls / total, "loss_bbox": l_box / denorm,
            "loss_centerness": l_ctr / total}


class CSLRotatedFCOSHead(RotatedFCOSHead):
    """The CSL variant: ``fcos_angle_cls`` (``coding_len`` bins) in place
    of ``fcos_angle`` and ``scale_angle`` (the CSL config's
    ``scale_angle=False``)."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 gn_groups: int = 32, omega: int = 1,
                 angle_version: str = "le90",
                 gen: torch.Generator | None = None):
        super().__init__(num_classes, in_channels, feat_channels,
                         stacked_convs, strides, gn_groups, gen)
        del self.fcos_angle, self.scale_angle
        self.coding_len = CSLCoder(angle_version, omega=omega).coding_len
        self.fcos_angle_cls = Conv2d(feat_channels, self.coding_len, 3,
                                     padding=1, gen=gen)

    def forward(self, feats):
        """Per level: (cls, distances, angle bins (B, H, W, coding_len),
        centerness)."""
        cls_scores, bbox_preds, angle_clses, centernesses = [], [], [], []
        for lvl, x in enumerate(feats):
            cf, rf = self._tower(x, "cls"), self._tower(x, "reg")
            cls_scores.append(self.fcos_cls(cf))
            bbox_preds.append(torch.relu(getattr(self, f"scale{lvl}")(
                self.fcos_reg(rf))) * self.strides[lvl])
            angle_clses.append(self.fcos_angle_cls(rf))
            centernesses.append(self.fcos_centerness(rf))
        return cls_scores, bbox_preds, angle_clses, centernesses


def csl_fcos_loss(cls_scores, bbox_preds, angle_clses, centernesses,
                  gt_obbs, gt_labels, gt_mask, num_classes: int,
                  strides=(8, 16, 32, 64, 128), version: str = "le90",
                  omega: int = 1, center_sample_radius: float = 1.5):
    """The CSL-FCOS losses of a batch. Returns dict(loss_cls, loss_bbox,
    loss_angle, loss_centerness): the box loss is -log of the horizontal
    IoU, clipped to [1e-6, 1], divided by the centerness weights' sum; the
    angle loss the smooth focal loss of the positives' bins, divided by
    the positives' count."""
    from .rotated_retina_head import csl_angle_loss
    dev = cls_scores[0].device
    b, nc = cls_scores[0].shape[0], num_classes
    acoder = CSLCoder(version, omega=omega)
    coder = DistanceAnglePointCoder(version)
    points, stride_vec, lo, hi = _points(cls_scores, strides, dev)
    cl = acoder.coding_len
    flat_cls = torch.cat([s.reshape(b, -1, nc) for s in cls_scores], 1)
    flat_reg = torch.cat([p.reshape(b, -1, 4) for p in bbox_preds], 1)
    flat_ang = torch.cat([a.reshape(b, -1, cl) for a in angle_clses], 1)
    flat_ctr = torch.cat([c.reshape(b, -1) for c in centernesses], 1)
    pos, cls_target, tgt = _fcos_targets(
        points, stride_vec, lo, hi, gt_obbs, gt_labels, gt_mask, nc,
        center_sample_radius)
    posf = pos.float()
    l_cls = sigmoid_focal_loss(flat_cls.reshape(-1, nc),
                               cls_target.reshape(-1), avg_factor=1.0)
    dist_t = coder.encode(points[None], tgt)
    ctr_t = _centerness_target(dist_t)
    ctr_w = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))

    def to_hbb(d):
        return torch.stack([points[:, 0] - d[..., 0],
                            points[:, 1] - d[..., 1],
                            points[:, 0] + d[..., 2],
                            points[:, 1] + d[..., 3]], -1)
    iou = bbox_overlaps(to_hbb(flat_reg), to_hbb(dist_t[..., :4]),
                        aligned=True)
    l_box = (-torch.log(_clip(iou, 1e-6, 1.0)) * ctr_w).sum()
    l_ang = csl_angle_loss(flat_ang, tgt[..., 4], posf, acoder,
                           avg_factor=1.0)
    l_ctr = sigmoid_cross_entropy(flat_ctr, ctr_t, weight=posf,
                                  avg_factor=1.0)
    total = torch.clamp(pos.sum().float(), min=1.0)
    denorm = torch.clamp(ctr_w.sum().detach(), min=1e-6)
    return {"loss_cls": l_cls / total, "loss_bbox": l_box / denorm,
            "loss_angle": l_ang / total, "loss_centerness": l_ctr / total}
