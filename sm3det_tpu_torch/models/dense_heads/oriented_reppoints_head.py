"""Oriented RepPoints head, NHWC.

Port of ``sm3det_tpu/models/dense_heads/oriented_reppoints_head.py``:

- ``OrientedRepPointsHead``: two towers of three 3x3 conv (no bias) +
  GroupNorm + ReLU; the classifier (bias at the 0.01 prior) on the class
  tower; the init offsets of 9 points and the refine offsets (plus the
  init offsets, detached) on the regression tower;
- ``points_to_obbs``: offsets around each location, times its stride, ->
  the points' least-area rectangle (``ops/geometry_extras``) -> an OBB;
- ``reppoints_loss``: the init stage assigned to the nearest gt whose
  rotated box holds the location, the refine stage by MaxIoU of the init
  boxes (no gradient) against the gts, both with the linear rotated IoU
  loss; the sigmoid focal loss on the refine assignment. Batched over
  images instead of ``vmap``: the refine assignment's IoU is one
  ``box_iou_rotated_chunked`` for the batch (row 5's matrix mode on the
  card).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...core.bbox.assigners import _argmax_first, max_iou_assign
from ...ops.box_convert import poly2obb
from ...ops.geometry_extras import min_area_polygons
from ...ops.rotated_iou import box_iou_rotated_chunked
from ..layers import Conv2d, GroupNorm
from ..losses import rotated_iou_loss, sigmoid_focal_loss

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
STRIDES = (8, 16, 32, 64, 128)


class OrientedRepPointsHead(nn.Module):
    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, num_points: int = 9,
                 stacked_convs: int = 3, gn_groups: int = 32,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.stacked_convs = stacked_convs
        for tower in ("cls", "reg"):
            for i in range(stacked_convs):
                setattr(self, f"{tower}_conv{i}", Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1, bias=False, gen=gen))
                setattr(self, f"{tower}_gn{i}",
                        GroupNorm(gn_groups, feat_channels))
        p2 = 2 * num_points
        self.reppoints_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                                    gen=gen, bias_init=PRIOR_BIAS)
        self.reppoints_init = Conv2d(feat_channels, p2, 3, padding=1,
                                     gen=gen)
        self.reppoints_refine = Conv2d(feat_channels, p2, 3, padding=1,
                                       gen=gen)

    def _tower(self, x, tower):
        for i in range(self.stacked_convs):
            x = torch.relu(getattr(self, f"{tower}_gn{i}")(
                getattr(self, f"{tower}_conv{i}")(x)))
        return x

    def forward(self, feats: Sequence[torch.Tensor]):
        """(cls, init offsets, refine offsets), each a list over levels of
        (B, H, W, C) / (B, H, W, 2 P)."""
        cls_s, init_s, refine_s = [], [], []
        for x in feats:
            cf, rf = self._tower(x, "cls"), self._tower(x, "reg")
            init_off = self.reppoints_init(rf)
            cls_s.append(self.reppoints_cls(cf))
            init_s.append(init_off)
            refine_s.append(self.reppoints_refine(rf) + init_off.detach())
        return cls_s, init_s, refine_s


def offsets_to_points(offsets, centers, stride):
    """offsets (..., N, 2 P) around centers (N, 2), scaled by each
    location's stride (N,) -> the points (..., N, P, 2)."""
    n = offsets.shape[-2]
    return offsets.reshape(offsets.shape[:-1] + (-1, 2)) * \
        stride.reshape(n, 1, 1) + centers[:, None, :]


def points_to_obbs(offsets, centers, stride, version: str = "le90"):
    """(the points' least-area OBBs (..., N, 5), the points (..., N, P,
    2)) of :func:`offsets_to_points`."""
    pts = offsets_to_points(offsets, centers, stride)
    return poly2obb(min_area_polygons(pts), version), pts


def level_points(cls_scores, strides, device):
    """The locations (P, 2) of every level's cells (centres at half
    strides) and each one's stride (P,)."""
    centers, stride = [], []
    for lvl, s in enumerate(cls_scores):
        h, w = s.shape[1:3]
        ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) \
            * strides[lvl]
        xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) \
            * strides[lvl]
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        centers.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        stride.append(torch.full((h * w,), float(strides[lvl]),
                                 device=device))
    return torch.cat(centers), torch.cat(stride)


def flatten_levels(cls_scores, init_offsets, refine_offsets,
                   num_classes: int):
    """The head's per-level outputs as (B, P, C), (B, P, 2 P), (B, P, 2 P)
    in fp32."""
    b = cls_scores[0].shape[0]
    p2 = init_offsets[0].shape[-1]
    return (torch.cat([s.reshape(b, -1, num_classes).float()
                       for s in cls_scores], 1),
            torch.cat([o.reshape(b, -1, p2).float() for o in init_offsets],
                      1),
            torch.cat([o.reshape(b, -1, p2).float() for o in refine_offsets],
                      1))


def init_assign(centers, gt_obbs, gt_mask):
    """Each location's nearest gt (B, G, 5) whose rotated box holds it
    strictly: (gt index (B, P), positive (B, P))."""
    cx, cy, w, h, th = (gt_obbs[..., None, :, i] for i in range(5))
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    dx = centers[None, :, 0, None] - cx
    dy = centers[None, :, 1, None] - cy
    fx = cos_t * dx + sin_t * dy
    fy = -sin_t * dx + cos_t * dy
    inside = (fx.abs() < w / 2) & (fy.abs() < h / 2) & gt_mask[:, None, :]
    d2 = torch.where(inside, dx * dx + dy * dy,
                     torch.full_like(dx, torch.inf))
    return _argmax_first(-d2, -1), torch.isfinite(d2.amin(-1))


def _gather_gts(gts, idx):
    """gts (B, G, D) at idx (B, P) -> (B, P, D)."""
    return torch.gather(gts, 1, idx[..., None].expand(-1, -1,
                                                      gts.shape[-1]))


def reppoints_loss(cls_scores, init_offsets, refine_offsets, gt_obbs,
                   gt_labels, gt_mask, num_classes: int,
                   strides=STRIDES, version: str = "le90"):
    """Oriented RepPoints' losses of a batch: dict(loss_cls, loss_pts_init
    (times 0.375, over the init positives), loss_pts_refine (over the
    refine positives)); the class loss over the refine positives too."""
    dev = cls_scores[0].device
    nc = num_classes
    centers, stride_vec = level_points(cls_scores, strides, dev)
    flat_cls, flat_init, flat_refine = flatten_levels(
        cls_scores, init_offsets, refine_offsets, nc)
    init_obbs, _ = points_to_obbs(flat_init, centers, stride_vec, version)
    refine_obbs, _ = points_to_obbs(flat_refine, centers, stride_vec,
                                    version)
    init_gt, init_pos = init_assign(centers, gt_obbs, gt_mask)
    ious_all = box_iou_rotated_chunked(init_obbs.detach(), gt_obbs)
    l_cls = l_init = l_refine = 0.0
    n_pos = 0
    for i in range(gt_obbs.shape[0]):
        gts, mask = gt_obbs[i], gt_mask[i]
        l_init = l_init + rotated_iou_loss(
            init_obbs[i], gts[init_gt[i]], mode="linear",
            weight=init_pos[i].float(), avg_factor=1.0)
        ious = torch.where(mask[None, :], ious_all[i],
                           torch.full_like(ious_all[i], -1.0))
        assigned = max_iou_assign(ious, mask, pos_iou_thr=0.5,
                                  neg_iou_thr=0.4, min_pos_iou=0.0,
                                  match_low_quality=True)
        pos = assigned > 0
        gt_idx = torch.clamp(assigned.long() - 1, min=0)
        cls_t = torch.where(pos, gt_labels[i][gt_idx].long(), nc)
        l_cls = l_cls + sigmoid_focal_loss(flat_cls[i], cls_t,
                                           avg_factor=1.0)
        l_refine = l_refine + rotated_iou_loss(
            refine_obbs[i], gts[gt_idx], mode="linear", weight=pos.float(),
            avg_factor=1.0)
        n_pos = n_pos + pos.sum()
    t_pos = torch.clamp(torch.as_tensor(n_pos, device=dev).float(), min=1.0)
    t_init = torch.clamp(init_pos.sum().float(), min=1.0)
    return {"loss_cls": l_cls / t_pos,
            "loss_pts_init": 0.375 * l_init / t_init,
            "loss_pts_refine": l_refine / t_pos}
