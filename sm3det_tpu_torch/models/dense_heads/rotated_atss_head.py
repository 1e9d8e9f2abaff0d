"""Rotated ATSS head.

Port of ``sm3det_tpu/models/dense_heads/rotated_atss_head.py``: the
rotated RetinaNet tower with one anchor a cell (``RotatedATSSHead``), its
targets from the ATSS-OBB assigner (``atss_obb_assign``: per gt, the ``topk``
priors nearest its centre on each level are candidates; the threshold is
the candidates' IoU mean plus their standard deviation; a positive's centre
must lie inside the rotated gt; a prior takes the gt of highest IoU among
its positive ones) and ``atss_loss`` (sigmoid focal loss, Smooth L1 on the
deltas, both divided by the batch's positives).

The IoU of every anchor with every gt is
``ops/rotated_iou.box_iou_rotated_chunked``: row 5's matrix mode on the
card, one launch for the batch. Ties break as JAX's do: the per-level
top-k keeps the lower index (``stable_topk``), the argmax the first.
"""

from __future__ import annotations

import functools

import torch

from ...core.anchor import RotatedAnchorGenerator
from ...core.bbox.assigners import _argmax_first
from ...core.bbox.coders import DeltaXYWHAOBBoxCoder
from ...ops.rotated_iou import box_iou_rotated_chunked
from ..losses import sigmoid_focal_loss, smooth_l1_loss
from ..moe import stable_topk
from .rotated_retina_head import RotatedRetinaHead


class RotatedATSSHead(RotatedRetinaHead):
    """RotatedRetinaHead's tower with one anchor a cell."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 gen: torch.Generator | None = None):
        super().__init__(num_classes, in_channels, feat_channels,
                         stacked_convs, num_anchors=1, gen=gen)


def atss_obb_assign(ious, prior_centers, gt_obbs, gt_mask, num_level_priors,
                    topk: int = 9):
    """ATSSObbAssigner of one image: ious (P, G) priors x padded gts,
    prior_centers (P, 2), gt_obbs (G, 5), gt_mask (G,), num_level_priors
    the priors of each level. Returns (P,) in {0 negative, k > 0 the
    (k - 1)-th gt}."""
    num_priors, num_gt = ious.shape
    diff = prior_centers[:, None, :] - gt_obbs[None, :, :2]
    distances = torch.sqrt(diff[..., 0] * diff[..., 0]
                           + diff[..., 1] * diff[..., 1])
    is_candidate = torch.zeros_like(ious, dtype=torch.bool)
    start = 0
    for n in num_level_priors:
        k = min(topk, n)
        _, idx = stable_topk(-distances[start:start + n].T, k)    # (G, k)
        level = torch.zeros((num_gt, n), dtype=torch.bool, device=ious.device)
        level.scatter_(1, idx, True)
        is_candidate[start:start + n] = level.T
        start += n
    count = is_candidate.sum(0).float()
    zero = torch.zeros_like(ious)
    mean = torch.where(is_candidate, ious, zero).sum(0) / count
    var = torch.where(is_candidate, (ious - mean[None]) ** 2, zero).sum(0) \
        / count
    is_pos = is_candidate & (ious >= (mean + torch.sqrt(var))[None])
    # the prior's centre inside the rotated gt
    cx, cy, w, h, th = (gt_obbs[:, i] for i in range(5))
    dx = prior_centers[:, 0, None] - cx[None]
    dy = prior_centers[:, 1, None] - cy[None]
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    fx = cos_t[None] * dx + sin_t[None] * dy
    fy = -sin_t[None] * dx + cos_t[None] * dy
    inside = (fx.abs() < w[None] / 2 + 0.01) & (fy.abs() < h[None] / 2 + 0.01)
    is_pos = is_pos & inside & gt_mask[None, :]
    best = _argmax_first(torch.where(is_pos, ious,
                                     torch.full_like(ious, -float("inf"))), 1)
    return torch.where(is_pos.any(1), best + 1, 0)


@functools.lru_cache(maxsize=None)
def make_atss_anchor_generator():
    """One anchor a cell: strides 8-128, octave_base_scale 4, ratio 1; made
    once (it keeps the grids it has made on a device, so a train step
    copies no anchors to the card)."""
    return RotatedAnchorGenerator(strides=(8, 16, 32, 64, 128), ratios=[1.0],
                                  octave_base_scale=4, scales_per_octave=1)


def atss_loss(cls_scores, bbox_preds, gt_obbs, gt_labels, gt_mask,
              anchor_generator: RotatedAnchorGenerator,
              coder: DeltaXYWHAOBBoxCoder, num_classes: int, topk: int = 9,
              beta: float = 0.11):
    """RotatedRetinaHead's losses under the ATSS-OBB assignment: per-level
    outputs in fp32, gts (B, G, 5) with labels and mask (B, G). Returns
    dict(loss_cls, loss_bbox), each divided by the batch's positives."""
    dev = cls_scores[0].device
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors_l = anchor_generator.grid_anchors(featmap_sizes, device=dev)
    num_level = [a.shape[0] for a in anchors_l]
    anchors = torch.cat(anchors_l, 0)
    b = cls_scores[0].shape[0]
    flat_cls = torch.cat([s.reshape(b, -1, num_classes) for s in cls_scores],
                         1)
    flat_reg = torch.cat([p.reshape(b, -1, 5) for p in bbox_preds], 1)
    ious_all = box_iou_rotated_chunked(anchors.expand((b,) + anchors.shape),
                                       gt_obbs)
    l_cls = l_reg = 0.0
    n_pos = 0
    for i in range(b):
        mask = gt_mask[i]
        ious = torch.where(mask[None, :], ious_all[i],
                           torch.full_like(ious_all[i], -1.0))
        assigned = atss_obb_assign(ious, anchors[:, :2], gt_obbs[i], mask,
                                   num_level, topk=topk)
        pos = assigned > 0
        gt_idx = torch.clamp(assigned - 1, min=0)
        cls_t = torch.where(pos, gt_labels[i].long()[gt_idx], num_classes)
        l_cls = l_cls + sigmoid_focal_loss(flat_cls[i], cls_t,
                                           avg_factor=1.0)
        l_reg = l_reg + smooth_l1_loss(
            flat_reg[i], coder.encode(anchors, gt_obbs[i][gt_idx]), beta=beta,
            weight=pos[:, None].float(), avg_factor=1.0)
        n_pos = n_pos + pos.sum()
    total = torch.clamp(torch.as_tensor(n_pos, device=dev).float(), min=1.0)
    return {"loss_cls": l_cls / total, "loss_bbox": l_reg / total}
