"""Oriented standard RoI head.

Port of ``sm3det_tpu/models/roi_heads/oriented_roi_head.py``:
``extract_rotated_roi_feats`` (level per RoI by ``floor(log2(sqrt(w h) /
56))``, rotated RoI align 7x7 with 2x2 samples, clockwise; differentiable
in the features), ``RotatedShared2FCBBoxHead`` (flatten, two fully
connected layers of 1024, then the (C+1)-way classifier and the
class-agnostic 5-parameter regressor), ``roi_head_get_bboxes`` (softmax,
decode, multi-class rotated NMS), batched over images instead of ``vmap``,
and the training half: ``sample_rois_for_training`` (gts as proposals,
MaxIoU on rotated IoU, random sampling) and ``bbox_head_loss`` (softmax
cross-entropy + Smooth L1), one image at a time.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.coders import DeltaXYWHAOBBoxCoder
from ...core.bbox.samplers import random_sample
from ...ops.cuda.roi_align_kernel import roi_align_rotated_pyramid_fused
from ...ops.cuda.rotated_iou_kernel import rotated_iou
from ...ops.nms import multiclass_nms_rotated
from ..layers import Dense
from ..losses import smooth_l1_loss, softmax_cross_entropy


def extract_rotated_roi_feats(feats: Sequence[torch.Tensor], rois,
                              out_size: int = 7, sample_num: int = 2,
                              featmap_strides=(4, 8, 16, 32),
                              finest_scale: int = 56):
    """Multi-level rotated RoI align with per-RoI level routing.

    feats: per-level (B, H, W, C), at least ``len(featmap_strides)`` of
    them; rois: (N, 6) ``(batch_idx, cx, cy, w, h, theta)`` in image
    coordinates. Returns (N, out, out, C) in the features' dtype, with a
    gradient for the features: the CUDA kernels for tensors on the card,
    the plain version and its autograd on the host.
    """
    return roi_align_rotated_pyramid_fused(
        feats, rois, out_size, featmap_strides, sample_num, finest_scale)


class RotatedShared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int = 26, in_channels: int = 256,
                 fc_out_channels: int = 1024, roi_feat_size: int = 7,
                 reg_class_agnostic: bool = True,
                 gen: torch.Generator | None = None):
        super().__init__()
        flat = roi_feat_size * roi_feat_size * in_channels
        self.shared_fc0 = Dense(flat, fc_out_channels, gen=gen)
        self.shared_fc1 = Dense(fc_out_channels, fc_out_channels, gen=gen)
        self.fc_cls = Dense(fc_out_channels, num_classes + 1, gen=gen)
        self.fc_reg = Dense(
            fc_out_channels, 5 if reg_class_agnostic else 5 * num_classes,
            gen=gen)

    def forward(self, roi_feats):
        """roi_feats (N, 7, 7, C) -> (cls_logits (N, C+1), deltas (N, 5)).
        The flatten runs over (h, w, C), as flax's does."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = torch.relu(self.shared_fc0(x))
        x = torch.relu(self.shared_fc1(x))
        return self.fc_cls(x), self.fc_reg(x)


def roi_head_get_bboxes(cls_logits, reg_pred, rois, roi_valid,
                        coder: DeltaXYWHAOBBoxCoder, num_classes: int,
                        img_shape=None, score_thr: float = 0.05,
                        iou_thr: float = 0.1, max_per_img: int = 2000,
                        pre_nms: int = 2000):
    """Decode + multi-class rotated NMS; one image ((N, ...) inputs) or a
    batch ((B, N, ...)). Returns (dets (.., max_per_img, 6), labels,
    valid)."""
    scores = torch.softmax(cls_logits, dim=-1)
    scores = torch.where(roi_valid[..., None], scores, 0.0)
    obbs = coder.decode(rois, reg_pred, max_shape=img_shape)
    return multiclass_nms_rotated(
        obbs, scores, score_thr=score_thr, iou_thr=iou_thr,
        max_num=max_per_img, pre_nms=pre_nms)


def sample_rois_for_training(sample_keys, proposals, proposal_valid,
                             gt_obbs, gt_labels, gt_mask, ious,
                             num: int = 512,
                             pos_fraction: float = 0.25,
                             pos_iou_thr: float = 0.5,
                             neg_iou_thr: float = 0.5,
                             min_pos_iou: float = 0.5):
    """Assign and sample the RoIs of one image, the gts among the
    proposals. ``sample_keys``: (key_pos, key_neg), each (G + P,) uniform
    keys. ``ious`` (G + P, G): the rotated IoU of every candidate (the gts,
    then the proposals) with every gt, the image's slice of
    :func:`candidate_gt_ious`. Padded gts and proposals are masked to -1
    before the assignment and ignored after. Returns dict(rois (num, 5),
    pos_mask, neg_mask, gt_idx)."""
    props = torch.cat([gt_obbs, proposals], dim=0)
    prop_valid = torch.cat([gt_mask, proposal_valid], dim=0)
    ious = torch.where(prop_valid[:, None] & gt_mask[None, :], ious,
                       torch.full_like(ious, -1.0))
    assigned = max_iou_assign(
        ious, gt_mask, pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
        min_pos_iou=min_pos_iou, match_low_quality=False)
    assigned = torch.where(prop_valid, assigned, -1)
    sample = random_sample(sample_keys[0], sample_keys[1], assigned, num,
                           pos_fraction)
    inds = sample["inds"]
    return {"rois": props[inds], "pos_mask": sample["pos_mask"],
            "neg_mask": sample["neg_mask"],
            "gt_idx": torch.clamp(assigned[inds].long() - 1, min=0)}


def candidate_gt_ious(proposals, gt_obbs):
    """The assigner's IoU for a batch of images: the candidates (the gts,
    then the proposals; (B, G + P, 5)) against the gts (B, G, 5) ->
    (B, G + P, G), one kernel launch on the card (the plain version on
    the host)."""
    return rotated_iou(torch.cat([gt_obbs, proposals], dim=1), gt_obbs)


def bbox_head_loss(cls_logits, reg_pred, sampled, gt_obbs, gt_labels,
                   coder: DeltaXYWHAOBBoxCoder, num_classes: int):
    """Softmax cross-entropy + Smooth L1 of one image's sampled RoIs,
    masked and summed (the caller divides by the batch's count of sampled
    RoIs). Returns (l_cls, l_reg, n_valid, n_pos)."""
    pos, neg = sampled["pos_mask"], sampled["neg_mask"]
    valid = pos | neg
    gt_idx = sampled["gt_idx"]
    labels = torch.where(pos, gt_labels[gt_idx].long(), num_classes)
    l_cls = softmax_cross_entropy(cls_logits, labels, weight=valid.float(),
                                  avg_factor=1.0)
    targets = coder.encode(sampled["rois"], gt_obbs[gt_idx])
    l_reg = smooth_l1_loss(reg_pred, targets, beta=1.0,
                           weight=pos[:, None].float(), avg_factor=1.0)
    return l_cls, l_reg, valid.sum(), pos.sum()
