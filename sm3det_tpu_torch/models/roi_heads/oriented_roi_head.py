"""Oriented standard RoI head, inference.

Port of ``sm3det_tpu/models/roi_heads/oriented_roi_head.py``:
``extract_rotated_roi_feats`` (level per RoI by ``floor(log2(sqrt(w h) /
56))``, rotated RoI align 7x7 with 2x2 samples, clockwise),
``RotatedShared2FCBBoxHead`` (flatten, two fully connected layers of 1024,
then the (C+1)-way classifier and the class-agnostic 5-parameter
regressor) and ``roi_head_get_bboxes`` (softmax, decode, multi-class rotated
NMS), batched over images instead of ``vmap``. Sampling and the losses
belong to the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.bbox.coders import DeltaXYWHAOBBoxCoder
from ...ops.cuda.roi_align_kernel import roi_align_rotated_pyramid_fused
from ...ops.nms import multiclass_nms_rotated
from ..layers import Dense


def extract_rotated_roi_feats(feats: Sequence[torch.Tensor], rois,
                              out_size: int = 7, sample_num: int = 2,
                              featmap_strides=(4, 8, 16, 32),
                              finest_scale: int = 56):
    """Multi-level rotated RoI align with per-RoI level routing.

    feats: per-level (B, H, W, C), at least ``len(featmap_strides)`` of
    them; rois: (N, 6) ``(batch_idx, cx, cy, w, h, theta)`` in image
    coordinates. Returns (N, out, out, C) in the features' dtype: the CUDA
    kernel for tensors on the card, its plain version on the host.
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
    scores = torch.where(roi_valid[..., None], scores,
                         scores.new_zeros(()))
    obbs = coder.decode(rois, reg_pred, max_shape=img_shape)
    return multiclass_nms_rotated(
        obbs, scores, score_thr=score_thr, iou_thr=iou_thr,
        max_num=max_per_img, pre_nms=pre_nms)
