"""Horizontal standard RoI head (Faster R-CNN).

Port of ``sm3det_tpu/models/roi_heads/standard_roi_head.py``, the SAR
branch of the H2 TriSource variants and the R-CNN stages of the horizontal
Faster / Cascade R-CNN: ``Shared2FCBBoxHead`` (flatten, two fully connected
layers of 1024, the (C+1)-way classifier and a class-specific 4-delta
regressor), ``hbb_to_roi5``, ``extract_hbb_roi_feats`` (the rotated pyramid
align at angle 0: on the card the align kernel and its gather backward),
``sample_hbb_rois`` (gts as proposals, MaxIoU on horizontal IoU, random
sampling), ``hbb_head_loss`` (softmax cross-entropy + Smooth L1 of the
gt class's deltas) and ``hbb_head_get_bboxes`` (softmax, class-specific
decode, multi-class horizontal NMS).
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.coders import DeltaXYWHBBoxCoder
from ...core.bbox.samplers import random_sample
from ...ops.nms import bbox_overlaps, multiclass_nms
from ..layers import Dense
from ..losses import smooth_l1_loss, softmax_cross_entropy
from .oriented_roi_head import extract_rotated_roi_feats


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int = 26, in_channels: int = 256,
                 fc_out_channels: int = 1024, roi_feat_size: int = 7,
                 reg_class_agnostic: bool = False,
                 gen: torch.Generator | None = None):
        super().__init__()
        flat = roi_feat_size * roi_feat_size * in_channels
        self.shared_fc0 = Dense(flat, fc_out_channels, gen=gen)
        self.shared_fc1 = Dense(fc_out_channels, fc_out_channels, gen=gen)
        self.fc_cls = Dense(fc_out_channels, num_classes + 1, gen=gen)
        self.fc_reg = Dense(
            fc_out_channels, 4 if reg_class_agnostic else 4 * num_classes,
            gen=gen)

    def forward(self, roi_feats):
        """roi_feats (N, 7, 7, C) -> (cls_logits (N, C+1), deltas (N, 4 C)
        or (N, 4)); the flatten runs over (h, w, C), as flax's does."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = torch.relu(self.shared_fc0(x))
        x = torch.relu(self.shared_fc1(x))
        return self.fc_cls(x), self.fc_reg(x)


def hbb_to_roi5(hbbs):
    """xyxy -> (cx, cy, w, h, 0), so that the rotated align serves as the
    horizontal one."""
    cx = (hbbs[..., 0] + hbbs[..., 2]) * 0.5
    cy = (hbbs[..., 1] + hbbs[..., 3]) * 0.5
    w = hbbs[..., 2] - hbbs[..., 0]
    h = hbbs[..., 3] - hbbs[..., 1]
    return torch.stack([cx, cy, w, h, torch.zeros_like(cx)], dim=-1)


def extract_hbb_roi_feats(feats, rois5, out_size: int = 7,
                          sample_num: int = 2,
                          featmap_strides=(4, 8, 16, 32),
                          finest_scale: int = 56):
    """rois5 (N, 5) = (batch_idx, x1, y1, x2, y2) -> (N, out, out, C): the
    pyramid rotated align of the boxes at angle 0, each on the level of
    ``floor(log2(sqrt(w h) / finest_scale))``."""
    rois6 = torch.cat([rois5[:, :1], hbb_to_roi5(rois5[:, 1:5])], dim=-1)
    return extract_rotated_roi_feats(feats, rois6, out_size, sample_num,
                                     featmap_strides, finest_scale)


def candidate_gt_overlaps(proposals, gt_bboxes):
    """The assigner's IoU for a batch of images: the candidates (the gts,
    then the proposals; (B, G + P, 4)) against the gts (B, G, 4) ->
    (B, G + P, G), the plain ``bbox_overlaps``."""
    return bbox_overlaps(torch.cat([gt_bboxes, proposals], dim=1), gt_bboxes)


def sample_hbb_rois(sample_keys, proposals, proposal_valid, gt_bboxes,
                    gt_labels, gt_mask, ious, num: int = 512,
                    pos_fraction: float = 0.25, pos_iou_thr: float = 0.5,
                    neg_iou_thr: float = 0.5, min_pos_iou: float = 0.5):
    """Assign and sample the RoIs of one image, the gts among the
    proposals. ``sample_keys``: (key_pos, key_neg), each (G + P,);
    ``ious`` (G + P, G): the image's slice of
    :func:`candidate_gt_overlaps`. Returns dict(rois (num, 4), pos_mask,
    neg_mask, gt_idx)."""
    props = torch.cat([gt_bboxes, proposals], dim=0)
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


def hbb_head_loss(cls_logits, reg_pred, sampled, gt_bboxes, gt_labels,
                  coder: DeltaXYWHBBoxCoder, num_classes: int):
    """Softmax cross-entropy + Smooth L1 (of the gt class's deltas when
    the regressor is class-specific) of one image's sampled RoIs, masked
    and summed. Returns (l_cls, l_reg, n_valid, n_pos)."""
    pos, neg = sampled["pos_mask"], sampled["neg_mask"]
    valid = pos | neg
    gt_idx = sampled["gt_idx"]
    labels = torch.where(pos, gt_labels[gt_idx].long(), num_classes)
    l_cls = softmax_cross_entropy(cls_logits, labels, weight=valid.float(),
                                  avg_factor=1.0)
    targets = coder.encode(sampled["rois"], gt_bboxes[gt_idx])
    if reg_pred.shape[-1] > 4:
        reg_pred = reg_pred.reshape(reg_pred.shape[0], num_classes, 4)
        cls = torch.clamp(labels, 0, num_classes - 1)
        reg_pred = reg_pred[torch.arange(reg_pred.shape[0],
                                         device=reg_pred.device), cls]
    l_reg = smooth_l1_loss(reg_pred, targets, beta=1.0,
                           weight=pos[:, None].float(), avg_factor=1.0)
    return l_cls, l_reg, valid.sum(), pos.sum()


def hbb_head_get_bboxes(cls_logits, reg_pred, rois, roi_valid,
                        coder: DeltaXYWHBBoxCoder, num_classes: int,
                        img_shape=None, score_thr: float = 0.05,
                        iou_thr: float = 0.5, max_per_img: int = 100,
                        pre_nms: int = 1000):
    """Softmax, decode (per class with a class-specific regressor) and
    multi-class horizontal NMS; one image ((N, ...) inputs) or a batch
    ((B, N, ...)). Returns (dets (.., max_per_img, 5), labels, valid)."""
    scores = torch.softmax(cls_logits, dim=-1)
    scores = torch.where(roi_valid[..., None], scores, 0.0)
    if reg_pred.shape[-1] > 4:
        lead = rois.shape[:-1]
        boxes = coder.decode(
            rois[..., None, :].expand(lead + (num_classes, 4)),
            reg_pred.reshape(lead + (num_classes, 4)), max_shape=img_shape)
        boxes = boxes.reshape(lead + (num_classes * 4,))
    else:
        boxes = coder.decode(rois, reg_pred, max_shape=img_shape)
    return multiclass_nms(boxes, scores, score_thr=score_thr,
                          iou_thr=iou_thr, max_num=max_per_img,
                          pre_nms=pre_nms)
