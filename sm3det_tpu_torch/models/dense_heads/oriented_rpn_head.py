"""Oriented RPN head (midpoint-offset regression), NHWC.

Port of ``sm3det_tpu/models/dense_heads/oriented_rpn_head.py``:
``OrientedRPNHead`` (3x3 conv + ReLU, then 1x1 objectness and 1x1
six-parameter midpoint-offset regression per anchor),
``rpn_get_proposals`` (per-level top-k, decode, horizontal NMS of the
proposals' enclosing boxes per level, merge by score), batched over images
instead of ``vmap``, and ``rpn_loss`` (MaxIoU on the gts' enclosing boxes,
random sampling, BCE + Smooth L1).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.anchor import AnchorGenerator
from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.coders import MidpointOffsetCoder
from ...core.bbox.samplers import random_sample
from ...ops.box_convert import obb2xyxy
from ...ops.nms import _take, _topk_scores, bbox_overlaps, nms
from ..layers import Conv2d
from ..losses import sigmoid_cross_entropy, smooth_l1_loss


class OrientedRPNHead(nn.Module):
    box_dim = 6      # midpoint-offset deltas a prior

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3, gen: torch.Generator | None = None):
        super().__init__()
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, padding=1,
                               gen=gen)
        self.rpn_cls = Conv2d(feat_channels, num_anchors, 1, gen=gen)
        self.rpn_reg = Conv2d(feat_channels, num_anchors * self.box_dim, 1,
                              gen=gen)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: list of (B, H, W, C) -> (cls, reg) lists of (B, H, W, A)
        and (B, H, W, box_dim A)."""
        cls_out, reg_out = [], []
        for x in feats:
            t = torch.relu(self.rpn_conv(x))
            cls_out.append(self.rpn_cls(t))
            reg_out.append(self.rpn_reg(t))
        return cls_out, reg_out


def rpn_loss(sample_keys, cls_scores, bbox_preds, gt_obbs, gt_mask,
             anchor_generator: AnchorGenerator, coder: MidpointOffsetCoder,
             version: str = "le90", num_sample: int = 256,
             pos_fraction: float = 0.5, pos_iou_thr: float = 0.7,
             neg_iou_thr: float = 0.3, min_pos_iou: float = 0.3,
             beta: float = 1.0 / 9.0):
    """Oriented RPN loss over a batch: per-level outputs in fp32, gts
    (B, G, 5) OBBs with mask (B, G). ``sample_keys``: (key_pos, key_neg),
    each (B, A) uniform keys of the sampler (``samplers.draw_sample_keys``).
    Returns dict(loss_rpn_cls, loss_rpn_bbox)."""
    dev = cls_scores[0].device
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors = torch.cat(anchor_generator.grid_anchors(featmap_sizes,
                                                      device=dev), dim=0)
    b = cls_scores[0].shape[0]
    flat_cls = torch.cat([s.reshape(b, -1) for s in cls_scores], dim=1)
    flat_reg = torch.cat([p.reshape(b, -1, 6) for p in bbox_preds], dim=1)
    key_pos, key_neg = sample_keys
    l_cls = l_reg = 0.0
    n_valid = 0
    for i in range(b):
        gts, mask = gt_obbs[i], gt_mask[i]
        ious = bbox_overlaps(anchors, obb2xyxy(gts, version))
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
            flat_reg[i][inds], targets, beta=beta,
            weight=pos_m[:, None].float(), avg_factor=1.0)
        n_valid = n_valid + valid.sum()
    total = torch.clamp(torch.as_tensor(n_valid, device=dev).float(),
                        min=1.0)
    return {"loss_rpn_cls": l_cls / total, "loss_rpn_bbox": l_reg / total}


def rpn_get_proposals(cls_scores, bbox_preds,
                      anchor_generator: AnchorGenerator,
                      coder: MidpointOffsetCoder, img_shape,
                      nms_pre: int = 2000, max_per_img: int = 2000,
                      iou_thr: float = 0.8):
    """Decode + per-level top-k + horizontal NMS -> fixed-size OBB
    proposals: (proposals (B, max_per_img, 5), scores, valid).

    The RPN's NMS is per level, so the levels are padded to a common K
    (score -inf, never kept) and all (image, level) pairs go through one
    batched NMS: one mask launch and one keep launch. The candidates of all
    levels are decoded together (the decode is elementwise, so this gives
    the per-level values with a fifth of the launches). The proposals are
    not clipped to the image, as in the reference.
    """
    dev = cls_scores[0].device
    b = cls_scores[0].shape[0]
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors_l = anchor_generator.grid_anchors(featmap_sizes, device=dev)
    sizes = [s[0].numel() for s in cls_scores]
    kmax = max(min(nms_pre, n) for n in sizes)
    anchors_lv, deltas_lv, scores_lv = [], [], []
    for lvl, (cls_s, reg_s) in enumerate(zip(cls_scores, bbox_preds)):
        scores = torch.sigmoid(cls_s.reshape(b, -1))
        deltas = reg_s.reshape(b, -1, 6)
        k = min(nms_pre, sizes[lvl])
        top_vals, top_idx = _topk_scores(scores, k)
        anchors, deltas = anchors_l[lvl][top_idx], _take(deltas, top_idx)
        if k < kmax:
            top_vals = torch.cat([top_vals, top_vals.new_full(
                (b, kmax - k), float("-inf"))], dim=1)
            anchors = torch.cat([anchors, anchors.new_zeros(
                (b, kmax - k, 4))], dim=1)
            deltas = torch.cat([deltas, deltas.new_zeros(
                (b, kmax - k, 6))], dim=1)
        anchors_lv.append(anchors)
        deltas_lv.append(deltas)
        scores_lv.append(top_vals)
    n_lvl = len(scores_lv)
    scores_lv = torch.stack(scores_lv, dim=1).reshape(b * n_lvl, kmax)
    obbs_lv = coder.decode(
        torch.stack(anchors_lv, dim=1).reshape(b * n_lvl, kmax, 4),
        torch.stack(deltas_lv, dim=1).reshape(b * n_lvl, kmax, 6))
    # the padding's boxes are zeros (its scores are -inf: never kept)
    obbs_lv = torch.where(torch.isneginf(scores_lv)[..., None], 0.0,
                          obbs_lv)
    keep_n = min(max_per_img, kmax)
    _, idx, valid = nms(obb2xyxy(obbs_lv), scores_lv, iou_thr,
                        max_out=keep_n, score_thr=float("-inf"))
    safe = torch.where(idx >= 0, idx, 0)
    obbs = torch.where(valid[..., None], _take(obbs_lv, safe),
                       0.0).reshape(b, n_lvl * keep_n, 5)
    scores = torch.where(valid, _take(scores_lv, safe),
                         float("-inf")).reshape(b, n_lvl * keep_n)
    if scores.shape[1] < max_per_img:          # degenerate tiny configs
        pad = max_per_img - scores.shape[1]
        scores = torch.cat([scores, scores.new_full(
            (b, pad), float("-inf"))], dim=1)
        obbs = torch.cat([obbs, obbs.new_zeros((b, pad, 5))], dim=1)
    top_s, top_i = _topk_scores(scores, max_per_img)
    valid = torch.isfinite(top_s)
    out_obbs = torch.where(valid[..., None], _take(obbs, top_i), 0.0)
    out_scores = torch.where(valid, top_s, 0.0)
    return out_obbs, out_scores, valid
