"""Oriented RPN head (midpoint-offset regression), inference, NHWC.

Port of ``sm3det_tpu/models/dense_heads/oriented_rpn_head.py``:
``OrientedRPNHead`` (3x3 conv + ReLU, then 1x1 objectness and 1x1
six-parameter midpoint-offset regression per anchor) and
``rpn_get_proposals`` (per-level top-k, decode, horizontal NMS of the
proposals' enclosing boxes per level, merge by score), batched over images
instead of ``vmap``. ``rpn_loss`` belongs to the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.anchor import AnchorGenerator
from ...core.bbox.coders import MidpointOffsetCoder
from ...ops.box_convert import obb2xyxy
from ...ops.nms import _take, _topk_scores, nms
from ..layers import Conv2d


class OrientedRPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3, gen: torch.Generator | None = None):
        super().__init__()
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, padding=1,
                               gen=gen)
        self.rpn_cls = Conv2d(feat_channels, num_anchors, 1, gen=gen)
        self.rpn_reg = Conv2d(feat_channels, num_anchors * 6, 1, gen=gen)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: list of (B, H, W, C) -> (cls, reg) lists of (B, H, W, A)
        and (B, H, W, 6 A)."""
        cls_out, reg_out = [], []
        for x in feats:
            t = torch.relu(self.rpn_conv(x))
            cls_out.append(self.rpn_cls(t))
            reg_out.append(self.rpn_reg(t))
        return cls_out, reg_out


def rpn_get_proposals(cls_scores, bbox_preds,
                      anchor_generator: AnchorGenerator,
                      coder: MidpointOffsetCoder, img_shape,
                      nms_pre: int = 2000, max_per_img: int = 2000,
                      iou_thr: float = 0.8):
    """Decode + per-level top-k + horizontal NMS -> fixed-size OBB
    proposals: (proposals (B, max_per_img, 5), scores, valid).

    The RPN's NMS is per level, so the levels are padded to a common K
    (score -inf, never kept) and all (image, level) pairs go through one
    batched NMS: one IoU launch and one greedy pass. The proposals are not
    clipped to the image, as in the reference.
    """
    dev = cls_scores[0].device
    b = cls_scores[0].shape[0]
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors_l = anchor_generator.grid_anchors(featmap_sizes, device=dev)
    sizes = [s[0].numel() for s in cls_scores]
    kmax = max(min(nms_pre, n) for n in sizes)
    boxes_lv, scores_lv = [], []
    for lvl, (cls_s, reg_s) in enumerate(zip(cls_scores, bbox_preds)):
        scores = torch.sigmoid(cls_s.reshape(b, -1))
        deltas = reg_s.reshape(b, -1, 6)
        k = min(nms_pre, sizes[lvl])
        top_vals, top_idx = _topk_scores(scores, k)
        obbs = coder.decode(anchors_l[lvl][top_idx], _take(deltas, top_idx))
        if k < kmax:
            top_vals = torch.cat([top_vals, top_vals.new_full(
                (b, kmax - k), float("-inf"))], dim=1)
            obbs = torch.cat([obbs, obbs.new_zeros((b, kmax - k, 5))], dim=1)
        boxes_lv.append(obbs)
        scores_lv.append(top_vals)
    n_lvl = len(boxes_lv)
    obbs_lv = torch.stack(boxes_lv, dim=1).reshape(b * n_lvl, kmax, 5)
    scores_lv = torch.stack(scores_lv, dim=1).reshape(b * n_lvl, kmax)
    keep_n = min(max_per_img, kmax)
    _, idx, valid = nms(obb2xyxy(obbs_lv), scores_lv, iou_thr,
                        max_out=keep_n, score_thr=float("-inf"))
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx))
    obbs = torch.where(valid[..., None], _take(obbs_lv, safe),
                       obbs_lv.new_zeros(())).reshape(b, n_lvl * keep_n, 5)
    scores = torch.where(valid, _take(scores_lv, safe), scores_lv.new_full(
        (), float("-inf"))).reshape(b, n_lvl * keep_n)
    if scores.shape[1] < max_per_img:          # degenerate tiny configs
        pad = max_per_img - scores.shape[1]
        scores = torch.cat([scores, scores.new_full(
            (b, pad), float("-inf"))], dim=1)
        obbs = torch.cat([obbs, obbs.new_zeros((b, pad, 5))], dim=1)
    top_s, top_i = _topk_scores(scores, max_per_img)
    valid = torch.isfinite(top_s)
    out_obbs = torch.where(valid[..., None], _take(obbs, top_i),
                           obbs.new_zeros(()))
    out_scores = torch.where(valid, top_s, top_s.new_zeros(()))
    return out_obbs, out_scores, valid
