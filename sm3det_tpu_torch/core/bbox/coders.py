"""Box coders. Port of ``sm3det_tpu/core/bbox/coders.py::
DistancePointBBoxCoder`` (GFL / FCOS)."""

from __future__ import annotations

import torch


class DistancePointBBoxCoder:
    """Point + (left, top, right, bottom) distances <-> xyxy boxes."""

    def encode(self, points, gt_bboxes, max_dis=None, eps=0.1):
        left = points[..., 0] - gt_bboxes[..., 0]
        top = points[..., 1] - gt_bboxes[..., 1]
        right = gt_bboxes[..., 2] - points[..., 0]
        bottom = gt_bboxes[..., 3] - points[..., 1]
        d = torch.stack([left, top, right, bottom], dim=-1)
        if max_dis is not None:
            d = torch.clamp(d, 0, max_dis - eps)
        return d

    def decode(self, points, distances, max_shape=None):
        x1 = points[..., 0] - distances[..., 0]
        y1 = points[..., 1] - distances[..., 1]
        x2 = points[..., 0] + distances[..., 2]
        y2 = points[..., 1] + distances[..., 3]
        if max_shape is not None:
            h, w = max_shape[0], max_shape[1]
            x1, x2 = torch.clamp(x1, 0, w), torch.clamp(x2, 0, w)
            y1, y2 = torch.clamp(y1, 0, h), torch.clamp(y2, 0, h)
        return torch.stack([x1, y1, x2, y2], dim=-1)
