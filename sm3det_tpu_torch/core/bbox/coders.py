"""Box coders. Port of ``sm3det_tpu/core/bbox/coders.py``:
``DistancePointBBoxCoder`` (GFL / FCOS) in full, and the ``decode`` halves
of ``MidpointOffsetCoder`` (Oriented RPN) and ``DeltaXYWHAOBBoxCoder``
(Oriented R-CNN). The ``encode`` halves of the last two are training code
and raise until the training slice."""

from __future__ import annotations

import math

import torch

from ...ops.box_convert import norm_angle, poly2obb

PI = math.pi


def _denormalize(deltas, means, stds):
    means = torch.as_tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.as_tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return deltas * stds + means


class DeltaXYWHAOBBoxCoder:
    """5-parameter rotated coder (mmrotate ``delta_xywha_rbbox_coder``)."""

    def __init__(self, angle_range="oc",
                 target_means=(0., 0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1., 1.),
                 norm_factor=None, edge_swap=False, proj_xy=False):
        self.version = angle_range
        self.means = target_means
        self.stds = target_stds
        self.norm_factor = norm_factor
        self.edge_swap = edge_swap
        self.proj_xy = proj_xy

    def encode(self, bboxes, gt_bboxes):
        raise NotImplementedError(
            "DeltaXYWHAOBBoxCoder.encode: training slice of the port")

    def decode(self, rois, deltas, max_shape=None, wh_ratio_clip=16 / 1000):
        d = _denormalize(deltas, self.means, self.stds)
        dx, dy, dw, dh, da = (d[..., i] for i in range(5))
        if self.norm_factor:
            da = da * (self.norm_factor * PI)
        max_ratio = abs(math.log(wh_ratio_clip))
        dw = torch.clamp(dw, -max_ratio, max_ratio)
        dh = torch.clamp(dh, -max_ratio, max_ratio)
        px, py, pw, ph, pa = (rois[..., i] for i in range(5))
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        if self.proj_xy:
            gx = dx * pw * torch.cos(pa) - dy * ph * torch.sin(pa) + px
            gy = dx * pw * torch.sin(pa) + dy * ph * torch.cos(pa) + py
        else:
            gx = px + pw * dx
            gy = py + ph * dy
        ga = norm_angle(pa + da, self.version)
        if max_shape is not None:
            gx = torch.clamp(gx, 0, max_shape[1] - 1)
            gy = torch.clamp(gy, 0, max_shape[0] - 1)
        if self.edge_swap:
            swap = gw <= gh
            w_r = torch.where(swap, gh, gw)
            h_r = torch.where(swap, gw, gh)
            theta_r = norm_angle(torch.where(swap, ga + PI / 2, ga),
                                 self.version)
            return torch.stack([gx, gy, w_r, h_r, theta_r], dim=-1)
        return torch.stack([gx, gy, gw, gh, ga], dim=-1)


class MidpointOffsetCoder:
    """Horizontal anchor -> OBB, 6 parameters (mmrotate
    ``delta_midpointoffset_rbbox_coder``): (dx, dy, dw, dh) regress the
    enclosing horizontal box, (da, db) place the top and right midpoints on
    its edges. Decoding rebuilds the 4-point polygon, stretches its
    half-diagonals to the longest so it is a rectangle, and converts to an
    OBB."""

    def __init__(self, angle_range="oc",
                 target_means=(0., 0., 0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1., 1., 1.)):
        self.version = angle_range
        self.means = target_means
        self.stds = target_stds

    def encode(self, bboxes, gt_bboxes):
        raise NotImplementedError(
            "MidpointOffsetCoder.encode: training slice of the port")

    def decode(self, rois, deltas, max_shape=None, wh_ratio_clip=16 / 1000):
        """``max_shape`` is accepted and unused, as in the reference."""
        d = _denormalize(deltas, self.means, self.stds)
        dx, dy, dw, dh, da, db = (d[..., i] for i in range(6))
        max_ratio = abs(math.log(wh_ratio_clip))
        dw = torch.clamp(dw, -max_ratio, max_ratio)
        dh = torch.clamp(dh, -max_ratio, max_ratio)
        px = (rois[..., 0] + rois[..., 2]) * 0.5
        py = (rois[..., 1] + rois[..., 3]) * 0.5
        pw = rois[..., 2] - rois[..., 0]
        ph = rois[..., 3] - rois[..., 1]
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        gx = px + pw * dx
        gy = py + ph * dy
        x1 = gx - gw * 0.5
        y1 = gy - gh * 0.5
        x2 = gx + gw * 0.5
        y2 = gy + gh * 0.5
        da = torch.clamp(da, -0.5, 0.5)
        db = torch.clamp(db, -0.5, 0.5)
        ga = gx + da * gw
        _ga = gx - da * gw
        gb = gy + db * gh
        _gb = gy - db * gh
        polys = torch.stack([ga, y1, x2, gb, _ga, y2, x1, _gb], dim=-1)
        center = torch.stack([gx, gy] * 4, dim=-1)
        cp = polys - center
        diag = torch.sqrt(cp[..., 0::2] ** 2 + cp[..., 1::2] ** 2)
        diag = torch.clamp(diag, min=1e-6)
        max_diag = diag.amax(dim=-1, keepdim=True)
        scale = torch.repeat_interleave(max_diag / diag, 2, dim=-1)
        rect = cp * scale + center
        return poly2obb(rect, self.version)


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
