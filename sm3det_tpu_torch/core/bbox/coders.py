"""Box coders. Port of ``sm3det_tpu/core/bbox/coders.py``:
``DistancePointBBoxCoder`` (GFL / FCOS), ``MidpointOffsetCoder`` (Oriented
RPN) and ``DeltaXYWHAOBBoxCoder`` (Oriented R-CNN), each with its
``encode`` (training targets) and ``decode``."""

from __future__ import annotations

import math

import torch

from ...ops.box_convert import norm_angle, obb2poly, obb2xyxy, poly2obb

PI = math.pi


def _normalize(deltas, means, stds):
    means = torch.as_tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.as_tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means) / stds


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
        """Deltas of ``gt_bboxes`` against ``bboxes``, both (..., 5)."""
        px, py, pw, ph, pa = (bboxes[..., i] for i in range(5))
        gx, gy, gw, gh, ga = (gt_bboxes[..., i] for i in range(5))
        pw = torch.clamp(pw, min=1e-6)
        ph = torch.clamp(ph, min=1e-6)
        if self.proj_xy:
            cos_a, sin_a = torch.cos(pa), torch.sin(pa)
            dx = (cos_a * (gx - px) + sin_a * (gy - py)) / pw
            dy = (-sin_a * (gx - px) + cos_a * (gy - py)) / ph
        else:
            dx = (gx - px) / pw
            dy = (gy - py) / ph
        if self.edge_swap:
            dtheta1 = norm_angle(ga - pa, self.version)
            dtheta2 = norm_angle(ga - pa + PI / 2, self.version)
            swap = dtheta1.abs() >= dtheta2.abs()
            gw, gh = torch.where(swap, gh, gw), torch.where(swap, gw, gh)
            da = torch.where(swap, dtheta2, dtheta1)
        else:
            da = norm_angle(ga - pa, self.version)
        dw = torch.log(torch.clamp(gw, min=1e-6) / pw)
        dh = torch.log(torch.clamp(gh, min=1e-6) / ph)
        if self.norm_factor:
            da = da / (self.norm_factor * PI)
        return _normalize(torch.stack([dx, dy, dw, dh, da], dim=-1),
                          self.means, self.stds)

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
        """Deltas of OBBs ``gt_bboxes`` (..., 5) against horizontal
        ``bboxes`` (..., 4): the enclosing box's (dx, dy, dw, dh), then the
        x of the topmost vertex and the y of the rightmost one, relative to
        the enclosing box."""
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = torch.clamp(bboxes[..., 2] - bboxes[..., 0], min=1e-6)
        ph = torch.clamp(bboxes[..., 3] - bboxes[..., 1], min=1e-6)
        hbb = obb2xyxy(gt_bboxes, self.version)
        poly = obb2poly(gt_bboxes, self.version)
        gx = (hbb[..., 0] + hbb[..., 2]) * 0.5
        gy = (hbb[..., 1] + hbb[..., 3]) * 0.5
        gw = torch.clamp(hbb[..., 2] - hbb[..., 0], min=1e-6)
        gh = torch.clamp(hbb[..., 3] - hbb[..., 1], min=1e-6)
        x_coor, y_coor = poly[..., 0::2], poly[..., 1::2]
        y_min = y_coor.amin(dim=-1, keepdim=True)
        x_max = x_coor.amax(dim=-1, keepdim=True)
        far = torch.full_like(x_coor, -1000.0)
        ga = torch.where((y_coor - y_min).abs() > 0.1, far, x_coor).amax(-1)
        gb = torch.where((x_coor - x_max).abs() > 0.1, far, y_coor).amax(-1)
        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(gw / pw), torch.log(gh / ph),
                              (ga - gx) / gw, (gb - gy) / gh], dim=-1)
        return _normalize(deltas, self.means, self.stds)

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
