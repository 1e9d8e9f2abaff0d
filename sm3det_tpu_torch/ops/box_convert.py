"""Rotated-box representation conversions.

Port of the part of ``sm3det_tpu/ops/box_convert.py`` that inference calls:
``norm_angle``, ``poly2obb`` (long-edge conventions), ``obb2poly`` and
``obb2xyxy``, and the host numpy variants ``_norm_angle_np``,
``poly2obb_np`` and ``obb2poly_np`` that the datasets and the DOTA
submission writer use. Oriented boxes are ``(cx, cy, w, h, theta)`` in image
coordinates (y down); ``'le90'`` keeps theta in [-pi/2, pi/2) with ``w`` the
long edge, ``'le135'`` in [-pi/4, 3pi/4). Every function broadcasts over
leading dimensions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi


def norm_angle(angle: torch.Tensor, angle_range: str) -> torch.Tensor:
    """Angles into the canonical range of a convention. The modulo is the
    floor modulo (the sign of the divisor), as ``%`` on jnp floats."""
    if angle_range == "oc":
        return angle
    if angle_range == "le135":
        return torch.remainder(angle + PI / 4, PI) - PI / 4
    if angle_range == "le90":
        return torch.remainder(angle + PI / 2, PI) - PI / 2
    raise NotImplementedError(f"unknown angle_range {angle_range!r}")


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _poly2obb_long_edge(polys: torch.Tensor, version: str) -> torch.Tensor:
    """Rectangle polygons ``(..., 8)`` -> OBBs with ``w`` the long edge."""
    polys = polys.reshape(polys.shape[:-1] + (4, 2))
    pt1, pt2, pt3, pt4 = (polys[..., i, :] for i in range(4))
    edge1 = _norm2(pt1 - pt2)
    edge2 = _norm2(pt2 - pt3)
    angle1 = torch.atan2(pt2[..., 1] - pt1[..., 1], pt2[..., 0] - pt1[..., 0])
    angle2 = torch.atan2(pt4[..., 1] - pt1[..., 1], pt4[..., 0] - pt1[..., 0])
    angle = norm_angle(torch.where(edge1 > edge2, angle1, angle2), version)
    ctr = (pt1 + pt3) / 2.0
    return torch.stack([ctr[..., 0], ctr[..., 1],
                        torch.maximum(edge1, edge2),
                        torch.minimum(edge1, edge2), angle], dim=-1)


def poly2obb(polys: torch.Tensor, version: str = "le90") -> torch.Tensor:
    if version in ("le135", "le90"):
        return _poly2obb_long_edge(polys, version)
    raise NotImplementedError(
        f"poly2obb: angle version {version!r} is not ported")


def obb2poly(obbs: torch.Tensor, version: str = "le90") -> torch.Tensor:
    """OBBs ``(..., 5)`` -> corner polygons ``(..., 8)``: corners
    ``(+-w/2, +-h/2)`` rotated by theta about the centre, for every
    convention."""
    del version
    x, y, w, h, a = (obbs[..., i] for i in range(5))
    cosa, sina = torch.cos(a), torch.sin(a)
    wx, wy = w / 2 * cosa, w / 2 * sina
    hx, hy = -h / 2 * sina, h / 2 * cosa
    return torch.stack([x - wx - hx, y - wy - hy, x + wx - hx, y + wy - hy,
                        x + wx + hx, y + wy + hy, x - wx + hx, y - wy + hy],
                       dim=-1)


def obb2xyxy(obbs: torch.Tensor, version: str = "le90") -> torch.Tensor:
    """Axis-aligned enclosing box ``(x1, y1, x2, y2)`` of an OBB."""
    del version
    x, y, w, h, a = (obbs[..., i] for i in range(5))
    cosa, sina = torch.abs(torch.cos(a)), torch.abs(torch.sin(a))
    dw = cosa * w + sina * h
    dh = sina * w + cosa * h
    return torch.stack([x - dw / 2, y - dh / 2, x + dw / 2, y + dh / 2],
                       dim=-1)


# ---- host numpy variants (annotation loading, eval, submission files) -----

def _norm_angle_np(angle, version):
    if version == "oc":
        return angle
    if version == "le135":
        return (angle + PI / 4) % PI - PI / 4
    return (angle + PI / 2) % PI - PI / 2


def poly2obb_np(polys: np.ndarray, version: str = "le90") -> np.ndarray:
    """Polygons ``(..., 8)`` -> OBBs ``(..., 5)`` float32, in numpy."""
    polys = np.asarray(polys, np.float32)
    pts = polys.reshape(polys.shape[:-1] + (4, 2))
    pt1, pt2, pt3, pt4 = (pts[..., i, :] for i in range(4))
    if version == "oc":
        ctr = pts.mean(-2)
        _w = np.linalg.norm(pt1 - pt2, axis=-1)
        _h = np.linalg.norm(pt2 - pt3, axis=-1)
        _theta = np.arctan2(-(pt2[..., 0] - pt1[..., 0]),
                            pt2[..., 1] - pt1[..., 1])
        odd = np.equal(np.floor(_theta / (PI * 0.5)) % 2, 0)
        w = np.where(odd, _h, _w)
        h = np.where(odd, _w, _h)
        theta = _theta % (PI * 0.5)
        return np.stack([ctr[..., 0], ctr[..., 1], w, h, theta],
                        -1).astype(np.float32)
    edge1 = np.linalg.norm(pt1 - pt2, axis=-1)
    edge2 = np.linalg.norm(pt2 - pt3, axis=-1)
    a1 = np.arctan2(pt2[..., 1] - pt1[..., 1], pt2[..., 0] - pt1[..., 0])
    a2 = np.arctan2(pt4[..., 1] - pt1[..., 1], pt4[..., 0] - pt1[..., 0])
    angle = _norm_angle_np(np.where(edge1 > edge2, a1, a2), version)
    ctr = (pt1 + pt3) / 2.0
    return np.stack([ctr[..., 0], ctr[..., 1],
                     np.maximum(edge1, edge2), np.minimum(edge1, edge2),
                     angle], -1).astype(np.float32)


def obb2poly_np(obbs: np.ndarray, version: str = "le90") -> np.ndarray:
    """OBBs ``(..., 5)`` -> corner polygons ``(..., 8)`` float32, in
    numpy."""
    del version
    obbs = np.asarray(obbs, np.float32)
    x, y, w, h, a = (obbs[..., i] for i in range(5))
    cosa, sina = np.cos(a), np.sin(a)
    wx, wy = w / 2 * cosa, w / 2 * sina
    hx, hy = -h / 2 * sina, h / 2 * cosa
    return np.stack([x - wx - hx, y - wy - hy, x + wx - hx, y + wy - hy,
                     x + wx + hx, y + wy + hy, x - wx + hx, y - wy + hy],
                    -1).astype(np.float32)
