"""Rotated-box representation conversions.

Port of ``sm3det_tpu/ops/box_convert.py``: ``norm_angle``, ``poly2obb``
(all three conventions), ``obb2poly``, ``obb2xyxy``, ``obb2hbb`` and
``hbb2obb`` (RoI Transformer's stage-1 priors), ``rbbox_flip``,
``gaussian2bbox``, and the host numpy variants ``_norm_angle_np``,
``poly2obb_np`` and ``obb2poly_np`` that the datasets and the DOTA
submission writer use. Oriented boxes are ``(cx, cy, w, h, theta)`` in image
coordinates (y down); ``'le90'`` keeps theta in [-pi/2, pi/2) with ``w`` the
long edge, ``'le135'`` in [-pi/4, 3pi/4), ``'oc'`` in (0, pi/2] with ``w``
the edge the y axis reaches when turned by theta. Every function broadcasts
over leading dimensions.
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


def _poly2obb_oc(polys: torch.Tensor) -> torch.Tensor:
    """Rectangle polygons ``(..., 8)`` -> OBBs in the OpenCV convention:
    the centre is the vertices' mean, theta the first edge's angle to the
    y axis taken modulo pi/2, with w and h swapped where that takes an
    even number of quarter turns."""
    polys = polys.reshape(polys.shape[:-1] + (4, 2))
    ctr = polys.mean(dim=-2)
    pt0, pt1, pt2 = polys[..., 0, :], polys[..., 1, :], polys[..., 2, :]
    _w = _norm2(pt0 - pt1)
    _h = _norm2(pt1 - pt2)
    _theta = torch.atan2(-(pt1[..., 0] - pt0[..., 0]),
                         pt1[..., 1] - pt0[..., 1])
    odd = torch.remainder(torch.floor(_theta / (PI * 0.5)), 2) == 0
    w = torch.where(odd, _h, _w)
    h = torch.where(odd, _w, _h)
    theta = torch.remainder(_theta, PI * 0.5)
    return torch.stack([ctr[..., 0], ctr[..., 1], w, h, theta], dim=-1)


def poly2obb(polys: torch.Tensor, version: str = "le90") -> torch.Tensor:
    """Rectangle polygons ``(..., 8)`` -> OBBs ``(..., 5)``."""
    if version == "oc":
        return _poly2obb_oc(polys)
    if version in ("le135", "le90"):
        return _poly2obb_long_edge(polys, version)
    raise NotImplementedError(f"poly2obb: unknown angle version {version!r}")


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



def hbb2obb(hbbs: torch.Tensor, version: str = "oc") -> torch.Tensor:
    """xyxy horizontal boxes ``(..., 4)`` -> OBBs ``(..., 5)`` of angle 0,
    or with the edges swapped at +-pi/2 where the box is taller than wide
    (``le90`` -pi/2, ``le135`` pi/2); ``oc`` always swaps, at pi/2."""
    x = (hbbs[..., 0] + hbbs[..., 2]) * 0.5
    y = (hbbs[..., 1] + hbbs[..., 3]) * 0.5
    w = hbbs[..., 2] - hbbs[..., 0]
    h = hbbs[..., 3] - hbbs[..., 1]
    if version == "oc":
        return torch.stack([x, y, h, w, torch.full_like(x, PI / 2)], dim=-1)
    swap = w < h
    theta = torch.where(swap, PI / 2 if version == "le135" else -PI / 2,
                        torch.zeros_like(x))
    return torch.stack([x, y, torch.where(swap, h, w),
                        torch.where(swap, w, h), theta], dim=-1)


def obb2hbb(obbs: torch.Tensor, version: str = "oc") -> torch.Tensor:
    """The enclosing horizontal box of OBBs, as an OBB (``hbb2obb`` of
    ``obb2xyxy``)."""
    return hbb2obb(obb2xyxy(obbs, version), version)


FLIP_DIRECTIONS = ("horizontal", "vertical", "diagonal")


def rbbox_flip(obbs: torch.Tensor, img_shape, direction: str = "horizontal",
               version: str = "le90") -> torch.Tensor:
    """OBBs mirrored inside an image of ``img_shape`` (H, W): the centre is
    reflected (x -> W - x, y -> H - y); a horizontal or vertical mirror
    negates the angle (``oc``: swaps the edges and takes pi/2 - a, except
    at a = pi/2), a diagonal one (a half turn) keeps it."""
    if direction not in FLIP_DIRECTIONS:
        raise ValueError(f"rbbox_flip: direction {direction!r}, one of "
                         f"{FLIP_DIRECTIONS}")
    x, y, w, h, a = (obbs[..., i] for i in range(5))
    hgt, wid = img_shape[0], img_shape[1]
    if direction in ("horizontal", "diagonal"):
        x = wid - x
    if direction in ("vertical", "diagonal"):
        y = hgt - y
    if direction != "diagonal":
        if version == "oc":
            rot = a != PI / 2
            w, h = torch.where(rot, h, w), torch.where(rot, w, h)
            a = torch.where(rot, PI / 2 - a, a)
        else:
            a = norm_angle(-a, version)
    return torch.stack([x, y, w, h, a], dim=-1)


def gaussian2bbox(mu: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """2-D Gaussians ``mu`` (..., 2), ``var`` (..., 2, 2) -> the corner
    polygons ``(..., 8)`` of their 3-sigma boxes, through an SVD of
    ``var``: the half sizes are 3 sqrt(s), the axes the rows of ``vt``.
    An SVD fixes each singular vector up to its sign: a flipped row of
    ``vt`` gives the same box with its vertices in the other order."""
    _, s, vt = torch.linalg.svd(var)
    size_half = 3.0 * torch.sqrt(torch.clamp(s, min=0.0))[..., None, :]
    signs = torch.tensor([[-1.0, 1.0], [1.0, 1.0], [1.0, -1.0],
                          [-1.0, -1.0]], dtype=mu.dtype, device=mu.device)
    corners = mu[..., None, :] + (size_half * signs) @ vt
    return corners.reshape(corners.shape[:-2] + (8,))

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
