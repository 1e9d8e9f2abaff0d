"""Gliding-Vertex coders.

Port of ``sm3det_tpu/core/bbox/gv_coders.py``: ``GVFixCoder`` encodes an
oriented box as the four fractions along its enclosing horizontal box's
edges at which its vertices touch them (top, right, down, left) and decodes
them back into a polygon; ``GVRatioCoder`` encodes the ratio of the
oriented box's area to the horizontal box's. Ties among the vertices break
as ``jnp.argmin`` / ``argmax`` do: the first extreme wins.
"""

from __future__ import annotations

import torch

from ...ops.box_convert import obb2poly, obb2xyxy
from .assigners import _argmax_first


def _pick(vals, idx):
    return torch.gather(vals, -1, idx[..., None])[..., 0]


class GVFixCoder:
    def __init__(self, angle_range: str = "le90"):
        self.version = angle_range

    def encode(self, obbs):
        """(..., 5) -> (..., 4) edge-sliding fractions (t, r, d, l)."""
        polys = obb2poly(obbs, self.version)
        xs, ys = polys[..., 0::2], polys[..., 1::2]
        xmin, xmax = xs.amin(-1), xs.amax(-1)
        ymin, ymax = ys.amin(-1), ys.amax(-1)
        w = torch.clamp(xmax - xmin, min=1e-6)
        h = torch.clamp(ymax - ymin, min=1e-6)
        # the vertex touching each edge: the top edge's x is that of the
        # vertex of least y, and so on round the box
        top_x = _pick(xs, _argmax_first(-ys, -1))
        right_y = _pick(ys, _argmax_first(xs, -1))
        down_x = _pick(xs, _argmax_first(ys, -1))
        left_y = _pick(ys, _argmax_first(-xs, -1))
        return torch.stack([(top_x - xmin) / w, (right_y - ymin) / h,
                            (xmax - down_x) / w, (ymax - left_y) / h], -1)

    def decode(self, hbbs, fix_deltas):
        """hbbs (..., 4) xyxy and fractions (..., 4) -> polygons (..., 8)."""
        x1, y1, x2, y2 = (hbbs[..., i] for i in range(4))
        w, h = x2 - x1, y2 - y1
        t, r, d, l = (torch.clamp(fix_deltas[..., i], 0, 1)
                      for i in range(4))
        return torch.stack([x1 + t * w, y1, x2, y1 + r * h,
                            x2 - d * w, y2, x1, y2 - l * h], -1)


class GVRatioCoder:
    def __init__(self, angle_range: str = "le90"):
        self.version = angle_range

    def encode(self, obbs):
        """(..., 5) -> (..., 1) area(obb) / area(hbb)."""
        hbb = obb2xyxy(obbs, self.version)
        area_h = torch.clamp((hbb[..., 2] - hbb[..., 0])
                             * (hbb[..., 3] - hbb[..., 1]), min=1e-6)
        return (obbs[..., 2] * obbs[..., 3] / area_h)[..., None]
