"""Rotated-box IoU by sort-free convex clipping, plain PyTorch.

Port of ``sm3det_tpu/ops/rotated_iou.py`` (``obb_corners``,
``_edge_clip_contrib``, ``rotated_intersection_area``, ``box_iou_rotated``).
The boundary of the intersection of two convex quads A and B is (the part
of A's boundary inside B) plus (the part of B's boundary inside A); each
straight piece adds ``0.5 * cross(start, end)`` to the shoelace sum, in any
order, so nothing is sorted. This is the plain version of the CUDA kernel
``ops/cuda/csrc/rotated_iou.cu`` and runs wherever the tensors lie; every
product, sum and quotient is a separate, separately rounded operation in
the order the kernel uses.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def obb_corners(obbs: torch.Tensor) -> torch.Tensor:
    """Corners of ``(..., 5)`` OBBs -> ``(..., 4, 2)``, counter-clockwise in
    the (x, y) plane for non-negative w and h."""
    x, y, w, h, a = (obbs[..., i] for i in range(5))
    cosa, sina = torch.cos(a), torch.sin(a)
    wx, wy = w / 2 * cosa, w / 2 * sina
    hx, hy = -h / 2 * sina, h / 2 * cosa
    corners = torch.stack([
        x - wx - hx, y - wy - hy,
        x + wx - hx, y + wy - hy,
        x + wx + hx, y + wy + hy,
        x - wx + hx, y - wy + hy], dim=-1)
    return corners.reshape(corners.shape[:-1] + (4, 2))


def _edge_clip_contrib(sub, clip, eps_inside: float):
    """Green's-theorem contribution of ``sub``'s edges clipped to the inside
    of the convex quad ``clip``; both ``(..., 4, 2)``, counter-clockwise.

    An edge P(t) = p + t (q - p) is inside ``clip`` on one interval
    [t_lo, t_hi]; its contribution is 0.5 * cross(P(t_lo), P(t_hi)).
    ``eps_inside`` shifts the half-plane test (in pixels) so that an edge
    lying on the other quad's boundary is counted once, not twice.
    """
    p = sub
    q = torch.roll(sub, -1, dims=-2)
    d = q - p
    o = clip
    e = torch.roll(clip, -1, dims=-2) - o
    e_len = torch.clamp(
        torch.sqrt(e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]), min=_EPS)

    # signed distance of P(t) to clip edge k: a + t * b, positive inside
    po = p[..., :, None, :] - o[..., None, :, :]          # (..., 4s, 4c, 2)
    ek = e[..., None, :, :]
    el = e_len[..., None, :]
    a = (ek[..., 0] * po[..., 1] - ek[..., 1] * po[..., 0]) / el
    dk = d[..., :, None, :]
    b = (ek[..., 0] * dk[..., 1] - ek[..., 1] * dk[..., 0]) / el
    a = a + eps_inside
    safe_b = torch.where(b.abs() < _EPS, torch.full_like(b, _EPS), b)
    t_cross = -a / safe_b
    zero, one = torch.zeros_like(b), torch.ones_like(b)
    outside = (b.abs() < _EPS) & (a < 0)
    t_lo_k = torch.where(outside, one, torch.where(b > _EPS, t_cross, zero))
    t_hi_k = torch.where(outside, zero, torch.where(b < -_EPS, t_cross, one))
    t_lo = torch.clamp(t_lo_k.amax(dim=-1), 0.0, 1.0)     # (..., 4s)
    t_hi = torch.clamp(t_hi_k.amin(dim=-1), 0.0, 1.0)
    valid = t_hi > t_lo

    x0 = p[..., 0] + t_lo * d[..., 0]
    y0 = p[..., 1] + t_lo * d[..., 1]
    x1 = p[..., 0] + t_hi * d[..., 0]
    y1 = p[..., 1] + t_hi * d[..., 1]
    c = 0.5 * (x0 * y1 - y0 * x1)
    c = torch.where(valid, c, torch.zeros_like(c))
    return ((c[..., 0] + c[..., 1]) + c[..., 2]) + c[..., 3]


def rotated_intersection_area(corners1, corners2):
    """Intersection area of two convex counter-clockwise quads
    ``(..., 4, 2)`` (``obb_corners`` order) with matching leading
    dimensions.

    The JAX function also multiplies by each quad's winding sign, which it
    takes from a shoelace sum; ``obb_corners`` only makes counter-clockwise
    quads, where that sign is +1, and neither the TPU kernel nor the CUDA
    kernel takes it. It is left out here too: under the multi-class NMS's
    class offsets (coordinates of 1e5 px) the shoelace sum of a small box
    is rounding noise, and a sign taken from it would flip boxes at random.
    """
    c1 = corners1.float()
    c2 = corners2.float()
    # A's edges count on or inside B, B's edges strictly inside A, so a
    # shared boundary is counted exactly once
    area = _edge_clip_contrib(c1, c2, 1e-4) + \
        _edge_clip_contrib(c2, c1, -1e-4)
    return torch.clamp(area, min=0.0)


def _iou_from_corners(c1, c2, area1, area2, mode):
    inter = rotated_intersection_area(c1, c2)
    if mode == "iou":
        union = area1 + area2 - inter
    elif mode == "iof":
        union = area1.expand_as(inter)
    else:
        raise ValueError(mode)
    return torch.where(union > _EPS, inter / torch.clamp(union, min=_EPS),
                       torch.zeros_like(inter))


def box_iou_rotated(boxes1, boxes2, mode: str = "iou",
                    aligned: bool = False, row_chunk: int = 256):
    """Rotated IoU of ``(cx, cy, w, h, theta)`` boxes.

    ``aligned=False``: ``(..., N, 5) x (..., M, 5) -> (..., N, M)``, computed
    ``row_chunk`` rows at a time so that the ``(rows, M, 4, 4)`` temporaries
    stay bounded; ``aligned=True``: pairwise ``(..., N)``. ``mode`` is
    ``'iou'`` or ``'iof'`` (intersection over the first box's area).
    """
    if mode not in ("iou", "iof"):
        raise ValueError(mode)
    area1 = boxes1[..., 2] * boxes1[..., 3]
    area2 = boxes2[..., 2] * boxes2[..., 3]
    c1 = obb_corners(boxes1)
    c2 = obb_corners(boxes2)
    if aligned:
        return _iou_from_corners(c1, c2, area1, area2, mode)
    n, m = boxes1.shape[-2], boxes2.shape[-2]
    lead = torch.broadcast_shapes(boxes1.shape[:-2], boxes2.shape[:-2])
    c2 = c2[..., None, :, :, :].expand(lead + (1, m, 4, 2))
    area2 = area2[..., None, :]
    out = []
    for r0 in range(0, max(n, 1), row_chunk):
        rows = c1[..., r0:r0 + row_chunk, None, :, :]
        shape = lead + (rows.shape[-4], m, 4, 2)
        out.append(_iou_from_corners(
            rows.expand(shape), c2.expand(shape),
            area1[..., r0:r0 + row_chunk, None], area2, mode))
    return out[0] if len(out) == 1 else torch.cat(out, dim=-2)


def box_iou_rotated_chunked(boxes1, boxes2, row_chunk: int = 256):
    """(..., N, 5) x (..., M, 5) -> (..., N, M) rotated IoU with a bounded
    working set (``box_iou_rotated_chunked`` of the JAX package; the
    RetinaNet assigner's anchors against the gts).

    A CUDA tensor goes through the IoU kernel's matrix mode
    (``ops/cuda/rotated_iou_kernel.rotated_iou``, one launch, every value
    equal to the plain version's), a CPU tensor through
    :func:`box_iou_rotated` in blocks of ``row_chunk`` rows."""
    if boxes1.is_cuda:
        from .cuda.rotated_iou_kernel import rotated_iou
        return rotated_iou(boxes1, boxes2)
    return box_iou_rotated(boxes1, boxes2, row_chunk=row_chunk)
