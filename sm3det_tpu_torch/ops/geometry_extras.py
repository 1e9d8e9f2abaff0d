"""The geometry ops of the rotated zoo beside the IoU kernels.

Port of ``sm3det_tpu/ops/geometry_extras.py``, plain PyTorch on either
device (the JAX functions are plain jnp too; no Pallas kernel):

- ``convex_hull_mask``: which points of (..., N, 2) sets are hull vertices;
- ``min_area_polygons``: the least-area enclosing rectangle of each point
  set, by rotating calipers over every pair direction (N^2 candidates, the
  first least area wins), as (..., 8) corners;
- ``points_in_polygons``; ``box_iou_quadri`` (aligned, or a matrix in
  blocks of rows) and ``convex_iou`` / ``convex_giou`` on it;
  ``diff_iou_rotated``; ``nms_quadri`` (the keep is ``ops/nms.py``'s:
  ``nms_keep.cu`` on the card, the plain greedy keep on the host);
  ``chamfer_distance``;
- ``rotated_feature_align`` of the refinement detectors (R3Det, S2ANet):
  every location of a level re-sampled at its refined rotated anchor, at
  the centre (``points=1``) or at the centre and the four edge midpoints
  (``points=5``), with the bilinear gather of
  ``sm3det_tpu/ops/roi_align_rotated.py`` (``_bilinear_gather``).

Quads take either winding, as in JAX: each quad's sign comes from its
shoelace sum (a degenerate quad counts as counter-clockwise). Where JAX's
gradient is NaN at a zero-length edge (its ``jnp.linalg.norm``), the port's
intersection (``rotated_iou._edge_clip_contrib``) clamps the square before
the root and stays finite.
"""

from __future__ import annotations

import torch

from ..core.bbox.assigners import _argmax_first
from .cuda.nms_keep_kernel import nms_keep, pack_bits
from .rotated_iou import _EPS, _edge_clip_contrib, box_iou_rotated

__all__ = [
    "min_area_polygons", "convex_hull_mask", "convex_iou", "convex_giou",
    "points_in_polygons", "diff_iou_rotated", "box_iou_quadri",
    "nms_quadri", "rotated_feature_align", "chamfer_distance",
    "bilinear_gather",
]


def convex_hull_mask(points, valid=None):
    """(..., N) bool: which points of the (..., N, 2) sets are hull
    vertices (an edge (i, j) with every valid point on one side, to 1e-6
    of cross product). O(N^3), for the 9-point RepPoints sets."""
    n = points.shape[-2]
    if valid is None:
        valid = torch.ones(points.shape[:-1], dtype=torch.bool,
                           device=points.device)
    p_i = points[..., :, None, None, :]
    p_j = points[..., None, :, None, :]
    p_k = points[..., None, None, :, :]
    cross = (p_j[..., 0] - p_i[..., 0]) * (p_k[..., 1] - p_i[..., 1]) - \
        (p_j[..., 1] - p_i[..., 1]) * (p_k[..., 0] - p_i[..., 0])
    vk = valid[..., None, None, :]
    eps = 1e-6
    all_pos = ((cross >= -eps) | ~vk).all(-1)
    all_neg = ((cross <= eps) | ~vk).all(-1)
    not_eye = ~torch.eye(n, dtype=torch.bool, device=points.device)
    is_edge = (all_pos | all_neg) & valid[..., :, None] & \
        valid[..., None, :] & not_eye
    return is_edge.any(-1) & valid


def first_least(area, ux, uy):
    """The candidate direction of least area, the first of equals
    (``jnp.argmin``). A set whose hull is a triangle has three rectangles
    of the same area in exact arithmetic (each edge times its height), so
    rounding decides among them, and two programs may decide differently;
    ``min_area_polygons`` calls the module's ``_pick``, which a comparison
    of two programs may point at another rule (the other's choice)."""
    del ux, uy
    return _argmax_first(-area, -1)


_pick = first_least


def min_area_polygons(points, valid=None):
    """The least-area enclosing rectangle of each (..., N, 2) point set, as
    (..., 8) corners (a0 b0, a1 b0, a1 b1, a0 b1 in the chosen frame:
    counter-clockwise).

    Every pair direction p_j - p_i is a candidate (the hull's edges among
    them); the first of least area wins, as ``jnp.argmin`` takes it. The
    zero directions (i == j, coincident points) are replaced by (1, 0)
    before the root and the division, so that no NaN reaches the gradient
    (JAX's double ``where``), and get an infinite area."""
    n = points.shape[-2]
    lead = points.shape[:-2]
    if valid is None:
        valid = torch.ones(points.shape[:-1], dtype=torch.bool,
                           device=points.device)
    d = (points[..., None, :, :] - points[..., :, None, :]).reshape(
        lead + (n * n, 2))
    dv = (valid[..., :, None] & valid[..., None, :]).reshape(lead + (n * n,))
    ok = dv & (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] > 1e-12)
    dx = torch.where(ok, d[..., 0], 1.0)
    dy = torch.where(ok, d[..., 1], 0.0)
    norm = torch.sqrt(dx * dx + dy * dy)
    ux = torch.where(ok, dx / norm, 1.0)
    uy = torch.where(ok, dy / norm, 0.0)

    px = points[..., None, :, 0]                    # (..., 1, N)
    py = points[..., None, :, 1]
    vmask = valid[..., None, :]
    big = 1e10
    a = ux[..., None] * px + uy[..., None] * py     # (..., D, N) along
    b = -uy[..., None] * px + ux[..., None] * py    # perpendicular
    a_min = torch.where(vmask, a, big).amin(-1)
    a_max = torch.where(vmask, a, -big).amax(-1)
    b_min = torch.where(vmask, b, big).amin(-1)
    b_max = torch.where(vmask, b, -big).amax(-1)
    area = (a_max - a_min) * (b_max - b_min)
    area = torch.where(ok, area, torch.inf)
    best = _pick(area, ux, uy)[..., None]

    def take(x):
        return torch.gather(x, -1, best)[..., 0]

    ux_b, uy_b = take(ux), take(uy)
    a0, a1, b0, b1 = take(a_min), take(a_max), take(b_min), take(b_max)
    corners = []
    for aa, bb in ((a0, b0), (a1, b0), (a1, b1), (a0, b1)):
        corners += [ux_b * aa - uy_b * bb, uy_b * aa + ux_b * bb]
    return torch.stack(corners, -1)


def points_in_polygons(points, polygons):
    """(P, 2) points x (G, 8) quads -> (P, G) bool: on or inside the quad
    (every edge's cross product of one sign)."""
    quad = polygons.reshape(polygons.shape[0], 4, 2)
    o = quad[None]
    e = torch.roll(quad, -1, dims=-2)[None]
    p = points[:, None, None, :]
    cr = (e[..., 0] - o[..., 0]) * (p[..., 1] - o[..., 1]) - \
        (e[..., 1] - o[..., 1]) * (p[..., 0] - o[..., 0])
    return (cr >= 0).all(-1) | (cr <= 0).all(-1)


def _poly_area(c):
    """Signed shoelace area of (..., 4, 2) quads."""
    nxt = torch.roll(c, -1, dims=-2)
    return 0.5 * (c[..., 0] * nxt[..., 1] - c[..., 1] * nxt[..., 0]).sum(-1)


def _winding(c):
    """+1 counter-clockwise (or degenerate), -1 clockwise."""
    area = _poly_area(c)
    return torch.sign(area) + (area.abs() < _EPS).to(area.dtype)


def quad_intersection_area(corners1, corners2):
    """Intersection area of two convex quads (..., 4, 2) of either winding
    (JAX's ``rotated_intersection_area``; the port's own takes
    counter-clockwise quads only)."""
    c1 = corners1.float()
    c2 = corners2.float()
    s1, s2 = _winding(c1), _winding(c2)
    area = _edge_clip_contrib(c1, c2, 1e-4, s1, s2) + \
        _edge_clip_contrib(c2, c1, -1e-4, s2, s1)
    return torch.clamp(area, min=0.0)


def _quad_iou(c1, c2, a1, a2):
    inter = quad_intersection_area(c1, c2)
    union = a1 + a2 - inter
    return torch.where(union > 1e-6, inter / torch.clamp(union, min=1e-6),
                       torch.zeros_like(inter))


QUADRI_ROWS = 1024         # rows of a block of box_iou_quadri's matrix


def box_iou_quadri(quads1, quads2, aligned: bool = False):
    """IoU of quads given as (..., N, 8) corners.

    ``aligned``: (..., N) x (..., N) -> (..., N). Otherwise (..., N, 8) x
    (..., M, 8) -> (..., N, M), ``QUADRI_ROWS`` rows at a time, so that the
    (rows, M, 4, 2) operands and the (rows, M, 4, 4) clipping temporaries
    stay bounded (13343 RepPoints sets x 64 gts at 800^2)."""
    c1 = quads1.reshape(quads1.shape[:-1] + (4, 2)).float()
    c2 = quads2.reshape(quads2.shape[:-1] + (4, 2)).float()
    a1 = _poly_area(c1).abs()
    a2 = _poly_area(c2).abs()
    if aligned:
        return _quad_iou(c1, c2, a1, a2)
    n, m = c1.shape[-3], c2.shape[-3]
    lead = torch.broadcast_shapes(c1.shape[:-3], c2.shape[:-3])
    cc2 = c2[..., None, :, :, :]
    out = []
    for r0 in range(0, max(n, 1), QUADRI_ROWS):
        rows = c1[..., r0:r0 + QUADRI_ROWS, None, :, :]
        shape = lead + (rows.shape[-4], m, 4, 2)
        out.append(_quad_iou(rows.expand(shape), cc2.expand(shape),
                             a1[..., r0:r0 + QUADRI_ROWS, None],
                             a2[..., None, :]))
    return out[0] if len(out) == 1 else torch.cat(out, dim=-2)


def convex_iou(pred_points, gt_quads, pred_valid=None):
    """IoU of each point set's least-area rectangle with every gt quad:
    (..., N, P, 2) x (..., G, 8) -> (..., N, G)."""
    return box_iou_quadri(min_area_polygons(pred_points, pred_valid),
                          gt_quads)


def convex_giou(pred_points, gt_quads, pred_valid=None):
    """GIoU of each point set's least-area rectangle with its own gt quad:
    (..., N, P, 2) x (..., N, 8) -> (..., N); the enclosing box is the
    axis-aligned one of both quads' corners. Gradients by autograd."""
    rect = min_area_polygons(pred_points, pred_valid)
    c1 = rect.reshape(rect.shape[:-1] + (4, 2)).float()
    c2 = gt_quads.reshape(gt_quads.shape[:-1] + (4, 2)).float()
    a1, a2 = _poly_area(c1).abs(), _poly_area(c2).abs()
    iou = _quad_iou(c1, c2, a1, a2)
    allp = torch.cat([c1, c2], dim=-2)
    enclose = (allp[..., 0].amax(-1) - allp[..., 0].amin(-1)) * \
        (allp[..., 1].amax(-1) - allp[..., 1].amin(-1))
    union = a1 + a2 - quad_intersection_area(c1, c2)
    return iou - (enclose - union) / torch.clamp(enclose, min=1e-6)


def diff_iou_rotated(boxes1, boxes2):
    """Differentiable aligned rotated IoU: the sort-free clipping IoU and
    its autograd."""
    return box_iou_rotated(boxes1, boxes2, aligned=True)


def nms_quadri(quads, scores, iou_threshold: float, max_out: int):
    """Greedy NMS of (N, 8) quads, or a (B, N, 8) batch: (idx (max_out,)
    into the input or -1, valid), kept boxes first in score order (ties to
    the lower index). The suppression bits are packed from the quad IoU
    matrix and resolved by ``ops/nms.py``'s keep (``nms_keep.cu`` on the
    card: no host synchronisation)."""
    single = quads.dim() == 2
    if single:
        quads, scores = quads[None], scores[None]
    n = scores.shape[-1]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    q_s = torch.gather(quads, 1, order[..., None].expand(-1, -1, 8))
    s_s = torch.gather(scores, 1, order)
    sup = box_iou_quadri(q_s, q_s) > iou_threshold
    keep = nms_keep(pack_bits(sup), s_s > -torch.inf)
    # the kept entries' ranks, packed first (jnp.nonzero(size=max_out))
    rank = torch.cumsum(keep.long(), dim=-1) - 1
    slot = torch.where(keep, rank, n)
    inv = torch.full((keep.shape[0], max(max_out, n) + 1), n,
                     dtype=torch.long, device=keep.device)
    inv.scatter_(1, slot, torch.arange(n, device=keep.device)
                 .expand_as(slot))
    inv[:, n] = n
    take = inv[:, :max_out]
    valid = take < n
    out_idx = torch.where(valid, torch.gather(
        order, 1, torch.where(valid, take, 0)), -1)
    return (out_idx[0], valid[0]) if single else (out_idx, valid)


def chamfer_distance(xyz1, xyz2, valid1=None, valid2=None):
    """Bidirectional chamfer distance of (N1, 2) and (N2, 2) point sets:
    (dist1 (N1,), dist2 (N2,)), each point's squared distance to the
    nearest valid point of the other set (0 for an invalid point)."""
    d = ((xyz1[:, None, :] - xyz2[None, :, :]) ** 2).sum(-1)
    big = 1e10
    if valid2 is not None:
        d = torch.where(valid2[None, :], d, big)
    dist1 = d.amin(1)
    d2 = d.T
    if valid1 is not None:
        d2 = torch.where(valid1[None, :], d2, big)
    dist2 = d2.amin(1)
    if valid1 is not None:
        dist1 = torch.where(valid1, dist1, 0.0)
    if valid2 is not None:
        dist2 = torch.where(valid2, dist2, 0.0)
    return dist1, dist2


def bilinear_gather(feat: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """feat (B, H, W, C); y, x (B, ...) sample coordinates in pixels of
    the image they index -> (B, ..., C) in fp32. A coordinate is clamped
    to the map; a sample beyond [-1, H] x [-1, W] is 0."""
    b, h, w, c = feat.shape
    oob = (y < -1.0) | (y > h * 1.0) | (x < -1.0) | (x > w * 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x = torch.clamp(x, 0.0, w - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly = (y - y0.to(y.dtype))[..., None]
    lx = (x - x0.to(x.dtype))[..., None]
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feat.reshape(b * h * w, c)
    base = (torch.arange(b, device=feat.device) * (h * w)).reshape(
        (b,) + (1,) * (y.dim() - 1))

    def tap(yy, xx):
        return flat[base + yy * w + xx].float()

    out = hy * hx * tap(y0, x0) + hy * lx * tap(y0, x1) + \
        ly * hx * tap(y1, x0) + ly * lx * tap(y1, x1)
    return torch.where(oob[..., None], torch.zeros((), device=out.device),
                       out)


def rotated_feature_align(features: torch.Tensor, best_rboxes: torch.Tensor,
                          points: int = 1, spatial_scale: float = 1.0):
    """R3Det's feature refinement.

    features: (B, H, W, C); best_rboxes: (B, H, W, 5) the refined anchor
    of each location, in image coordinates. The samples are summed in the
    order centre, +w/2, -w/2, +h/2, -h/2, then divided by their count, in
    fp32; the result is rounded once to the features' dtype."""
    cx = best_rboxes[..., 0] * spatial_scale
    cy = best_rboxes[..., 1] * spatial_scale
    bw = best_rboxes[..., 2] * spatial_scale
    bh = best_rboxes[..., 3] * spatial_scale
    a = best_rboxes[..., 4]
    cos_a, sin_a = torch.cos(a), torch.sin(a)
    if points == 1:
        offsets = [(0.0, 0.0)]
    else:
        offsets = [(0.0, 0.0), (0.5, 0.0), (-0.5, 0.0), (0.0, 0.5),
                   (0.0, -0.5)]
    out = None
    for dx, dy in offsets:
        px = cx + dx * bw * cos_a - dy * bh * sin_a
        py = cy + dx * bw * sin_a + dy * bh * cos_a
        sampled = bilinear_gather(features, py, px)
        out = sampled if out is None else out + sampled
    return (out / len(offsets)).to(features.dtype)
