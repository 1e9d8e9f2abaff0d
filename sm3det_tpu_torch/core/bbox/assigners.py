"""Static-shape box assigners.

Port of ``max_iou_assign``, ``atss_assign``, ``convex_assign`` and
``sas_assign`` of ``sm3det_tpu/core/bbox/assigners.py``. Ground truths
arrive padded to ``G`` with a validity mask; each assigner returns per
prior the mmdet encoding: -1 ignore, 0 negative, ``k > 0`` the (k - 1)-th
gt. The IoU matrix comes from the caller (``convex_assign`` makes its
own), so one assigner serves horizontal and rotated boxes.
Ties break as the JAX functions' do: ``argmax`` takes the first maximum
and the per-level top-k keeps the lower index.
"""

from __future__ import annotations

import torch


def _argmax_first(x, dim):
    """Index of the first maximum along ``dim`` (``jnp.argmax``)."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device)
    shape = [1] * x.dim()
    shape[dim] = n
    is_max = x == x.amax(dim=dim, keepdim=True)
    return torch.where(is_max, idx.reshape(shape),
                       torch.full_like(idx, n).reshape(shape)).amin(dim=dim)


def max_iou_assign(ious, gt_mask, pos_iou_thr, neg_iou_thr, min_pos_iou=0.0,
                   match_low_quality=True):
    """mmdet ``MaxIoUAssigner`` on a (P, G) IoU matrix; gt_mask (G,) bool.
    Returns (P,) int32 (``gt_max_assign_all``: every prior that reaches a
    gt's best IoU is matched to it, a later gt over an earlier one)."""
    ious = torch.where(gt_mask[None, :], ious, torch.full_like(ious, -1.0))
    max_overlaps = ious.amax(dim=1)
    argmax_overlaps = _argmax_first(ious, 1)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           0, -1)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps + 1,
                           assigned)
    if match_low_quality:
        gt_max = ious.amax(dim=0)
        eligible = gt_mask & (gt_max > min_pos_iou)
        is_gt_argmax = (ious == gt_max[None, :]) & eligible[None, :]
        gt_ids = torch.arange(1, ious.shape[1] + 1, device=ious.device)
        low_q = torch.where(is_gt_argmax, gt_ids[None, :], 0).amax(dim=1)
        assigned = torch.where(low_q > 0, low_q, assigned)
    return assigned.to(torch.int32)


def atss_assign(ious, priors_cxcy, gt_hbboxes, gt_mask, num_level_priors,
                topk=9):
    """mmdet ``ATSSAssigner`` with static shapes.

    ious (P, G) horizontal IoU; priors_cxcy (P, 2); gt_hbboxes (G, 4) xyxy;
    gt_mask (G,); num_level_priors: priors per level. Candidates are the
    ``topk`` priors per level nearest each gt centre; the IoU threshold is
    the candidates' mean plus their unbiased standard deviation; a positive
    prior's centre lies inside the gt by more than 0.01. Returns
    (assigned (P,) int32, max_overlaps (P,)).
    """
    num_priors, num_gt = ious.shape
    gt_points = torch.stack([(gt_hbboxes[:, 0] + gt_hbboxes[:, 2]) / 2.0,
                             (gt_hbboxes[:, 1] + gt_hbboxes[:, 3]) / 2.0], -1)
    distances = torch.linalg.vector_norm(
        priors_cxcy[:, None, :] - gt_points[None, :, :], dim=-1)
    parts, start = [], 0
    for n in num_level_priors:
        level_dist = distances[start:start + n]
        k = min(topk, n)
        # lax.top_k(-d) keeps the lower index on ties: a stable ascending
        # sort of d
        order = torch.sort(level_dist.T, dim=-1, stable=True).indices[:, :k]
        mask = torch.zeros((num_gt, n), dtype=torch.bool, device=ious.device)
        mask.scatter_(1, order, True)
        parts.append(mask.T)
        start += n
    is_candidate = torch.cat(parts, 0)

    count = is_candidate.sum(0).to(ious.dtype)
    zero = torch.zeros_like(ious)
    mean_iou = torch.where(is_candidate, ious, zero).sum(0) / \
        torch.clamp(count, min=1.0)
    sq_dev = torch.where(is_candidate, (ious - mean_iou[None, :]) ** 2, zero)
    std_iou = torch.sqrt(sq_dev.sum(0) / torch.clamp(count - 1.0, min=1.0))
    is_pos = is_candidate & (ious >= (mean_iou + std_iou)[None, :])

    cx = priors_cxcy[:, 0][:, None]
    cy = priors_cxcy[:, 1][:, None]
    inside = (cx - gt_hbboxes[None, :, 0] > 0.01) & \
        (cy - gt_hbboxes[None, :, 1] > 0.01) & \
        (gt_hbboxes[None, :, 2] - cx > 0.01) & \
        (gt_hbboxes[None, :, 3] - cy > 0.01)
    is_pos = is_pos & inside & gt_mask[None, :]

    pos_ious = torch.where(is_pos, ious, torch.full_like(ious, -torch.inf))
    max_pos = pos_ious.amax(dim=1)
    has_pos = max_pos > -torch.inf
    assigned = torch.where(has_pos, _argmax_first(pos_ious, 1) + 1, 0)
    masked = torch.where(gt_mask[None, :], ious, torch.full_like(ious, -1.0))
    max_overlaps = torch.where(has_pos, max_pos, masked.amax(dim=1))
    return assigned.to(torch.int32), max_overlaps


def convex_assign(pred_points, gt_polys, gt_mask, pos_iou_thr=0.5,
                  neg_iou_thr=0.4, valid_points=None):
    """mmrotate's ConvexAssigner / MaxConvexIoUAssigner: ``max_iou_assign``
    of point sets (P, K, 2) against gt quads (G, 8) on the IoU of each
    set's least-area rectangle (``ops/geometry_extras.convex_iou``, in
    blocks of rows). A leading batch axis, (B, P, K, 2) x (B, G, 8) with
    gt_mask (B, G), gives (B, P)."""
    from ...ops.geometry_extras import convex_iou
    ious = convex_iou(pred_points, gt_polys, valid_points)

    def one(iou, mask):
        iou = torch.where(mask[None, :], iou, torch.full_like(iou, -1.0))
        return max_iou_assign(iou, mask, pos_iou_thr=pos_iou_thr,
                              neg_iou_thr=neg_iou_thr, min_pos_iou=0.0,
                              match_low_quality=True)
    if ious.dim() == 3:
        return torch.stack([one(i, m) for i, m in zip(ious, gt_mask)])
    return one(ious, gt_mask)


def sas_assign(points, stride_vec, gt_obbs, gt_mask, topk: int = 9):
    """mmrotate's SASAssigner with static shapes: per gt the ``topk``
    points (P, 2) nearest its centre, in units of sqrt(w h), that lie
    inside it; a point positive for several gts takes the nearest.
    ``stride_vec`` is taken, unused, as in JAX. Returns (P,) int32.

    The top-k runs over distances with 1e6 added outside a gt or for a
    padded gt, ties to the lower index (``lax.top_k``: ``stable_topk``);
    the candidates are set with a ``scatter_`` into a bool tensor."""
    from ...models.moe import stable_topk
    del stride_vec
    g = gt_obbs.shape[0]
    cx, cy, w, h, th = (gt_obbs[:, i] for i in range(5))
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    dx = points[:, 0][:, None] - cx[None]
    dy = points[:, 1][:, None] - cy[None]
    fx = cos_t[None] * dx + sin_t[None] * dy
    fy = -sin_t[None] * dx + cos_t[None] * dy
    inside = (fx.abs() < w[None] / 2) & (fy.abs() < h[None] / 2)
    scale = torch.sqrt(w * h)[None]
    dist = torch.sqrt(dx * dx + dy * dy) / torch.clamp(scale, min=1e-6)
    dist = dist + (1.0 - inside.to(dist.dtype)) * 1e6 + \
        (~gt_mask)[None].to(dist.dtype) * 1e6
    k = min(topk, points.shape[0])
    _, top_idx = stable_topk(-dist.T, k)                    # (G, k)
    cand = torch.zeros((g, points.shape[0]), dtype=torch.bool,
                       device=points.device)
    cand.scatter_(1, top_idx, True)
    is_pos = cand.T & inside & gt_mask[None]
    d_masked = torch.where(is_pos, dist, torch.full_like(dist, torch.inf))
    has = torch.isfinite(d_masked.amin(1))
    best = _argmax_first(-d_masked, 1)
    return torch.where(has, best + 1, 0).to(torch.int32)
