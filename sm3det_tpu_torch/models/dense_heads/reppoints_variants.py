"""The RepPoints variants: RotatedRepPoints, SAMRepPoints, G-RepPoints.

Port of ``sm3det_tpu/models/dense_heads/reppoints_variants.py``: the heads
(``RotatedRepPointsHead``, ``SAMRepPointsHead``) are
``OrientedRepPointsHead``'s tower, registered under those names by the
builder; ``reppoints_variant_loss`` is one
loss with a ``variant`` switch, batched over images instead of ``vmap``:

- ``rotated``: the convex GIoU loss on both stages (init times 0.375),
  the refine stage assigned by MaxConvexIoU (``convex_assign``,
  positives from IoU 0.5) of the init point sets (no gradient);
- ``sam``: the same box losses, the refine stage assigned by
  ``sas_assign`` (the 9 nearest locations inside each gt);
- ``kld``: ``kld_reppoints_loss`` on both stages, ``convex_assign`` from
  IoU 0.4;

with the init stage assigned to the nearest gt holding the location,
the sigmoid focal loss on the refine assignment, and under
``spatial_border`` the spatial border losses (0.05 init, 0.1 refine,
each the mean over the images of one image's loss).
"""

from __future__ import annotations

import torch

from ...core.bbox.assigners import convex_assign, sas_assign
from ...ops.box_convert import obb2poly
from ...ops.geometry_extras import convex_giou
from ..losses import (kld_reppoints_loss, sigmoid_focal_loss,
                      spatial_border_loss)
from .oriented_reppoints_head import (STRIDES,
                                      _gather_gts, flatten_levels,
                                      init_assign, level_points,
                                      offsets_to_points)

VARIANTS = ("rotated", "sam", "kld")


def reppoints_variant_loss(cls_scores, init_offsets, refine_offsets,
                           gt_obbs, gt_labels, gt_mask, num_classes: int,
                           strides=STRIDES, version: str = "le90",
                           variant: str = "rotated",
                           spatial_border: bool = False):
    """The losses of a batch: dict(loss_cls, loss_pts_init,
    loss_pts_refine[, loss_spatial_init, loss_spatial_refine])."""
    if variant not in VARIANTS:
        raise ValueError(f"RepPoints variant {variant!r}: one of {VARIANTS}")
    dev = cls_scores[0].device
    nc = num_classes
    centers, stride_vec = level_points(cls_scores, strides, dev)
    flat_cls, flat_init, flat_refine = flatten_levels(
        cls_scores, init_offsets, refine_offsets, nc)
    gt_polys = obb2poly(gt_obbs, version)                    # (B, G, 8)
    # JAX also makes the sets' OBBs here, which no loss reads
    init_pts = offsets_to_points(flat_init, centers, stride_vec)
    refine_pts = offsets_to_points(flat_refine, centers, stride_vec)

    def box_loss(pts, polys, w):
        if variant == "kld":
            return kld_reppoints_loss(pts, polys, weight=w, avg_factor=1.0)
        return ((1.0 - convex_giou(pts, polys)) * w).sum()

    init_gt, init_pos = init_assign(centers, gt_obbs, gt_mask)
    init_w = init_pos.float()
    init_polys = _gather_gts(gt_polys, init_gt)
    l_init = box_loss(init_pts, init_polys, init_w)
    if variant == "sam":
        assigned = torch.stack([sas_assign(centers, stride_vec, g, m,
                                           topk=9)
                                for g, m in zip(gt_obbs, gt_mask)])
    else:
        assigned = convex_assign(
            init_pts.detach(), gt_polys, gt_mask,
            pos_iou_thr=0.5 if variant == "rotated" else 0.4,
            neg_iou_thr=0.4)
    pos = assigned > 0
    gt_idx = torch.clamp(assigned.long() - 1, min=0)
    pos_w = pos.float()
    cls_t = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx), nc)
    l_cls = sigmoid_focal_loss(flat_cls.reshape(-1, nc), cls_t.reshape(-1),
                               avg_factor=1.0)
    refine_polys = _gather_gts(gt_polys, gt_idx)
    l_refine = box_loss(refine_pts, refine_polys, pos_w)
    t_pos = torch.clamp(pos.sum().float(), min=1.0)
    t_init = torch.clamp(init_pos.sum().float(), min=1.0)
    out = {"loss_cls": l_cls / t_pos,
           "loss_pts_init": 0.375 * l_init / t_init,
           "loss_pts_refine": l_refine / t_pos}
    if spatial_border:
        b = gt_obbs.shape[0]
        sp_init = sum(spatial_border_loss(init_pts[i], init_polys[i],
                                          init_w[i]) for i in range(b))
        sp_refine = sum(spatial_border_loss(refine_pts[i], refine_polys[i],
                                            pos_w[i]) for i in range(b))
        out["loss_spatial_init"] = 0.05 * sp_init / b
        out["loss_spatial_refine"] = 0.1 * sp_refine / b
    return out
