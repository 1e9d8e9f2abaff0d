"""Static-shape NMS, horizontal and rotated.

Port of ``sm3det_tpu/ops/nms.py``: every function returns fixed-size
outputs with a validity mask. Each greedy function takes one image
(``(N, 4)`` or ``(N, 5)`` boxes) or a batch (``(B, N, ...)``); a batch is
one suppression-mask launch and one keep launch for all its images.
``soft_nms`` takes one image: its IoU matrix is
``ops/cuda/hbb_iou_kernel.hbb_iou``'s (the kernel's matrix mode on the
card), and its ``max_out`` selection steps are device operations.

The suppression decisions ``iou > thr`` of the score-ordered boxes come as
packed bits from ``ops/cuda/hbb_iou_kernel.hbb_nms_mask`` or
``ops/cuda/rotated_iou_kernel.rotated_nms_mask``, and the keep mask from
``ops/cuda/nms_keep_kernel.nms_keep``, equal to sequential greedy NMS: the
kernels on a CUDA tensor, their plain versions on a CPU tensor. On the
card the functions here make no host synchronisation. Ties in score keep
the lower index first, as JAX's stable sorts do.
"""

from __future__ import annotations

import torch

from .cuda.hbb_iou_kernel import hbb_iou, hbb_nms_mask
from .cuda.nms_keep_kernel import greedy_keep, nms_keep  # noqa: F401
from .cuda.rotated_iou_kernel import INERT_GROUP, rotated_nms_mask

NEG_INF = -1e10


def _topk_scores(flat_scores: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(flat_scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def bbox_overlaps(boxes1, boxes2, mode: str = "iou", aligned: bool = False,
                  eps: float = 1e-6):
    """Horizontal IoU/IoF, mmdet ``bbox_overlaps`` semantics."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * \
        (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * \
        (boxes2[..., 3] - boxes2[..., 1])
    if not aligned:
        b1 = boxes1[..., :, None, :]
        b2 = boxes2[..., None, :, :]
        area1 = area1[..., :, None]
        area2 = area2[..., None, :]
    else:
        b1, b2 = boxes1, boxes2
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    if mode == "iou":
        union = area1 + area2 - inter
    elif mode == "iof":
        union = area1
    else:
        raise ValueError(mode)
    return inter / torch.clamp(union, min=eps)


def _finalize(boxes_sorted, scores_sorted, order, keep, max_out):
    """Pack kept entries first, padded to max_out, in score order. Batched
    (B, n, ...)."""
    b, n = keep.shape
    dev = keep.device
    rank = torch.cumsum(keep.long(), dim=-1) - 1
    slot = torch.where(keep, rank, n)
    inv = torch.full((b, max(max_out, n) + 1), n, dtype=torch.long,
                     device=dev)
    inv.scatter_(1, slot, torch.arange(n, device=dev).expand(b, n))
    inv[:, n] = n                       # clear the scratch slot
    take = inv[:, :max_out]
    valid = take < n
    take_safe = torch.where(valid, take, 0)
    out_idx = torch.where(valid, torch.gather(order, 1, take_safe), -1)
    out_boxes = torch.gather(
        boxes_sorted, 1,
        take_safe[..., None].expand(-1, -1, boxes_sorted.shape[-1])) \
        * valid[..., None]
    out_scores = torch.where(valid, torch.gather(scores_sorted, 1, take_safe),
                             0.0)
    return out_boxes, out_scores, out_idx, valid


def _batched(fn):
    """Run a batched (B, N, ...) implementation on one image as well."""
    def wrapper(boxes, scores, *args, **kwargs):
        if boxes.dim() == 2:
            args = [a[None] if torch.is_tensor(a) else a for a in args]
            kwargs = {k: a[None] if torch.is_tensor(a) else a
                      for k, a in kwargs.items()}
            return tuple(o[0] for o in fn(boxes[None], scores[None], *args,
                                          **kwargs))
        return fn(boxes, scores, *args, **kwargs)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


@_batched
def nms(boxes, scores, iou_threshold: float, max_out: int,
        score_thr: float = float("-inf")):
    """Horizontal greedy NMS with static output size.

    boxes (N, 4) xyxy, scores (N,); entries with score <= score_thr are
    ignored. Returns (dets (max_out, 5), idx (max_out,) into the input or
    -1, valid (max_out,) bool); batched inputs give batched outputs.
    """
    order = torch.sort(-scores, dim=-1, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    scores_s = torch.gather(scores, 1, order)
    eligible = scores_s > score_thr
    keep = nms_keep(hbb_nms_mask(boxes_s, iou_threshold), eligible)
    ob, os_, oi, ov = _finalize(boxes_s, scores_s, order, keep, max_out)
    return torch.cat([ob, os_[..., None]], dim=-1), oi, ov


SOFT_NMS_METHODS = ("linear", "gaussian", "naive")


def soft_nms(boxes, scores, iou_threshold: float = 0.3, max_out: int = 100,
             sigma: float = 0.5, min_score: float = 1e-3,
             method: str = "linear"):
    """Soft-NMS with static output size (mmcv ``soft_nms``), one image.

    ``max_out`` times, the box of the highest current score is selected
    (the first of equal maxima) and decays the scores of the others by its
    IoU with them: ``linear`` ``s *= 1 - iou`` where ``iou > thr``,
    ``gaussian`` ``s *= exp(-iou^2 / sigma)``, ``naive`` ``s = 0`` where
    ``iou > thr``. boxes (N, 4) xyxy, scores (N,). Returns (dets (max_out,
    5) with the decayed scores, idx (max_out,) into the input or -1, valid
    (max_out,): a selection scoring above ``min_score``).
    """
    if method not in SOFT_NMS_METHODS:
        raise ValueError(f"soft_nms: method {method!r}, one of "
                         f"{SOFT_NMS_METHODS}")
    n = boxes.shape[0]
    iou = hbb_iou(boxes, boxes)
    iou = iou * (1.0 - torch.eye(n, dtype=iou.dtype, device=iou.device))
    cur = scores.float()
    sel, sel_scores = [], []
    for _ in range(max_out):
        i = torch.argmax(cur, dim=0, keepdim=True)             # (1,)
        row = iou.index_select(0, i)[0]
        if method == "gaussian":
            w = torch.exp(-(row * row) / sigma)
        elif method == "naive":
            w = torch.where(row > iou_threshold, 0.0, 1.0)
        else:
            w = torch.where(row > iou_threshold, 1.0 - row, 1.0)
        sel.append(i)
        sel_scores.append(cur.gather(0, i))
        cur = (cur * w).scatter(0, i, NEG_INF)
    sel = torch.cat(sel)
    sel_scores = torch.cat(sel_scores)
    valid = sel_scores > min_score
    out_boxes = boxes.index_select(0, torch.where(valid, sel, 0)) \
        * valid[:, None]
    out_scores = torch.where(valid, sel_scores, 0.0)
    dets = torch.cat([out_boxes, out_scores[:, None]], dim=-1)
    return dets, torch.where(valid, sel, -1), valid


@_batched
def batched_nms(boxes, scores, idxs, iou_threshold: float, max_out: int,
                score_thr: float = float("-inf")):
    """Class-aware NMS by the coordinate-offset trick (mmcv
    ``batched_nms``): boxes of different ``idxs`` never suppress each
    other. The offset is ``idx * 2 * (max|boxes| + 1)`` per image."""
    max_coord = boxes.abs().amax(dim=(-2, -1)) + 1.0          # (B,)
    offsets = idxs.to(boxes.dtype) * (2.0 * max_coord[:, None])
    dets, oi, ov = nms(boxes + offsets[..., None], scores, iou_threshold,
                       max_out, score_thr)
    safe = torch.where(oi >= 0, oi, 0)
    out_boxes = torch.where(
        ov[..., None], torch.gather(boxes, 1, safe[..., None].expand(
            -1, -1, 4)), 0.0)
    return torch.cat([out_boxes, dets[..., 4:5]], dim=-1), oi, ov


@_batched
def multiclass_nms(multi_bboxes, multi_scores, score_thr: float,
                   iou_thr: float, max_num: int, pre_nms: int = 2000):
    """Multi-class horizontal NMS (mmdet ``multiclass_nms`` semantics).

    multi_bboxes (N, 4) or (N, C*4); multi_scores (N, C+1), the last column
    background. The top ``pre_nms`` (box, class) pairs by score are the
    candidates. Returns (dets (max_num, 5), labels (max_num,) or -1,
    valid (max_num,)).
    """
    num_classes = multi_scores.shape[-1] - 1
    b, n = multi_scores.shape[:2]
    scores = multi_scores[..., :-1]
    k = min(pre_nms, n * num_classes)
    top_scores, top_idx = _topk_scores(scores.reshape(b, -1), k)
    box_idx = top_idx // num_classes
    cls_idx = top_idx % num_classes
    if multi_bboxes.shape[-1] > 4:
        flat = multi_bboxes.reshape(b, n * num_classes, 4)
        cand_boxes = torch.gather(flat, 1, top_idx[..., None].expand(
            -1, -1, 4))
    else:
        cand_boxes = torch.gather(multi_bboxes, 1, box_idx[..., None].expand(
            -1, -1, 4))
    cand_scores = torch.where(top_scores > score_thr, top_scores, NEG_INF)
    dets, oi, ov = batched_nms(cand_boxes, cand_scores, cls_idx, iou_thr,
                               max_num, score_thr=score_thr)
    safe = torch.where(oi >= 0, oi, 0)
    labels = torch.where(ov, torch.gather(cls_idx, 1, safe), -1)
    return dets, labels, ov


def _take(x, idx):
    """Gather rows of (B, N, D) or entries of (B, N) by idx (B, K)."""
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.gather(x, 1, idx)


@_batched
def nms_rotated(boxes, scores, iou_threshold: float, max_out: int,
                score_thr: float = float("-inf"), groups=None):
    """Rotated greedy NMS with static output size.

    boxes (N, 5) ``(cx, cy, w, h, theta)``. ``groups`` (optional, int (N,)
    in [0, 2**15)): boxes of different groups never suppress each other.
    The candidates are then reordered group-major (score order inside a
    group: the same greedy result, since suppression is inside a group
    only), so the suppression matrix is block-diagonal and the banded IoU
    kernel skips the cross-group tiles; entries the NMS may not keep go to
    an inert band at the end. Returns (dets (max_out, 6) with the score
    last, idx (max_out,) into the input or -1, valid (max_out,)), equal to
    the ungrouped result on class-offset boxes.
    """
    order = torch.sort(-scores, dim=-1, stable=True).indices
    boxes_s = _take(boxes, order)
    scores_s = _take(scores, order)
    eligible = scores_s > score_thr
    if groups is None:
        keep = nms_keep(rotated_nms_mask(boxes_s, iou_threshold), eligible)
    else:
        n = boxes.shape[1]
        groups_s = _take(groups, order).long()
        g_eff = torch.where(eligible, groups_s, INERT_GROUP)
        # group-major permutation; the index keeps score order in a group
        g_key = torch.where(eligible, groups_s, 1 << 15)
        perm = torch.sort(
            g_key * n + torch.arange(n, device=boxes.device), dim=-1).indices
        boxes_p = _take(boxes_s, perm)
        g_p = _take(g_eff, perm).int()
        keep_g = nms_keep(rotated_nms_mask(boxes_p, iou_threshold, g_p),
                          _take(eligible, perm))
        keep = torch.zeros_like(keep_g).scatter_(1, perm, keep_g)
    ob, os_, oi, ov = _finalize(boxes_s, scores_s, order, keep, max_out)
    return torch.cat([ob, os_[..., None]], dim=-1), oi, ov


@_batched
def multiclass_nms_rotated(multi_bboxes, multi_scores, score_thr: float,
                           iou_thr: float, max_num: int,
                           pre_nms: int = 2000):
    """Multi-class rotated NMS (mmrotate ``multiclass_nms_rotated``).

    multi_bboxes (N, 5) or (N, C*5); multi_scores (N, C+1), the last column
    background. The top ``pre_nms`` (box, class) pairs by score are the
    candidates; their centres are shifted by a per-class offset so that
    classes never overlap, and the class ids are the groups of the banded
    NMS. Returns (dets (max_num, 6), labels (max_num,) or -1, valid).
    """
    num_classes = multi_scores.shape[-1] - 1
    b, n = multi_scores.shape[:2]
    scores = multi_scores[..., :-1]
    k = min(pre_nms, n * num_classes)
    top_scores, top_idx = _topk_scores(scores.reshape(b, -1), k)
    box_idx = top_idx // num_classes
    cls_idx = top_idx % num_classes
    if multi_bboxes.shape[-1] > 5:
        cand_boxes = _take(multi_bboxes.reshape(b, n * num_classes, 5),
                           top_idx)
    else:
        cand_boxes = _take(multi_bboxes, box_idx)
    cand_scores = torch.where(top_scores > score_thr, top_scores, NEG_INF)
    max_coord = cand_boxes[..., :2].abs().amax(dim=(-2, -1)) + \
        cand_boxes[..., 2:4].amax(dim=(-2, -1)) + 1.0            # (B,)
    offset = cls_idx.to(cand_boxes.dtype) * (2.0 * max_coord[:, None])
    shifted = torch.cat([cand_boxes[..., :2] + offset[..., None],
                         cand_boxes[..., 2:]], dim=-1)
    dets, oi, ov = nms_rotated(shifted, cand_scores, iou_thr, max_num,
                               score_thr=score_thr, groups=cls_idx)
    safe = torch.where(oi >= 0, oi, 0)
    out_boxes = torch.where(ov[..., None], _take(cand_boxes, safe), 0.0)
    labels = torch.where(ov, _take(cls_idx, safe), -1)
    return torch.cat([out_boxes, dets[..., 5:6]], dim=-1), labels, ov


def aug_multiclass_nms_rotated(dets_list, labels_list, valid_list,
                               iou_thr: float, max_out: int,
                               box_dim: int = 5):
    """Merge the detection sets of several test-time augmentations through
    one joint class-offset NMS (mmrotate ``aug_multiclass_nms_rotated``).

    Per augmentation: dets ``(N_i, box_dim + 1)`` with the score last,
    labels ``(N_i,)``, valid ``(N_i,)``, already in the original image's
    frame; or all with a leading batch dimension. ``box_dim=4`` is the
    horizontal variant. Returns (dets (max_out, box_dim + 1), labels,
    valid).
    """
    boxes = torch.cat([d[..., :box_dim] for d in dets_list], dim=-2)
    scores = torch.cat([torch.where(v, d[..., box_dim], NEG_INF)
                        for d, v in zip(dets_list, valid_list)], dim=-1)
    labels = torch.cat(list(labels_list), dim=-1)
    off = labels.to(boxes.dtype) * 2e4
    shifted = torch.cat([boxes[..., :1] + off[..., None], boxes[..., 1:]],
                        dim=-1)
    if box_dim == 4:
        dets, idx, valid = nms(shifted, scores, iou_thr, max_out)
    else:
        dets, idx, valid = nms_rotated(shifted, scores, iou_thr, max_out)
    # masked-out inputs carry NEG_INF scores: never valid outputs
    valid = valid & (dets[..., box_dim] > NEG_INF / 2)
    safe = torch.where(idx >= 0, idx, 0)
    out_b = torch.where(
        valid[..., None],
        torch.gather(boxes, -2, safe[..., None].expand(
            safe.shape + (box_dim,))), 0.0)
    out_l = torch.where(valid, torch.gather(labels, -1, safe), -1)
    return torch.cat([out_b, dets[..., box_dim:box_dim + 1]], dim=-1), \
        out_l, valid
