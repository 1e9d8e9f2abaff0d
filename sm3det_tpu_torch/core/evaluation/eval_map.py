"""Rotated (and horizontal) mAP, VOC style.

Port of ``sm3det_tpu/core/evaluation/eval_map.py``: per class, the
detections of all images sorted by score are matched greedily to the gts
at each IoU threshold of 0.50:0.05:0.95 (mmdet ``tpfp_default``, with
difficult gts as ignore boxes and optional scale ranges), and AP is the
area under the interpolated precision-recall curve.

The IoU matrices come from the port's IoU kernels, on ``device``: the
detections and the gts (then the ignore gts) of a chunk of images are
padded into (B, N, 5) x (B, G, 5) with the class as the group of each row
and column (``INERT_GROUP`` for padding) and go through one call of
``rotated_iou`` in its grouped matrix mode (row 5); the cross-class tiles
are not computed, and only same-class blocks are read. Horizontal boxes
(``box_dim=4``) go through ``hbb_iou`` (row 4's matrix mode). So the
launches scale with chunks of images, not with images x classes. On the
CPU both run their plain versions. The tp/fp bookkeeping is numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ...ops.cuda.hbb_iou_kernel import hbb_iou
from ...ops.cuda.rotated_iou_kernel import INERT_GROUP, rotated_iou

# pairs (B * N * G) of one IoU call: the output on the card, the plain
# version's intermediates on the host
MAX_PAIRS = {"cuda": 1 << 25, "cpu": 1 << 18}


def _box_areas(boxes: np.ndarray, box_dim: int) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros(0, np.float32)
    if box_dim == 5:
        return boxes[:, 2] * boxes[:, 3]
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def pack_chunk(items, box_dim: int):
    """Pad a chunk's blocks into one IoU call's inputs: ``items`` is a list
    of (image, [(class, dets (n, >= box_dim), gts (m, box_dim))]) ->
    (dets (B, N, box_dim), gts (B, G, box_dim), their groups (B, N) and
    (B, G) int32, the classes ascending and ``INERT_GROUP`` on padding,
    and the spans (image, class, b, row, n, col, m) of the blocks)."""
    bsz = len(items)
    n_max = max(sum(len(d) for _, d, _ in blocks) for _, blocks in items)
    g_max = max(sum(len(g) for _, _, g in blocks) for _, blocks in items)
    d_arr = np.zeros((bsz, n_max, box_dim), np.float32)
    g_arr = np.zeros((bsz, g_max, box_dim), np.float32)
    d_grp = np.full((bsz, n_max), INERT_GROUP, np.int32)
    g_grp = np.full((bsz, g_max), INERT_GROUP, np.int32)
    spans = []
    for b, (img, blocks) in enumerate(items):
        r = s = 0
        for c, d, g in blocks:
            d_arr[b, r:r + len(d)] = d[:, :box_dim]
            g_arr[b, s:s + len(g)] = g
            d_grp[b, r:r + len(d)] = c
            g_grp[b, s:s + len(g)] = c
            spans.append((img, c, b, r, len(d), s, len(g)))
            r, s = r + len(d), s + len(g)
    return d_arr, g_arr, d_grp, g_grp, spans


def chunks(cls_dets, cls_gts, limit: int):
    """The images with detections and gts of one class, packed in order
    into chunks of at most ``limit`` pairs (B * N * G of the padded call;
    an image alone may exceed it): lists of (image, blocks) for
    :func:`pack_chunk`."""
    chunk, n_max, g_max = [], 0, 0
    for i, (dets_i, gts_i) in enumerate(zip(cls_dets, cls_gts)):
        blocks = [(c, d, g) for c, (d, g) in enumerate(zip(dets_i, gts_i))
                  if len(d) and len(g)]
        if not blocks:
            continue
        n = sum(len(d) for _, d, _ in blocks)
        g = sum(len(gg) for _, _, gg in blocks)
        if chunk and (len(chunk) + 1) * max(n_max, n) * max(g_max, g) \
                > limit:
            yield chunk
            chunk, n_max, g_max = [], 0, 0
        chunk.append((i, blocks))
        n_max, g_max = max(n_max, n), max(g_max, g)
    if chunk:
        yield chunk


def _chunk_ious(items, box_dim: int, device: torch.device):
    """{(image, class): (n, m) float32 IoU} of one chunk, one call."""
    d_arr, g_arr, d_grp, g_grp, spans = pack_chunk(items, box_dim)

    def dev(a):
        return torch.from_numpy(a).to(device)
    if box_dim == 5:
        iou = rotated_iou(dev(d_arr), dev(g_arr), groups1=dev(d_grp),
                          groups2=dev(g_grp))
    else:
        iou = hbb_iou(dev(d_arr), dev(g_arr))
    iou = iou.cpu().numpy()
    return {(img, c): iou[b, r:r + n, s:s + m]
            for img, c, b, r, n, s, m in spans}


def pairwise_ious(cls_dets: List[List[np.ndarray]],
                  cls_gts: List[List[np.ndarray]], box_dim: int,
                  device) -> Dict:
    """IoU of every (image, class) with detections and gts: ``cls_dets[i]
    [c]`` (n, box_dim + 1), ``cls_gts[i][c]`` (m, box_dim) -> {(i, c): (n,
    m) float32}. Images are packed into chunks of at most
    ``MAX_PAIRS[device]`` pairs, one IoU call each; empty sets are left
    out on the host."""
    device = resolve_device(device)
    limit = MAX_PAIRS["cuda" if device.type == "cuda" else "cpu"]
    out: Dict = {}
    for items in chunks(cls_dets, cls_gts, limit):
        out.update(_chunk_ious(items, box_dim, device))
    return out


def _tpfp(det: np.ndarray, gts: np.ndarray, gts_ignore: np.ndarray,
          ious: Optional[np.ndarray], iou_thr: float,
          area_ranges=None, box_dim: int = 5):
    """tp/fp flags of one image and class (mmdet ``tpfp_default``): a
    detection whose best-IoU gt is an ignore gt (IoU >= thr) is neither tp
    nor fp, and ignore gts never count. ``ious`` is the (N, G + K) matrix
    against the stacked [gts; gts_ignore]. ``area_ranges`` are mmdet's
    scale ranges by w * h areas. Returns (num_scales, nd) tp and fp."""
    nd = len(det)
    n_gt, n_ign = len(gts), len(gts_ignore)
    if area_ranges is None:
        area_ranges = [(None, None)]
    ns = len(area_ranges)
    tp = np.zeros((ns, nd), np.float32)
    fp = np.zeros((ns, nd), np.float32)
    if n_gt + n_ign == 0:
        for k, (mn, mx) in enumerate(area_ranges):
            if mn is None:
                fp[k] = 1
            else:
                da = _box_areas(det[:, :box_dim], box_dim)
                fp[k] = ((da >= mn) & (da < mx)).astype(np.float32)
        return tp, fp
    if nd == 0:
        return tp, fp
    ignore_flag = np.concatenate(
        [np.zeros(n_gt, bool), np.ones(n_ign, bool)])
    gt_all = np.concatenate([gts, gts_ignore], 0) if n_ign else gts
    gareas = _box_areas(gt_all, box_dim)
    ious_max = ious.max(1)
    ious_argmax = ious.argmax(1)
    order = np.argsort(-det[:, -1])
    dareas = None
    for k, (mn, mx) in enumerate(area_ranges):
        covered = np.zeros(n_gt + n_ign, bool)
        area_ignore = np.zeros(n_gt + n_ign, bool) if mn is None else \
            (gareas < mn) | (gareas >= mx)
        for i in order:
            if ious_max[i] >= iou_thr:
                j = int(ious_argmax[i])
                if not (ignore_flag[j] or area_ignore[j]):
                    if not covered[j]:
                        covered[j] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
                # else: the det covers an ignored gt: neither tp nor fp
            elif mn is None:
                fp[k, i] = 1
            else:
                if dareas is None:
                    dareas = _box_areas(det[:, :box_dim], box_dim)
                if mn <= dareas[i] < mx:
                    fp[k, i] = 1
    return tp, fp


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> float:
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    # 11-point
    ap = 0.0
    for t in np.arange(0, 1.1, 0.1):
        prec = precisions[recalls >= t]
        ap += (prec.max() if len(prec) else 0.0) / 11.0
    return float(ap)


_EMPTY5 = np.zeros((0, 5), np.float32)


def eval_rbbox_map(det_results: List[List[np.ndarray]],
                   annotations: List[Dict],
                   iou_thrs: Optional[Sequence[float]] = None,
                   box_dim: int = 5,
                   scale_ranges: Optional[Sequence] = None,
                   logger=print, device=None) -> Dict:
    """mAP of ``det_results`` (per image, per class (N, box_dim + 1), the
    score last) against ``annotations`` (per image ``bboxes`` (G, box_dim),
    ``labels``, optional ``bboxes_ignore`` / ``labels_ignore``).

    ``iou_thrs`` defaults to 0.50:0.05:0.95. ``scale_ranges`` [(min, max),
    ...] in pixels (areas in [min^2, max^2)) add ``per_scale_ap50``; the
    headline metrics always come from all areas. The IoUs run on
    ``device``: the card unless ``"cpu"``.

    Returns dict(mAP50, mAP75, mAP, per_class_ap50[, per_scale_ap50]).
    """
    if iou_thrs is None:
        iou_thrs = [round(0.5 + 0.05 * i, 2) for i in range(10)]
    num_classes = len(det_results[0])
    num_imgs = len(det_results)
    # row 0: all areas (the headline metrics); then the scale ranges
    area_ranges = [(None, None)] + (
        [(r[0] ** 2, r[1] ** 2) for r in scale_ranges]
        if scale_ranges else [])
    ns = len(area_ranges)

    empty = _EMPTY5[:, :box_dim]
    gts_by = [[None] * num_classes for _ in range(num_imgs)]
    ign_by = [[None] * num_classes for _ in range(num_imgs)]
    both_by = [[None] * num_classes for _ in range(num_imgs)]
    for i, ann in enumerate(annotations):
        li = ann.get("labels_ignore")
        for c in range(num_classes):
            g = ann["bboxes"][ann["labels"] == c]
            gi = ann["bboxes_ignore"][li == c] \
                if li is not None and len(li) else empty
            gts_by[i][c], ign_by[i][c] = g, gi
            both_by[i][c] = np.concatenate([g, gi], 0) if len(gi) else g
    # one IoU matrix an image and class against the stacked [gt;
    # gt_ignore], shared by the whole threshold grid
    ious = pairwise_ious(det_results, both_by, box_dim, device)

    ap_table = np.zeros((len(iou_thrs), ns, num_classes))
    valid_class = np.zeros(num_classes, bool)
    for c in range(num_classes):
        cls_dets = [det_results[i][c] for i in range(num_imgs)]
        cls_gts = [gts_by[i][c] for i in range(num_imgs)]
        cls_gts_ign = [ign_by[i][c] for i in range(num_imgs)]
        # per-scale gt counts; ignore gts never count
        num_gts = np.zeros(ns, np.int64)
        for g in cls_gts:
            num_gts[0] += len(g)
            if ns > 1 and len(g):
                ga = _box_areas(g, box_dim)
                for k, (mn, mx) in enumerate(area_ranges[1:], 1):
                    num_gts[k] += int(np.sum((ga >= mn) & (ga < mx)))
        if num_gts[0] == 0 and sum(len(d) for d in cls_dets) == 0:
            continue
        valid_class[c] = num_gts[0] > 0
        cls_ious = [ious.get((i, c)) for i in range(num_imgs)]
        for ti, thr in enumerate(iou_thrs):
            tps, fps, scores = [], [], []
            for d, g, gi, io in zip(cls_dets, cls_gts, cls_gts_ign,
                                    cls_ious):
                tp, fp = _tpfp(d, g, gi, io, thr,
                               area_ranges=area_ranges, box_dim=box_dim)
                tps.append(tp)
                fps.append(fp)
                scores.append(d[:, -1] if len(d) else
                              np.zeros(0, np.float32))
            scores = np.concatenate(scores)
            order = np.argsort(-scores)
            tp = np.cumsum(np.concatenate(tps, 1)[:, order], 1)
            fp = np.cumsum(np.concatenate(fps, 1)[:, order], 1)
            for k in range(ns):
                if num_gts[k] == 0:
                    continue
                recalls = tp[k] / num_gts[k]
                precisions = tp[k] / np.maximum(tp[k] + fp[k], 1e-9)
                ap_table[ti, k, c] = average_precision(recalls, precisions)

    def mean_over_valid(row):
        return float(row[valid_class].mean()) if valid_class.any() else 0.0

    def row_for(thr, k=0):
        # thresholds by value, so custom iou_thrs still label mAP50/75
        for ti, t in enumerate(iou_thrs):
            if abs(t - thr) < 1e-6:
                return ap_table[ti, k]
        return None

    row50, row75 = row_for(0.5), row_for(0.75)
    result = {
        "mAP50": mean_over_valid(row50) if row50 is not None else 0.0,
        "mAP75": mean_over_valid(row75) if row75 is not None else 0.0,
        "mAP": float(np.mean([mean_over_valid(ap_table[t, 0])
                              for t in range(len(iou_thrs))])),
        "per_class_ap50": {c: float(row50[c]) if row50 is not None else 0.0
                           for c in range(num_classes) if valid_class[c]},
    }
    if scale_ranges:
        result["per_scale_ap50"] = {
            f"{lo}-{hi}": mean_over_valid(row_for(0.5, k))
            for k, (lo, hi) in enumerate(scale_ranges, 1)}
    if logger:
        logger(f"mAP50={result['mAP50']:.4f} mAP75={result['mAP75']:.4f} "
               f"mAP={result['mAP']:.4f}")
    return result
