"""COCO-protocol bbox AP (pycocotools ``COCOeval`` semantics), in numpy.

Port of ``sm3det_tpu/core/evaluation/coco_eval.py``, the SAR branch's
``bbox`` metric (mmdet ``CocoDataset.evaluate('bbox', classwise=True)``):
IoU thresholds .50:.05:.95, 101-point interpolated precision over recall
thresholds 0:.01:1, the area ranges all / small < 32^2 / medium < 96^2 /
large, maxDets truncation (100, 300, 1000), crowd regions matched by
intersection over the detection's area, and stable (mergesort) score
order.

Inputs follow ``apis/eval_loop.stream_eval``:

- ``det_results``: per image, per class ``(N, 5)`` float arrays
  ``[x1, y1, x2, y2, score]`` in original-image coordinates.
- ``annotations``: per image ``bboxes`` (G, 4) xyxy, ``labels`` (G,),
  optional ``areas`` (G,) (default the box's w * h), and optional crowd
  regions ``bboxes_crowd`` / ``labels_crowd`` / ``areas_crowd``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

# areaRng exactly as pycocotools Params for detection
AREA_RANGES = OrderedDict([
    ("all", (0.0, 1e5 ** 2)),
    ("small", (0.0, 32 ** 2)),
    ("medium", (32 ** 2, 96 ** 2)),
    ("large", (96 ** 2, 1e5 ** 2)),
])
REC_THRS = np.linspace(0.0, 1.00, 101)


def _xyxy_area(b: np.ndarray) -> np.ndarray:
    return np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
        b[:, 3] - b[:, 1], 0)


def _iou_xyxy(dt: np.ndarray, gt: np.ndarray,
              crowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU; for crowd gts IoU = intersection / det area
    (``maskUtils.iou`` iscrowd semantics)."""
    if dt.shape[0] == 0 or gt.shape[0] == 0:
        return np.zeros((dt.shape[0], gt.shape[0]), np.float64)
    x1 = np.maximum(dt[:, None, 0], gt[None, :, 0])
    y1 = np.maximum(dt[:, None, 1], gt[None, :, 1])
    x2 = np.minimum(dt[:, None, 2], gt[None, :, 2])
    y2 = np.minimum(dt[:, None, 3], gt[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    ad = _xyxy_area(dt)[:, None]
    ag = _xyxy_area(gt)[None, :]
    union = np.where(crowd[None, :], ad, ad + ag - inter)
    return inter / np.maximum(union, np.finfo(np.float64).tiny)


def _match_image(ious: np.ndarray, gt_ig_base: np.ndarray,
                 gt_crowd: np.ndarray, gt_areas: np.ndarray,
                 dt_areas: np.ndarray, iou_thrs: np.ndarray,
                 arng) -> tuple:
    """One (image, class, areaRng) matching pass over ALL dets
    (callers slice per maxDet afterwards, like COCOeval.accumulate).

    Implements COCOeval.evaluateImg: gts sorted ignore-last (stable);
    per threshold, each det (already score-sorted) takes the max-IoU
    available gt, preferring non-ignored; matched-to-ignored or
    area-out-of-range-unmatched dets become ignored.

    Returns (dt_matched (T, D) bool, dt_ignore (T, D) bool,
    n_pos_gt int).
    """
    T = len(iou_thrs)
    D, G = ious.shape
    gt_ig = gt_ig_base | (gt_areas < arng[0]) | (gt_areas > arng[1])
    order = np.argsort(gt_ig, kind="mergesort")  # non-ignored first
    gt_ig = gt_ig[order]
    crowd = gt_crowd[order]
    iou_s = ious[:, order]
    npig = int(np.count_nonzero(~gt_ig))

    dtm = np.zeros((T, D), bool)
    dt_ignore = np.zeros((T, D), bool)
    n_real = int(np.count_nonzero(~gt_ig))  # sorted: reals are [:n_real]
    for t in range(T):
        thr = min(iou_thrs[t], 1 - 1e-10)
        gt_taken = np.zeros(G, bool)
        for d in range(D):
            row = iou_s[d]
            avail = ~gt_taken | crowd
            # best among non-ignored available gts (last max wins,
            # matching pycocotools' >=-update scan order)
            m = -1
            cand = avail[:n_real] & (row[:n_real] >= thr)
            if cand.any():
                vals = np.where(cand, row[:n_real], -np.inf)
                best = vals.max()
                m = int(np.nonzero(vals == best)[0][-1])
            else:
                cand = avail[n_real:] & (row[n_real:] >= thr)
                if cand.any():
                    vals = np.where(cand, row[n_real:], -np.inf)
                    best = vals.max()
                    m = n_real + int(np.nonzero(vals == best)[0][-1])
            if m < 0:
                continue
            dt_ignore[t, d] = gt_ig[m]
            dtm[t, d] = True
            gt_taken[m] = True
    out_of_rng = (dt_areas < arng[0]) | (dt_areas > arng[1])
    dt_ignore |= (~dtm) & out_of_rng[None, :]
    return dtm, dt_ignore, npig


def coco_eval_bbox(det_results: List[List[np.ndarray]],
                   annotations: List[Dict],
                   iou_thrs: Optional[Sequence[float]] = None,
                   max_dets: Sequence[int] = (100, 300, 1000),
                   classwise: bool = False,
                   class_names: Optional[Sequence[str]] = None,
                   logger=print) -> "OrderedDict[str, float]":
    """pycocotools-semantics bbox AP over the repo's eval contract.

    Returns the mmdet ``CocoDataset.evaluate('bbox')`` result dict:
    ``bbox_mAP``, ``bbox_mAP_50``, ``bbox_mAP_75``, ``bbox_mAP_s``,
    ``bbox_mAP_m``, ``bbox_mAP_l``, ``bbox_mAP_copypaste`` (all
    3-decimal-rounded like mmdet), plus ``bbox_AR@<m>`` recall rows
    and, when ``classwise``, a printed per-class AP table and a
    ``per_class_ap`` dict.
    """
    if iou_thrs is None:
        iou_thrs = np.linspace(0.5, 0.95, 10)
    iou_thrs = np.asarray(iou_thrs, np.float64)
    max_dets = sorted(int(m) for m in max_dets)
    num_imgs = len(det_results)
    num_classes = len(det_results[0]) if num_imgs else 0
    T, R = len(iou_thrs), len(REC_THRS)
    A, M = len(AREA_RANGES), len(max_dets)
    arngs = list(AREA_RANGES.values())

    # precision[T, R, K, A, M], recall[T, K, A, M]; -1 = no gt
    precision = -np.ones((T, R, num_classes, A, M))
    recall = -np.ones((T, num_classes, A, M))

    for c in range(num_classes):
        # per-image matches at every area range, all dets retained up
        # to max(max_dets) (COCOeval computeIoU truncation)
        per_img = []  # (scores, dtm[A][T,D], dtIg[A][T,D], npig[A])
        for i in range(num_imgs):
            ann = annotations[i]
            sel = np.asarray(ann["labels"]) == c
            gt = np.asarray(ann["bboxes"], np.float64).reshape(-1, 4)[sel]
            if "areas" in ann and ann["areas"] is not None:
                g_areas = np.asarray(ann["areas"], np.float64)[sel]
            else:
                g_areas = _xyxy_area(gt)
            g_crowd = np.zeros(len(gt), bool)
            g_ig = np.zeros(len(gt), bool)
            if ann.get("bboxes_crowd") is not None and \
                    len(ann["bboxes_crowd"]):
                selc = np.asarray(ann["labels_crowd"]) == c
                gc = np.asarray(ann["bboxes_crowd"],
                                np.float64).reshape(-1, 4)[selc]
                if ann.get("areas_crowd") is not None:
                    ac = np.asarray(ann["areas_crowd"], np.float64)[selc]
                else:
                    ac = _xyxy_area(gc)
                gt = np.concatenate([gt, gc])
                g_areas = np.concatenate([g_areas, ac])
                g_crowd = np.concatenate(
                    [g_crowd, np.ones(len(gc), bool)])
                g_ig = np.concatenate([g_ig, np.ones(len(gc), bool)])

            dt = np.asarray(det_results[i][c],
                            np.float64).reshape(-1, 5)
            dord = np.argsort(-dt[:, 4], kind="mergesort")[:max_dets[-1]]
            dt = dt[dord]
            d_areas = _xyxy_area(dt)

            if len(gt) == 0 and len(dt) == 0:
                continue
            ious = _iou_xyxy(dt[:, :4], gt, g_crowd)
            dtm_a, dtig_a, npig_a = [], [], []
            for arng in arngs:
                dtm, dtig, npig = _match_image(
                    ious, g_ig, g_crowd, g_areas, d_areas, iou_thrs,
                    arng)
                dtm_a.append(dtm)
                dtig_a.append(dtig)
                npig_a.append(npig)
            per_img.append((dt[:, 4], dtm_a, dtig_a, npig_a))

        if not per_img:
            continue
        for a in range(A):
            npig = sum(p[3][a] for p in per_img)
            if npig == 0:
                continue
            for m, mdet in enumerate(max_dets):
                scores = np.concatenate(
                    [p[0][:mdet] for p in per_img])
                inds = np.argsort(-scores, kind="mergesort")
                dtm = np.concatenate(
                    [p[1][a][:, :mdet] for p in per_img], 1)[:, inds]
                dtig = np.concatenate(
                    [p[2][a][:, :mdet] for p in per_img], 1)[:, inds]
                tps = np.logical_and(dtm, ~dtig)
                fps = np.logical_and(~dtm, ~dtig)
                tp_sum = np.cumsum(tps, 1).astype(np.float64)
                fp_sum = np.cumsum(fps, 1).astype(np.float64)
                for t in range(T):
                    tp, fp = tp_sum[t], fp_sum[t]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / (fp + tp + np.spacing(1))
                    recall[t, c, a, m] = rc[-1] if nd else 0.0
                    q = np.zeros(R)
                    # monotone-decreasing precision envelope
                    pr = pr.tolist()
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    idx = np.searchsorted(rc, REC_THRS, side="left")
                    for ri, pi in enumerate(idx):
                        if pi < nd:
                            q[ri] = pr[pi]
                    precision[t, :, c, a, m] = q

    def _ap(t=None, area="all", mdet=max_dets[-1]):
        aind = list(AREA_RANGES).index(area)
        mind = max_dets.index(mdet)
        s = precision[:, :, :, aind, mind]
        if t is not None:
            s = s[np.where(np.isclose(iou_thrs, t))[0]]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def _ar(area="all", mdet=max_dets[-1]):
        aind = list(AREA_RANGES).index(area)
        mind = max_dets.index(mdet)
        s = recall[:, :, aind, mind]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    stats = OrderedDict()
    stats["bbox_mAP"] = _ap()
    stats["bbox_mAP_50"] = _ap(t=0.5)
    stats["bbox_mAP_75"] = _ap(t=0.75)
    stats["bbox_mAP_s"] = _ap(area="small")
    stats["bbox_mAP_m"] = _ap(area="medium")
    stats["bbox_mAP_l"] = _ap(area="large")
    for mdet in max_dets:
        stats[f"bbox_AR@{mdet}"] = _ar(mdet=mdet)
    for area in ("small", "medium", "large"):
        stats[f"bbox_AR_{area}@{max_dets[-1]}"] = _ar(area=area)

    out = OrderedDict(
        (k, float(f"{v:.3f}")) for k, v in stats.items())
    out["bbox_mAP_copypaste"] = (
        f"{stats['bbox_mAP']:.3f} {stats['bbox_mAP_50']:.3f} "
        f"{stats['bbox_mAP_75']:.3f} {stats['bbox_mAP_s']:.3f} "
        f"{stats['bbox_mAP_m']:.3f} {stats['bbox_mAP_l']:.3f}")

    if classwise:
        # mmdet's classwise table: per-class AP averaged over IoU
        # thresholds at area=all, maxDets[-1]
        names = class_names or [str(c) for c in range(num_classes)]
        rows = []
        per_class = OrderedDict()
        for c in range(num_classes):
            s = precision[:, :, c, 0, -1]
            s = s[s > -1]
            ap_c = float(np.mean(s)) if s.size else float("nan")
            per_class[names[c]] = round(ap_c, 4)
            rows.append(f"{names[c]:>20s} | {ap_c:0.3f}")
        if logger is not None:
            logger("per-class bbox AP (IoU .50:.95):\n"
                   + "\n".join(rows))
        out["per_class_ap"] = per_class
    return out
