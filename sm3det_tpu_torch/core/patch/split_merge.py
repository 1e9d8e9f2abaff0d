"""Large-image patches: the multi-scale sliding-window split, the merge of
per-patch detections by rotated NMS, and the DOTA Task1 submission.

Port of ``sm3det_tpu/core/patch/split_merge.py`` (mmrotate
``core/patch/split.py`` and ``merge_results.py``, and the DOTA patch merge
and submission writer of ``datasets/dota.py``). The merges run
``ops/nms.py::nms_rotated`` on ``device`` with the class as the group, one
call an image for all its classes: on the card the rotated IoU kernel's
mask mode and the ``nms_keep.cu`` scan, on the host their plain versions.
Boxes of different classes never suppress each other, so the result is
the per-class NMS's.
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...ops.box_convert import obb2poly_np
from ...ops.nms import nms_rotated


def get_multiscale_patch(sizes: Sequence[int], steps: Sequence[int],
                         ratios: Sequence[float]):
    """Window sizes and steps for each test scale ``ratio``."""
    assert len(sizes) == len(steps)
    out_sizes, out_steps, out_ratios = [], [], []
    for r in ratios:
        for s, st in zip(sizes, steps):
            out_sizes.append(int(s / r))
            out_steps.append(int(st / r))
            out_ratios.append(r)
    return out_sizes, out_steps, out_ratios


def slide_window(width: int, height: int, sizes: Sequence[int],
                 steps: Sequence[int],
                 img_ratios: Optional[Sequence[float]] = None):
    """Sliding windows (x, y, w, h, ratio) covering the image."""
    windows = []
    ratios = img_ratios or [1.0] * len(sizes)
    for size, step, ratio in zip(sizes, steps, ratios):
        assert size >= step, (size, step)
        x_num = 1 if width <= size else int(np.ceil(
            (width - size) / step + 1))
        y_num = 1 if height <= size else int(np.ceil(
            (height - size) / step + 1))
        for i in range(x_num):
            for j in range(y_num):
                x = min(i * step, max(width - size, 0))
                y = min(j * step, max(height - size, 0))
                windows.append((x, y, size, size, ratio))
    return windows


def nms_by_class(dets: np.ndarray, labels: np.ndarray, num_classes: int,
                 iou_thr: float, device,
                 max_per_class: Optional[int] = None) -> List[np.ndarray]:
    """Per-class rotated NMS of (M, 6) detections in one grouped call:
    a list of (K_c, 6) float32 arrays in score order, at most
    ``max_per_class`` each."""
    out = [np.zeros((0, 6), np.float32) for _ in range(num_classes)]
    if len(dets) == 0:
        return out
    dev = resolve_device(device)
    d = torch.from_numpy(np.ascontiguousarray(dets, np.float32)).to(dev)
    lab = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    kept, idx, valid = nms_rotated(d[:, :5], d[:, 5], iou_thr,
                                   max_out=len(dets), groups=lab)
    kept = kept.cpu().numpy()
    valid = valid.cpu().numpy()
    idx = idx.cpu().numpy()
    kept, kept_lab = kept[valid], np.asarray(labels)[idx[valid]]
    for c in range(num_classes):
        out[c] = kept[kept_lab == c][:max_per_class]
    return out


def merge_patch_results(patch_dets: List[np.ndarray],
                        patch_labels: List[np.ndarray],
                        offsets: List[Tuple[float, float, float]],
                        num_classes: int, iou_thr: float = 0.1,
                        max_per_img: int = 2000, device=None):
    """Per-patch OBB detections (N, 6) [cx, cy, w, h, theta, score] mapped
    into image coordinates (``/ scale``, then translated by the window's
    (x0, y0)) and merged by per-class rotated NMS. Returns a per-class
    list of (M, 6) arrays, at most ``max_per_img`` each."""
    all_dets, all_labels = [], []
    for dets, labels, (x0, y0, sc) in zip(patch_dets, patch_labels,
                                          offsets):
        if len(dets) == 0:
            continue
        d = dets.copy()
        d[:, :4] /= sc
        d[:, 0] += x0
        d[:, 1] += y0
        all_dets.append(d)
        all_labels.append(labels)
    if not all_dets:
        return [np.zeros((0, 6), np.float32) for _ in range(num_classes)]
    return nms_by_class(np.concatenate(all_dets), np.concatenate(all_labels),
                        num_classes, iou_thr, device,
                        max_per_class=max_per_img)


PATCH_NAME_RE = re.compile(r"^(.*?)__(\d+(?:\.\d+)?)__(\d+)___(\d+)$")


def parse_patch_id(patch_id: str):
    """'P0001__1.0__0___600' -> (base, scale, x0, y0); another name ->
    (name, 1.0, 0.0, 0.0)."""
    m = PATCH_NAME_RE.match(patch_id)
    if not m:
        return patch_id, 1.0, 0.0, 0.0
    return (m.group(1), float(m.group(2)), float(m.group(3)),
            float(m.group(4)))


def merge_det_by_patch_ids(patch_ids: List[str],
                           patch_results: List[List[np.ndarray]],
                           num_classes: int, iou_thr: float = 0.1,
                           device=None) -> Dict[str, List[np.ndarray]]:
    """Patch results grouped by base image, translated into its frame and
    merged by per-class rotated NMS: {base id: per-class (M, 6)}."""
    groups: Dict[str, List[int]] = {}
    metas = [parse_patch_id(p) for p in patch_ids]
    for i, (base, _, _, _) in enumerate(metas):
        groups.setdefault(base, []).append(i)

    merged: Dict[str, List[np.ndarray]] = {}
    for base, idxs in groups.items():
        dets, labels = [], []
        for c in range(num_classes):
            for i in idxs:
                d = patch_results[i][c]
                if not len(d):
                    continue
                _, sc, x0, y0 = metas[i]
                dd = d.copy()
                dd[:, :4] /= sc
                dd[:, 0] += x0
                dd[:, 1] += y0
                dets.append(dd)
                labels.append(np.full(len(dd), c, np.int64))
        if dets:
            merged[base] = nms_by_class(
                np.concatenate(dets).astype(np.float32),
                np.concatenate(labels), num_classes, iou_thr, device)
        else:
            merged[base] = [np.zeros((0, 6), np.float32)
                            for _ in range(num_classes)]
    return merged


def write_dota_submission(merged: Dict[str, List[np.ndarray]],
                          class_names: Sequence[str], out_dir: str,
                          version: str = "le90",
                          zip_name: Optional[str] = None) -> str:
    """One ``Task1_<class>.txt`` a class (``img_id score x1 y1 ... y4``)
    and their zip; returns the zip's path."""
    os.makedirs(out_dir, exist_ok=True)
    files = {}
    for c, cname in enumerate(class_names):
        files[c] = open(os.path.join(out_dir, f"Task1_{cname}.txt"), "w")
    try:
        for img_id, per_class in merged.items():
            for c, dets in enumerate(per_class):
                if not len(dets):
                    continue
                polys = obb2poly_np(dets[:, :5], version)
                for poly, score in zip(polys, dets[:, 5]):
                    coords = " ".join(f"{v:.2f}" for v in poly)
                    files[c].write(f"{img_id} {score:.4f} {coords}\n")
    finally:
        for f in files.values():
            f.close()
    zip_path = os.path.join(out_dir, zip_name or "submission.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for cname in class_names:
            p = os.path.join(out_dir, f"Task1_{cname}.txt")
            zf.write(p, os.path.basename(p))
    return zip_path
