"""Inference on an image larger than the model's input, by patches.

Port of ``sm3det_tpu/apis/inference.py`` (mmrotate
``inference_detector_by_patches``): the image is cut into multi-scale
sliding windows, each window is resized to the patch size, normalised and
padded, the patches run through ``infer_fn`` in batches of one shape (the
last batch padded with zero patches), and the per-patch detections are
merged by per-class rotated NMS on ``device``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..core.patch.split_merge import (get_multiscale_patch,
                                      merge_patch_results, slide_window)
from ..data.transforms import _resize_bilinear, normalize, pad_to


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def inference_detector_by_patches(
        infer_fn: Callable, img: np.ndarray, num_classes: int,
        sizes: Sequence[int] = (1024,), steps: Sequence[int] = (824,),
        ratios: Sequence[float] = (1.0,), patch_size: int = 1024,
        batch_size: int = 1, merge_iou_thr: float = 0.1,
        mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
        device=None):
    """``infer_fn(batch)``: float32 (B, S, S, 3) normalised patches ->
    (dets (B, N, 6), labels (B, N), valid (B, N)). ``img``: (H, W, 3)
    BGR. Returns a per-class list of (M, 6) detections in the image's
    coordinates."""
    h, w = img.shape[:2]
    m_sizes, m_steps, m_ratios = get_multiscale_patch(sizes, steps, ratios)
    windows = slide_window(w, h, m_sizes, m_steps, m_ratios)

    patch_dets: List[np.ndarray] = []
    patch_labels: List[np.ndarray] = []
    offsets = []
    batch, metas = [], []

    def flush():
        if not batch:
            return
        while len(batch) < batch_size:      # one batch shape
            batch.append(np.zeros_like(batch[0]))
            metas.append(None)
        dets, labels, valid = (_host(x) for x in infer_fn(np.stack(batch)))
        for i, meta in enumerate(metas):
            if meta is None:
                continue
            sel = valid[i]
            patch_dets.append(dets[i][sel])
            patch_labels.append(labels[i][sel])
            offsets.append(meta)
        batch.clear()
        metas.clear()

    for (x0, y0, win_w, win_h, ratio) in windows:
        patch = img[int(y0):int(y0 + win_h), int(x0):int(x0 + win_w)]
        scale = patch_size / max(patch.shape[:2])
        nh = int(round(patch.shape[0] * scale))
        nw = int(round(patch.shape[1] * scale))
        patch = _resize_bilinear(patch.astype(np.float32), nh, nw)
        patch = normalize(patch, mean, std)
        patch = pad_to(patch, (patch_size, patch_size))
        batch.append(patch.astype(np.float32))
        # boxes come back in the resized patch's coordinates: undo the
        # scale, then translate by the window's origin
        metas.append((float(x0), float(y0), scale))
        if len(batch) == batch_size:
            flush()
    flush()

    return merge_patch_results(patch_dets, patch_labels, offsets,
                               num_classes, iou_thr=merge_iou_thr,
                               device=device)
