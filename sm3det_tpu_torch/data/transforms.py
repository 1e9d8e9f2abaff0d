"""Host transforms of the evaluation pipeline, in numpy.

Port of the eval subset of ``sm3det_tpu/data/transforms.py``: the
keep-ratio ``resize`` (mmrotate ``RResize``: OBB centres scale per axis,
their sizes by sqrt(sx * sy)) with its bilinear sampler, ``normalize``,
``pad_to`` and the fixed-size ``pad_gt``. The augmentations belong to the
training pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

PI = np.pi


def _norm_angle_np(a, version):
    if version == "oc":
        return a
    if version == "le135":
        return (a + PI / 4) % PI - PI / 4
    return (a + PI / 2) % PI - PI / 2


def resize(img: np.ndarray, scale: Tuple[int, int],
           obbs: Optional[np.ndarray] = None,
           hbbs: Optional[np.ndarray] = None, keep_ratio: bool = True):
    """Resize to ``scale`` = (h, w), or inside it with ``keep_ratio``.
    Returns (image, obbs, hbbs, (sx, sy))."""
    h, w = img.shape[:2]
    th, tw = scale
    if keep_ratio:
        s = min(th / h, tw / w)
        nh, nw = int(round(h * s)), int(round(w * s))
    else:
        nh, nw = th, tw
    out = _resize_bilinear(img, nh, nw)
    sy, sx = nh / h, nw / w
    if obbs is not None and len(obbs):
        obbs = obbs.copy()
        obbs[:, 0] *= sx
        obbs[:, 1] *= sy
        obbs[:, 2] *= np.sqrt(sx * sy)
        obbs[:, 3] *= np.sqrt(sx * sy)
    if hbbs is not None and len(hbbs):
        hbbs = hbbs.copy()
        hbbs[:, 0::2] *= sx
        hbbs[:, 1::2] *= sy
    return out, obbs, hbbs, (sx, sy)


def _resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Half-pixel-centre bilinear resize, float32 out (the input itself
    when the size does not change)."""
    h, w = img.shape[:2]
    if (nh, nw) == (h, w):
        return img
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    ly = (ys - y0).clip(0, 1)[:, None, None]
    lx = (xs - x0).clip(0, 1)[None, :, None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - lx) + im[y0][:, x1] * lx
    bot = im[y1][:, x0] * (1 - lx) + im[y1][:, x1] * lx
    return top * (1 - ly) + bot * ly


def normalize(img, mean=(123.675, 116.28, 103.53),
              std=(58.395, 57.12, 57.375), to_rgb: bool = True):
    img = img.astype(np.float32)
    if to_rgb and img.shape[-1] == 3:
        img = img[..., ::-1]
    return (img - np.asarray(mean, np.float32)) / \
        np.asarray(std, np.float32)


def pad_to(img, size: Tuple[int, int], pad_val: float = 0.0):
    h, w = img.shape[:2]
    th, tw = size
    out = np.full((th, tw) + img.shape[2:], pad_val, np.float32)
    out[:h, :w] = img
    return out


def pad_gt(boxes: np.ndarray, labels: np.ndarray, max_gt: int,
           box_dim: int):
    """Fixed-size gts: (max_gt, box_dim) boxes, (max_gt,) labels, mask."""
    n = min(len(boxes), max_gt)
    out_b = np.zeros((max_gt, box_dim), np.float32)
    out_l = np.zeros((max_gt,), np.int32)
    mask = np.zeros((max_gt,), bool)
    if n:
        out_b[:n] = boxes[:n, :box_dim]
        out_l[:n] = labels[:n]
        mask[:n] = True
    return out_b, out_l, mask
