"""Host transforms of the data pipelines, in numpy.

Port of ``sm3det_tpu/data/transforms.py``: the keep-ratio ``resize``
(mmrotate ``RResize``: OBB centres scale per axis, their sizes by
sqrt(sx * sy)) with its bilinear sampler, ``normalize``, ``pad_to`` and the
fixed-size ``pad_gt``; and the train augmentations ``random_flip``
(``flip_obbs`` / ``flip_hbbs``), ``poly_random_rotate`` (with the bilinear
``_rotate_image``), ``random_crop`` and ``mosaic``. Every sample leaves the
pipeline with static shapes. The arithmetic and each draw of the
``RandomState`` follow the JAX package's order, so the outputs are its
outputs bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def flip_obbs(obbs: np.ndarray, img_shape: Tuple[int, int],
              direction: str, version: str) -> np.ndarray:
    """Flip OBBs for one direction. Horizontal and vertical mirror one
    centre axis (c -> L - c) and remap the angle: ``oc`` swaps (w, h) and
    maps theta -> pi/2 - theta (for theta != pi/2), ``le90`` / ``le135``
    map theta -> norm(pi - theta). ``diagonal`` mirrors both centres and
    keeps the angle (a 180-degree rotation)."""
    h, w = img_shape
    out = obbs.copy()
    if direction in ("horizontal", "diagonal"):
        out[:, 0] = w - obbs[:, 0]
    if direction in ("vertical", "diagonal"):
        out[:, 1] = h - obbs[:, 1]
    if direction == "diagonal":
        return out
    if version == "oc":
        rot = obbs[:, 4] != PI / 2
        out[rot, 4] = PI / 2 - obbs[rot, 4]
        out[rot, 2] = obbs[rot, 3]
        out[rot, 3] = obbs[rot, 2]
    else:
        out[:, 4] = _norm_angle_np(PI - obbs[:, 4], version)
    return out


def flip_hbbs(hbbs: np.ndarray, img_shape: Tuple[int, int],
              direction: str) -> np.ndarray:
    """Flip xyxy boxes for one direction."""
    h, w = img_shape
    out = hbbs.copy()
    if direction in ("horizontal", "diagonal"):
        out[:, 0] = w - hbbs[:, 2]
        out[:, 2] = w - hbbs[:, 0]
    if direction in ("vertical", "diagonal"):
        out[:, 1] = h - hbbs[:, 3]
        out[:, 3] = h - hbbs[:, 1]
    return out


_FLIP_SLICES = {"horizontal": (slice(None), slice(None, None, -1)),
                "vertical": (slice(None, None, -1), slice(None)),
                "diagonal": (slice(None, None, -1), slice(None, None, -1))}


def random_flip(rng: np.random.RandomState, img, obbs=None, hbbs=None,
                prob=0.5, version: str = "le90",
                direction="horizontal"):
    """mmrotate ``RRandomFlip``. ``direction`` is one name or a list;
    ``prob`` one ratio (split evenly over the directions) or one a
    direction. One draw picks the direction or none. Returns (img, obbs,
    hbbs, the direction picked or False)."""
    dirs = [direction] if isinstance(direction, str) else list(direction)
    if isinstance(prob, (int, float)):
        probs = [float(prob) / len(dirs)] * len(dirs)
    else:
        probs = [float(p) for p in prob]
    assert len(probs) == len(dirs) and sum(probs) <= 1.0 + 1e-6
    r = rng.rand()
    picked = False
    acc = 0.0
    for d, p in zip(dirs, probs):
        acc += p
        if r < acc:
            picked = d
            break
    if not picked:
        return img, obbs, hbbs, False
    img = img[_FLIP_SLICES[picked]].copy()
    shape = img.shape[:2]
    if obbs is not None and len(obbs):
        obbs = flip_obbs(obbs, shape, picked, version)
    if hbbs is not None and len(hbbs):
        hbbs = flip_hbbs(hbbs, shape, picked)
    return img, obbs, hbbs, picked


def poly_random_rotate(rng: np.random.RandomState, img, obbs, labels,
                       rotate_ratio: float = 0.5,
                       angles_range: int = 180,
                       mode: str = "range",
                       discrete_angles: Sequence[float] = (),
                       rect_classes: Sequence[int] = (),
                       version: str = "le90"):
    """mmrotate ``PolyRandomRotate``: with probability ``rotate_ratio``
    rotate the image about its centre by an angle drawn from
    [-angles_range, angles_range] degrees (``mode="range"``) or from
    ``discrete_angles``; rotate the boxes' centres and angles, snap the
    ``rect_classes`` to multiples of 90 degrees and drop the boxes whose
    centre leaves the image."""
    h, w = img.shape[:2]
    if rng.rand() >= rotate_ratio:
        return img, obbs, labels
    if mode == "range":
        angle = (rng.rand() * 2 - 1) * angles_range
    else:
        angle = float(discrete_angles[rng.randint(len(discrete_angles))])

    theta = np.deg2rad(angle)
    img = _rotate_image(img, theta)

    if obbs is None or not len(obbs):
        return img, obbs, labels
    obbs = obbs.copy()
    cx, cy = w / 2.0, h / 2.0
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    dx = obbs[:, 0] - cx
    dy = obbs[:, 1] - cy
    obbs[:, 0] = cos_t * dx - sin_t * dy + cx
    obbs[:, 1] = sin_t * dx + cos_t * dy + cy
    is_rect = np.isin(labels, np.asarray(rect_classes)) \
        if len(rect_classes) else np.zeros(len(labels), bool)
    new_angle = obbs[:, 4] + theta
    snapped = np.round(new_angle / (PI / 2)) * (PI / 2)
    obbs[:, 4] = _norm_angle_np(
        np.where(is_rect, snapped, new_angle), version)
    keep = (obbs[:, 0] >= 0) & (obbs[:, 0] < w) & \
           (obbs[:, 1] >= 0) & (obbs[:, 1] < h)
    return img, obbs[keep], labels[keep]


def _rotate_image(img: np.ndarray, theta: float) -> np.ndarray:
    """Bilinear rotation about the image centre by ``theta`` (the content
    turns by +theta), zero outside the source."""
    h, w = img.shape[:2]
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    cx, cy = w / 2.0, h / 2.0
    cos_t, sin_t = np.cos(-theta), np.sin(-theta)
    sx = cos_t * (xx - cx) - sin_t * (yy - cy) + cx
    sy = sin_t * (xx - cx) + cos_t * (yy - cy) + cy
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    sx = sx.clip(0, w - 1)
    sy = sy.clip(0, h - 1)
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    lx = (sx - x0)[..., None]
    ly = (sy - y0)[..., None]
    im = img.astype(np.float32)
    out = (im[y0, x0] * (1 - lx) * (1 - ly) + im[y0, x1] * lx * (1 - ly) +
           im[y1, x0] * (1 - lx) * ly + im[y1, x1] * lx * ly)
    return np.where(valid[..., None], out, 0.0)


def random_crop(rng: np.random.RandomState, img, obbs, labels,
                crop_size: Tuple[int, int], allow_negative: bool = False):
    """mmrotate ``RRandomCrop``: a random window; the boxes whose centre
    lies inside it, translated. Returns (None, None, None) when no box
    survives (the caller keeps the uncropped sample) unless
    ``allow_negative``."""
    h, w = img.shape[:2]
    ch, cw = min(crop_size[0], h), min(crop_size[1], w)
    y0 = rng.randint(0, h - ch + 1)
    x0 = rng.randint(0, w - cw + 1)
    out = img[y0:y0 + ch, x0:x0 + cw]
    if obbs is None or not len(obbs):
        return out, obbs, labels
    obbs = obbs.copy()
    obbs[:, 0] -= x0
    obbs[:, 1] -= y0
    keep = (obbs[:, 0] >= 0) & (obbs[:, 0] < cw) & \
           (obbs[:, 1] >= 0) & (obbs[:, 1] < ch)
    if not keep.any() and not allow_negative:
        return None, None, None
    return out, obbs[keep], labels[keep]


def mosaic(rng: np.random.RandomState, samples, out_size: int,
           center_ratio_range=(0.5, 1.5)):
    """mmrotate ``RMosaic``: four samples pasted around a random centre
    into a canvas of twice ``out_size``; the boxes translated, those whose
    centre falls outside their pasted part dropped."""
    canvas = np.zeros((2 * out_size, 2 * out_size, 3), np.float32)
    cx = int(rng.uniform(*center_ratio_range) * out_size)
    cy = int(rng.uniform(*center_ratio_range) * out_size)
    all_obbs, all_labels = [], []
    locs = [(0, 0, cx, cy), (cx, 0, 2 * out_size, cy),
            (0, cy, cx, 2 * out_size), (cx, cy, 2 * out_size,
                                        2 * out_size)]
    for (x1, y1, x2, y2), s in zip(locs, samples):
        img = s["img"].astype(np.float32)
        tw, th = x2 - x1, y2 - y1
        ih, iw = img.shape[:2]
        pw, ph_ = min(iw, tw), min(ih, th)
        canvas[y1:y1 + ph_, x1:x1 + pw] = img[:ph_, :pw]
        obbs = s.get("obbs")
        if obbs is not None and len(obbs):
            ob = obbs.copy()
            ob[:, 0] += x1
            ob[:, 1] += y1
            keep = (ob[:, 0] >= x1) & (ob[:, 0] < x1 + pw) & \
                   (ob[:, 1] >= y1) & (ob[:, 1] < y1 + ph_)
            all_obbs.append(ob[keep])
            all_labels.append(s["labels"][keep])
    obbs = np.concatenate(all_obbs) if all_obbs else \
        np.zeros((0, 5), np.float32)
    labels = np.concatenate(all_labels) if all_labels else \
        np.zeros((0,), np.int32)
    return canvas, obbs, labels


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
