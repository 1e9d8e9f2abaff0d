"""Rotated RoI align, plain PyTorch: one level and the pyramid.

Port of ``sm3det_tpu/ops/roi_align_rotated.py``: ``roi_align_rotated`` (one
feature map, with mmcv's ``aligned`` and ``clockwise`` flags; no Pallas
kernel computes it in JAX either), ``roi_align_rotated_pyramid`` and the
level rule of ``extract_rotated_roi_feats``: for each RoI
``(batch_idx, cx, cy, w, h, theta)`` an ``out x out`` grid of ``sample x
sample`` points is rotated into its pyramid level and read bilinearly, then
averaged per bin. This is the plain version of the CUDA kernel
``ops/cuda/csrc/roi_align_rotated.cu``; its coordinate arithmetic is
written one separately rounded operation at a time, in the order the kernel
uses, so both decide a border sample alike. Features are NHWC; the sampling
runs in fp32 and the result is rounded once to the feature dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch


def route_levels(rois: torch.Tensor, finest_scale: int = 56,
                 num_levels: int = 4) -> torch.Tensor:
    """Pyramid level per RoI, ``floor(log2(sqrt(w h) / finest_scale))``
    clipped to the pyramid (mmrotate ``map_roi_levels``); (N,) int32."""
    scale = torch.sqrt(torch.clamp(rois[:, 3] * rois[:, 4], min=1e-6))
    lvls = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return torch.clamp(lvls, 0, num_levels - 1).to(torch.int32)


def sample_taps(rois, hgt, wid, out_size, spatial_scale, sample_num,
                aligned: bool = True, clockwise: bool = True):
    """The bilinear taps of every sample of ``rois`` (n, 6) on a level of
    ``hgt`` x ``wid`` pixels at ``spatial_scale`` (1 / stride): rows
    ``y0 <= y1``, columns ``x0 <= x1`` (int64, clipped to the level),
    fractions ``ly``, ``lx`` and ``keep`` (0 for a sample outside the
    level), each (n, out, g, out, g) for bin row, sample row, bin column,
    sample column. With ``aligned`` pixel centres are at half-integers
    (mmcv's ``aligned=True``), without it a RoI is at least a pixel wide
    and high; with ``clockwise`` the angle turns clockwise."""
    offset = 0.5 if aligned else 0.0
    cx = rois[:, 1] * spatial_scale - offset
    cy = rois[:, 2] * spatial_scale - offset
    w = rois[:, 3] * spatial_scale
    h = rois[:, 4] * spatial_scale
    theta = -rois[:, 5] if clockwise else rois[:, 5]
    if not aligned:
        w = torch.clamp(w, min=1.0)
        h = torch.clamp(h, min=1.0)
    g = sample_num
    sub = (torch.arange(g, dtype=rois.dtype, device=rois.device) + 0.5) / g
    ph = torch.arange(out_size, dtype=rois.dtype, device=rois.device)
    bin_h = h / out_size
    bin_w = w / out_size
    grid = ph[None, :, None] + sub[None, None, :]               # (1, out, g)
    yy = (-h / 2)[:, None, None] + grid * bin_h[:, None, None]
    xx = (-w / 2)[:, None, None] + grid * bin_w[:, None, None]
    yy = yy[:, :, :, None, None]                                # (n,out,g,1,1)
    xx = xx[:, None, None, :, :]
    cos_t = torch.cos(theta)[:, None, None, None, None]
    sin_t = torch.sin(theta)[:, None, None, None, None]
    y = yy * cos_t + xx * sin_t + cy[:, None, None, None, None]
    x = xx * cos_t - yy * sin_t + cx[:, None, None, None, None]

    oob = (y < -1.0) | (y > hgt) | (x < -1.0) | (x > wid)
    y = torch.clamp(y, 0.0, hgt - 1.0)
    x = torch.clamp(x, 0.0, wid - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=hgt - 1)
    x1 = torch.clamp(x0 + 1, max=wid - 1)
    ly = y - y0.to(y.dtype)
    lx = x - x0.to(x.dtype)
    return y0, x0, y1, x1, ly, lx, (~oob).to(y.dtype)


def _align_one_level(feat, rois, out_size, spatial_scale, sample_num,
                     aligned: bool = True, clockwise: bool = True):
    """feat (B, H, W, C); rois (n, 6), all on this level -> (n, out, out,
    C) fp32."""
    hgt, wid = feat.shape[1], feat.shape[2]
    y0, x0, y1, x1, ly, lx, keep = sample_taps(
        rois, hgt, wid, out_size, spatial_scale, sample_num, aligned,
        clockwise)
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feat.reshape(-1, feat.shape[-1])
    base = rois[:, 0].long()[:, None, None, None, None] * (hgt * wid)

    def tap(yi, xi, wgt):
        v = flat[base + yi * wid + xi].float()                  # (..., C)
        return (wgt * keep)[..., None] * v

    vals = tap(y0, x0, hy * hx) + tap(y0, x1, hy * lx) + \
        tap(y1, x0, ly * hx) + tap(y1, x1, ly * lx)
    return vals.mean(dim=(2, 4))                                # (n,out,out,C)


def roi_align_rotated_pyramid(feats: Sequence[torch.Tensor], rois,
                              target_lvls, out_size: int,
                              featmap_strides=(4, 8, 16, 32),
                              sample_num: int = 2, roi_chunk: int = 1024):
    """Multi-level rotated RoI align.

    feats: per-level (B, H_l, W_l, C), the same B and C; only the first
    ``len(featmap_strides)`` levels are read. rois: (N, 6) ``(batch_idx,
    cx, cy, w, h, theta)`` in image coordinates; target_lvls: (N,) level
    per RoI. Returns (N, out, out, C) in the features' dtype. The RoIs of a
    level are sampled ``roi_chunk`` at a time to bound the temporaries.
    """
    n, ch = rois.shape[0], feats[0].shape[-1]
    rois = rois.float()
    out = torch.zeros((n, out_size, out_size, ch), dtype=feats[0].dtype,
                      device=rois.device)
    for lvl, stride in enumerate(featmap_strides):
        idx = torch.nonzero(target_lvls == lvl).squeeze(1)
        for c0 in range(0, idx.numel(), roi_chunk):
            sel = idx[c0:c0 + roi_chunk]
            out[sel] = _align_one_level(
                feats[lvl], rois[sel], out_size, 1.0 / stride,
                sample_num).to(out.dtype)
    return out


def roi_align_rotated(features, rois, out_size: int, spatial_scale: float,
                      sample_num: int = 2, aligned: bool = True,
                      clockwise: bool = True):
    """Rotated RoI align on one feature map.

    features: (B, H, W, C); rois: (N, 6) ``(batch_idx, cx, cy, w, h,
    theta)`` in image coordinates; ``spatial_scale`` the stride's
    reciprocal. Returns (N, out, out, C) in the promoted dtype of the
    features and fp32, as the JAX function's bilinear weights promote it.
    """
    out = _align_one_level(features, rois.float(), out_size, spatial_scale,
                           sample_num, aligned, clockwise)
    return out.to(torch.promote_types(features.dtype, torch.float32))
