"""Rotated feature alignment of the refinement detectors (R3Det, S2ANet).

Port of ``rotated_feature_align`` of ``sm3det_tpu/ops/geometry_extras.py``
and of the bilinear gather it calls (``_bilinear_gather`` of
``sm3det_tpu/ops/roi_align_rotated.py``): every location of a level is
re-sampled at its refined rotated anchor, at the centre (``points=1``) or
at the centre and the four edge midpoints (``points=5``), and the samples
are averaged. The JAX package computes it outside any Pallas kernel; here
it is plain PyTorch on either device, differentiable in the features.
"""

from __future__ import annotations

import torch


def bilinear_gather(feat: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """feat (B, H, W, C); y, x (B, ...) sample coordinates in pixels of
    the image they index -> (B, ..., C) in fp32. A coordinate is clamped
    to the map; a sample beyond [-1, H] x [-1, W] is 0."""
    b, h, w, c = feat.shape
    oob = (y < -1.0) | (y > h * 1.0) | (x < -1.0) | (x > w * 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x = torch.clamp(x, 0.0, w - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly = (y - y0.to(y.dtype))[..., None]
    lx = (x - x0.to(x.dtype))[..., None]
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feat.reshape(b * h * w, c)
    base = (torch.arange(b, device=feat.device) * (h * w)).reshape(
        (b,) + (1,) * (y.dim() - 1))

    def tap(yy, xx):
        return flat[base + yy * w + xx].float()

    out = hy * hx * tap(y0, x0) + hy * lx * tap(y0, x1) + \
        ly * hx * tap(y1, x0) + ly * lx * tap(y1, x1)
    return torch.where(oob[..., None], torch.zeros((), device=out.device),
                       out)


def rotated_feature_align(features: torch.Tensor, best_rboxes: torch.Tensor,
                          points: int = 1, spatial_scale: float = 1.0):
    """R3Det's feature refinement.

    features: (B, H, W, C); best_rboxes: (B, H, W, 5) the refined anchor
    of each location, in image coordinates. The samples are summed in the
    order centre, +w/2, -w/2, +h/2, -h/2, then divided by their count, in
    fp32; the result is rounded once to the features' dtype."""
    cx = best_rboxes[..., 0] * spatial_scale
    cy = best_rboxes[..., 1] * spatial_scale
    bw = best_rboxes[..., 2] * spatial_scale
    bh = best_rboxes[..., 3] * spatial_scale
    a = best_rboxes[..., 4]
    cos_a, sin_a = torch.cos(a), torch.sin(a)
    if points == 1:
        offsets = [(0.0, 0.0)]
    else:
        offsets = [(0.0, 0.0), (0.5, 0.0), (-0.5, 0.0), (0.0, 0.5),
                   (0.0, -0.5)]
    out = None
    for dx, dy in offsets:
        px = cx + dx * bw * cos_a - dy * bh * sin_a
        py = cy + dx * bw * sin_a + dy * bh * cos_a
        sampled = bilinear_gather(features, py, px)
        out = sampled if out is None else out + sampled
    return (out / len(offsets)).to(features.dtype)
