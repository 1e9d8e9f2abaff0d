"""Multi-scale deformable attention sampling.

Port of ``sm3det_tpu/ops/ms_deform_attn.py::ms_deform_attn``, which JAX
computes as a plain gather (no Pallas kernel): for each query, bilinear taps
at ``num_points`` predicted locations on every level, combined with the
softmax attention weights. The bilinear is JAX's, not ``F.grid_sample``'s:
a location with ``y < -1``, ``y > h``, ``x < -1`` or ``x > w`` (pixel
coordinates ``loc * size - 0.5``) gives 0; any other is clamped to
``[0, h-1] x [0, w-1]`` and read from four taps, the second row and column
``min(y0 + 1, h - 1)`` / ``min(x0 + 1, w - 1)``. So the borders differ from
zero padding: a location half a pixel outside the map reads the edge.
Autograd gives the backward.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def ms_deform_attn(value: torch.Tensor,
                   value_spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """
    Args:
        value: (B, sum(H*W), num_heads, head_dim), the levels flattened
            and concatenated.
        value_spatial_shapes: the (H, W) of each level (Python ints).
        sampling_locations: (B, Q, num_heads, L, P, 2), (x, y) in [0, 1].
        attention_weights: (B, Q, num_heads, L, P), softmaxed over L * P.

    Returns:
        (B, Q, num_heads * head_dim) in ``value``'s dtype; the sum runs in
        the promoted dtype of value and locations (fp32 for bf16 values).
    """
    b, _, nh, hd = value.shape
    q = sampling_locations.shape[1]
    p = sampling_locations.shape[4]
    out = None
    start = 0
    for lvl, (h, w) in enumerate(value_spatial_shapes):
        # (B * nh, H * W, hd)
        v = value[:, start:start + h * w].permute(0, 2, 1, 3) \
            .reshape(b * nh, h * w, hd)
        loc = sampling_locations[:, :, :, lvl]             # (B, Q, nh, P, 2)
        x = (loc[..., 0] * w - 0.5).permute(0, 2, 1, 3)    # (B, nh, Q, P)
        y = (loc[..., 1] * h - 0.5).permute(0, 2, 1, 3)
        oob = (y < -1.0) | (y > h * 1.0) | (x < -1.0) | (x > w * 1.0)
        y = torch.clamp(y, 0.0, h - 1.0)
        x = torch.clamp(x, 0.0, w - 1.0)
        y0f, x0f = torch.floor(y), torch.floor(x)
        # the clamp changes no finite location; a NaN one (a diverged
        # model) reads row 0 and stays NaN through its weights, as in JAX,
        # whose gather clamps, instead of indexing out of bounds
        y0 = torch.clamp(y0f.long(), 0, h - 1)
        x0 = torch.clamp(x0f.long(), 0, w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        ly = (y - y0f)[..., None]
        lx = (x - x0f)[..., None]

        def tap(yy, xx):
            idx = (yy * w + xx).reshape(b * nh, q * p, 1).expand(-1, -1, hd)
            return torch.gather(v, 1, idx).reshape(b, nh, q, p, hd)

        res = (1 - ly) * (1 - lx) * tap(y0, x0) + \
            (1 - ly) * lx * tap(y0, x1) + \
            ly * (1 - lx) * tap(y1, x0) + \
            ly * lx * tap(y1, x1)
        res = torch.where(oob[..., None], torch.zeros((), dtype=res.dtype,
                                                      device=res.device), res)
        sampled = res.permute(0, 2, 1, 3, 4)               # (B, Q, nh, P, hd)
        wgt = attention_weights[:, :, :, lvl][..., None]
        part = torch.sum(sampled * wgt, dim=3)
        out = part if out is None else out + part
        start += h * w
    return out.reshape(b, q, nh * hd).to(value.dtype)
