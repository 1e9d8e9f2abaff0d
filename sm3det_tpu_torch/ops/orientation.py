"""Orientation ops of S2ANet's ODM head and of ReDet.

Port of ``sm3det_tpu/ops/orientation.py``: ``orconv_indices`` (ORConv2d's
discrete 45-degree index tables; the port keeps its own numpy copy),
``arf_expand`` (ActiveRotatedFilter: one base filter an output plane,
expanded into ``n_rot`` rotated copies), ``rotation_invariant_pool`` (max
over each output plane's rotations), ``_rotation_interp_matrix`` (the
bilinear map that rotates a k x k kernel; numpy) with
``active_rotated_filter`` on it, ``orientation_align`` (RiRoIAlign's cyclic
interpolation of the orientation channels by each RoI's angle) and
``riroi_align_rotated`` (the single-level rotated align, then that
alignment). The expansion is a static permutation, one ``index_select`` of
the base weight, so its gradient reaches the base filter through plain
autograd; the index tables and rotation matrices are made once a device.
"""

from __future__ import annotations

import numpy as np
import torch

from .roi_align_rotated import roi_align_rotated

# ORConv2d's kernel index tables: for a k x k kernel rotated by ``angle``
# degrees, entry j is the 1-based cell that source cell j lands on
_ORCONV_KERNEL_INDICES = {
    1: {a: (1,) for a in range(0, 360, 45)},
    3: {
        0: (1, 2, 3, 4, 5, 6, 7, 8, 9),
        45: (2, 3, 6, 1, 5, 9, 4, 7, 8),
        90: (3, 6, 9, 2, 5, 8, 1, 4, 7),
        135: (6, 9, 8, 3, 5, 7, 2, 1, 4),
        180: (9, 8, 7, 6, 5, 4, 3, 2, 1),
        225: (8, 7, 4, 9, 5, 1, 6, 3, 2),
        270: (7, 4, 1, 8, 5, 2, 9, 6, 3),
        315: (4, 1, 2, 7, 5, 3, 8, 9, 6),
    },
}


def orconv_indices(k: int, n_orient: int, n_rot: int) -> np.ndarray:
    """0-based (n_orient k k, n_rot) target table: source entry
    ``l = i k k + j`` (orientation i, cell j) lands, under rotation r by
    ``angle = r 360 / n_rot`` degrees, at orientation
    ``(i + angle // (360 / n_orient)) % n_orient`` and kernel cell
    ``table[k][angle][j]``."""
    if 360 % n_rot or (360 // n_rot) % 45:
        raise ValueError(f"n_rot must divide 360 into 45-deg steps: {n_rot}")
    table = _ORCONV_KERNEL_INDICES[k]
    d_or = 360 / n_orient
    idx = np.zeros((n_orient * k * k, n_rot), np.int64)
    for i in range(n_orient):
        for j in range(k * k):
            for r in range(n_rot):
                angle = r * (360 // n_rot)
                layer = (i + int(angle // d_or)) % n_orient
                idx[i * k * k + j, r] = layer * k * k + table[angle][j] - 1
    return idx


def arf_gather_index(cin: int, o_in: int, cout: int, k: int,
                     n_rot: int) -> np.ndarray:
    """Flat positions into an ORConv base weight ``(Cout, Cin, O_in, k,
    k)`` that make the expanded OIHW kernel ``(Cout R, Cin O_in, k, k)``:
    output channel ``co R + r`` (R fastest), input channel ``ci O_in + o``,
    cell (ky, kx) reads the source entry whose rotation r lands there."""
    idx = orconv_indices(k, o_in, n_rot)               # (O_in k k, R)
    inv = np.empty_like(idx)
    for r in range(n_rot):
        inv[idx[:, r], r] = np.arange(idx.shape[0])
    # source entry l = (o_src, cell_src) as a flat (O_in, k, k) position
    co = np.arange(cout)[:, None, None, None, None, None]
    r = np.arange(n_rot)[None, :, None, None, None, None]
    ci = np.arange(cin)[None, None, :, None, None, None]
    o = np.arange(o_in)[None, None, None, :, None, None]
    ky = np.arange(k)[None, None, None, None, :, None]
    kx = np.arange(k)[None, None, None, None, None, :]
    src = inv[(o * k + ky) * k + kx, r]                 # l, by broadcast
    flat = (co * cin + ci) * (o_in * k * k) + src
    return flat.reshape(cout * n_rot, cin * o_in, k, k)


def arf_expand(weight: torch.Tensor, n_rot: int = 8) -> torch.Tensor:
    """ActiveRotatedFilter with ORConv2d's index semantics.

    weight: ``(Cout, Cin, O_in, k, k)``, the base filters. Returns the
    OIHW conv kernel ``(Cout R, Cin O_in, k, k)``, output channels ordered
    (Cout, R) with R fastest, the order ``rotation_invariant_pool``
    groups by."""
    cout, cin, o_in, k, _ = weight.shape
    flat = _device_index(cin, o_in, cout, k, n_rot, weight.device)
    out = weight.reshape(-1).index_select(0, flat)
    return out.reshape(cout * n_rot, cin * o_in, k, k)


_INDEX = {}     # (shape, n_rot, device) -> the gather index on the device


def _device_index(cin, o_in, cout, k, n_rot, device):
    """``arf_gather_index`` flattened, on ``device``; made once, outside
    inference mode (a train step after an eval pass saves it for its
    backward), so that a forward copies nothing to the card."""
    key = (cin, o_in, cout, k, n_rot, str(device))
    if key not in _INDEX:
        with torch.inference_mode(False):
            _INDEX[key] = torch.from_numpy(arf_gather_index(
                cin, o_in, cout, k, n_rot).reshape(-1)).to(device)
    return _INDEX[key]


def rotation_invariant_pool(x: torch.Tensor, n_orient: int = 8):
    """RotationInvariantPooling on NHWC: max over each group of
    ``n_orient`` consecutive channels (orientation fastest)."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // n_orient,
                                     n_orient)).amax(dim=-1)


def _rotation_interp_matrix(k: int, angle: float) -> np.ndarray:
    """(k k, k k) float32 bilinear map rotating a k x k kernel by
    ``angle`` radians about its centre: row ``oy k + ox`` reads the four
    cells around the rotated source position."""
    c = (k - 1) / 2.0
    cos_a, sin_a = np.cos(-angle), np.sin(-angle)
    m = np.zeros((k * k, k * k), np.float32)
    for oy in range(k):
        for ox in range(k):
            sx = cos_a * (ox - c) - sin_a * (oy - c) + c
            sy = sin_a * (ox - c) + cos_a * (oy - c) + c
            x0, y0 = int(np.floor(sx)), int(np.floor(sy))
            for dy in (0, 1):
                for dx in (0, 1):
                    xx, yy = x0 + dx, y0 + dy
                    if 0 <= xx < k and 0 <= yy < k:
                        wx = 1 - abs(sx - xx)
                        wy = 1 - abs(sy - yy)
                        if wx > 0 and wy > 0:
                            m[oy * k + ox, yy * k + xx] += wx * wy
    return m


_MATS = {}      # (k, n, device) -> (n, k k, k k) rotation matrices


def rotation_matrices(k: int, n: int, device) -> torch.Tensor:
    """The n rotations by 2 pi r / n of a k x k kernel,
    ``_rotation_interp_matrix`` stacked, on ``device``; made once, outside
    inference mode."""
    key = (k, n, str(device))
    if key not in _MATS:
        with torch.inference_mode(False):
            _MATS[key] = torch.from_numpy(np.stack([
                _rotation_interp_matrix(k, 2 * np.pi * r / n)
                for r in range(n)])).to(device)
    return _MATS[key]


def active_rotated_filter(weights: torch.Tensor, num_rotations: int = 8):
    """Rotated copies of orientation-grouped filters.

    weights: ``(Cout, Cin O, k, k)``, input channels grouped (Cin, O),
    orientation fastest (the OIHW form of JAX's ``(k, k, Cin O, Cout)``).
    Returns ``(O, Cout, Cin O, k, k)``: copy r is the filter rotated by
    2 pi r / O (bilinear) with its orientation channels shifted
    cyclically by r."""
    cout, cin_o, k, _ = weights.shape
    o = num_rotations
    cin = cin_o // o
    mats = rotation_matrices(k, o, weights.device).to(weights.dtype)
    w = weights.reshape(cout, cin, o, k * k)
    rotated = torch.einsum("rab,dcob->rdcoa", mats, w)
    outs = [torch.roll(rotated[r], r, dims=2) for r in range(o)]
    return torch.stack(outs).reshape(o, cout, cin_o, k, k)


def orientation_align(pooled: torch.Tensor, theta: torch.Tensor,
                      num_orientations: int = 8):
    """RiRoIAlign's channel alignment: pooled (N, s, s, Cin O),
    orientation fastest, and the RoIs' angles (N,) in radians. Each RoI's
    orientation channels are read from ``floor(theta / (2 pi / O))``
    places on, cyclically (a negative angle wraps: ``remainder``, not
    ``fmod``), interpolated linearly by the fractional part, in fp32 for
    an fp32 angle; the result is rounded once to the pooled dtype."""
    n, s, _, co = pooled.shape
    o = num_orientations
    cin = co // o
    p = pooled.reshape(n, s, s, cin, o)
    shift = theta / (2 * np.pi / o)
    lo = torch.floor(shift)
    frac = (shift - lo)[:, None, None, None, None]
    idx = torch.remainder(torch.arange(o, device=pooled.device)[None]
                          + lo.long()[:, None], o)            # (N, O)
    idx1 = torch.remainder(idx + 1, o)

    def take(i):
        return torch.gather(p, -1, i[:, None, None, None, :].expand(
            n, s, s, cin, o))
    out = (1 - frac) * take(idx) + frac * take(idx1)
    return out.reshape(n, s, s, co).to(pooled.dtype)


def riroi_align_rotated(features, rois, out_size: int,
                        spatial_scale: float, num_orientations: int = 8,
                        sample_num: int = 2):
    """Rotation-invariant RoI align (ReDet): the rotated align of
    features (B, H, W, Cin O), orientation fastest, at rois (N, 6)
    ``(batch, cx, cy, w, h, theta)`` (``aligned``, ``clockwise``), then
    :func:`orientation_align` by each RoI's angle."""
    pooled = roi_align_rotated(features, rois, out_size, spatial_scale,
                               sample_num=sample_num, aligned=True,
                               clockwise=True)
    return orientation_align(pooled, rois[:, 5], num_orientations)
