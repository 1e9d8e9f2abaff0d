"""Anchor generation (mmdet ``AnchorGenerator`` semantics).

The port's own copy of ``sm3det_tpu/core/anchor.py::AnchorGenerator``:
per-level base anchors from ``scales x ratios`` around ``base_size =
stride``, shifted over the feature grid, computed in numpy on the host and
handed over as tensors on the requested device.
"""

from __future__ import annotations

import numpy as np
import torch


class AnchorGenerator:
    def __init__(self, strides, ratios, scales=None, octave_base_scale=None,
                 scales_per_octave=None, base_sizes=None, center_offset=0.0):
        self.strides = list(strides)
        self.ratios = np.asarray(ratios, np.float32)
        if scales is not None:
            self.scales = np.asarray(scales, np.float32)
        else:
            if octave_base_scale is None:
                raise ValueError("give scales or octave_base_scale")
            octave_scales = np.array(
                [2 ** (i / scales_per_octave)
                 for i in range(scales_per_octave)], np.float32)
            self.scales = octave_scales * octave_base_scale
        self.base_sizes = list(base_sizes) if base_sizes is not None \
            else list(strides)
        self.center_offset = center_offset
        self._grids = {}    # (featmap sizes, device) -> anchors per level

    def base_anchors(self, level: int) -> np.ndarray:
        """(A, 4) xyxy base anchors for one level, centered per offset."""
        base = self.base_sizes[level]
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        # mmdet ordering: scales vary fastest within a ratio
        ws = (base * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (base * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        cx = self.center_offset * base
        cy = self.center_offset * base
        return np.stack(
            [cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs],
            axis=-1).astype(np.float32)

    def grid_anchors_np(self, featmap_sizes):
        """List over levels of (H*W*A, 4) xyxy anchors, row-major over
        (y, x) with the base anchors fastest."""
        out = []
        for lvl, (h, w) in enumerate(featmap_sizes):
            stride = self.strides[lvl]
            base = self.base_anchors(lvl)
            xs = np.arange(w, dtype=np.float32) * stride
            ys = np.arange(h, dtype=np.float32) * stride
            shift_x, shift_y = np.meshgrid(xs, ys)
            shifts = np.stack(
                [shift_x.ravel(), shift_y.ravel(),
                 shift_x.ravel(), shift_y.ravel()], axis=-1)
            out.append((shifts[:, None, :] + base[None, :, :]).reshape(-1, 4))
        return out

    def grid_anchors(self, featmap_sizes, device=None):
        """As ``grid_anchors_np``, as tensors on ``device``; a generator
        keeps the grids it has made."""
        key = (tuple(tuple(s) for s in featmap_sizes), str(device))
        if key not in self._grids:
            self._grids[key] = [torch.from_numpy(a).to(device)
                                for a in self.grid_anchors_np(featmap_sizes)]
        return self._grids[key]
