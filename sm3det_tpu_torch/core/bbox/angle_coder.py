"""The circular smooth label (CSL) angle coder.

Port of ``sm3det_tpu/core/bbox/angle_coder.py``: an angle in radians is
binned into ``coding_len`` bins of ``omega`` degrees over the version's
range (``oc`` 90 degrees from 0; ``le90`` 180 from -90; ``le135`` 180 from
-45) and encoded as a window around its bin, at circular bin distance:
``gaussian`` (exp(-d^2 / 2 r^2)), ``triangle`` (1 - d / r, clipped),
``rect`` (d <= r) or ``pulse`` (d == 0). ``decode`` takes the first
argmax bin's centre.
"""

from __future__ import annotations

import math

import torch

from .assigners import _argmax_first

WINDOWS = ("gaussian", "triangle", "rect", "pulse")


class CSLCoder:
    def __init__(self, angle_version: str = "le90", omega: int = 1,
                 window: str = "gaussian", radius: int = 6):
        if angle_version not in ("oc", "le90", "le135"):
            raise ValueError(f"CSLCoder: angle version {angle_version!r}")
        if window not in WINDOWS:
            raise ValueError(f"CSLCoder: window {window!r}, one of {WINDOWS}")
        self.version = angle_version
        self.omega = omega
        self.window = window
        self.radius = radius
        self.angle_range = 90 if angle_version == "oc" else 180
        self.angle_offset = {"oc": 0, "le90": 90, "le135": 45}[angle_version]
        self.coding_len = int(self.angle_range // omega)

    def encode(self, angle_targets: torch.Tensor) -> torch.Tensor:
        """(...,) radians -> (..., coding_len) smooth labels, fp32."""
        deg = angle_targets * (180.0 / math.pi) + self.angle_offset
        bin_idx = torch.clamp(torch.div(deg, self.omega,
                                        rounding_mode="floor"),
                              0, self.coding_len - 1)
        idx = torch.arange(self.coding_len, dtype=torch.float32,
                           device=angle_targets.device)
        d = (idx - bin_idx[..., None]).abs()
        d = torch.minimum(d, self.coding_len - d)
        r = self.radius
        if self.window == "gaussian":
            return torch.exp(-(d ** 2) / (2 * r * r))
        if self.window == "triangle":
            return torch.clamp(1 - d / r, 0, 1)
        if self.window == "rect":
            return (d <= r).float()
        return (d == 0).float()

    def decode(self, angle_preds: torch.Tensor) -> torch.Tensor:
        """(..., coding_len) logits -> (...,) radians."""
        idx = _argmax_first(angle_preds, -1).float()
        deg = idx * self.omega + self.omega / 2.0 - self.angle_offset
        return deg * (math.pi / 180.0)
