"""MultitaskFPN, NHWC.

Port of ``sm3det_tpu/models/necks/fpn.py::MultitaskFPN``: one set of
lateral/fpn/extra convs serves per-call ``start_level`` and
``add_extra_convs`` modes. Upsampling is nearest 2x (``repeat`` along H and
W); extra convs are 3x3, stride 2, padding 1 (25 -> 13 -> 7 at 800^2).
Only the ``"on_output"`` extra-conv mode the detector uses is ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers import Conv2d


def upsample_nearest_2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class MultitaskFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (96, 192, 384, 768),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, extra_level: int = 1,
                 add_extra_convs: str = "on_output",
                 gen: torch.Generator | None = None):
        super().__init__()
        self.n_in = len(in_channels)
        self.num_outs, self.start_level = num_outs, start_level
        self.add_extra_convs = add_extra_convs
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", Conv2d(c, out_channels, 1, gen=gen))
            setattr(self, f"fpn{i}", Conv2d(out_channels, out_channels, 3,
                                            padding=1, gen=gen))
        self.num_extra = max(num_outs - self.n_in + extra_level, 0)
        for i in range(self.num_extra):
            setattr(self, f"extra{i}", Conv2d(out_channels, out_channels, 3,
                                              stride=2, padding=1, gen=gen))

    def forward(self, inputs, start_level: int | None = None,
                add_extra_convs: str | None = None):
        sl = self.start_level if start_level is None else start_level
        mode = self.add_extra_convs if add_extra_convs is None \
            else add_extra_convs
        if mode != "on_output":
            raise NotImplementedError(
                f"add_extra_convs={mode!r}: only 'on_output' is ported")
        laterals = [getattr(self, f"lateral{i + sl}")(inputs[i + sl])
                    for i in range(self.n_in - sl)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + \
                upsample_nearest_2x(laterals[i])
        outs = [getattr(self, f"fpn{i + sl}")(lat)
                for i, lat in enumerate(laterals)]
        extra_idx = 0
        while len(outs) < self.num_outs:
            outs.append(getattr(self, f"extra{extra_idx}")(outs[-1]))
            extra_idx += 1
        return tuple(outs)
