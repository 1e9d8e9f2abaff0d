"""Feature pyramid necks, NHWC: ``MultitaskFPN``, ``FPN`` and ``SimpleFPN``.

Port of ``sm3det_tpu/models/necks/fpn.py``.

- ``MultitaskFPN``: one set of lateral/fpn/extra convs serves per-call
  ``start_level`` and ``add_extra_convs`` modes. Upsampling is nearest 2x
  (``repeat`` along H and W). The levels past the backbone's come from
  3x3 stride-2 convs (25 -> 13 -> 7 at 800^2) on the last output
  (``"on_output"``, or ``True``), the last input (``"on_input"``) or the
  last lateral (``"on_lateral"``), with a ReLU before every extra conv but
  the first under ``relu_before_extra_convs``; with ``False`` they are
  (1, 1) max-pools of stride 2 of the last output. The detectors choose
  the mode per call (``"on_output"`` on both branches, as JAX's do).
- ``FPN``: the same module, as in JAX.
- ``SimpleFPN`` (ViTDet-style, one stride-16 map): two stride-2 transposed
  convs with LayerNorm and exact GELU between them (4x up), one transposed
  conv (2x up), the map itself and a 2x2 max-pool, then per level a 1x1
  lateral and a 3x3 output conv; extra levels are (1, 1) stride-2 pools.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cuda.convnext_block_kernel import layernorm_math
from ..backbones.convnext import LayerNormOpt
from ..layers import Conv2d, trunc_normal_

EXTRA_CONV_MODES = (False, True, "on_input", "on_lateral", "on_output")


def upsample_nearest_2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def pool_stride2(x):
    """flax ``max_pool(x, (1, 1), strides=(2, 2))``: every other pixel."""
    return x[:, ::2, ::2]


def check_extra_convs(mode):
    """``mode`` if it is an extra-level mode, else ``ValueError`` (the JAX
    module takes any other string for "on_output")."""
    if not any(mode is m or (isinstance(m, str) and mode == m)
               for m in EXTRA_CONV_MODES):
        raise ValueError(f"add_extra_convs={mode!r}: one of "
                         f"{EXTRA_CONV_MODES}")
    return mode


class MultitaskFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (96, 192, 384, 768),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, extra_level: int = 1,
                 add_extra_convs: str | bool = "on_output",
                 relu_before_extra_convs: bool = False,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.n_in = len(in_channels)
        self.num_outs, self.start_level = num_outs, start_level
        self.add_extra_convs = check_extra_convs(add_extra_convs)
        self.relu_before_extra_convs = relu_before_extra_convs
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", Conv2d(c, out_channels, 1, gen=gen))
            setattr(self, f"fpn{i}", Conv2d(out_channels, out_channels, 3,
                                            padding=1, gen=gen))
        self.num_extra = max(num_outs - self.n_in + extra_level, 0)
        for i in range(self.num_extra):
            # the first extra conv reads the last input under "on_input"
            cin = in_channels[-1] if i == 0 and \
                add_extra_convs == "on_input" else out_channels
            setattr(self, f"extra{i}", Conv2d(cin, out_channels, 3,
                                              stride=2, padding=1, gen=gen))

    def forward(self, inputs, start_level: int | None = None,
                add_extra_convs: str | bool | None = None):
        sl = self.start_level if start_level is None else start_level
        mode = self.add_extra_convs if add_extra_convs is None \
            else check_extra_convs(add_extra_convs)
        laterals = [getattr(self, f"lateral{i + sl}")(inputs[i + sl])
                    for i in range(self.n_in - sl)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + \
                upsample_nearest_2x(laterals[i])
        outs = [getattr(self, f"fpn{i + sl}")(lat)
                for i, lat in enumerate(laterals)]
        if len(outs) >= self.num_outs:
            return tuple(outs)
        if mode is False:
            while len(outs) < self.num_outs:
                outs.append(pool_stride2(outs[-1]))
            return tuple(outs)
        source = {"on_input": inputs[-1],
                  "on_lateral": laterals[-1]}.get(mode, outs[-1])
        outs.append(self.extra0(source))
        while len(outs) < self.num_outs:
            src = outs[-1]
            if self.relu_before_extra_convs:
                src = torch.relu(src)
            outs.append(getattr(self, f"extra{len(outs) - len(laterals)}")(
                src))
        return tuple(outs)


class FPN(MultitaskFPN):
    """The plain FPN: the same module as ``MultitaskFPN``, as in JAX."""


class UpConv2x2(nn.Module):
    """flax ``nn.ConvTranspose(cout, (2, 2), strides=(2, 2))`` (padding
    "SAME", ``transpose_kernel=False``) on NHWC tensors, with its kernel
    kept in the flax layout (2, 2, cin, cout): output pixel (2i + a, 2j + c)
    is ``x[i, j] @ kernel[1 - a, 1 - c] + bias``. flax does not flip the
    kernel; ``conv_transpose2d`` places tap (a, c) at offset (a, c), hence
    the flip."""

    def __init__(self, cin: int, cout: int,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(trunc_normal_(
            torch.empty(2, 2, cin, cout), 1 / math.sqrt(4 * cin), gen))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        w = self.kernel.flip(0, 1).permute(2, 3, 0, 1)   # (cin, cout, 2, 2)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, self.bias, stride=2)
        return y.permute(0, 2, 3, 1)


class SimpleFPN(nn.Module):
    """Simple feature pyramid of one stride-16 map (B, H, W,
    ``backbone_channel``) -> ``num_outs`` levels of ``out_channels``, at
    strides 4, 8, 16, 32, then every other pixel of the last."""

    def __init__(self, backbone_channel: int = 768,
                 in_channels: Sequence[int] = (192, 384, 768, 768),
                 out_channels: int = 256, num_outs: int = 5,
                 gen: torch.Generator | None = None):
        super().__init__()
        del in_channels     # the levels' widths follow backbone_channel
        bc = backbone_channel
        self.num_outs = num_outs
        self.fpn1_up1 = UpConv2x2(bc, bc // 2, gen)
        self.fpn1_norm = LayerNormOpt(bc // 2)
        self.fpn1_up2 = UpConv2x2(bc // 2, bc // 4, gen)
        self.fpn2_up = UpConv2x2(bc, bc // 2, gen)
        for i, c in enumerate((bc // 4, bc // 2, bc, bc)):
            setattr(self, f"lateral_conv{i}", Conv2d(c, out_channels, 1,
                                                     gen=gen))
            setattr(self, f"fpn_conv{i}", Conv2d(out_channels, out_channels,
                                                 3, padding=1, gen=gen))

    def forward(self, x):
        up1 = self.fpn1_up1(x)
        # flax nn.LayerNorm, outside any kernel in JAX too
        norm = self.fpn1_norm
        up1 = layernorm_math(up1, norm.weight, norm.bias, norm.eps)
        up1 = self.fpn1_up2(F.gelu(up1))
        up2 = self.fpn2_up(x)
        down4 = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        outs = []
        for i, feat in enumerate((up1, up2, x, down4)):
            lat = getattr(self, f"lateral_conv{i}")(feat)
            outs.append(getattr(self, f"fpn_conv{i}")(lat))
        while len(outs) < self.num_outs:
            outs.append(pool_stride2(outs[-1]))
        return tuple(outs)
