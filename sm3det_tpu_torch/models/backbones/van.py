"""VAN / VAN-MoE backbone, NHWC.

Port of ``sm3det_tpu/models/backbones/van.py``: Large Kernel Attention (a
5x5 depthwise conv, a 7x7 depthwise conv of dilation 3 and a 1x1 conv, as
a multiplicative gate) in the LSKNet block structure: LayerNorm-normed
blocks with layer scale 1e-2, overlapping patch embeds, and the MLP of
``lsknet.py`` (``ConvMlp``) with its optional MoE fc1 / fc2. Inference and
training run as in ``lsknet.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import Conv2d
from .lsknet import LSKAttention, LSKNetBlock, LSKNetMoE


class LKA(nn.Module):
    """Large Kernel Attention: x * conv1(conv_spatial(conv0(x)))."""

    def __init__(self, dim: int, gen: torch.Generator | None = None):
        super().__init__()
        self.conv0 = Conv2d(dim, dim, 5, padding=2, groups=dim, gen=gen)
        self.conv_spatial = Conv2d(dim, dim, 7, padding=9, groups=dim,
                                   dilation=3, gen=gen)
        self.conv1 = Conv2d(dim, dim, 1, gen=gen)

    def forward(self, x):
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


class VANAttention(LSKAttention):
    gating_cls = LKA


class VANBlock(LSKNetBlock):
    attention_cls = VANAttention


class VANMoE(LSKNetMoE):
    """VAN(-MoE). Default arch b0: depths (3, 3, 5, 2), dims (32, 64, 160,
    256); b1: (2, 2, 4, 2) / (64, 128, 320, 512)."""

    block_cls = VANBlock
