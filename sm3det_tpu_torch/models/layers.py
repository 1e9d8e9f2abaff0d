"""Common building blocks, NHWC at every public function.

Port of ``sm3det_tpu/models/layers.py`` (GELU policy, ``Scale``,
``DropPath``) plus the NHWC convolution and flax-style GroupNorm the neck
and head use.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU policy: exact erf for fp32, the tanh form if and only if bf16.

    Computed in fp32 on the given values and rounded once to ``x.dtype``.
    """
    approx = "tanh" if x.dtype == torch.bfloat16 else "none"
    return F.gelu(x.float(), approximate=approx).to(x.dtype)


def drop_path_mask(batch: int, rate: float, gen: torch.Generator | None):
    """Per-sample keep mask of stochastic depth, (batch,) bool, True with
    probability ``1 - rate``; drawn on ``gen``'s device."""
    dev = gen.device if gen is not None else None
    return torch.rand(batch, generator=gen, device=dev) < 1.0 - rate


def drop_path(x: torch.Tensor, rate: float, keep_mask=None) -> torch.Tensor:
    """Stochastic depth per sample (timm semantics, ``DropPath``): a kept
    sample is scaled by ``1 / (1 - rate)``, a dropped one is 0. Identity
    for ``rate == 0`` or without a mask (inference)."""
    if rate == 0.0 or keep_mask is None:
        return x
    keep = 1.0 - rate
    mask = keep_mask.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Scale(nn.Module):
    """Learnable scalar multiplier (GFL per-level regression scale)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self.scale


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """flax's truncated normal: N(0, 1) cut at +-2, scaled to ``std``."""
    with torch.no_grad():
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(std / 0.87962566103423978)
    return t


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on NHWC tensors; weight OIHW, lecun-normal init."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 gen: torch.Generator | None = None,
                 bias_init: float = 0.0, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        fan_in = cin // groups * kernel * kernel
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel, kernel))
        trunc_normal_(self.weight, 1.0 / math.sqrt(fan_in), gen)
        self.bias = nn.Parameter(torch.full((cout,), float(bias_init))) \
            if bias else None

    def forward(self, x):
        # the permuted view of an NHWC tensor is a channels-last NCHW
        # tensor: cuDNN runs channels-last and the result permutes back
        # without a copy
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense``: weight (out, in), lecun-normal init, zero bias."""

    def __init__(self, cin: int, cout: int,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        trunc_normal_(self.weight, 1.0 / math.sqrt(cin), gen)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm``: fp32 statistics with the fast variance
    ``max(E[x^2] - mean^2, 0)``, eps 1e-6, output in the promoted dtype."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, h, w, c = x.shape
        g = self.num_groups
        xf = x.float().reshape(b, h * w, g, c // g)
        mean = xf.mean(dim=(1, 3))
        var = torch.clamp((xf * xf).mean(dim=(1, 3)) - mean * mean, min=0.0)
        # (x - mean) * a + bias as one fp32 pass over x:
        # x * a + (bias - mean * a), a = rsqrt(var + eps) * weight per
        # (image, channel)
        a = torch.rsqrt(var + self.eps).repeat_interleave(c // g, dim=1) \
            * self.weight.float()
        shift = self.bias.float() - mean.repeat_interleave(c // g, dim=1) * a
        y = torch.addcmul(shift[:, None, None], x, a[:, None, None])
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))
