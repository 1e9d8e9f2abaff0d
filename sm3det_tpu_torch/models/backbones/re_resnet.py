"""The rotation-equivariant ResNet and FPN of ReDet, NHWC.

Port of ``sm3det_tpu/models/backbones/re_resnet.py``. Every convolution is
a C8 group convolution lowered to one dense ``conv2d``: its base weight
``(Cout, Cin, O_in, k, k)`` (flax's ``(k, k, Cin, O_in, Cout)``) is
expanded into the orbit of 8 rotations, output channels ordered (Cout, O)
with the orientation fastest, the layout ``rotation_invariant_pool`` and
``orientation_align`` read:

- ``EquivariantConv``: k in {1, 3} through ORConv's exact 45-degree index
  tables (``ops/orientation.arf_expand``); the 7x7 stem lift (input
  without orientation channels) through the bilinear kernel rotations
  (``_rotation_interp_matrix``, exact at 90 degrees), made once a device;
- ``EquivariantLayerNorm``: LayerNorm over all channels, its scale and
  bias shared across the orientation axis;
- ``ReBasicBlock``, ``ReResNet`` (the 7x7 stride-2 lift, a 3x3 stride-2
  max-pool, four stages of basic blocks) and ``ReFPN`` (1x1 laterals,
  nearest top-down upsampling with half-pixel centres as
  ``jax.image.resize``, 3x3 output convs, extra levels by (1, 1) stride-2
  max-pools).

The JAX defaults are the port's: stem 8, stages (8, 16, 32, 64) x 8
orientations, (2, 2, 2, 2) blocks. Equivariance is exact at multiples of
90 degrees where every stride-2 step sees an odd size.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.orientation import arf_expand, rotation_matrices
from ..layers import trunc_normal_


class EquivariantConv(nn.Module):
    """C8-equivariant conv of ``in_channels`` (all orientations) into
    ``out_channels`` an orientation; ``first_layer`` lifts an input
    without orientation channels."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 num_orientations: int = 8, first_layer: bool = False,
                 gen: torch.Generator | None = None):
        super().__init__()
        o_in = 1 if first_layer else num_orientations
        k = kernel_size
        if k not in (1, 3) and not first_layer:
            raise ValueError(
                f"EquivariantConv: ORConv's index tables cover k in (1, 3); "
                f"k={k} only for the first-layer lift")
        self.k, self.stride, self.o = k, stride, num_orientations
        self.first_layer = first_layer
        cin = in_channels // o_in
        self.weight = nn.Parameter(torch.empty(out_channels, cin, o_in, k, k))
        trunc_normal_(self.weight, 1.0 / math.sqrt(k * k * cin * o_in), gen)

    def expanded_weight(self) -> torch.Tensor:
        """The OIHW kernel ``(Cout O, Cin O_in, k, k)``."""
        if self.k in (1, 3):
            return arf_expand(self.weight, self.o)
        cout, cin, _, k, _ = self.weight.shape
        mats = rotation_matrices(k, self.o, self.weight.device).to(
            self.weight.dtype)
        wf = self.weight.reshape(cout, cin, k * k)
        orbit = torch.einsum("rab,dcb->drca", mats, wf)
        return orbit.reshape(cout * self.o, cin, k, k)

    def forward(self, x):
        w = self.expanded_weight().to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, None, self.stride,
                     (self.k - 1) // 2)
        return y.permute(0, 2, 3, 1)


class EquivariantLayerNorm(nn.Module):
    """LayerNorm over the last axis (eps 1e-6, statistics in fp32), then a
    scale and bias an orientation field (``channels`` of them), shared by
    its ``num_orientations`` channels."""

    def __init__(self, channels: int, num_orientations: int = 8,
                 eps: float = 1e-6):
        super().__init__()
        self.o, self.eps = num_orientations, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y.reshape(x.shape[:-1] + (-1, self.o))
        y = y * self.weight.float()[:, None] + self.bias.float()[:, None]
        return y.reshape(x.shape).to(x.dtype)


class ReBasicBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 num_orientations: int = 8,
                 gen: torch.Generator | None = None):
        super().__init__()
        o = num_orientations
        self.conv1 = EquivariantConv(in_channels, channels, 3, stride, o,
                                     gen=gen)
        self.norm1 = EquivariantLayerNorm(channels, o)
        self.conv2 = EquivariantConv(channels * o, channels, 3, 1, o, gen=gen)
        self.norm2 = EquivariantLayerNorm(channels, o)
        # JAX adds the projection where the shapes differ
        if stride != 1 or in_channels != channels * o:
            self.downsample = EquivariantConv(in_channels, channels, 1,
                                              stride, o, gen=gen)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return torch.relu(y + identity)


class ReResNet(nn.Module):
    """The equivariant ResNet; ``stage_channels`` are an orientation's, so
    the levels hold ``stage_channels[i] * num_orientations`` channels."""

    def __init__(self, stem_channels: int = 8,
                 stage_channels: Sequence[int] = (8, 16, 32, 64),
                 stage_blocks: Sequence[int] = (2, 2, 2, 2),
                 num_orientations: int = 8,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 gen: torch.Generator | None = None):
        super().__init__()
        o = num_orientations
        self.out_indices = tuple(out_indices)
        self.stage_blocks = tuple(stage_blocks)
        self.stem = EquivariantConv(3, stem_channels, 7, 2, o,
                                    first_layer=True, gen=gen)
        self.stem_norm = EquivariantLayerNorm(stem_channels, o)
        cin = stem_channels * o
        for i, (ch, nb) in enumerate(zip(stage_channels, stage_blocks)):
            for j in range(nb):
                setattr(self, f"stage{i}_block{j}", ReBasicBlock(
                    cin, ch, 2 if (j == 0 and i > 0) else 1, o, gen=gen))
                cin = ch * o

    def forward(self, x):
        """(B, H, W, 3) -> the levels of ``out_indices`` (orientation
        channels kept, for RiRoI align)."""
        x = torch.relu(self.stem_norm(self.stem(x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for i, nb in enumerate(self.stage_blocks):
            for j in range(nb):
                x = getattr(self, f"stage{i}_block{j}")(x)
            if i in self.out_indices:
                outs.append(x)
        return outs

    def forward_train(self, x, gen=None):
        """The training forward: the same levels, no gate loss."""
        return self(x), None


def resize_nearest(x, hw):
    """``jax.image.resize(x, ..., "nearest")`` of NHWC ``x`` to ``hw``:
    source index floor((i + 0.5) in / out), computed in fp32 as JAX does
    (torch's ``nearest-exact`` rounds its scale in another order)."""
    for axis, n in ((1, hw[0]), (2, hw[1])):
        m = x.shape[axis]
        if m == n:
            continue
        src = torch.floor((torch.arange(n, dtype=torch.float32,
                                        device=x.device) + 0.5) * m / n)
        x = x.index_select(axis, src.long())
    return x


class ReFPN(nn.Module):
    """The equivariant FPN: ``out_channels`` in all (an orientation's
    ``out_channels / num_orientations``), ``num_outs`` levels."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 num_outs: int = 5, num_orientations: int = 8,
                 gen: torch.Generator | None = None):
        super().__init__()
        o = num_orientations
        c = out_channels // o
        self.num_ins, self.num_outs = len(in_channels), num_outs
        for i, cin in enumerate(in_channels):
            setattr(self, f"lateral{i}", EquivariantConv(cin, c, 1, 1, o,
                                                         gen=gen))
            setattr(self, f"fpn_conv{i}", EquivariantConv(c * o, c, 3, 1, o,
                                                          gen=gen))

    def forward(self, feats):
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[1:3])
        outs = [getattr(self, f"fpn_conv{i}")(lat)
                for i, lat in enumerate(laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, ::2, ::2])
        return outs
