"""LSKNet / LSKNet-MoE backbone, NHWC.

Port of ``sm3det_tpu/models/backbones/lsknet.py``: the Large Selective
Kernel spatial gating (a 5x5 depthwise conv, a 7x7 depthwise conv of
dilation 3, two 1x1 projections to C/2, avg/max spatial attention through
a 7x7 squeeze conv), LayerNorm-normed blocks with layer scale 1e-2,
overlapping patch embeds (the first named ``stem_single`` in the MultiInput
mode of the TriSource detectors, ``patch_embed0`` in the single-stem mode
of the zoo's ``LSKNet_moe``), and a grid MoE of linear experts that may replace the MLP's fc1 / fc2.

- Inference (``forward``): the LayerNorms through ``fused_layernorm`` (its
  kernel on a CUDA tensor), the convolutions through ``F.conv2d`` on the
  channels-last view of the NHWC activations (no copy around a conv), the
  MoE through its capacity dispatch (``models/moe.py``).
- Training (``forward_train``): the LayerNorms as ``layernorm_math``,
  stochastic depth with the ``np.linspace(0, rate, sum(depths))`` ramp over
  blocks, the MoE's noisy gate; returns the mean of the blocks' gate
  losses (a block's own is the mean of its fc1 / fc2 layers').
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..layers import Conv2d, drop_path, drop_path_mask, gelu
from ..moe import MoELayer
from .convnext import LayerNormOpt


class LSKBlock(nn.Module):
    """The spatial gating unit."""

    def __init__(self, dim: int, gen: torch.Generator | None = None):
        super().__init__()
        self.conv0 = Conv2d(dim, dim, 5, padding=2, groups=dim, gen=gen)
        self.conv_spatial = Conv2d(dim, dim, 7, padding=9, groups=dim,
                                   dilation=3, gen=gen)
        self.conv1 = Conv2d(dim, dim // 2, 1, gen=gen)
        self.conv2 = Conv2d(dim, dim // 2, 1, gen=gen)
        self.conv_squeeze = Conv2d(2, 2, 7, padding=3, gen=gen)
        self.conv = Conv2d(dim // 2, dim, 1, gen=gen)

    def forward(self, x):
        attn1 = self.conv0(x)
        attn2 = self.conv_spatial(attn1)
        attn1 = self.conv1(attn1)
        attn2 = self.conv2(attn2)
        attn = torch.cat([attn1, attn2], dim=-1)
        agg = torch.cat([attn.mean(-1, keepdim=True),
                         attn.amax(-1, keepdim=True)], dim=-1)
        sig = torch.sigmoid(self.conv_squeeze(agg))
        attn = attn1 * sig[..., 0:1] + attn2 * sig[..., 1:2]
        return x * self.conv(attn)


class LSKAttention(nn.Module):
    """1x1 projection, GELU, the gating unit, 1x1 projection, residual."""

    gating_cls = LSKBlock

    def __init__(self, dim: int, gen: torch.Generator | None = None):
        super().__init__()
        self.proj_1 = Conv2d(dim, dim, 1, gen=gen)
        self.spatial_gating_unit = self.gating_cls(dim, gen=gen)
        self.proj_2 = Conv2d(dim, dim, 1, gen=gen)

    def forward(self, x):
        y = self.spatial_gating_unit(gelu(self.proj_1(x)))
        return self.proj_2(y) + x


def _moe(cfg: dict, d_in: int, d_out: int, gen):
    return MoELayer(d_in, 0, num_experts=cfg["num_experts"],
                    top_k=cfg["top_k"], gating=cfg["gating"],
                    noisy_gating=cfg["noisy_gating"],
                    capacity_factor=cfg["capacity_factor"],
                    expert_kind="linear", out_dim=d_out, gen=gen)


class ConvMlp(nn.Module):
    """1x1 -> depthwise 3x3 -> GELU -> 1x1, with fc1 / fc2 optionally a
    grid MoE of linear experts over the flattened tokens."""

    def __init__(self, dim: int, hidden: int, moe_fc1: dict | None = None,
                 moe_fc2: dict | None = None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.dim, self.hidden = dim, hidden
        self.fc1 = _moe(moe_fc1, dim, hidden, gen) if moe_fc1 \
            else Conv2d(dim, hidden, 1, gen=gen)
        self.dwconv = Conv2d(hidden, hidden, 3, padding=1, groups=hidden,
                             gen=gen)
        self.fc2 = _moe(moe_fc2, hidden, dim, gen) if moe_fc2 \
            else Conv2d(hidden, dim, 1, gen=gen)

    @staticmethod
    def _run(layer, x, noise, train, losses):
        if not isinstance(layer, MoELayer):
            return layer(x)
        b, h, w, c = x.shape
        if train:
            y, aux = layer.forward_train(x.reshape(-1, c), noise)
            losses.append(aux)
        else:
            y = layer(x.reshape(-1, c))
        return y.reshape(b, h, w, layer.out_dim)

    def forward(self, x):
        x = gelu(self.dwconv(self._run(self.fc1, x, None, False, None)))
        return self._run(self.fc2, x, None, False, None)

    def forward_train(self, x, noises=(None, None)):
        """(output, the mean of the MoE layers' aux losses or None);
        ``noises`` the normal draws of fc1's and fc2's noisy gates."""
        losses = []
        x = self._run(self.fc1, x, noises[0], True, losses)
        x = gelu(self.dwconv(x))
        x = self._run(self.fc2, x, noises[1], True, losses)
        return x, (sum(losses) / len(losses) if losses else None)


class LSKNetBlock(nn.Module):
    """x + ls1 * attn(LN(x)), then x + ls2 * mlp(LN(x)), each branch under
    stochastic depth in training."""

    attention_cls = LSKAttention

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, moe_fc1: dict | None = None,
                 moe_fc2: dict | None = None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNormOpt(dim)
        self.attn = self.attention_cls(dim, gen=gen)
        self.norm2 = LayerNormOpt(dim)
        self.mlp = ConvMlp(dim, int(dim * mlp_ratio), moe_fc1, moe_fc2,
                           gen=gen)

    def forward(self, x):
        x = x + self.layer_scale_1 * self.attn(self.norm1(x))
        return x + self.layer_scale_2 * self.mlp(self.norm2(x))

    def forward_train(self, x, masks=(None, None), noises=(None, None)):
        """(output, aux loss of the MoE layers or None); ``masks`` the two
        branches' stochastic-depth keep masks (B,)."""
        rate = self.drop_path_rate
        y = self.attn(self.norm1.forward_train(x))
        x = x + drop_path(self.layer_scale_1 * y, rate, masks[0])
        y, aux = self.mlp.forward_train(self.norm2.forward_train(x), noises)
        return x + drop_path(self.layer_scale_2 * y, rate, masks[1]), aux


class LSKNetMoE(nn.Module):
    """LSKNet(-MoE); its stem is ``stem_single`` in the MultiInput mode,
    ``patch_embed0`` with ``multi_input=False``, as JAX names them. Returns
    the ``out_indices`` features after their LayerNorms. Default arch: T
    (depths (3, 3, 5, 2), dims (32, 64, 160, 256))."""

    block_cls = LSKNetBlock

    def __init__(self, embed_dims: Sequence[int] = (32, 64, 160, 256),
                 depths: Sequence[int] = (3, 3, 5, 2),
                 mlp_ratios: Sequence[float] = (8.0, 8.0, 4.0, 4.0),
                 drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 moe_block_inds_fc1: Sequence[Sequence[int]] = ((), (), (),
                                                                ()),
                 moe_block_inds_fc2: Sequence[Sequence[int]] = ((), (), (),
                                                                ()),
                 num_experts: int = 2, top_k: int = 2, gate: str = "cosine",
                 noisy_gating: bool = True, capacity_factor: float = 1.5,
                 multi_input: bool = True,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.depths, self.out_indices = tuple(depths), tuple(out_indices)
        self.stem_name = "stem_single" if multi_input else "patch_embed0"
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        moe_cfg = dict(num_experts=num_experts, top_k=top_k, gating=gate,
                       noisy_gating=noisy_gating,
                       capacity_factor=capacity_factor)
        block_idx = 0
        for i, (depth, dim) in enumerate(zip(depths, embed_dims)):
            if i == 0:
                setattr(self, self.stem_name, Conv2d(
                    3, dim, 7, stride=4, padding=3, gen=gen))
            else:
                setattr(self, f"patch_embed{i}", Conv2d(
                    embed_dims[i - 1], dim, 3, stride=2, padding=1, gen=gen))
            setattr(self, f"embed_norm{i}", LayerNormOpt(dim))
            fc1 = [q for q in moe_block_inds_fc1[i] if q < depth]
            fc2 = [q for q in moe_block_inds_fc2[i] if q < depth]
            for j in range(depth):
                setattr(self, f"stage{i}_block{j}", self.block_cls(
                    dim, mlp_ratio=mlp_ratios[i],
                    drop_path_rate=float(dpr[block_idx + j]),
                    moe_fc1=moe_cfg if j in fc1 else None,
                    moe_fc2=moe_cfg if j in fc2 else None, gen=gen))
            block_idx += depth
            if i in self.out_indices:
                setattr(self, f"out_norm{i}", LayerNormOpt(dim))

    def _embed(self, i, x):
        conv = getattr(self, self.stem_name if i == 0 else f"patch_embed{i}")
        return conv(x)

    def forward(self, x, dataset_ids=None):
        """x: (B, H, W, 3) -> tuple of (B, H/s, W/s, C_i) features. The
        images' ``dataset_ids`` are taken and not read, as in JAX (no
        domain attention)."""
        outs = []
        for i, depth in enumerate(self.depths):
            x = getattr(self, f"embed_norm{i}")(self._embed(i, x))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"out_norm{i}")(x))
        return tuple(outs)

    def forward_train(self, x, gen: torch.Generator | None = None,
                      dataset_ids=None):
        """Training forward: x (B, H, W, 3) -> (features, gate_loss), the
        gate loss the mean of the MoE blocks' aux losses (None without MoE
        blocks); ``dataset_ids`` as in :meth:`forward`. The draws come
        from ``gen`` (on its device, then moved to x's), block by block in
        order: the fc1 and fc2 gates' normal noise, then the two
        stochastic-depth masks."""
        gdev = gen.device if gen is not None else None
        outs, gate_losses = [], []
        for i, depth in enumerate(self.depths):
            x = getattr(self, f"embed_norm{i}").forward_train(
                self._embed(i, x))
            for j in range(depth):
                blk = getattr(self, f"stage{i}_block{j}")
                n_tok = x.shape[0] * x.shape[1] * x.shape[2]
                noises = [
                    torch.randn(n_tok, m.num_experts, generator=gen,
                                device=gdev).to(x.device)
                    if isinstance(m, MoELayer) and m.noisy_gating else None
                    for m in (blk.mlp.fc1, blk.mlp.fc2)]
                masks = (None, None)
                if blk.drop_path_rate > 0:
                    masks = tuple(drop_path_mask(x.shape[0],
                                                 blk.drop_path_rate, gen)
                                  for _ in range(2))
                x, aux = blk.forward_train(x, masks, noises)
                if aux is not None:
                    gate_losses.append(aux)
            if i in self.out_indices:
                outs.append(getattr(self, f"out_norm{i}").forward_train(x))
        gate_loss = sum(gate_losses) / len(gate_losses) if gate_losses \
            else None
        return tuple(outs), gate_loss
