"""ConvNeXt / ConvNeXt-MoE backbone, NHWC.

Port of ``sm3det_tpu/models/backbones/convnext.py``: the ``multi_input``
``stem_single`` stem (the TriSource detectors) or the single-dataset
``stem_conv`` (the zoo's detectors), stem/downsample/out LayerNorms
(``layernorm_math``), dense blocks and grid-MoE blocks, with the options of
the Domain-Attention baseline and ConvNeXt-V2: a ``DALayer`` after the MLP
of the ``da_block_inds`` blocks (applied only where the caller gives each
image's dataset id), ``GRN`` after the GELU (``use_grn``, which drops the
layer scale, as in JAX) and blocks without layer scale
(``layer_scale_init_value <= 0``: no ``gamma`` parameter).

- Inference (``forward``): on a CUDA tensor every block goes through the
  kernels at every dtype: a dense block through ``fused_convnext_block``
  (a block without layer scale hands it a scale of ones, which multiplies
  exactly); a DA block through ``fused_dwconv_ln`` and the same FFN kernels
  (``convnext_ffn``), then the DA layer, the layer scale and the residual;
  a GRN block through ``fused_dwconv_ln``, then matrix products and GRN (no
  kernel computes that MLP in JAX either); a MoE block through
  ``fused_dwconv_ln``, the gate, the dispatch and ``moe_ffn_grouped``; the
  LayerNorms through ``fused_layernorm``. On a CPU tensor the same wrappers
  run their plain versions.
- Training (``forward_train``): the dw7x7 + LN of every block through the
  trainable ``fused_dwconv_ln_train`` (its kernel on the card), the MLP as
  matrix products, the MoE through its capacity dispatch, the LayerNorms
  as ``layernorm_math``, stochastic depth with the linear ``dpr`` ramp;
  returns the MoE gate losses' mean beside the features (None without MoE
  blocks).

``dataset_ids`` are Python ints, one an image (0 SAR, 1 RGB, 2 infrared):
the batch's composition, known to the host, as in JAX. The DA layer picks
each image's branch by slicing the runs of equal ids, so it neither copies
ids to the card nor waits for it.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.cuda.convnext_block_kernel import (convnext_ffn,
                                               fused_convnext_block,
                                               fused_dwconv_ln,
                                               fused_dwconv_ln_train,
                                               fused_layernorm,
                                               layernorm_math)
from ..layers import (GRN, Conv2d, drop_path, drop_path_mask, gelu,
                      trunc_normal_)
from ..moe import MoELayer

ARCH_SETTINGS = {
    "atto": {"depths": [2, 2, 6, 2], "channels": [40, 80, 160, 320]},
    "femto": {"depths": [2, 2, 6, 2], "channels": [48, 96, 192, 384]},
    "pico": {"depths": [2, 2, 6, 2], "channels": [64, 128, 256, 512]},
    "nano": {"depths": [2, 2, 8, 2], "channels": [80, 160, 320, 640]},
    "tiny": {"depths": [3, 3, 9, 3], "channels": [96, 192, 384, 768]},
    "small": {"depths": [3, 3, 27, 3], "channels": [96, 192, 384, 768]},
    "base": {"depths": [3, 3, 27, 3], "channels": [128, 256, 512, 1024]},
    "large": {"depths": [3, 3, 27, 3], "channels": [192, 384, 768, 1536]},
    "xlarge": {"depths": [3, 3, 27, 3],
               "channels": [256, 512, 1024, 2048]},
}


class LayerNormOpt(nn.Module):
    """``layernorm_math`` with parameters; through ``fused_layernorm``, so a
    CUDA tensor goes through the LayerNorm kernel."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return fused_layernorm(x, self.weight, self.bias, self.eps)

    def forward_train(self, x):
        return layernorm_math(x, self.weight, self.bias, self.eps)


class _Pointwise(nn.Module):
    """Dense layer kept in the JAX (in, out) layout the GEMM kernel reads."""

    def __init__(self, cin: int, cout: int, gen: torch.Generator | None):
        super().__init__()
        self.kernel = nn.Parameter(trunc_normal_(
            torch.empty(cin, cout), 1 / math.sqrt(cin), gen))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return torch.matmul(x, self.kernel) + self.bias


def _dataset_runs(dataset_ids: Sequence[int]):
    """(dataset id, first image, end) of each run of equal ids."""
    runs, start = [], 0
    for d, grp in itertools.groupby(dataset_ids):
        n = len(list(grp))
        runs.append((int(d), start, start + n))
        start += n
    return runs


class DALayer(nn.Module):
    """Domain Attention: an SE-style channel attention with one branch a
    dataset, ``sigmoid(fc{d}_1(relu(fc{d}_0(mean_hw x))))`` (bias-free
    layers, ``dim // reduction`` wide in the middle). Every branch runs on
    the whole batch, as in JAX; each image's scale is then taken from the
    branch of its dataset id (JAX's one-hot product, whose other terms are
    exact zeros)."""

    def __init__(self, dim: int, reduction: int = 16, num_datasets: int = 3,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.num_datasets = num_datasets
        mid = dim // reduction
        for d in range(num_datasets):
            for q, (cin, cout) in enumerate(((dim, mid), (mid, dim))):
                fc = nn.Linear(cin, cout, bias=False)
                trunc_normal_(fc.weight, 1 / math.sqrt(cin), gen)
                setattr(self, f"fc{d}_{q}", fc)

    def forward(self, x, dataset_ids: Sequence[int]):
        """x (B, H, W, C); ``dataset_ids`` B Python ints in [0, D)."""
        if len(dataset_ids) != x.shape[0] or not all(
                0 <= int(d) < self.num_datasets for d in dataset_ids):
            raise ValueError(f"DALayer: dataset ids {list(dataset_ids)} for "
                             f"{x.shape[0]} images of {self.num_datasets} "
                             f"datasets")
        y = x.mean(dim=(1, 2))
        scales = [torch.sigmoid(getattr(self, f"fc{d}_1")(torch.relu(
            getattr(self, f"fc{d}_0")(y)))) for d in range(self.num_datasets)]
        scale = torch.cat([scales[d][s:e]
                           for d, s, e in _dataset_runs(dataset_ids)])
        return x * scale[:, None, None, :]


class ConvNeXtBlock(nn.Module):
    """One ConvNeXt block; ``moe`` swaps the MLP for a grid MoE, ``use_da``
    adds Domain Attention after the MLP, ``use_grn`` a GRN after its GELU.
    The layer scale ``gamma`` exists for ``layer_scale_init_value > 0``
    without GRN, as in JAX."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 layer_scale_init_value: float = 1e-6, moe: dict | None = None,
                 drop_path_rate: float = 0.0, use_grn: bool = False,
                 use_da: bool = False, gen: torch.Generator | None = None):
        super().__init__()
        hidden = int(mlp_ratio * dim)
        self.dwconv = Conv2d(dim, dim, 7, padding=3, gen=gen, groups=dim)
        self.norm = LayerNormOpt(dim)
        if layer_scale_init_value > 0 and not use_grn:
            self.gamma = nn.Parameter(
                torch.full((dim,), float(layer_scale_init_value)))
        else:
            self.gamma = None
            # the dense block kernel's scale: x * 1 is exact in every dtype
            self.register_buffer("unit_scale", torch.ones(dim),
                                 persistent=False)
        self.drop_path_rate = drop_path_rate
        self.use_grn, self.use_da = use_grn, use_da
        self.moe = moe is not None
        if self.moe:
            self.ffn = MoELayer(dim, hidden, num_experts=moe["num_experts"],
                                top_k=moe["top_k"], gating=moe["gating"],
                                noisy_gating=moe["noisy_gating"],
                                capacity_factor=moe.get("capacity_factor",
                                                        1.5),
                                use_grn=use_grn, gen=gen)
        else:
            self.pwconv1 = _Pointwise(dim, hidden, gen)
            self.pwconv2 = _Pointwise(hidden, dim, gen)
            if use_grn:
                self.grn = GRN(hidden)
        if use_da:
            self.da = DALayer(dim, gen=gen)

    def _mlp(self, xn):
        """The dense MLP as matrix products (training, GRN blocks)."""
        h = gelu(self.pwconv1(xn))
        if self.use_grn:
            h = self.grn(h)
        return self.pwconv2(h)

    def _tail(self, y, dataset_ids):
        """Domain attention (where ids are given) and the layer scale of
        the MLP's output ``y``."""
        if self.use_da and dataset_ids is not None:
            y = self.da(y, dataset_ids)
        return y if self.gamma is None else y * self.gamma

    def forward(self, x, dataset_ids: Optional[Sequence[int]] = None):
        dw, ln = self.dwconv, self.norm
        da = self.use_da and dataset_ids is not None
        if not (self.moe or da or self.use_grn):
            return fused_convnext_block(
                x, dw.weight, dw.bias, ln.weight, ln.bias,
                self.pwconv1.kernel, self.pwconv1.bias,
                self.pwconv2.kernel, self.pwconv2.bias,
                self.unit_scale if self.gamma is None else self.gamma)
        b, h, w, c = x.shape
        xn = fused_dwconv_ln(x, dw.weight, dw.bias, ln.weight, ln.bias)
        if self.moe:
            y = self.ffn(xn.reshape(-1, c))
        elif self.use_grn:
            y = self._mlp(xn)
        else:
            p1, p2 = self.pwconv1, self.pwconv2
            y = convnext_ffn(xn.reshape(-1, c), p1.kernel, p1.bias,
                             p2.kernel, p2.bias)
        return x + self._tail(y.reshape(b, h, w, c), dataset_ids)

    def forward_train(self, x, keep_mask=None, noise=None,
                      dataset_ids: Optional[Sequence[int]] = None):
        """Training forward: (x + droppath(gamma * DA(mlp(LN(dw7x7(x))))),
        aux loss of the MoE or None). ``keep_mask`` (B,) bool of stochastic
        depth; ``noise`` (H W B, E) normal draws of a noisy MoE gate."""
        dw, ln = self.dwconv, self.norm
        b, h, w, c = x.shape
        xn = fused_dwconv_ln_train(x, dw.weight, dw.bias, ln.weight, ln.bias)
        aux = None
        if self.moe:
            y, aux = self.ffn.forward_train(xn.reshape(-1, c), noise)
            y = y.reshape(b, h, w, c)
        else:
            y = self._mlp(xn)
        return x + drop_path(self._tail(y, dataset_ids),
                             self.drop_path_rate, keep_mask), aux


class ConvNeXtMoE(nn.Module):
    """ConvNeXt with grid-MoE blocks and Domain-Attention blocks; returns
    the ``out_indices`` features after their LayerNorms. The stem is
    ``stem_single`` with ``multi_input`` (the MultiInput layout), else
    ``stem_conv``: the same patchify conv under the JAX module's two
    names. ``da_block_inds`` takes effect with ``use_da``."""

    def __init__(self, arch: str = "tiny", in_channels: int = 3,
                 stem_patch_size: int = 4,
                 layer_scale_init_value: float = 1e-6,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 moe_block_inds: Sequence[Sequence[int]] = ((), (), (), ()),
                 num_experts: int = 2, top_k: int = 2, gate: str = "cosine",
                 noisy_gating: bool = True, capacity_factor: float = 1.5,
                 drop_path_rate: float = 0.0, use_grn: bool = False,
                 use_da: bool = False,
                 da_block_inds: Sequence[Sequence[int]] = ((), (), (), ()),
                 multi_input: bool = True,
                 gen: torch.Generator | None = None):
        super().__init__()
        depths = ARCH_SETTINGS[arch]["depths"]
        channels = ARCH_SETTINGS[arch]["channels"]
        self.depths, self.out_indices = depths, tuple(out_indices)
        p = stem_patch_size
        self._stem = "stem_single" if multi_input else "stem_conv"
        setattr(self, self._stem, Conv2d(in_channels, channels[0], p,
                                         stride=p, gen=gen))
        self.stem_norm = LayerNormOpt(channels[0])
        total = sum(depths)
        # the linear stochastic-depth ramp, as np.linspace(0, rate, total)
        step = drop_path_rate / (total - 1) if total > 1 else 0.0
        dpr = [q * step for q in range(total - 1)] + [drop_path_rate]
        block_idx = 0
        for i, (depth, dim) in enumerate(zip(depths, channels)):
            if i > 0:
                setattr(self, f"downsample_norm{i}",
                        LayerNormOpt(channels[i - 1]))
                setattr(self, f"downsample_conv{i}",
                        Conv2d(channels[i - 1], dim, 2, stride=2, gen=gen))
            moe_inds = [q for q in moe_block_inds[i] if q < depth]
            da_inds = [q for q in da_block_inds[i] if q < depth] \
                if use_da else []
            for j in range(depth):
                moe = None
                if j in moe_inds:
                    moe = dict(num_experts=num_experts, top_k=top_k,
                               gating=gate, noisy_gating=noisy_gating,
                               capacity_factor=capacity_factor)
                setattr(self, f"stage{i}_block{j}", ConvNeXtBlock(
                    dim, layer_scale_init_value=layer_scale_init_value,
                    moe=moe, drop_path_rate=dpr[block_idx + j],
                    use_grn=use_grn, use_da=j in da_inds, gen=gen))
            block_idx += depth
            if i in self.out_indices:
                setattr(self, f"out_norm{i}", LayerNormOpt(dim))

    def forward(self, x, dataset_ids: Optional[Sequence[int]] = None):
        """x: (B, H, W, 3) -> tuple of (B, H/s, W/s, C_i) features;
        ``dataset_ids`` (B Python ints) reach the DA blocks."""
        x = getattr(self, self._stem)(x)
        outs = []
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = self.stem_norm(x)
            else:
                x = getattr(self, f"downsample_norm{i}")(x)
                x = getattr(self, f"downsample_conv{i}")(x)
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x, dataset_ids)
            if i in self.out_indices:
                outs.append(getattr(self, f"out_norm{i}")(x))
        return tuple(outs)

    def forward_train(self, x, gen: torch.Generator | None = None,
                      dataset_ids: Optional[Sequence[int]] = None):
        """Training forward: x (B, H, W, 3) -> (features, gate_loss), the
        gate loss the mean of the MoE blocks' aux losses (None without MoE
        blocks); ``dataset_ids`` as in :meth:`forward`. The stochastic-depth
        masks and the noisy gates' normal draws come from ``gen`` (on its
        device, then moved to x's), block by block in order: gate noise,
        then the depth mask."""
        gdev = gen.device if gen is not None else None
        x = getattr(self, self._stem)(x)
        outs, gate_losses = [], []
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = self.stem_norm.forward_train(x)
            else:
                x = getattr(self, f"downsample_norm{i}").forward_train(x)
                x = getattr(self, f"downsample_conv{i}")(x)
            for j in range(depth):
                blk = getattr(self, f"stage{i}_block{j}")
                noise = mask = None
                if blk.moe and blk.ffn.noisy_gating:
                    noise = torch.randn(
                        x.shape[0] * x.shape[1] * x.shape[2],
                        blk.ffn.num_experts, generator=gen, device=gdev
                    ).to(x.device)
                if blk.drop_path_rate > 0:
                    mask = drop_path_mask(x.shape[0], blk.drop_path_rate,
                                          gen)
                x, aux = blk.forward_train(x, mask, noise, dataset_ids)
                if aux is not None:
                    gate_losses.append(aux)
            if i in self.out_indices:
                outs.append(getattr(self, f"out_norm{i}").forward_train(x))
        gate_loss = sum(gate_losses) / len(gate_losses) if gate_losses \
            else None
        return tuple(outs), gate_loss
