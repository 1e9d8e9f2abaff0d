"""Grid-level sparse Mixture-of-Experts, inference only.

Port of ``sm3det_tpu/models/moe.py``: the cosine top-k gate and the no-drop
group-aligned dispatch of ``MoELayer`` at inference (``train=False``, FFN
experts). The routes are sorted by expert and each expert's group is padded
to the GEMM tile, so every ``tile``-row tile of the slot layout belongs to
one expert; ``x_slots`` and ``tile_expert`` match the JAX layout exactly,
and the expert FFN runs through ``ops/cuda/moe_groupgemm_kernel``. No route
is dropped. The training-time capacity dispatch, noisy gating and balance
loss are not in this slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.cuda.moe_groupgemm_kernel import moe_ffn_grouped
from .layers import trunc_normal_


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class CosineTopKGate(nn.Module):
    """Cosine-similarity gate: L2 norms clamped at 1e-12, the temperature
    clamped at log(100)."""

    def __init__(self, dim: int, num_experts: int, init_t: float = 0.5,
                 gen: torch.Generator | None = None):
        super().__init__()
        proj_dim = min(dim // 2, 256)
        self.temperature = nn.Parameter(
            torch.full((1,), math.log(1.0 / init_t)))
        self.cosine_projector = nn.Linear(dim, proj_dim)
        with torch.no_grad():
            trunc_normal_(self.cosine_projector.weight, 1 / math.sqrt(dim),
                          gen)
            self.cosine_projector.bias.zero_()
        self.sim_matrix = nn.Parameter(
            torch.randn(proj_dim, num_experts, generator=gen) * 0.01)

    def forward(self, x):
        proj = self.cosine_projector(x)
        proj = proj / torch.clamp(
            torch.linalg.vector_norm(proj, dim=-1, keepdim=True), min=1e-12)
        sim = self.sim_matrix / torch.clamp(
            torch.linalg.vector_norm(self.sim_matrix, dim=0, keepdim=True),
            min=1e-12)
        scale = torch.exp(torch.clamp(self.temperature,
                                      max=math.log(1.0 / 0.01)))
        return (proj @ sim) * scale


class ExpertFFN(nn.Module):
    """All experts' FFN weights stacked on a leading expert axis, in the
    JAX layout: w1 (E, d, h), b1 (E, h), w2 (E, h, d), b2 (E, d)."""

    def __init__(self, num_experts: int, dim: int, hidden: int,
                 gen: torch.Generator | None = None):
        super().__init__()
        e = num_experts
        self.w1 = nn.Parameter(trunc_normal_(
            torch.empty(e, dim, hidden), 1 / math.sqrt(e * dim), gen))
        self.b1 = nn.Parameter(torch.zeros(e, hidden))
        self.w2 = nn.Parameter(trunc_normal_(
            torch.empty(e, hidden, dim), 1 / math.sqrt(e * hidden), gen))
        self.b2 = nn.Parameter(torch.zeros(e, dim))

    def grouped(self, x_slots, tile_expert):
        return moe_ffn_grouped(x_slots, tile_expert, self.w1, self.b1,
                               self.w2, self.b2)


def group_aligned_dispatch(top_k_idx: torch.Tensor, num_experts: int,
                           dim: int):
    """Slot layout of the no-drop grouped dispatch (``moe.py:366-402``).

    Returns ``(src_token, tile_expert, tile, pos_route)``: ``x_slots =
    x[src_token]``, the expert of each ``tile``-row tile, and for each
    (token, choice) route in flat order its slot in the layout.
    """
    n, k = top_k_idx.shape
    e = num_experts
    m = n * k
    dev = top_k_idx.device
    flat_expert = top_k_idx.reshape(-1)
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(flat_expert, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(m, device=dev))
    position = rank - starts[flat_expert]          # place within its expert

    tile = 256 if dim > 512 else 512
    aligned = (counts + tile - 1) // tile * tile
    ends = torch.cumsum(aligned, 0)
    astart = ends - aligned
    s_static = -(-m // tile) * tile + e * tile
    n_tiles = s_static // tile
    tile_e = torch.clamp(torch.searchsorted(
        ends, torch.arange(n_tiles, device=dev) * tile, right=True),
        0, e - 1)
    slot_e = tile_e.repeat_interleave(tile)
    local = torch.arange(s_static, device=dev) - astart[slot_e]
    src_route = order[torch.clamp(starts[slot_e] + local, 0, m - 1)]
    pos_route = astart[flat_expert] + position
    return src_route // k, tile_e, tile, pos_route


class MoELayer(nn.Module):
    """Grid-level sparse MoE over flattened spatial tokens (inference).

    ``w_noise`` is the noisy gate's projection, read only in training; it is
    kept so that a JAX training checkpoint converts one to one.
    """

    def __init__(self, dim: int, hidden: int, num_experts: int = 8,
                 top_k: int = 2, gating: str = "cosine",
                 noisy_gating: bool = True,
                 gen: torch.Generator | None = None):
        super().__init__()
        if gating != "cosine":
            raise NotImplementedError(
                f"gating {gating!r}: only the cosine gate is ported")
        self.dim, self.num_experts, self.top_k = dim, num_experts, top_k
        self.w_gate = CosineTopKGate(dim, num_experts, gen=gen)
        if noisy_gating:
            self.w_noise = nn.Parameter(torch.zeros(dim, num_experts))
        self.experts = ExpertFFN(num_experts, dim, hidden, gen=gen)

    def forward(self, x):
        """x: (N, d) tokens -> (N, d) in x.dtype."""
        n, d = x.shape
        e, k = self.num_experts, self.top_k
        logits = self.w_gate(x)
        top_logits, top_idx = stable_topk(logits, min(k + 1, e))
        gates = torch.softmax(top_logits[:, :k], dim=-1)
        src_token, tile_e, _, pos_route = group_aligned_dispatch(
            top_idx[:, :k], e, d)
        y_slots = self.experts.grouped(x[src_token], tile_e)
        weighted = y_slots[pos_route] * gates.reshape(-1, 1).to(y_slots.dtype)
        return weighted.reshape(n, k, d).sum(dim=1).to(x.dtype)
