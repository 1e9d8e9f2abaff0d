"""Grid-level sparse Mixture-of-Experts.

Port of ``sm3det_tpu/models/moe.py``: the cosine gate and the linear gate
(``x @ w_gate``, zeros at init, so that the first routes are decided by
tie-breaking alone: ``stable_topk`` picks the lower index, as
``lax.top_k``); two-layer FFN experts (ConvNeXt, optionally with GRN after
the GELU) and single-projection linear experts (the LSKNet / VAN MLP's
fc1 / fc2, ``expert_kind="linear"``).

- Inference of FFN experts (``MoELayer.forward``): the no-drop
  group-aligned dispatch. The routes are sorted by expert and each expert's
  group is padded to the GEMM tile, so every ``tile``-row tile of the slot
  layout belongs to one expert; ``x_slots`` and ``tile_expert`` match the
  JAX layout exactly, and the expert FFN runs through
  ``ops/cuda/moe_groupgemm_kernel``. No route is dropped.
- Inference of linear experts and of GRN experts (GRN normalises over an
  expert's whole bucket, which the fused FFN kernel cannot hold between
  its GELU and fc2), and training of every kind
  (``MoELayer.forward_train``: the noisy top-k gate with its normal noise
  passed in, the CV^2 importance/load balance loss): the capacity-bucketed
  dispatch with its drops. Every (token, choice) route takes the next place
  of its expert's ``(E, capacity)`` bucket in flat route order, routes past
  the capacity are dropped (their token keeps the residual path), and the
  experts run as batched matrix products. The capacity counts the tokens of
  the whole call, so a joint batch may drop other routes than its parts
  alone, as in JAX. The dispatch makes no host synchronisation. The JAX
  package's scatter-free custom VJPs (``_inv_gather``, ``_bf16_dot``) are
  TPU workarounds: plain indexing and ``baddbmm`` under autograd give the
  same values and gradients.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.cuda.moe_groupgemm_kernel import moe_ffn_grouped
from .layers import GRN, gelu, trunc_normal_


LOSS_COEF = 1e-2      # weight of the balance loss (the JAX ``loss_coef``)
GATES = ("cosine", "linear")


def cv_squared(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Coefficient of variation squared, unbiased variance."""
    if x.shape[-1] == 1:
        return x.new_zeros(())
    return x.var(unbiased=True) / (x.mean() ** 2 + eps)


def _normal_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def prob_in_top_k(clean_logits, noisy_logits, noise_stddev, noisy_top_values,
                  k: int):
    """Smooth estimate of P[token routed to each expert] under the gate
    noise, for the load-balance loss: (N, E)."""
    m = noisy_top_values.shape[1]
    threshold_if_in = noisy_top_values[:, k if m > k else -1][:, None]
    threshold_if_out = noisy_top_values[:, k - 1][:, None]
    is_in = noisy_logits > threshold_if_in
    prob_if_in = _normal_cdf((clean_logits - threshold_if_in) / noise_stddev)
    prob_if_out = _normal_cdf((clean_logits - threshold_if_out) /
                              noise_stddev)
    return torch.where(is_in, prob_if_in, prob_if_out)


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
    JAX layout: w1 (E, d, h), b1 (E, h), w2 (E, h, d), b2 (E, d); with
    ``use_grn`` a GRN after the GELU, over each expert's bucket."""

    def __init__(self, num_experts: int, dim: int, hidden: int,
                 use_grn: bool = False,
                 gen: torch.Generator | None = None):
        super().__init__()
        e = num_experts
        self.num_experts, self.hidden = e, hidden
        self.w1 = nn.Parameter(trunc_normal_(
            torch.empty(e, dim, hidden), 1 / math.sqrt(e * dim), gen))
        self.b1 = nn.Parameter(torch.zeros(e, hidden))
        self.w2 = nn.Parameter(trunc_normal_(
            torch.empty(e, hidden, dim), 1 / math.sqrt(e * hidden), gen))
        self.b2 = nn.Parameter(torch.zeros(e, dim))
        self.grn = GRN(hidden) if use_grn else None

    def grouped(self, x_slots, tile_expert):
        return moe_ffn_grouped(x_slots, tile_expert, self.w1, self.b1,
                               self.w2, self.b2)

    def forward(self, x):
        """Capacity buckets x (E, cap, d) -> (E, cap, d) in x.dtype: two
        batched matrix products summed in fp32, the hidden activation
        rounded to x.dtype before the GELU."""
        h = torch.bmm(x, self.w1).float() + self.b1[:, None].float()
        h = gelu(h.to(x.dtype))
        if self.grn is not None:
            # the JAX layout: (E, cap, 1, h), normalised over the bucket
            e, hid = self.num_experts, self.hidden
            h = self.grn(h.reshape(e, -1, 1, hid)).reshape(e, -1, hid)
        y = torch.bmm(h, self.w2).float() + self.b2[:, None].float()
        return y.to(x.dtype)


class ExpertLinear(nn.Module):
    """Every expert's single projection stacked on a leading expert axis,
    in the JAX layout: w (E, d, o), b (E, o)."""

    def __init__(self, num_experts: int, dim: int, out_dim: int,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(trunc_normal_(
            torch.empty(num_experts, dim, out_dim),
            1 / math.sqrt(num_experts * dim), gen))
        self.b = nn.Parameter(torch.zeros(num_experts, out_dim))

    def forward(self, x):
        """Capacity buckets x (E, cap, d) -> (E, cap, o) in x.dtype: the
        product summed in fp32 with the bias, rounded once."""
        return torch.baddbmm(self.b[:, None].to(x.dtype), x, self.w)


def capacity_of(n: int, k: int, e: int, capacity_factor: float) -> int:
    """Bucket size of the capacity dispatch: ``ceil(n k / e * cf)``, at
    least 4."""
    return max(int(math.ceil(n * k / e * capacity_factor)), 4)


def _route_positions(top_k_idx: torch.Tensor, num_experts: int):
    """Each (token, choice) route in flat order ``token * k + choice``:
    ``(its expert, the experts' route counts, their starts in the
    expert-sorted order, that stable order, the route's place within its
    expert)``. The counts are a scatter-add, not ``bincount``, which sizes
    its output from the data and so waits for the card."""
    flat_expert = top_k_idx.reshape(-1)
    counts = torch.zeros(num_experts, dtype=torch.long,
                         device=flat_expert.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(flat_expert, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return flat_expert, counts, starts, order, rank - starts[flat_expert]


def capacity_dispatch(top_k_idx: torch.Tensor, num_experts: int,
                      capacity: int):
    """Slot arithmetic of the capacity-bucketed dispatch
    (``moe.py:342-424`` of the JAX package).

    A stable sort by expert gives each (token, choice) route, in flat order
    ``token * k + choice``, its place in its expert's bucket. Returns
    ``(src_token (E, cap), valid (E, cap), slot (N k,), keep (N k,))``: the
    token each bucket place reads, whether a route fills that place, the
    place each route reads its result from, and whether the route fits.
    """
    n, k = top_k_idx.shape
    e, m = num_experts, n * k
    dev = top_k_idx.device
    flat_expert, counts, starts, order, position = _route_positions(
        top_k_idx, e)
    keep = position < capacity
    slot = flat_expert * capacity + torch.clamp(position, max=capacity - 1)
    places = torch.arange(capacity, device=dev)
    rank_grid = starts[:, None] + places[None, :]
    valid = places[None, :] < counts[:, None]
    src_token = order[torch.clamp(rank_grid, 0, m - 1)] // k
    return src_token, valid, slot, keep


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
    flat_expert, counts, starts, order, position = _route_positions(
        top_k_idx, e)

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
    """Grid-level sparse MoE over flattened spatial tokens.

    ``gating`` ``"cosine"`` (:class:`CosineTopKGate`) or ``"linear"``
    (``w_gate`` (d, E), zeros at init). The JAX package builds the cosine
    gate for any name but ``"linear"``; the port raises on other names.
    ``expert_kind`` ``"ffn"`` (FFN experts of width ``hidden``, output
    width ``dim``, a GRN after the GELU with ``use_grn``) or ``"linear"``
    (one projection to ``out_dim``, default ``dim``). ``w_noise`` is the
    noisy gate's projection (zeros at init, as in JAX), read only in
    training.
    """

    def __init__(self, dim: int, hidden: int, num_experts: int = 8,
                 top_k: int = 2, gating: str = "cosine",
                 noisy_gating: bool = True, capacity_factor: float = 1.5,
                 expert_kind: str = "ffn", out_dim: int | None = None,
                 use_grn: bool = False,
                 gen: torch.Generator | None = None):
        super().__init__()
        if gating not in GATES:
            raise ValueError(f"gating {gating!r}: one of {GATES}")
        self.dim, self.num_experts, self.top_k = dim, num_experts, top_k
        self.gating, self.use_grn = gating, use_grn
        self.noisy_gating = noisy_gating
        self.capacity_factor = capacity_factor
        if gating == "linear":
            self.w_gate = nn.Parameter(torch.zeros(dim, num_experts))
        else:
            self.w_gate = CosineTopKGate(dim, num_experts, gen=gen)
        if noisy_gating:
            self.w_noise = nn.Parameter(torch.zeros(dim, num_experts))
        if expert_kind == "ffn":
            self.out_dim = dim
            self.experts = ExpertFFN(num_experts, dim, hidden,
                                     use_grn=use_grn, gen=gen)
        elif expert_kind == "linear":
            self.out_dim = out_dim or dim
            self.experts = ExpertLinear(num_experts, dim, self.out_dim,
                                        gen=gen)
        else:
            raise ValueError(f"expert_kind {expert_kind!r}")
        self.expert_kind = expert_kind

    def forward_train(self, x, noise=None):
        """Training forward: x (N, d) -> ((N, out_dim) in x.dtype, aux loss).

        ``noise`` (N, E) standard normal draws for the noisy gate; required
        with ``noisy_gating``, ignored without.
        """
        n, d = x.shape
        e, k = self.num_experts, self.top_k
        clean_logits = self.gate_logits(x)
        if self.noisy_gating:
            if noise is None:
                raise ValueError("noisy gating needs its normal draws")
            noise_std = torch.nn.functional.softplus(x @ self.w_noise) + 1e-2
            logits = clean_logits + noise.to(clean_logits.device) * noise_std
        else:
            logits = clean_logits
        top_logits, top_idx = stable_topk(logits, min(k + 1, e))
        top_k_idx = top_idx[:, :k]
        top_k_gates = torch.softmax(top_logits[:, :k], dim=-1)

        gates = torch.zeros((n, e), dtype=logits.dtype, device=x.device) \
            .scatter_add(1, top_k_idx, top_k_gates)
        importance = gates.sum(0)
        if self.noisy_gating and k < e:
            load = prob_in_top_k(clean_logits, logits, noise_std, top_logits,
                                 k).sum(0)
        else:
            load = (gates > 0).sum(0).float()
        aux = (cv_squared(importance) + cv_squared(load)) * LOSS_COEF

        return self._capacity_forward(x, top_k_idx, top_k_gates), aux

    def _capacity_forward(self, x, top_k_idx, top_k_gates):
        """The capacity-bucketed dispatch, the experts and the combine:
        (N, out_dim) in x.dtype."""
        n, d = x.shape
        e, k, o = self.num_experts, self.top_k, self.out_dim
        cap = capacity_of(n, k, e, self.capacity_factor)
        src_token, valid, slot, keep = capacity_dispatch(top_k_idx, e, cap)
        # index_select, not x[idx]: its backward is an index_add, not the
        # sorting index_put of advanced indexing (~1.5 ms a MoE block at
        # the flagship step)
        buf = torch.index_select(x, 0, src_token.reshape(-1)) \
            .reshape(e, cap, d) * valid[..., None].to(x.dtype)
        out_buf = self.experts(buf).reshape(e * cap, o)
        weighted = torch.index_select(out_buf, 0, slot) * \
            (top_k_gates.reshape(-1) * keep)[:, None].to(out_buf.dtype)
        return weighted.reshape(n, k, o).sum(dim=1).to(x.dtype)

    def gate_logits(self, x):
        """The clean gate logits (N, E)."""
        if self.gating == "linear":
            return x @ self.w_gate
        return self.w_gate(x)

    def route(self, x):
        """The inference gate: (top-k expert ids (N, k), their softmax
        weights (N, k))."""
        k = self.top_k
        top_logits, top_idx = stable_topk(self.gate_logits(x),
                                          min(k + 1, self.num_experts))
        return top_idx[:, :k], torch.softmax(top_logits[:, :k], dim=-1)

    def forward(self, x):
        """x: (N, d) tokens -> (N, out_dim) in x.dtype. Linear and GRN
        experts take the capacity dispatch, drops included, as in JAX."""
        n, d = x.shape
        e, k = self.num_experts, self.top_k
        top_k_idx, gates = self.route(x)
        if self.expert_kind == "linear" or self.use_grn:
            return self._capacity_forward(x, top_k_idx, gates)
        src_token, tile_e, _, pos_route = group_aligned_dispatch(
            top_k_idx, e, d)
        y_slots = self.experts.grouped(x[src_token], tile_e)
        weighted = y_slots[pos_route] * gates.reshape(-1, 1).to(y_slots.dtype)
        return weighted.reshape(n, k, d).sum(dim=1).to(x.dtype)
