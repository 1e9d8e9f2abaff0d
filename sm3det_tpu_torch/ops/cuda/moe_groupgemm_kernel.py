"""Grouped expert FFN for no-drop MoE inference: CUDA kernel
(``csrc/grouped_ffn.cu``) and its plain PyTorch version.

Counterpart of ``sm3det_tpu/ops/pallas/moe_groupgemm_kernel.py::
moe_ffn_grouped``. ``x_slots`` is the group-aligned, expert-sorted slot
layout built by ``models/moe.py``: every ``S // len(tile_expert)``-row tile
belongs to the one expert ``tile_expert[t]``. Numeric contract of the TPU
kernel: fp32-accumulated products, bias in fp32, GELU at the compute dtype
(tanh form in bf16, exact erf in fp32), output in ``x_slots.dtype``. Unlike
the JAX package, which keeps its kernel to bf16 on a TPU, the port runs the
kernel in fp32 as well.
"""

from __future__ import annotations

import torch

from ...models.layers import gelu
from . import build

# epilogue codes of sm3det_grouped_gemm
EPI_GELU, EPI_BIAS, EPI_RESIDUAL = 0, 1, 2


def ffn_ref(x, w1, b1, w2, b2):
    """One expert's FFN under the kernel's contract (plain version)."""
    h = x.float() @ w1.float() + b1.float()
    h = gelu(h.to(x.dtype))
    y = h.float() @ w2.float() + b2.float()
    return y.to(x.dtype)


def moe_ffn_grouped_ref(x_slots, tile_expert, w1, b1, w2, b2):
    """Plain version: loops over the runs of tiles that share an expert."""
    s = x_slots.shape[0]
    te = [int(e) for e in tile_expert.tolist()]
    tile = s // len(te)
    out = torch.empty_like(x_slots)
    i = 0
    while i < len(te):
        j = i
        while j < len(te) and te[j] == te[i]:
            j += 1
        e = te[i]
        rows = slice(i * tile, j * tile)
        out[rows] = ffn_ref(x_slots[rows], w1[e], b1[e], w2[e], b2[e])
        i = j
    return out


def grouped_gemm(a, w, bias, epilogue, tile_expert=None, tile_rows=0,
                 shortcut=None, gamma=None):
    """One launch of the grouped GEMM: ``epilogue(a @ w[e] + bias[e])``.

    a: (M, K) fp32 or bf16; w: (E, K, N) of a's dtype; bias (E, N);
    tile_expert: (M // tile_rows,) int in [0, E) or None (then e = 0
    everywhere);
    shortcut (M, N) and gamma (N,) for the residual epilogue.
    """
    build.require_cuda(a, "a")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grouped_gemm: unsupported dtype {a.dtype}")
    if w.dtype != a.dtype or w.dim() != 3 or a.dim() != 2 \
            or w.shape[1] != a.shape[1]:
        raise ValueError(f"grouped_gemm: a {tuple(a.shape)} {a.dtype}, "
                         f"w {tuple(w.shape)} {w.dtype}")
    m, k = a.shape
    n = w.shape[2]
    for t, name in ((w, "w"), (bias, "bias"), (tile_expert, "tile_expert"),
                    (shortcut, "shortcut"), (gamma, "gamma")):
        if t is not None:
            build.require_cuda(t, name, a.device)
    if a.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(f"grouped_gemm: bf16 needs K and N in multiples of "
                         f"8, got K={k}, N={n}")
    a = a.contiguous()
    w = w.contiguous()
    bias = bias.float().reshape(w.shape[0], n).contiguous()
    te = None
    if tile_expert is not None:
        te = tile_expert.to(torch.int32).contiguous()
        if tile_rows * te.shape[0] != m or tile_rows % 128:
            raise ValueError(f"grouped_gemm: {te.shape[0]} tiles of "
                             f"{tile_rows} rows for {m} rows")
    if epilogue == EPI_RESIDUAL:
        shortcut = shortcut.to(a.dtype).reshape(m, n).contiguous()
        gamma = gamma.float().contiguous()
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    if m == 0:
        return out
    lib = build.load_library()
    rc = lib.sm3det_grouped_gemm(
        a.data_ptr(), build.ptr(te), tile_rows, w.data_ptr(),
        bias.data_ptr(), build.ptr(shortcut), build.ptr(gamma),
        out.data_ptr(), m, k, n, epilogue, int(a.dtype == torch.bfloat16),
        build.stream_ptr(a.device))
    build.check(rc, "grouped_gemm")
    return out


def moe_ffn_grouped(x_slots, tile_expert, w1, b1, w2, b2):
    """Fused grouped expert FFN: ``y[s] = FFN_{e(s)}(x_slots[s])``.

    x_slots (S, d); tile_expert (T,) int, ascending; w1 (E, d, h),
    b1 (E, h), w2 (E, h, d), b2 (E, d). Returns (S, d) in x_slots.dtype.
    A CUDA tensor goes through the kernel (two launches: fc1 with the GELU
    epilogue, fc2 with the bias epilogue), a CPU tensor through
    :func:`moe_ffn_grouped_ref`.
    """
    if x_slots.device.type == "cpu":
        return moe_ffn_grouped_ref(x_slots, tile_expert, w1, b1, w2, b2)
    if not x_slots.is_cuda:
        raise ValueError(f"moe_ffn_grouped: unsupported device "
                         f"{x_slots.device}")
    s = x_slots.shape[0]
    tile = s // tile_expert.shape[0]
    dt = x_slots.dtype
    hid = grouped_gemm(x_slots, w1.to(dt), b1, EPI_GELU, tile_expert, tile)
    out = grouped_gemm(hid, w2.to(dt), b2, EPI_BIAS, tile_expert, tile)
    build.LAUNCHES["moe_ffn_grouped"] += 1
    return out
