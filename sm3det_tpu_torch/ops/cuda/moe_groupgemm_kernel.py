"""Grouped expert FFN for no-drop MoE inference: CUDA kernels and their
plain PyTorch version.

Counterpart of ``sm3det_tpu/ops/pallas/moe_groupgemm_kernel.py::
moe_ffn_grouped``. ``x_slots`` is the group-aligned, expert-sorted slot
layout built by ``models/moe.py``: every ``S // len(tile_expert)``-row tile
belongs to the one expert ``tile_expert[t]``. Numeric contract of the TPU
kernel: fp32-accumulated products, bias in fp32, GELU at the compute dtype
(tanh form in bf16, exact erf in fp32), output in ``x_slots.dtype``.

- bf16: :func:`ffn_fused`, one launch of ``csrc/ffn_wgmma.cu`` (wgmma and
  TMA, the hidden activation kept on chip). It also runs the MLP of the
  dense ConvNeXt block (``convnext_block_kernel.fused_convnext_block``).
- fp32: :func:`grouped_gemm` twice (``csrc/grouped_ffn.cu``, fp32 FMAs):
  unlike the JAX package, which keeps its kernel to bf16 on a TPU, the port
  runs the FFN on the card in fp32 as well.
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
    """One launch of the fp32 grouped GEMM: ``epilogue(a @ w[e] + bias[e])``.

    a: (M, K) fp32; w: (E, K, N) fp32; bias (E, N);
    tile_expert: (M // tile_rows,) int in [0, E) or None (then e = 0
    everywhere);
    shortcut (M, N) and gamma (N,) for the residual epilogue.
    """
    build.require_cuda(a, "a")
    if a.dtype != torch.float32:
        raise ValueError(f"grouped_gemm: fp32 only, got {a.dtype} (bf16 "
                         f"goes through ffn_fused)")
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
        shortcut = shortcut.float().reshape(m, n).contiguous()
        gamma = gamma.float().contiguous()
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    if m == 0:
        return out
    lib = build.load_library()
    rc = lib.sm3det_grouped_gemm(
        a.data_ptr(), build.ptr(te), tile_rows, w.data_ptr(),
        bias.data_ptr(), build.ptr(shortcut), build.ptr(gamma),
        out.data_ptr(), m, k, n, epilogue, build.stream_ptr(a.device))
    build.check(rc, "grouped_gemm")
    return out


# rows of a tile of the fused kernel
FFN_TILE_ROWS = 128
_VEC_DTYPES = (torch.float32, torch.bfloat16)


def ffn_fused(x, w1, b1, w2, b2, tile_expert=None, tile_rows=0,
              shortcut=None, gamma=None):
    """One launch of ``csrc/ffn_wgmma.cu``: the bf16 FFN with the hidden
    activation kept on chip. The kernel picks its variant from C (any
    multiple of 8).

    x (M, C) bf16; w1 (E, C, H) and w2 (E, H, C) bf16; b1 (E, H) and
    b2 (E, C), or (H,) and (C,) with E = 1, in bf16 or fp32; tile_expert
    (M // tile_rows,) int32 or int64, or None (then e = 0 everywhere). With
    ``shortcut`` (M, C) bf16 and ``gamma`` (C,): ``shortcut + gamma * FFN``
    rounded once (the dense block), else ``FFN`` (the MoE). Nothing is
    copied or converted: the kernel reads the biases and gamma in their
    own dtype and tile_expert in int32 or int64.
    """
    build.require_cuda(x, "x")
    if x.dtype != torch.bfloat16 or w1.dtype != x.dtype or \
            w2.dtype != x.dtype or x.dim() != 2 or w1.dim() != 3 or \
            w2.dim() != 3:
        raise ValueError(f"ffn_fused: x {tuple(x.shape)} {x.dtype}, w1 "
                         f"{tuple(w1.shape)} {w1.dtype}, w2 "
                         f"{tuple(w2.shape)} {w2.dtype}: bf16 only")
    m, c = x.shape
    e, _, h = w1.shape
    if w1.shape != (e, c, h) or w2.shape != (e, h, c):
        raise ValueError(f"ffn_fused: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if c % 8 or h % 8:
        raise ValueError(f"ffn_fused: C and H must be multiples of 8, got "
                         f"C={c}, H={h}")
    for t, name in ((w1, "w1"), (b1, "b1"), (w2, "w2"), (b2, "b2"),
                    (tile_expert, "tile_expert"), (shortcut, "shortcut"),
                    (gamma, "gamma")):
        if t is not None:
            build.require_cuda(t, name, x.device)
    if b1.numel() != e * h or b2.numel() != e * c:
        raise ValueError(f"ffn_fused: b1 {tuple(b1.shape)}, b2 "
                         f"{tuple(b2.shape)} for E={e}, C={c}, H={h}")
    x, w1, w2, b1, b2 = (t.contiguous() for t in (x, w1, w2, b1, b2))
    residual = shortcut is not None
    if residual:
        if shortcut.dtype != x.dtype or gamma is None or \
                gamma.numel() != c:
            raise ValueError("ffn_fused: the residual epilogue needs a bf16 "
                             "shortcut of x's shape and a gamma of C")
        shortcut, gamma = shortcut.reshape(m, c).contiguous(), \
            gamma.contiguous()
    else:
        # the kernel reads no shortcut or gamma then, but is never handed
        # a pointer outside an array of their shapes
        shortcut, gamma = x, b2
    vecs = (b1, b2, gamma)
    if any(v.dtype not in _VEC_DTYPES for v in vecs):
        raise ValueError(f"ffn_fused: biases and gamma in fp32 or bf16, got "
                         f"{[v.dtype for v in vecs]}")
    # bits 0-2: b1, b2, gamma in bf16; bit 3: tile_expert in int64; bit 4:
    # the residual epilogue
    flags = sum(1 << i for i, v in enumerate(vecs)
                if v.dtype == torch.bfloat16) + 16 * residual
    te = None
    if tile_expert is not None:
        if tile_expert.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"ffn_fused: tile_expert {tile_expert.dtype}")
        te = tile_expert.contiguous()
        flags |= 8 * (te.dtype == torch.int64)
        if tile_rows * te.shape[0] != m or tile_rows % FFN_TILE_ROWS:
            raise ValueError(f"ffn_fused: {te.shape[0]} tiles of {tile_rows}"
                             f" rows for {m} rows (a multiple of "
                             f"{FFN_TILE_ROWS})")
    elif e != 1:
        raise ValueError(f"ffn_fused: {e} experts and no tile_expert")
    for t, name in ((x, "x"), (w1, "w1"), (w2, "w2")):
        if t.data_ptr() % 16:
            raise ValueError(f"ffn_fused: {name} must sit at a 16-byte "
                             f"address (TMA)")
    for t, name in zip(vecs, ("b1", "b2", "gamma")):
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"ffn_fused: {name} is read in pairs: it must "
                             f"sit at a {2 * t.element_size()}-byte address")
    out = torch.empty((m, c), device=x.device, dtype=x.dtype)
    if m == 0:
        return out
    lib = build.load_library()
    rc = lib.sm3det_ffn_fused(
        x.data_ptr(), build.ptr(te), tile_rows, w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), shortcut.data_ptr(),
        gamma.data_ptr(), out.data_ptr(), m, c, h, e, flags,
        build.stream_ptr(x.device))
    build.check(rc, "ffn_fused")
    return out


def moe_ffn_grouped(x_slots, tile_expert, w1, b1, w2, b2):
    """Fused grouped expert FFN: ``y[s] = FFN_{e(s)}(x_slots[s])``.

    x_slots (S, d); tile_expert (T,) int, ascending; w1 (E, d, h),
    b1 (E, h), w2 (E, h, d), b2 (E, d). Returns (S, d) in x_slots.dtype.
    A bf16 CUDA tensor goes through one launch of :func:`ffn_fused` (the
    weights in bf16 too), an fp32 CUDA tensor through the fp32 grouped GEMM
    (two launches: fc1 with the GELU epilogue, fc2 with the bias epilogue),
    a CPU tensor through :func:`moe_ffn_grouped_ref`.
    """
    if x_slots.device.type == "cpu":
        return moe_ffn_grouped_ref(x_slots, tile_expert, w1, b1, w2, b2)
    if not x_slots.is_cuda:
        raise ValueError(f"moe_ffn_grouped: unsupported device "
                         f"{x_slots.device}")
    build.forbid_grad("moe_ffn_grouped", x_slots, w1, b1, w2, b2)
    s = x_slots.shape[0]
    tile = s // tile_expert.shape[0]
    dt = x_slots.dtype
    if dt == torch.bfloat16:
        out = ffn_fused(x_slots, w1, b1, w2, b2, tile_expert, tile)
    else:
        hid = grouped_gemm(x_slots, w1.to(dt), b1, EPI_GELU, tile_expert,
                           tile)
        out = grouped_gemm(hid, w2.to(dt), b2, EPI_BIAS, tile_expert, tile)
    build.LAUNCHES["moe_ffn_grouped"] += 1
    return out
