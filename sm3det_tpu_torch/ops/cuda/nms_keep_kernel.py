"""Greedy NMS keep decisions from packed suppression bits: CUDA kernel
(``csrc/nms_keep.cu``) and its plain PyTorch version.

The mask is what the IoU kernels' mask mode writes
(``hbb_iou_kernel.hbb_nms_mask``, ``rotated_iou_kernel.rotated_nms_mask``):
``(B, N, W)`` int32 words, ``W = ceil(N / 32)``, bit ``j % 32`` of word
``j // 32`` of row ``i`` set if box ``i`` (earlier in score order)
suppresses box ``j``; only the bits ``j > i`` are read. The keep mask is
that of sequential greedy NMS. The JAX package resolves it with the jnp
``greedy_keep`` (``sm3det_tpu/ops/nms.py``), not a Pallas kernel; the plain
version here unpacks the bits and calls the port's copy of it,
:func:`greedy_keep`.
"""

from __future__ import annotations

import torch

from . import build

WORD = 32


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., M) bool -> (..., ceil(M / 32)) int32, bit k of word w is entry
    32 w + k (two's complement: bit 31 is the sign)."""
    m = bits.shape[-1]
    w = -(-m // WORD)
    x = torch.nn.functional.pad(bits.to(torch.int64), (0, w * WORD - m))
    weight = torch.ones(WORD, dtype=torch.int64, device=bits.device) \
        << torch.arange(WORD, device=bits.device)
    weight[-1] = -(1 << 31)
    words = (x.reshape(bits.shape[:-1] + (w, WORD)) * weight).sum(-1)
    return words.to(torch.int32)


def unpack_bits(words: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., W) int32 -> (..., m) bool."""
    shift = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shift) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :m].bool()


def _fixpoint_keep(supf: torch.Tensor, eligible: torch.Tensor):
    """Greedy keep on a strictly upper-triangular (B, n, n) float
    suppression matrix by fixpoint iteration: after sweep t every decision
    i <= t is exact. Each sweep checks convergence on the host."""
    n = supf.shape[-1]
    keep, prev = eligible, torch.zeros_like(eligible)
    it = 0
    while it < n and bool((keep != prev).any()):
        suppressed = (keep.to(supf.dtype).unsqueeze(-2) @ supf) \
            .squeeze(-2) > 0.5
        keep, prev = eligible & ~suppressed, keep
        it += 1
    return keep


def greedy_keep(sup: torch.Tensor, eligible: torch.Tensor,
                block: int = 256) -> torch.Tensor:
    """Greedy-NMS keep mask from a score-ordered suppression matrix.

    ``sup[..., j, i]`` is True if box j (higher score) suppresses box i;
    only the strict upper triangle is read. Blocks of ``block`` rows are
    resolved in score order: a small fixpoint inside the block, then one
    (block, N) product propagates the block's suppression to every later
    box. Equal to sequential greedy NMS. (N, N) or (B, N, N). The plain
    version of ``nms_keep`` (:func:`nms_keep_ref`).
    """
    squeeze = sup.dim() == 2
    if squeeze:
        sup, eligible = sup[None], eligible[None]
    n = sup.shape[-1]
    dev = sup.device
    if n <= block:
        tri = torch.triu(torch.ones(n, n, dtype=torch.bool, device=dev), 1)
        keep = _fixpoint_keep((sup & tri).float(), eligible)
        return keep[0] if squeeze else keep
    pad = (-n) % block
    if pad:
        sup = torch.nn.functional.pad(sup, (0, pad, 0, pad))
        eligible = torch.nn.functional.pad(eligible, (0, pad))
    tri_b = torch.triu(torch.ones(block, block, dtype=torch.bool,
                                  device=dev), 1)
    alive = eligible
    keeps = []
    for r0 in range(0, n + pad, block):
        rows = sup[:, r0:r0 + block, :]
        sub = rows[:, :, r0:r0 + block]
        keep_b = _fixpoint_keep((sub & tri_b).float(),
                                alive[:, r0:r0 + block])
        # within the block, lower-triangle entries can only clear alive
        # columns that are never read again (blocks go in row order)
        suppressed = (keep_b.float().unsqueeze(-2) @ rows.float()) \
            .squeeze(-2) > 0.5
        alive = alive & ~suppressed
        keeps.append(keep_b)
    keep = torch.cat(keeps, dim=-1)[:, :n]
    return keep[0] if squeeze else keep


def _check_mask(mask: torch.Tensor, eligible: torch.Tensor) -> None:
    n = eligible.shape[-1]
    if mask.dtype != torch.int32 or mask.shape[:-1] != eligible.shape \
            or mask.shape[-1] != -(-n // WORD):
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype} does not fit "
                         f"eligible {tuple(eligible.shape)}")


def nms_keep_ref(mask: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack the bits, then the blocked greedy keep."""
    _check_mask(mask, eligible)
    return greedy_keep(unpack_bits(mask, eligible.shape[-1]),
                       eligible.bool())


def _launch(mask: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    _check_mask(mask, eligible)
    build.require_cuda(eligible, "eligible", mask.device)
    squeeze = mask.dim() == 2
    m = mask.contiguous()
    e = eligible.to(torch.bool).contiguous()
    if squeeze:
        m, e = m[None], e[None]
    bsz, n = e.shape
    keep = torch.empty((bsz, n), dtype=torch.bool, device=m.device)
    if keep.numel():
        lib = build.load_library()
        rc = lib.sm3det_nms_keep(m.data_ptr(), e.data_ptr(), keep.data_ptr(),
                                 bsz, n, build.stream_ptr(m.device))
        build.check(rc, "nms_keep")
        build.LAUNCHES["nms_keep"] += 1
    return keep[0] if squeeze else keep


def nms_keep(mask: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    """Keep mask (N,) or (B, N) bool of greedy NMS from ``mask`` (N, W) or
    (B, N, W) int32 and ``eligible`` (N,) or (B, N) bool.

    A CUDA tensor goes through the kernel (one launch, one block an image),
    a CPU tensor through :func:`nms_keep_ref`.
    """
    if mask.is_cuda:
        return _launch(mask, eligible)
    if mask.device.type == "cpu":
        return nms_keep_ref(mask, eligible)
    raise ValueError(f"nms_keep: unsupported device {mask.device}")
