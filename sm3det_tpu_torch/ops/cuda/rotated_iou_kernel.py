"""Pairwise rotated-box IoU: CUDA kernel (``csrc/rotated_iou.cu``) and its
plain PyTorch version.

Counterpart of ``sm3det_tpu/ops/pallas/rotated_iou_kernel.py::
box_iou_rotated_pallas``. ``triu=True`` gives zeros in every tile strictly
below the diagonal of tiles. ``groups1``/``groups2`` (int, ascending per
image) select the group-banded mode for multi-class NMS: a tile is computed
only where the group ranges of its rows and columns overlap and neither is
all inert (``>= INERT_GROUP``); the other tiles are zeros. Cross-group
pairs inside a computed tile carry their true IoU, which the plain version
defines as 0: callers keep classes apart by a coordinate offset, so those
are 0 either way.

Tiles are ``TILE`` = 32 wide here (128 on the TPU): the triangle and the
band follow the kernel's tile.
"""

from __future__ import annotations

import torch

from ..rotated_iou import box_iou_rotated
from . import build

TILE = 32
# group id of entries whose rows and columns are never read (padding,
# candidates the NMS may not keep); far below int32 overflow
INERT_GROUP = 1 << 20


def tile_need(n: int, m: int, triu: bool, groups1=None, groups2=None,
              device=None) -> torch.Tensor:
    """(..., ceil(n / TILE), ceil(m / TILE)) bool: the tiles the kernel
    computes; the rule of ``rotated_iou.cu``."""
    nt, mt = -(-n // TILE), -(-m // TILE)
    device = groups1.device if groups1 is not None else device
    need = torch.ones(nt, mt, dtype=torch.bool, device=device)
    if triu:
        need = torch.triu(need)
    if groups1 is None:
        return need

    def bounds(g, k, kt):
        g = torch.nn.functional.pad(g.int(), (0, kt * TILE - k),
                                    value=INERT_GROUP)
        g = g.reshape(g.shape[:-1] + (kt, TILE))
        return g.amin(-1), g.amax(-1)

    lo1, hi1 = bounds(groups1, n, nt)
    lo2, hi2 = bounds(groups2, m, mt)
    return need & (hi1[..., :, None] >= lo2[..., None, :]) \
        & (hi2[..., None, :] >= lo1[..., :, None]) \
        & (lo1[..., :, None] < INERT_GROUP) & (lo2[..., None, :] < INERT_GROUP)


def rotated_iou_ref(boxes1: torch.Tensor, boxes2: torch.Tensor,
                    triu: bool = False, groups1=None, groups2=None
                    ) -> torch.Tensor:
    """Plain version: (..., N, 5) x (..., M, 5) fp32 -> (..., N, M). The
    banded mode is the dense IoU masked to same-group pairs."""
    iou = box_iou_rotated(boxes1.float(), boxes2.float())
    if groups1 is not None:
        iou = iou * (groups1[..., :, None] == groups2[..., None, :])
    if triu:
        n, m = iou.shape[-2:]
        ti = torch.arange(n, device=iou.device) // TILE
        tj = torch.arange(m, device=iou.device) // TILE
        iou = iou * (tj[None, :] >= ti[:, None])
    return iou


def _launch(boxes1, boxes2, triu, groups1, groups2):
    dev = boxes1.device
    build.require_cuda(boxes2, "boxes2", dev)
    squeeze = boxes1.dim() == 2
    b1 = boxes1.float().contiguous()
    b2 = boxes2.float().contiguous()
    if squeeze:
        b1, b2 = b1[None], b2[None]
    if b1.dim() != 3 or b1.shape[-1] != 5 or b2.shape[-1] != 5 \
            or b1.shape[0] != b2.shape[0]:
        raise ValueError(f"bad box shapes {tuple(boxes1.shape)} "
                         f"{tuple(boxes2.shape)}")
    bsz, n, m = b1.shape[0], b1.shape[1], b2.shape[1]
    banded = groups1 is not None
    g1 = g2 = None
    if banded:
        if groups2 is None:
            raise ValueError("groups1 without groups2")
        build.require_cuda(groups1, "groups1", dev)
        build.require_cuda(groups2, "groups2", dev)
        g1 = groups1.to(torch.int32).reshape(bsz, n).contiguous()
        g2 = g1 if groups2 is groups1 else \
            groups2.to(torch.int32).reshape(bsz, m).contiguous()
    out = torch.empty((bsz, n, m), device=dev, dtype=torch.float32)
    if out.numel():
        name = "rotated_iou_banded" if banded else "rotated_iou"
        lib = build.load_library()
        rc = lib.sm3det_rotated_iou(
            b1.data_ptr(), b2.data_ptr(), build.ptr(g1), build.ptr(g2),
            out.data_ptr(), bsz, n, m, int(triu), build.stream_ptr(dev))
        build.check(rc, name)
        build.LAUNCHES[name] += 1
    return out[0] if squeeze else out


def rotated_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                triu: bool = False, groups1=None, groups2=None
                ) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) rotated IoU, or batched (B, N, 5) x
    (B, M, 5) with groups (B, N) / (B, M).

    A CUDA tensor goes through the kernel (one launch for the batch), a CPU
    tensor through :func:`rotated_iou_ref`.
    """
    if boxes1.is_cuda:
        build.forbid_grad("rotated_iou", boxes1, boxes2)
        return _launch(boxes1, boxes2, triu, groups1, groups2)
    if boxes1.device.type == "cpu":
        return rotated_iou_ref(boxes1, boxes2, triu, groups1, groups2)
    raise ValueError(f"rotated_iou: unsupported device {boxes1.device}")
