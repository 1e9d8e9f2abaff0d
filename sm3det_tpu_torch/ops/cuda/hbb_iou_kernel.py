"""Pairwise horizontal-box IoU: CUDA kernel (``csrc/hbb_iou.cu``) and its
plain PyTorch version.

Counterpart of ``sm3det_tpu/ops/pallas/hbb_iou_kernel.py::hbb_iou_pallas``
(mmdet ``bbox_overlaps`` iou mode, eps 1e-6). ``triu=True`` gives zeros in
every 128x128 tile strictly below the diagonal of tiles, as the TPU kernel
does; score-ordered greedy NMS reads only the strict upper triangle.
"""

from __future__ import annotations

import torch

from . import build

BLK = 128


def _tile_mask(n: int, m: int, device) -> torch.Tensor:
    """(n, m) bool, True where the 128-tile is on or above the diagonal."""
    ti = torch.arange(n, device=device) // BLK
    tj = torch.arange(m, device=device) // BLK
    return tj[None, :] >= ti[:, None]


def hbb_iou_ref(boxes1: torch.Tensor, boxes2: torch.Tensor,
                triu: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: (..., N, 4) x (..., M, 4) fp32 -> (..., N, M)."""
    b1 = boxes1.float()[..., :, None, :]
    b2 = boxes2.float()[..., None, :, :]
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / torch.clamp(union, min=eps)
    if triu:
        iou = iou * _tile_mask(iou.shape[-2], iou.shape[-1], iou.device)
    return iou


def _launch(boxes1: torch.Tensor, boxes2: torch.Tensor, triu: bool,
            eps: float) -> torch.Tensor:
    build.require_cuda(boxes2, "boxes2", boxes1.device)
    squeeze = boxes1.dim() == 2
    b1 = boxes1.float().contiguous()
    b2 = boxes2.float().contiguous()
    if squeeze:
        b1, b2 = b1[None], b2[None]
    if b1.dim() != 3 or b1.shape[-1] != 4 or b2.shape[-1] != 4 \
            or b1.shape[0] != b2.shape[0]:
        raise ValueError(f"bad box shapes {tuple(boxes1.shape)} "
                         f"{tuple(boxes2.shape)}")
    bsz, n, m = b1.shape[0], b1.shape[1], b2.shape[1]
    out = torch.empty((bsz, n, m), device=b1.device, dtype=torch.float32)
    if out.numel():
        lib = build.load_library()
        rc = lib.sm3det_hbb_iou(b1.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                bsz, n, m, int(triu), eps,
                                build.stream_ptr(b1.device))
        build.check(rc, "hbb_iou")
        build.LAUNCHES["hbb_iou"] += 1
    return out[0] if squeeze else out


def hbb_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, triu: bool = False,
            eps: float = 1e-6) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) IoU, or batched (B, N, 4) x (B, M, 4).

    A CUDA tensor goes through the kernel (one launch for the batch), a CPU
    tensor through :func:`hbb_iou_ref`.
    """
    if boxes1.is_cuda:
        return _launch(boxes1, boxes2, triu, eps)
    if boxes1.device.type == "cpu":
        return hbb_iou_ref(boxes1, boxes2, triu, eps)
    raise ValueError(f"hbb_iou: unsupported device {boxes1.device}")
