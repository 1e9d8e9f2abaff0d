"""Pairwise horizontal-box IoU: CUDA kernel (``csrc/hbb_iou.cu``) and its
plain PyTorch version, as a matrix (``hbb_iou``) or as the packed
suppression bits of greedy NMS (``hbb_nms_mask``).

Counterpart of ``sm3det_tpu/ops/pallas/hbb_iou_kernel.py::hbb_iou_pallas``
(mmdet ``bbox_overlaps`` iou mode, eps 1e-6). ``triu=True`` gives zeros in
every 128x128 tile strictly below the diagonal of tiles, as the TPU kernel
does. The NMS reads only the strict upper triangle of the score-ordered
self-IoU, compared with its threshold: the mask mode keeps just those
decisions, 32 to an int32 word (``nms_keep_kernel.pack_bits``).
"""

from __future__ import annotations

import torch

from . import build
from .nms_keep_kernel import pack_bits

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
        build.forbid_grad("hbb_iou", boxes1, boxes2)
        return _launch(boxes1, boxes2, triu, eps)
    if boxes1.device.type == "cpu":
        return hbb_iou_ref(boxes1, boxes2, triu, eps)
    raise ValueError(f"hbb_iou: unsupported device {boxes1.device}")


def hbb_nms_mask_ref(boxes: torch.Tensor, thr: float,
                     eps: float = 1e-6) -> torch.Tensor:
    """Plain version: (..., N, 4) -> (..., N, ceil(N / 32)) int32, bit
    ``j % 32`` of word ``j // 32`` of row ``i`` set iff ``j > i`` and
    ``iou(i, j) > thr`` (compared in fp32, as ``iou > thr`` does)."""
    iou = hbb_iou_ref(boxes, boxes, eps=eps)
    n = iou.shape[-1]
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=iou.device),
                       1)
    return pack_bits((iou > thr) & upper)


def _launch_mask(boxes: torch.Tensor, thr: float, eps: float) -> torch.Tensor:
    squeeze = boxes.dim() == 2
    b = boxes.float().contiguous()
    if squeeze:
        b = b[None]
    if b.dim() != 3 or b.shape[-1] != 4:
        raise ValueError(f"bad box shape {tuple(boxes.shape)}")
    if b.data_ptr() % 16:
        b = b.clone()               # the kernel reads a box as one float4
    bsz, n = b.shape[:2]
    out = torch.empty((bsz, n, -(-n // 32)), device=b.device,
                      dtype=torch.int32)
    if out.numel():
        lib = build.load_library()
        rc = lib.sm3det_hbb_nms_mask(b.data_ptr(), out.data_ptr(), bsz, n,
                                     thr, eps, build.stream_ptr(b.device))
        build.check(rc, "hbb_nms_mask")
        build.LAUNCHES["hbb_nms_mask"] += 1
    return out[0] if squeeze else out


def hbb_nms_mask(boxes: torch.Tensor, thr: float,
                 eps: float = 1e-6) -> torch.Tensor:
    """Suppression bits of the score-ordered boxes (N, 4) or (B, N, 4):
    (N, W) or (B, N, W) int32, W = ceil(N / 32), as :func:`hbb_nms_mask_ref`.

    A CUDA tensor goes through the kernel (one launch for the batch), a CPU
    tensor through :func:`hbb_nms_mask_ref`.
    """
    if boxes.is_cuda:
        build.forbid_grad("hbb_nms_mask", boxes)
        return _launch_mask(boxes, thr, eps)
    if boxes.device.type == "cpu":
        return hbb_nms_mask_ref(boxes, thr, eps)
    raise ValueError(f"hbb_nms_mask: unsupported device {boxes.device}")
