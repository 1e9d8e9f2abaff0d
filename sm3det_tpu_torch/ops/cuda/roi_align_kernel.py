"""Pyramid rotated RoI align: CUDA kernel (``csrc/roi_align_rotated.cu``)
and the dispatch to its plain PyTorch version.

Counterpart of ``sm3det_tpu/ops/pallas/roi_align_kernel.py::
roi_align_rotated_pyramid_fused`` and ``..._fused_bucketed``: one direct
bilinear-sampling kernel for both. Levels come from the exact sqrt-area
rule (``ops/roi_align_rotated.route_levels``), without the TPU kernels'
extent clamp and size buckets. Forward only: the feature gradient is the
training slice's kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..roi_align_rotated import roi_align_rotated_pyramid, route_levels
from . import build

MAX_LEVELS = 4
MAX_SAMPLES = 64      # out_size * sample_num^2, one bin row of the kernel


def _launch(feats, rois, lvls, out_size, featmap_strides, sample_num):
    dev = rois.device
    n_lvl = len(featmap_strides)
    if n_lvl > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {n_lvl}")
    if out_size * sample_num * sample_num > MAX_SAMPLES:
        raise ValueError("out_size * sample_num^2 exceeds the kernel's "
                         f"{MAX_SAMPLES} samples a bin row")
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"features must be fp32 or bf16, got {dtype}")
    bsz, ch = feats[0].shape[0], feats[0].shape[-1]
    if ch % 2:
        raise ValueError(f"the channel count must be even, got {ch}")
    levels = []
    for f in feats[:n_lvl]:
        build.require_cuda(f, "feats", dev)
        if f.dtype != dtype or f.shape[0] != bsz or f.shape[-1] != ch \
                or f.dim() != 4:
            raise ValueError("levels must share batch, channels and dtype")
        levels.append(f.contiguous())
    rois = rois.float().contiguous()
    if rois.dim() != 2 or rois.shape[1] != 6:
        raise ValueError(f"rois must be (N, 6), got {tuple(rois.shape)}")
    lvls = lvls.to(torch.int32).contiguous()
    n = rois.shape[0]
    out = torch.empty((n, out_size, out_size, ch), device=dev, dtype=dtype)
    if out.numel():
        pad = MAX_LEVELS - n_lvl
        lib = build.load_library()
        rc = lib.sm3det_roi_align_rotated(
            *[f.data_ptr() for f in levels], *[None] * pad,
            *[f.shape[1] for f in levels], *[0] * pad,
            *[f.shape[2] for f in levels], *[0] * pad,
            *[1.0 / s for s in featmap_strides], *[0.0] * pad,
            rois.data_ptr(), lvls.data_ptr(), out.data_ptr(), bsz, ch, n,
            out_size, sample_num, int(dtype == torch.bfloat16),
            build.stream_ptr(dev))
        build.check(rc, "roi_align_rotated")
        build.LAUNCHES["roi_align_rotated"] += 1
    return out


def roi_align_rotated_pyramid_fused(
        feats: Sequence[torch.Tensor], rois: torch.Tensor, out_size: int = 7,
        featmap_strides=(4, 8, 16, 32), sample_num: int = 2,
        finest_scale: int = 56) -> torch.Tensor:
    """feats per level (B, H_l, W_l, C); rois (N, 6) ``(batch_idx, cx, cy,
    w, h, theta)`` -> (N, out, out, C) in the features' dtype.

    CUDA tensors go through the kernel (one launch), CPU tensors through
    the plain ``roi_align_rotated_pyramid``; the levels are routed by
    ``route_levels`` either way.
    """
    lvls = route_levels(rois.float(), finest_scale, len(featmap_strides))
    if rois.is_cuda:
        return _launch(feats, rois, lvls, out_size, featmap_strides,
                       sample_num)
    if rois.device.type == "cpu":
        return roi_align_rotated_pyramid(
            feats, rois, lvls, out_size, featmap_strides=featmap_strides,
            sample_num=sample_num)
    raise ValueError(f"roi_align_rotated: unsupported device {rois.device}")
