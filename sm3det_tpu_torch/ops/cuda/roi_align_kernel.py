"""Pyramid rotated RoI align: CUDA kernels (``csrc/roi_align_rotated.cu``
forward, ``csrc/roi_align_rotated_bwd.cu`` feature gradient) in one
``torch.autograd.Function``, and the dispatch to the plain PyTorch version.

Counterpart of ``sm3det_tpu/ops/pallas/roi_align_kernel.py::
roi_align_rotated_pyramid_fused``, ``..._fused_bucketed`` (one direct
bilinear-sampling kernel for both) and ``..._fused_bwd``. Levels come from
the exact sqrt-area rule (``ops/roi_align_rotated.route_levels``), without
the TPU kernels' extent clamp and size buckets. The backward gives the
features' gradient and none for the RoIs, as the reference op does.

The backward kernel adds each sample's taps into an fp32 buffer per level
with atomics, which commit in no fixed order: two runs on the card differ
by fp32 rounding (the card tests allow 1e-4 of the gradient's scale in
fp32 and 2^-6 in bf16, where the buffer is rounded once to bf16). On the
host the backward is autograd of the plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..roi_align_rotated import roi_align_rotated_pyramid, route_levels
from . import build

MAX_LEVELS = 4
MAX_SAMPLES = 64      # out_size * sample_num^2, a bin row of the backward
MAX_ROI_SAMPLES = 1024  # out_size^2 * sample_num^2, a RoI of the forward


def _check_args(feats, rois, out_size, featmap_strides, sample_num):
    dev = rois.device
    n_lvl = len(featmap_strides)
    if n_lvl > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {n_lvl}")
    if (out_size * sample_num) ** 2 > MAX_ROI_SAMPLES:
        raise ValueError("out_size^2 * sample_num^2 exceeds the kernel's "
                         f"{MAX_ROI_SAMPLES} samples a RoI")
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"features must be fp32 or bf16, got {dtype}")
    bsz, ch = feats[0].shape[0], feats[0].shape[-1]
    if ch % 2:
        raise ValueError(f"the channel count must be even, got {ch}")
    for f in feats[:n_lvl]:
        build.require_cuda(f, "feats", dev)
        if f.dtype != dtype or f.shape[0] != bsz or f.shape[-1] != ch \
                or f.dim() != 4:
            raise ValueError("levels must share batch, channels and dtype")
    if rois.dim() != 2 or rois.shape[1] != 6:
        raise ValueError(f"rois must be (N, 6), got {tuple(rois.shape)}")


def _geometry_args(levels, featmap_strides):
    pad = MAX_LEVELS - len(levels)
    return ([f.shape[1] for f in levels] + [0] * pad
            + [f.shape[2] for f in levels] + [0] * pad
            + [1.0 / s for s in featmap_strides] + [0.0] * pad)


def _launch(feats, rois, lvls, out_size, featmap_strides, sample_num):
    """One launch of the forward kernel."""
    _check_args(feats, rois, out_size, featmap_strides, sample_num)
    dev = rois.device
    n_lvl = len(featmap_strides)
    dtype = feats[0].dtype
    bsz, ch = feats[0].shape[0], feats[0].shape[-1]
    levels = [f.contiguous() for f in feats[:n_lvl]]
    rois = rois.float().contiguous()
    lvls = lvls.to(torch.int32).contiguous()
    n = rois.shape[0]
    out = torch.empty((n, out_size, out_size, ch), device=dev, dtype=dtype)
    if out.numel():
        lib = build.load_library()
        rc = lib.sm3det_roi_align_rotated(
            *[f.data_ptr() for f in levels], *[None] * (MAX_LEVELS - n_lvl),
            *_geometry_args(levels, featmap_strides),
            rois.data_ptr(), lvls.data_ptr(), out.data_ptr(), bsz, ch, n,
            out_size, sample_num, int(dtype == torch.bfloat16),
            build.stream_ptr(dev))
        build.check(rc, "roi_align_rotated")
        build.LAUNCHES["roi_align_rotated"] += 1
    return out


def roi_align_rotated_pyramid_bwd(g, rois, lvls, level_shapes, dtype,
                                  featmap_strides=(4, 8, 16, 32),
                                  sample_num: int = 2):
    """Feature gradients of the pyramid align on the card: g (N, out, out,
    C) -> per level (B, H_l, W_l, C) in ``dtype``. One launch of the
    scatter kernel into zeroed fp32 buffers, then one rounding to
    ``dtype``."""
    dev = g.device
    build.require_cuda(g, "g")
    build.require_cuda(rois, "rois", dev)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g must be fp32 or bf16, got {g.dtype}")
    n_lvl = len(featmap_strides)
    n, out_size, _, ch = g.shape
    if ch % 2 or out_size * sample_num * sample_num > MAX_SAMPLES \
            or rois.shape != (n, 6) or len(level_shapes) < n_lvl:
        raise ValueError(f"bad shapes: g {tuple(g.shape)}, rois "
                         f"{tuple(rois.shape)}, {len(level_shapes)} levels")
    bufs = [torch.zeros(tuple(s), device=dev, dtype=torch.float32)
            for s in level_shapes[:n_lvl]]
    if n:
        g = g.contiguous()
        rois = rois.float().contiguous()
        lvls = lvls.to(torch.int32).contiguous()
        lib = build.load_library()
        rc = lib.sm3det_roi_align_rotated_bwd(
            *[b.data_ptr() for b in bufs], *[None] * (MAX_LEVELS - n_lvl),
            *_geometry_args(bufs, featmap_strides),
            rois.data_ptr(), lvls.data_ptr(), g.data_ptr(),
            bufs[0].shape[0], ch, n, out_size, sample_num,
            int(g.dtype == torch.bfloat16), build.stream_ptr(dev))
        build.check(rc, "roi_align_rotated_bwd")
        build.LAUNCHES["roi_align_rotated_bwd"] += 1
    return [b.to(dtype) for b in bufs]


def roi_align_rotated_pyramid_bwd_ref(g, rois, lvls, level_shapes, dtype,
                                      featmap_strides=(4, 8, 16, 32),
                                      sample_num: int = 2):
    """Plain version of :func:`roi_align_rotated_pyramid_bwd`: autograd of
    the plain align, which is linear in the features, so fp32 zeros of
    their shapes stand for them; the gradient sums in fp32 and is rounded
    once to ``dtype``, as the kernel's."""
    n_lvl = len(featmap_strides)
    with torch.enable_grad():
        feats = [torch.zeros(tuple(s), dtype=torch.float32, device=g.device,
                             requires_grad=True)
                 for s in level_shapes[:n_lvl]]
        out = roi_align_rotated_pyramid(
            feats, rois, lvls, g.shape[1], featmap_strides=featmap_strides,
            sample_num=sample_num)
        grads = torch.autograd.grad(out, feats, g.float(), allow_unused=True)
    return [(torch.zeros_like(f) if d is None else d).to(dtype)
            for f, d in zip(feats, grads)]


class _PyramidAlign(torch.autograd.Function):
    """Forward: the kernel on the card, the plain version on the host.
    Backward: the scatter kernel on the card, autograd of the plain version
    on the host. Only the features get a gradient."""

    @staticmethod
    def forward(ctx, rois, lvls, out_size, featmap_strides, sample_num,
                *feats):
        ctx.save_for_backward(rois, lvls)
        ctx.geometry = (featmap_strides, sample_num)
        ctx.levels = [(tuple(f.shape), f.dtype) for f in feats]
        if rois.is_cuda:
            return _launch(feats, rois, lvls, out_size, featmap_strides,
                           sample_num)
        return roi_align_rotated_pyramid(
            feats, rois, lvls, out_size, featmap_strides=featmap_strides,
            sample_num=sample_num)

    @staticmethod
    def backward(ctx, g):
        rois, lvls = ctx.saved_tensors
        strides, sample_num = ctx.geometry
        shapes = [s for s, _ in ctx.levels]
        dtype = ctx.levels[0][1]
        bwd = roi_align_rotated_pyramid_bwd if g.is_cuda \
            else roi_align_rotated_pyramid_bwd_ref
        grads = bwd(g, rois, lvls, shapes, dtype, strides, sample_num)
        return (None, None, None, None, None, *grads)


def roi_align_rotated_pyramid_fused(
        feats: Sequence[torch.Tensor], rois: torch.Tensor, out_size: int = 7,
        featmap_strides=(4, 8, 16, 32), sample_num: int = 2,
        finest_scale: int = 56) -> torch.Tensor:
    """feats per level (B, H_l, W_l, C); rois (N, 6) ``(batch_idx, cx, cy,
    w, h, theta)`` -> (N, out, out, C) in the features' dtype, with a
    gradient for the features.

    CUDA tensors go through the kernels (one launch forward, one backward),
    CPU tensors through the plain ``roi_align_rotated_pyramid`` and its
    autograd; the levels are routed by ``route_levels`` either way.
    """
    if rois.device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_align_rotated: unsupported device "
                         f"{rois.device}")
    rois = rois.detach()
    lvls = route_levels(rois.float(), finest_scale, len(featmap_strides))
    return _PyramidAlign.apply(rois, lvls, out_size, tuple(featmap_strides),
                               sample_num,
                               *feats[:len(featmap_strides)])
