"""Pyramid rotated RoI align: CUDA kernels (``csrc/roi_align_rotated.cu``
forward, ``csrc/roi_align_rotated_bwd.cu`` feature gradient) in one
``torch.autograd.Function``, and the dispatch to the plain PyTorch version.

Counterpart of ``sm3det_tpu/ops/pallas/roi_align_kernel.py::
roi_align_rotated_pyramid_fused``, ``..._fused_bucketed`` (one direct
bilinear-sampling kernel for both) and ``..._fused_bwd``. Levels come from
the exact sqrt-area rule (``ops/roi_align_rotated.route_levels``), without
the TPU kernels' extent clamp and size buckets. The backward gives the
features' gradient and none for the RoIs, as the reference op does.

The backward gathers: a first launch turns each RoI's samples into a
stencil (per bin, the pixels its taps touch and their summed weights) and
the box of pixels the RoI touches; a second sums, for each 8 x 8 pixel tile
of a level, the stencils of the RoIs whose box meets it, in RoI order, in
fp32, and writes the tile once in the feature dtype (zeros where no RoI
touches it). No atomics: two runs on the card give the same bits. On the
host the backward is autograd of the plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..roi_align_rotated import (roi_align_rotated_pyramid,
                                 route_levels, sample_taps)
from . import build

MAX_LEVELS = 4
MAX_ROI_SAMPLES = 1024  # out_size^2 * sample_num^2, a RoI
MAX_BWD_SAMPLE_NUM = 2  # the backward's stencil: 4 sample_num^2 <= 16 taps
BWD_TAPS = 16           # a bin's entries in the backward's stencil
BWD_TILE = 8            # the backward's output tiles: 8 x 8 pixels


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
    C) -> per level (B, H_l, W_l, C) in ``dtype``, each written once by the
    kernel. One launch of the stencil kernel and one of the tile kernel
    (counted once); their scratch is sized from the shapes."""
    dev = g.device
    build.require_cuda(g, "g")
    build.require_cuda(rois, "rois", dev)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g must be fp32 or bf16, got {g.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the gradient must be fp32 or bf16, got {dtype}")
    n_lvl = len(featmap_strides)
    n, out_size, _, ch = g.shape
    if ch % 2 or not 1 <= sample_num <= MAX_BWD_SAMPLE_NUM \
            or (out_size * sample_num) ** 2 > MAX_ROI_SAMPLES \
            or rois.shape != (n, 6) or not 0 < n_lvl <= MAX_LEVELS \
            or len(level_shapes) < n_lvl:
        raise ValueError(f"bad shapes: g {tuple(g.shape)}, rois "
                         f"{tuple(rois.shape)}, {len(level_shapes)} levels, "
                         f"sample_num {sample_num}")
    grads = [torch.empty(tuple(s), device=dev, dtype=dtype)
             for s in level_shapes[:n_lvl]]
    for t in grads:
        if t.shape[0] != grads[0].shape[0] or t.shape[-1] != ch \
                or max(t.shape[1:3]) >= (1 << 15) - 1:
            raise ValueError(f"levels must be (B, H, W, {ch}), H and W "
                             f"below 32767")
    g = g.contiguous()
    if g.data_ptr() % (2 * g.element_size()):
        g = g.clone()       # the kernel reads g by channel pairs at least
    rois = rois.float().contiguous()
    lvls = lvls.to(torch.int32).contiguous()
    n_bins = out_size * out_size
    entries = torch.empty((n, n_bins * BWD_TAPS, 2), device=dev,
                          dtype=torch.int32)
    bin_box = torch.empty((n, n_bins, 2), device=dev, dtype=torch.int32)
    info = torch.empty((n, 4), device=dev, dtype=torch.int32)
    lib = build.load_library()
    rc = lib.sm3det_roi_align_rotated_bwd(
        *[t.data_ptr() for t in grads], *[None] * (MAX_LEVELS - n_lvl),
        *_geometry_args(grads, featmap_strides),
        rois.data_ptr(), lvls.data_ptr(), g.data_ptr(), entries.data_ptr(),
        bin_box.data_ptr(), info.data_ptr(), grads[0].shape[0], ch, n,
        out_size, sample_num,
        int(g.dtype == torch.bfloat16), int(dtype == torch.bfloat16),
        build.stream_ptr(dev))
    build.check(rc, "roi_align_rotated_bwd")
    build.LAUNCHES["roi_align_rotated_bwd"] += 1
    return grads


def touched_boxes_ref(rois, lvls, level_shapes, featmap_strides=(4, 8, 16,
                                                                 32),
                      out_size: int = 7, sample_num: int = 2):
    """Plain version of the backward's tile rule: per RoI the box ``(ymin,
    ymax, xmin, xmax)`` (int64, on its level) of the pixels its taps of
    non-zero weight touch, ``ymin = ymax = -1`` where there are none. The
    tile kernel sums RoI n into a tile exactly where this box meets it."""
    n = rois.shape[0]
    box = torch.full((n, 4), -1, dtype=torch.int64, device=rois.device)
    rois = rois.float()
    for lvl, stride in enumerate(featmap_strides):
        sel = torch.nonzero(lvls == lvl).squeeze(1)
        if not sel.numel():
            continue
        hgt, wid = level_shapes[lvl][1], level_shapes[lvl][2]
        y0, x0, y1, x1, ly, lx, keep = sample_taps(
            rois[sel], hgt, wid, out_size, 1.0 / stride, sample_num)
        hy, hx = 1.0 - ly, 1.0 - lx
        ys = torch.stack([y0, y0, y1, y1], -1).flatten(1)
        xs = torch.stack([x0, x1, x0, x1], -1).flatten(1)
        wts = (torch.stack([hy * hx, hy * lx, ly * hx, ly * lx], -1)
               * keep[..., None]).flatten(1)
        on = wts != 0
        big = torch.iinfo(torch.int64).max
        box[sel, 0] = torch.where(on, ys, big).amin(1)
        box[sel, 1] = torch.where(on, ys, -1).amax(1)
        box[sel, 2] = torch.where(on, xs, big).amin(1)
        box[sel, 3] = torch.where(on, xs, -1).amax(1)
        none = ~on.any(1)
        box[sel[none]] = -1
    return box


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
    Backward: the gather kernels on the card, autograd of the plain version
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
