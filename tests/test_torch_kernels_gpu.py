"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
where there is none. Run on a machine with a card, from the repository's
root (``--noconftest``: the suite's conftest sets JAX up, and this file
needs no JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

fp32 kernels differ from the plain versions only in summation order
(1e-4 of the output scale); bf16 outputs may land on the neighbouring bf16
value where the fp32 sums differ, and the bf16 hidden activation of the
FFN may too (2^-6 of the output scale).
"""

import copy

import numpy as np
import pytest
import torch

from sm3det_tpu_torch.models.detectors.trisource import (DEFAULT_MODEL_CFG,
                                                          TriSourceDetector)
from sm3det_tpu_torch.models.moe import (MoELayer, group_aligned_dispatch,
                                         stable_topk)
from sm3det_tpu_torch.ops.cuda import build
from sm3det_tpu_torch.ops.cuda import convnext_block_kernel as cbk
from sm3det_tpu_torch.ops.cuda import hbb_iou_kernel as hik
from sm3det_tpu_torch.ops.cuda import moe_groupgemm_kernel as mgk
from sm3det_tpu_torch.ops.cuda import nms_keep_kernel as nkk
from sm3det_tpu_torch.ops.cuda import roi_align_kernel as rak
from sm3det_tpu_torch.ops.cuda import rotated_iou_kernel as rik
from sm3det_tpu_torch.ops import nms as nms_mod
from sm3det_tpu_torch.ops.roi_align_rotated import (
    roi_align_rotated_pyramid, route_levels)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, dtype=torch.float32, scale=1.0, device="cuda"):
    return (torch.randn(*shape, generator=gen, device=device) * scale) \
        .to(dtype)


def _check(got, ref, dtype):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert bool(torch.isfinite(got.float()).all())
    scale = max(ref.float().abs().max().item(), 1.0)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


def _block_args(gen, b, hw, c, dtype):
    x = _rand(gen, b, hw, hw, c, dtype=dtype)
    vec = [_rand(gen, c, scale=0.1, dtype=dtype) for _ in range(2)]
    return dict(
        x=x, dwk=_rand(gen, c, 1, 7, 7, scale=0.15, dtype=dtype),
        dwb=vec[0], lns=(1 + _rand(gen, c, scale=0.1)).to(dtype),
        lnb=vec[1],
        w1=_rand(gen, c, 4 * c, scale=c ** -0.5, dtype=dtype),
        b1=_rand(gen, 4 * c, scale=0.1, dtype=dtype),
        w2=_rand(gen, 4 * c, c, scale=(4 * c) ** -0.5, dtype=dtype),
        b2=_rand(gen, c, scale=0.1, dtype=dtype),
        gamma=(0.5 + torch.rand(c, generator=gen, device="cuda")).to(dtype))


SHAPES = [(2, 9, 40), (2, 13, 96), (8, 50, 384), (8, 25, 768)]
# ConvNeXt-L's and -XL's widest stages (8 blocks of 6 and of 8 channel
# chunks in the dw7x7 + LN clusters)
WIDE = [(1, 6, 1536), (2, 5, 2048)]
# the dw7x7 + LN kernels also at a non-square image and at C = 36, whose
# bf16 row (72 bytes) is not a multiple of 16 bytes, and an odd C
DWCONV_SHAPES = SHAPES + [(2, (9, 13), 36), (2, (9, 13), 96),
                          (1, (7, 5), 33)] + WIDE
# the LayerNorm kernel also where a row is not a multiple of 16 bytes
# (scalar reads, several rows a row group; C = 33 also leaves a tail under
# 16 bytes at the end of x) and where the last chunk of rows is short
# and at the LSKNet / VAN stages of 8 images of 800^2 (the T arch's
# widths, then the S / B arch's)
LSK_LN = [(8, 200, 32), (8, 100, 64), (8, 50, 160), (8, 25, 256),
          (8, 200, 64), (8, 100, 128), (8, 50, 320), (8, 25, 512)]
LN_SHAPES = SHAPES + [(2, 7, 36), (1, 5, 33), (3, 20, 192)] + WIDE + LSK_LN


def _dwconv_inputs(gen, b, hw, c, dtype):
    h, w = hw if isinstance(hw, tuple) else (hw, hw)
    return [_rand(gen, b, h, w, c, dtype=dtype),
            _rand(gen, c, 1, 7, 7, scale=0.15, dtype=dtype),
            _rand(gen, c, scale=0.1, dtype=dtype),
            (1 + _rand(gen, c, scale=0.1)).to(dtype),
            _rand(gen, c, scale=0.1, dtype=dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c", DWCONV_SHAPES)
def test_dwconv_ln_kernel(cuda, dtype, b, hw, c):
    gen = torch.Generator(device=cuda).manual_seed(c)
    args = _dwconv_inputs(gen, b, hw, c, dtype)
    build.reset_launches()
    got = cbk.fused_dwconv_ln(*args)
    assert build.LAUNCHES["dwconv_ln"] == 1
    _check(got, cbk.dwconv_ln_ref(*args), dtype)


def _ln_args(gen, b, hw, c, dtype):
    """LayerNorm input off zero mean, and its scale and bias."""
    return ((_rand(gen, b, hw, hw, c, dtype=dtype) * 3 + 1).to(dtype),
            (1 + _rand(gen, c, scale=0.1)).to(dtype),
            _rand(gen, c, scale=0.1, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c", LN_SHAPES)
def test_layernorm_kernel(cuda, dtype, b, hw, c):
    gen = torch.Generator(device=cuda).manual_seed(c + 2)
    a = _block_args(gen, b, hw, c, dtype)
    args = (a["x"] * 3 + 1, a["lns"], a["lnb"])
    build.reset_launches()
    got = cbk.fused_layernorm(*args)
    assert build.LAUNCHES["fused_layernorm"] == 1
    _check(got, cbk.layernorm_math(*args), dtype)


class _LibSpy:
    """The kernel library with a record of the C entries called and their
    arguments."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls.append((name, args))
            return fn(*args)
        return call


# bf16 x with fp32, bf16 and mixed parameters (the output is fp32 where
# either parameter is), and fp32 x with bf16 parameters
@pytest.mark.parametrize("xd,sd,bd", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16, torch.bfloat16)])
def test_layernorm_reads_parameters_as_they_are(cuda, monkeypatch, xd, sd,
                                                bd):
    """One launch, given scale and bias themselves (no per-call copy), at
    the main path's (B, 25, 25, 768) and the stem's C = 96; bit-equal
    runs."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    spy = _LibSpy(build.load_library())
    monkeypatch.setattr(build, "load_library", lambda: spy)
    for b, hw, c in ((2, 25, 768), (2, 40, 96)):
        x, s, bias = _ln_args(gen, b, hw, c, xd)
        s, bias = s.to(sd), bias.to(bd)
        spy.calls.clear()
        build.reset_launches()
        got = cbk.fused_layernorm(x, s, bias)
        assert build.LAUNCHES["fused_layernorm"] == 1
        assert [name for name, _ in spy.calls] == ["sm3det_layernorm"]
        args = spy.calls[0][1]
        assert args[1] == s.data_ptr() and args[2] == bias.data_ptr()
        ref = cbk.layernorm_math(x, s, bias)
        _check(got, ref, torch.float32 if ref.dtype == torch.float32
               else torch.bfloat16)
        assert torch.equal(got, cbk.fused_layernorm(x, s, bias))


def test_wide_channels_refuse_past_2048(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, s, b = _ln_args(gen, 1, 2, 2056, torch.bfloat16)
    with pytest.raises(ValueError, match="2048"):
        cbk.fused_layernorm(x, s, b)
    args = _dwconv_inputs(gen, 1, 3, 2056, torch.bfloat16)
    with pytest.raises(ValueError, match="2048"):
        cbk.fused_dwconv_ln(*args)


@pytest.mark.parametrize("arch", ["large", "xlarge"])
def test_convnext_wide_archs_run_on_the_card(cuda, arch):
    """ConvNeXt-L and -XL (stage 3 at C = 1536 / 2048, a MoE block in
    stages 2 and 3): a bf16 forward through the kernels, every LayerNorm
    and dw7x7 + LN included, finite, as the host's fp32 plain path within
    bf16's reach."""
    from sm3det_tpu_torch.models.backbones.convnext import ConvNeXtMoE
    net = ConvNeXtMoE(arch=arch, moe_block_inds=((), (), (0,), (0,)),
                      num_experts=2, top_k=1,
                      gen=torch.Generator().manual_seed(0)).eval()
    for blk in net.modules():
        if hasattr(blk, "gamma"):
            blk.gamma.data.fill_(0.2)        # blocks that change x
    img = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = net(img)
        card = net.to(cuda, torch.bfloat16)
        build.reset_launches()
        got = card(img.to(cuda, torch.bfloat16))
    torch.cuda.synchronize()
    assert build.LAUNCHES["fused_layernorm"] == 8
    assert build.LAUNCHES["dwconv_ln"] == 36
    for g, r in zip(got, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g.float()).all())
        # 36 blocks of bf16 rounding: the features' shape, not their bits
        cos = torch.nn.functional.cosine_similarity(
            g.float().cpu().flatten(), r.flatten(), dim=0)
        assert cos > 0.99, float(cos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c", SHAPES)
def test_convnext_block_kernel(cuda, dtype, b, hw, c):
    gen = torch.Generator(device=cuda).manual_seed(c + 1)
    a = _block_args(gen, b, hw, c, dtype)
    args = [a[k] for k in ("x", "dwk", "dwb", "lns", "lnb", "w1", "b1",
                           "w2", "b2", "gamma")]
    build.reset_launches()
    got = cbk.fused_convnext_block(*args)
    assert build.LAUNCHES["fused_convnext_block"] == 1
    _check(got, cbk.convnext_block_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,e,k", [(3000, 96, 4, 2), (2000, 768, 8, 3)])
def test_moe_ffn_grouped_kernel(cuda, dtype, n, d, e, k):
    gen = torch.Generator(device=cuda).manual_seed(d)
    moe = MoELayer(d, 4 * d, num_experts=e, top_k=k,
                   gen=torch.Generator().manual_seed(d)).to(cuda, dtype)
    tokens = _rand(gen, n, d, dtype=dtype)
    with torch.no_grad():
        _, top_idx = stable_topk(moe.w_gate(tokens), k)
    src, tile_e, _, _ = group_aligned_dispatch(top_idx, e, d)
    ex = moe.experts
    args = (tokens[src], tile_e, ex.w1.detach(), ex.b1.detach(),
            ex.w2.detach(), ex.b2.detach())
    build.reset_launches()
    got = mgk.moe_ffn_grouped(*args)
    assert build.LAUNCHES["moe_ffn_grouped"] == 1
    _check(got, mgk.moe_ffn_grouped_ref(*args), dtype)


def _cuda_kernels(fn):
    """``fn()`` and the names of the CUDA kernels it launched
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]


def _is_ffn(name):
    return "ffn_fused_kernel" in name


# the fused bf16 FFN (csrc/ffn_wgmma.cu) at the four stage widths and at
# ConvNeXt-B's last (C = 1024: clusters of eight 128-column blocks); the
# dense rows are not a multiple of its 128-row tile (25^2 x 8 = 5000 at
# C = 768, the main path's stage 3)
FFN_DENSE = [(2, 45, 96), (2, 30, 192), (4, 25, 384), (8, 25, 768),
             (2, 13, 1024),
             # between the variants: ConvNeXt-nano's 80 / 160 / 320 / 640
             # and -B's 128 / 256 / 512 (masked 192-column blocks, clusters)
             (2, 30, 80), (2, 20, 128), (2, 20, 160), (2, 15, 256),
             (2, 12, 320), (2, 12, 512), (2, 10, 640)]


@pytest.mark.parametrize("b,hw,c", FFN_DENSE)
def test_ffn_fused_dense_block(cuda, b, hw, c):
    """The dense block's MLP: one launch of the fused kernel after the
    ``dwconv_ln`` launch, and on its own nothing else (no dtype copies of
    the weights, biases or gamma); bit-equal runs."""
    gen = torch.Generator(device=cuda).manual_seed(c + 5)
    a = _block_args(gen, b, hw, c, torch.bfloat16)
    args = [a[k] for k in ("x", "dwk", "dwb", "lns", "lnb", "w1", "b1",
                           "w2", "b2", "gamma")]
    build.reset_launches()
    got, names = _cuda_kernels(lambda: cbk.fused_convnext_block(*args))
    assert build.LAUNCHES["fused_convnext_block"] == 1
    assert sum(map(_is_ffn, names)) == 1, names
    assert sum("dwconv_ln_kernel" in n for n in names) == 1, names
    assert not any("gemm" in n for n in names), names
    _check(got, cbk.convnext_block_ref(*args), torch.bfloat16)
    assert torch.equal(got, cbk.fused_convnext_block(*args))
    xn = cbk.fused_dwconv_ln(*args[:5]).reshape(-1, c)
    half, names = _cuda_kernels(lambda: mgk.ffn_fused(
        xn, a["w1"][None], a["b1"], a["w2"][None], a["b2"],
        shortcut=a["x"].reshape(-1, c), gamma=a["gamma"]))
    assert len(names) == 1 and _is_ffn(names[0]), names
    assert torch.equal(half.reshape(got.shape), got)


def _ffn_weights(gen, e, c, vec_dtype=torch.bfloat16):
    h = 4 * c
    return (_rand(gen, e, c, h, scale=c ** -0.5, dtype=torch.bfloat16),
            _rand(gen, e, h, scale=0.1, dtype=vec_dtype),
            _rand(gen, e, h, c, scale=h ** -0.5, dtype=torch.bfloat16),
            _rand(gen, e, c, scale=0.1, dtype=vec_dtype))


# expert of each tile: a spread with a run per expert, expert 1 owning no
# tile, one expert owning every tile
TILE_EXPERTS = {"spread": [0, 0, 1, 2, 2, 2, 3], "idle": [0, 0, 2, 3, 3],
                "single": [2, 2, 2, 2]}


# above C = 1024 the clusters of eight cover C in column passes of 1024
@pytest.mark.parametrize("case", sorted(TILE_EXPERTS))
@pytest.mark.parametrize("c", [96, 192, 384, 768, 1024, 1536, 2048,
                               80, 128, 160, 256, 320, 512, 640])
def test_ffn_fused_moe(cuda, c, case):
    """The MoE expert FFN over a slot layout: one launch, nothing else,
    bit-equal runs; tile_expert as the dispatch gives it (int64) and in
    int32; fp32 biases read as they are."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    tile = 256 if c > 512 else 512
    te = torch.tensor(TILE_EXPERTS[case], device=cuda)
    x = _rand(gen, tile * te.numel(), c, dtype=torch.bfloat16)
    vec_dtype = torch.float32 if case == "idle" else torch.bfloat16
    w1, b1, w2, b2 = _ffn_weights(gen, 4, c, vec_dtype)
    args = (x, te, w1, b1, w2, b2)
    build.reset_launches()
    got, names = _cuda_kernels(lambda: mgk.moe_ffn_grouped(*args))
    assert build.LAUNCHES["moe_ffn_grouped"] == 1
    assert len(names) == 1 and _is_ffn(names[0]), names
    _check(got, mgk.moe_ffn_grouped_ref(*args), torch.bfloat16)
    assert torch.equal(got, mgk.moe_ffn_grouped(*args))
    assert torch.equal(got, mgk.moe_ffn_grouped(x, te.int(), *args[2:]))


def test_ffn_fused_refuses_other_weight_dtypes(cuda):
    """bf16 activations need bf16 weights: the kernel reads them as they
    are, so fp32 ones raise before anything is launched (no per-call
    copy)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = _block_args(gen, 2, 9, 96, torch.bfloat16)
    a["w1"] = a["w1"].float()
    args = [a[k] for k in ("x", "dwk", "dwb", "lns", "lnb", "w1", "b1",
                           "w2", "b2", "gamma")]
    te = torch.tensor([0, 1], device=cuda)
    w1, b1, w2, b2 = _ffn_weights(gen, 2, 96)
    x = _rand(gen, 2 * 128, 96, dtype=torch.bfloat16)
    build.reset_launches()
    with pytest.raises(ValueError, match="w1"):
        cbk.fused_convnext_block(*args)
    with pytest.raises(ValueError, match="bf16"):
        mgk.moe_ffn_grouped(x, te, w1.float(), b1, w2, b2)
    with pytest.raises(ValueError, match="bf16"):
        mgk.moe_ffn_grouped(x, te, w1, b1, w2.float(), b2)
    torch.cuda.synchronize()
    assert not any(build.LAUNCHES.values()), build.LAUNCHES


# stage 0 of two 800^2 images; the dense FFN at C = 1536 and 2048 (ConvNeXt-L
# and -XL's last stage), in two column passes
@pytest.mark.parametrize("m,c", [(2 * 200 * 200, 96), (144, 1536),
                                 (121, 2048)])
def test_ffn_fused_keeps_the_hidden_on_chip(cuda, m, c):
    """The dense FFN with its residual epilogue: the call allocates its
    output and no (M, 4C) hidden tensor."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = _rand(gen, m, c, dtype=torch.bfloat16)
    w1, b1, w2, b2 = _ffn_weights(gen, 1, c)
    gamma = torch.rand(c, generator=gen, device=cuda).to(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = mgk.ffn_fused(x, w1, b1[0], w2, b2[0], shortcut=x, gamma=gamma)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    hidden_bytes = m * 4 * c * 2
    assert grown < hidden_bytes, (grown, hidden_bytes)
    assert grown >= out.numel() * 2
    ref = x.float() + gamma.float() * mgk.ffn_ref(
        x, w1[0], b1[0], w2[0], b2[0]).float()
    # ffn_ref rounds the FFN before the residual; the kernel rounds once
    _check(out, ref.to(torch.bfloat16), torch.bfloat16)


@pytest.mark.parametrize("n", [130, 2000])
@pytest.mark.parametrize("triu", [False, True])
def test_hbb_iou_kernel(cuda, n, triu):
    gen = torch.Generator(device=cuda).manual_seed(n)
    xy = torch.rand(3, n, 2, generator=gen, device=cuda) * 700
    wh = 2 + torch.rand(3, n, 2, generator=gen, device=cuda) * 100
    boxes = torch.cat([xy, xy + wh], -1)
    got = hik.hbb_iou(boxes, boxes, triu=triu)
    ref = hik.hbb_iou_ref(boxes, boxes, triu=triu)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-6


def _rboxes(gen, b, n, device, span=300.0):
    """Clustered rotated boxes that really overlap, with exact duplicates
    and a few zero-size entries."""
    ctr = torch.rand(b, n, 2, generator=gen, device=device) * span
    wh = 4 + torch.rand(b, n, 2, generator=gen, device=device) * 90
    ang = (torch.rand(b, n, 1, generator=gen, device=device) - 0.5) * 3.1
    boxes = torch.cat([ctr, wh, ang], -1)
    boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]
    boxes[:, -3:] = 0.0
    return boxes


def _both_real_or_both_empty(boxes):
    """Pairs whose IoU is defined: a box of no area against a real one is
    rounding noise over a union near 0, in the kernel and the plain version
    alike, and no caller reads it."""
    real = (boxes[..., 2] * boxes[..., 3]) > 0
    return real[..., :, None] == real[..., None, :]


# the IoU is a quotient of sums of ~1e4-sized cross products; the kernel
# repeats the plain version's operations one by one, so 1e-5 absolute is
# generous
IOU_TOL = 1e-5


@pytest.mark.parametrize("b,n", [(1, 70), (3, 333), (2, 2000)])
@pytest.mark.parametrize("triu", [False, True])
def test_rotated_iou_kernel(cuda, b, n, triu):
    gen = torch.Generator(device=cuda).manual_seed(n)
    boxes = _rboxes(gen, b, n, cuda)
    build.reset_launches()
    got = rik.rotated_iou(boxes, boxes, triu=triu)
    assert build.LAUNCHES["rotated_iou"] == 1
    assert build.LAUNCHES["rotated_iou_banded"] == 0
    ref = rik.rotated_iou_ref(boxes, boxes, triu=triu)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (b, n, n)
    assert bool(torch.isfinite(got).all())
    ok = _both_real_or_both_empty(boxes)
    assert ((got - ref).abs() * ok).max().item() <= IOU_TOL
    assert float(ref.max()) > 0.99          # duplicates: IoU 1
    one = rik.rotated_iou(boxes[0], boxes[0, :n // 2], triu=triu)
    assert one.shape == (n, n // 2)
    assert torch.equal(one, got[0, :, :n // 2])


@pytest.mark.parametrize("b,n,classes", [(1, 100, 3), (3, 333, 5),
                                         (2, 2000, 26)])
@pytest.mark.parametrize("triu", [False, True])
def test_rotated_iou_banded_kernel(cuda, b, n, classes, triu):
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    boxes = _rboxes(gen, b, n, cuda)
    groups = torch.sort(torch.randint(0, classes, (b, n), generator=gen,
                                      device=cuda), dim=-1).values.int()
    groups[:, -n // 10:] = rik.INERT_GROUP
    build.reset_launches()
    got = rik.rotated_iou(boxes, boxes, triu=triu, groups1=groups,
                          groups2=groups)
    assert build.LAUNCHES["rotated_iou_banded"] == 1
    assert build.LAUNCHES["rotated_iou"] == 0
    ref = rik.rotated_iou_ref(boxes, boxes, triu=triu, groups1=groups,
                              groups2=groups)
    torch.cuda.synchronize()
    same = (groups[:, :, None] == groups[:, None, :]) & \
        (groups[:, :, None] < rik.INERT_GROUP)
    ok = same & _both_real_or_both_empty(boxes)
    assert ((got - ref).abs() * ok).max().item() <= IOU_TOL
    need = rik.tile_need(n, n, triu, groups, groups)
    assert 0 < int(need.sum()) < need.numel()
    skipped = ~need.repeat_interleave(rik.TILE, -2) \
        .repeat_interleave(rik.TILE, -1)[:, :n, :n]
    assert float((got.abs() * skipped).max()) == 0.0


# ---- the NMS's suppression bits and keep scan ------------------------------

# the main path's shapes (SAR b = 8, RPN b = 40 image-levels, n = 2000;
# the aug_test merge n = 4000) and the edges of a word
MASK_SHAPES = [(b, n) for n in (1, 31, 33, 2000, 4000) for b in (1, 8, 40)]


def _hbb_boxes(gen, b, n, device):
    """xyxy boxes in clusters, exact duplicates and a few of no size."""
    ctr = torch.rand(b, max(n // 16, 1), 2, generator=gen,
                     device=device) * 700
    pick = torch.randint(0, ctr.shape[1], (b, n), generator=gen,
                         device=device)
    xy = torch.gather(ctr, 1, pick[..., None].expand(-1, -1, 2)) \
        + torch.randn(b, n, 2, generator=gen, device=device) * 20
    wh = 2 + torch.rand(b, n, 2, generator=gen, device=device) * 100
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]
    boxes[:, 5::11, 2:] = boxes[:, 5::11, :2]
    return boxes


def _mask_bits(mask, n, ok=None):
    bits = nkk.unpack_bits(mask, n)
    return bits if ok is None else bits & ok


@pytest.mark.parametrize("b,n", MASK_SHAPES)
def test_hbb_nms_mask_kernel(cuda, b, n):
    gen = torch.Generator(device=cuda).manual_seed(n + b)
    boxes = _hbb_boxes(gen, b, n, cuda)
    build.reset_launches()
    got = hik.hbb_nms_mask(boxes, 0.6)
    assert build.LAUNCHES["hbb_nms_mask"] == 1
    assert build.LAUNCHES["hbb_iou"] == 0
    ref = hik.hbb_nms_mask_ref(boxes, 0.6)
    torch.cuda.synchronize()
    assert got.shape == (b, n, -(-n // 32)) and got.dtype == torch.int32
    assert torch.equal(got, ref)                       # bit for bit
    if n >= 2000:
        assert int(_mask_bits(ref, n).sum()) > b * n // 10
    assert torch.equal(hik.hbb_nms_mask(boxes[-1], 0.6), got[-1])


def test_hbb_nms_mask_at_the_threshold(cuda):
    """Thresholds equal to IoUs that occur, and the floats beside them: the
    kernel decides without dividing away from the threshold, and the
    rounded quotient decides next to it; every bit as the plain
    ``iou > thr``. Also thresholds where only the quotient decides: 0, a
    negative one and one below the normal floats."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    boxes = _hbb_boxes(gen, 8, 2000, cuda)
    iou = hik.hbb_iou_ref(boxes, boxes)
    picks = iou[(iou > 0.05) & (iou < 0.95)]
    picks = picks[torch.randint(0, picks.numel(), (6,), generator=gen,
                                device=cuda)].cpu()
    thrs = torch.cat([picks, torch.nextafter(picks, torch.ones_like(picks)),
                      torch.nextafter(picks, torch.zeros_like(picks))])
    for thr in thrs.tolist() + [0.0, -0.5, 1e-40]:
        got = hik.hbb_nms_mask(boxes, thr)
        ref = hik.hbb_nms_mask_ref(boxes, thr)
        assert torch.equal(got, ref), thr


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("b,n", MASK_SHAPES)
def test_rotated_nms_mask_kernel(cuda, b, n, banded):
    """Banded: 26 classes shifted apart by up to 1e5 px (the multi-class
    NMS's offset, where fp32 steps by 0.008 px), the last eighth inert.
    Pairs of one box of no size and one real have no defined IoU and are
    left out."""
    gen = torch.Generator(device=cuda).manual_seed(3 * n + b)
    boxes = _rboxes(gen, b, n, cuda)
    groups = None
    if banded:
        groups = torch.sort(torch.randint(0, 26, (b, n), generator=gen,
                                          device=cuda), dim=-1).values.int()
        boxes[..., :2] += (groups * 4000.0)[..., None]
        groups[:, n - n // 8:] = rik.INERT_GROUP
    name = "rotated_nms_mask" + ("_banded" if banded else "")
    build.reset_launches()
    got = rik.rotated_nms_mask(boxes, 0.1, groups)
    assert build.LAUNCHES[name] == 1
    assert sum(build.LAUNCHES.values()) == 1
    ref = torch.cat([rik.rotated_nms_mask_ref(
        boxes[i:i + 1], 0.1, None if groups is None else groups[i:i + 1])
        for i in range(b)])
    torch.cuda.synchronize()
    assert got.shape == (b, n, -(-n // 32)) and got.dtype == torch.int32
    ok = _both_real_or_both_empty(boxes)
    assert torch.equal(_mask_bits(got, n, ok), _mask_bits(ref, n, ok))
    if n >= 2000:
        assert int(_mask_bits(ref, n, ok).sum()) > b * n // 20
    if banded:                      # nothing across groups, nothing inert
        bits = _mask_bits(got, n)
        same = (groups[:, :, None] == groups[:, None, :]) & \
            (groups[:, :, None] < rik.INERT_GROUP)
        assert not bool((bits & ~same).any())


def _edge_cases(device, n_cls=26, offset=0.0):
    """Rotated boxes the separation test must leave to the exact pair
    function, or decide right: pairs sharing an edge (axis-aligned and
    rotated), pairs apart by gaps around the test's margin (0 to 0.1 px),
    duplicates, boxes of no size or of tiny size, each group shifted by
    ``offset`` px (the multi-class NMS's class offsets)."""
    rows = []
    for k, ang in enumerate((0.0, 0.3, -1.2, 1.5707964)):
        x, y, w, h = 60.0 + 150 * k, 80.0, 30.0 + 7 * k, 12.0 + 3 * k
        ca, sa = float(np.cos(ang)), float(np.sin(ang))
        rows.append([x, y, w, h, ang])
        rows.append([x + w * ca, y + w * sa, w, h, ang])        # shares an edge
        rows.append([x - h * sa, y + h * ca, w, h, ang])        # the other one
        for gap in (0.0, 1e-4, 1e-3, 2e-3, 1e-2, 0.1):
            rows.append([x + (w + gap) * ca, y + (w + gap) * sa + 300, w, h,
                         ang])
            rows.append([x, y + 300, w, h, ang])
        rows.append([x, y, w, h, ang])                          # duplicate
        rows.append([x + 5, y, 0.0, h, ang])                    # no width
        rows.append([x, y + 5, 1e-3, 1e-3, ang])                # tiny
    boxes = torch.tensor(rows, device=device, dtype=torch.float32)
    groups = (torch.arange(boxes.shape[0], device=device) * n_cls
              // boxes.shape[0]).int()
    boxes[:, :2] += (groups.float() * offset)[:, None]
    return boxes, groups


@pytest.mark.parametrize("offset", [0.0, 4000.0])
def test_rotated_nms_mask_at_the_threshold(cuda, offset):
    """Rows 5 and 6's mask mode decides most pairs without the pair
    function (boxes apart by more than a margin have IoU +0) and the rest
    with it. Thresholds equal to IoUs that occur, and the floats beside
    them, on clustered boxes with class offsets, boxes of no size, and
    boxes sharing an edge or apart by gaps around the margin: every bit,
    and the keeps, as the plain version's; thresholds where only the
    comparison with 0 decides (0, negative) too."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    boxes = _rboxes(gen, 4, 1000, cuda)
    edge, egroups = _edge_cases(cuda, offset=offset)
    groups = torch.sort(torch.randint(0, 26, (4, 1000), generator=gen,
                                      device=cuda), dim=-1).values.int()
    boxes[..., :2] += (groups * offset)[..., None]
    boxes[:, :edge.shape[0]] = edge
    groups[:, :edge.shape[0]] = egroups
    groups = torch.sort(groups, dim=-1).values
    ok = _both_real_or_both_empty(boxes)
    iou = rik.rotated_iou_ref(boxes, boxes)
    picks = iou[ok & (iou > 0.02) & (iou < 0.98)]
    picks = picks[torch.randint(0, picks.numel(), (5,), generator=gen,
                                device=cuda)].cpu()
    thrs = torch.cat([picks, torch.nextafter(picks, torch.ones_like(picks)),
                      torch.nextafter(picks, torch.zeros_like(picks))])
    n = boxes.shape[1]
    # boxes of no size are not eligible: the undefined pairs reach no keep
    elig = (torch.rand(4, n, generator=gen, device=cuda) < 0.9) & \
        (boxes[..., 2] * boxes[..., 3] > 0)
    for thr in thrs.tolist() + [0.1, 0.0, -0.5]:
        for grp in (None, groups):
            got = rik.rotated_nms_mask(boxes, thr, grp)
            ref = rik.rotated_nms_mask_ref(boxes, thr, grp)
            assert torch.equal(_mask_bits(got, n, ok), _mask_bits(ref, n, ok)
                               ), (thr, grp is None)
            keep = nkk.nms_keep(got, elig)
            assert torch.equal(keep, nkk.nms_keep(ref, elig)), thr


def test_rotated_iou_assigner_batched(cuda):
    """The R-CNN assigner's matrix mode at its batched train-step shape:
    the gts and 2000 proposals of 2 images against their 16 gts, one
    launch, every IoU equal to the plain version's (the assigner thresholds
    them and takes their argmax), boxes apart from their gts decided +0
    without the pair function; and each image's slice equal to a launch of
    that image alone."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    cands = _rboxes(gen, 2, 16 + 2000, cuda, span=800.0)
    cands[:, 16:200] = cands[:, :16].repeat(1, 12, 1)[:, :184] + \
        torch.randn(2, 184, 5, generator=gen, device=cuda) * 4
    edge, _ = _edge_cases(cuda)
    cands[:, 300:300 + edge.shape[0]] = edge
    gts = cands[:, :16]
    build.reset_launches()
    got = rik.rotated_iou(cands, gts)
    assert build.LAUNCHES["rotated_iou"] == 1
    ref = rik.rotated_iou_ref(cands, gts)
    torch.cuda.synchronize()
    ok = _both_real_or_both_empty(cands)[:, :, :16]
    assert torch.equal(got * ok, ref * ok)
    assert int(((ref > 0.5) & ok).sum()) > 16
    for i in range(2):
        assert torch.equal(rik.rotated_iou(cands[i], gts[i]), got[i])


# n = 30000 is past two staged steps in shared memory: rows read from
# device memory
KEEP_CASES = [(b, n, d) for b, n in ((1, 1), (8, 31), (40, 33), (8, 2000),
                                     (40, 2000), (1, 4000))
              for d in (0.001, 0.01, 0.3, "real")] + [(1, 30000, 0.001)]


@pytest.mark.parametrize("b,n,density", KEEP_CASES)
def test_nms_keep_kernel(cuda, b, n, density):
    """Random bits, the lower triangle too (never read), or the hbb
    kernel's own."""
    gen = torch.Generator(device=cuda).manual_seed(n + b)
    if density == "real":
        mask = hik.hbb_nms_mask(_hbb_boxes(gen, b, n, cuda), 0.6)
    else:
        bits = torch.rand(b, n, n, generator=gen, device=cuda) < density
        mask = nkk.pack_bits(bits)
        del bits
    elig = torch.rand(b, n, generator=gen, device=cuda) < 0.9
    build.reset_launches()
    keep = nkk.nms_keep(mask, elig)
    again = nkk.nms_keep(mask, elig)
    assert build.LAUNCHES["nms_keep"] == 2
    ref = nkk.nms_keep_ref(mask, elig)
    torch.cuda.synchronize()
    assert keep.dtype == torch.bool and keep.shape == (b, n)
    assert torch.equal(keep, ref)
    assert torch.equal(keep, again)
    assert not bool((keep & ~elig).any())


def _nms_calls(gen, device):
    """Each NMS function of ops/nms.py on inputs on the card, as the main
    path calls them (batched, 2000 candidates)."""
    b, n = 4, 2000
    hbb = _hbb_boxes(gen, b, n, device)
    obb = _rboxes(gen, b, n, device)
    scores = torch.rand(b, n, generator=gen, device=device)
    cls = torch.randint(0, 26, (b, n), generator=gen, device=device)
    multi = torch.rand(b, n // 4, 27, generator=gen, device=device)
    dets = [torch.cat([obb[:1], scores[:1, :, None]], -1)] * 2
    return {
        "nms": lambda: nms_mod.nms(hbb, scores, 0.6, 100, 0.05),
        "batched_nms": lambda: nms_mod.batched_nms(hbb, scores, cls, 0.6,
                                                   100),
        "multiclass_nms": lambda: nms_mod.multiclass_nms(
            hbb[:, :n // 4], multi, 0.05, 0.6, 100),
        "nms_rotated": lambda: nms_mod.nms_rotated(obb, scores, 0.1, 2000),
        "nms_rotated_grouped": lambda: nms_mod.nms_rotated(
            obb, scores, 0.1, 2000, 0.05, groups=cls),
        "multiclass_nms_rotated": lambda: nms_mod.multiclass_nms_rotated(
            obb[:, :n // 4], multi, 0.05, 0.1, 2000),
        "aug_multiclass_nms_rotated": lambda:
            nms_mod.aug_multiclass_nms_rotated(
                dets, [cls[:1]] * 2, [scores[:1] > 0.1] * 2, 0.1, 2000),
    }


def test_nms_functions_make_no_host_sync(cuda):
    """Every NMS function runs under ``set_sync_debug_mode("error")``: a
    synchronising call (``.item()``, ``bool()`` of a card tensor, a copy to
    the host) would raise. The results equal an earlier run's."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    calls = _nms_calls(gen, cuda)
    first = {k: fn() for k, fn in calls.items()}      # builds and warms up
    torch.cuda.synchronize()
    build.reset_launches()
    try:
        torch.cuda.set_sync_debug_mode("error")
        second = {k: fn() for k, fn in calls.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["nms_keep"] == len(calls)
    for k in calls:
        for a, c in zip(first[k], second[k]):
            assert torch.equal(a, c), k
        assert int(first[k][-1].sum()) > 0, k


def _pyramid(gen, b, size, c, dtype, device):
    return [_rand(gen, b, size // s, size // s, c, dtype=dtype,
                  device=device) for s in (4, 8, 16, 32, 64)]


def _rois(gen, b, n, size, device):
    """RoIs over all four levels, rotated, some crossing the border, some
    far outside, some of no size."""
    u = lambda *s: torch.rand(*s, generator=gen, device=device)  # noqa: E731
    side = 8 * 2 ** (u(n) * 6.5)                     # 8 .. ~720 px
    aspect = 2 ** ((u(n) - 0.5) * 3)
    rois = torch.stack([
        torch.randint(0, b, (n,), generator=gen, device=device).float(),
        (u(n) * 1.2 - 0.1) * size, (u(n) * 1.2 - 0.1) * size,
        side * aspect, side / aspect, (u(n) - 0.5) * 3.1], -1)
    rois[::11, 1:] = 0.0
    rois[5::50, 1:3] = -3.0 * size
    return rois


# C = 34: a pixel is not a multiple of 16 bytes (reads of a channel pair)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,size,c", [(1, 50, 128, 32), (3, 777, 320, 64),
                                        (8, 4000, 800, 256),
                                        (2, 300, 256, 34)])
def test_roi_align_rotated_kernel(cuda, dtype, b, n, size, c):
    gen = torch.Generator(device=cuda).manual_seed(n)
    feats = _pyramid(gen, b, size, c, dtype, cuda)
    rois = _rois(gen, b, n, size, cuda)
    lvls = route_levels(rois)
    assert set(lvls.tolist()) == {0, 1, 2, 3}
    build.reset_launches()
    got = rak.roi_align_rotated_pyramid_fused(feats, rois)
    assert build.LAUNCHES["roi_align_rotated"] == 1
    ref = roi_align_rotated_pyramid(feats, rois, lvls, 7)
    _check(got, ref, dtype)
    assert float(got[5::50].abs().max()) == 0.0      # far outside: zeros
    assert torch.equal(got, rak.roi_align_rotated_pyramid_fused(feats, rois))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_rotated_footprints(cuda, dtype):
    """Every RoI on the finest level, at C = 256: small RoIs whose whole
    footprint fits the shared-memory stage and larger ones that read their
    taps from device memory (``chip_smoke.align_read_model`` counts each
    kind from the plain geometry); both match the plain version,
    bit-equal across runs."""
    from chip_smoke import align_read_model
    from sm3det_tpu_torch.ops.roi_align_rotated import sample_taps
    gen = torch.Generator(device=cuda).manual_seed(5)
    feats = _pyramid(gen, 2, 800, 256, dtype, cuda)
    rois = _rois(gen, 2, 600, 800, cuda)
    rois[:8, 1:] = torch.tensor([40.0, 40.0, 12.0, 10.0, 0.3], device=cuda)
    lvls = torch.zeros(rois.shape[0], dtype=torch.int32, device=cuda)
    got = rak._launch(feats, rois, lvls, 7, (4, 8, 16, 32), 2)
    ref = roi_align_rotated_pyramid(feats, rois, lvls, 7)
    _check(got, ref, dtype)
    assert torch.equal(got, rak._launch(feats, rois, lvls, 7, (4, 8, 16, 32),
                                        2))
    m = align_read_model(torch, sample_taps, feats, rois, lvls)
    assert m["staged"] >= 8 and m["unstaged"] > 0, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "one_centre", "long_thin"])
@pytest.mark.parametrize("b,n,size,c", [(1, 50, 128, 32), (2, 1024, 800, 256)])
def test_roi_align_rotated_bwd_kernel(cuda, dtype, case, b, n, size, c):
    """Row 8: the gather kernels against autograd of the plain align, and
    two launches bit-equal (every element summed in one fixed order, no
    atomics). fp32: 1e-4 of the scale (another summation order); bf16:
    both round the fp32 sum once (2^-6). ``one_centre``: every RoI on one
    point, so every RoI meets the same tiles; ``long_thin``: RoIs of aspect
    up to 1:40, routed by area to fine levels where they cross many
    tiles."""
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    rois = _rois(gen, b, n, size, cuda)
    if case == "one_centre":
        rois[:, 0] = 0.0
        rois[:, 1:3] = size / 2
        rois[:, 3:5] = 24 + torch.rand(n, 2, generator=gen, device=cuda) * 36
    elif case == "long_thin":
        rois[:, 3] = size * (0.2 + 0.6 * torch.rand(n, generator=gen,
                                                    device=cuda))
        rois[:, 4] = rois[:, 3] / (4 + 36 * torch.rand(n, generator=gen,
                                                       device=cuda))
    lvls = route_levels(rois)
    shapes = [(b, size // s, size // s, c) for s in (4, 8, 16, 32)]
    g = _rand(gen, n, 7, 7, c, dtype=dtype)
    build.reset_launches()
    got = rak.roi_align_rotated_pyramid_bwd(g, rois, lvls, shapes, dtype)
    again = rak.roi_align_rotated_pyramid_bwd(g, rois, lvls, shapes, dtype)
    assert build.LAUNCHES["roi_align_rotated_bwd"] == 2
    ref = rak.roi_align_rotated_pyramid_bwd_ref(g, rois, lvls, shapes, dtype)
    for a, a2, r in zip(got, again, ref):
        _check(a, r, dtype)
        assert torch.equal(a, a2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,offset", [(34, 0), (6, 0), (256, 2), (256, 1)])
def test_roi_align_rotated_bwd_unaligned(cuda, dtype, c, offset):
    """Row 8 off the train step's layout: C not a multiple of 8 (g rows
    copied by cp.async in channel pairs, partial lanes, gradient stored
    by pairs) and g an offset view of a larger buffer (rows not 16-byte
    aligned; an odd offset is copied by the wrapper first), against the
    plain version with the tolerance of the test above, two launches
    bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(c + offset)
    b, n, size = 1, 50, 128
    rois = _rois(gen, b, n, size, cuda)
    lvls = route_levels(rois)
    shapes = [(b, size // s, size // s, c) for s in (4, 8, 16, 32)]
    flat = _rand(gen, n * 49 * c + offset, dtype=dtype)
    g = flat[offset:].view(n, 7, 7, c)
    assert g.data_ptr() % 16 or c % 8
    got = rak.roi_align_rotated_pyramid_bwd(g, rois, lvls, shapes, dtype)
    again = rak.roi_align_rotated_pyramid_bwd(g, rois, lvls, shapes, dtype)
    ref = rak.roi_align_rotated_pyramid_bwd_ref(g, rois, lvls, shapes, dtype)
    for a, a2, r in zip(got, again, ref):
        _check(a, r, dtype)
        assert torch.equal(a, a2)


def test_roi_align_autograd_on_the_card(cuda):
    """The autograd.Function: one forward and one backward launch, and the
    feature gradient equals the host's autograd of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    feats = [f.requires_grad_(True)
             for f in _pyramid(gen, 2, 320, 64, torch.float32, cuda)]
    rois = _rois(gen, 2, 500, 320, cuda)
    g = _rand(gen, 500, 7, 7, 64)
    build.reset_launches()
    out = rak.roi_align_rotated_pyramid_fused(feats, rois)
    got = torch.autograd.grad(out, feats[:4], g)
    assert build.LAUNCHES["roi_align_rotated"] == 1
    assert build.LAUNCHES["roi_align_rotated_bwd"] == 1
    host = [f.detach().cpu().requires_grad_(True) for f in feats]
    ref = torch.autograd.grad(
        rak.roi_align_rotated_pyramid_fused(host, rois.cpu()), host[:4],
        g.cpu())
    for a, r in zip(got, ref):
        _check(a.cpu(), r, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c", DWCONV_SHAPES)
def test_dwconv_ln_train(cuda, dtype, b, hw, c):
    """Row 10: the kernel forward and the backward kernels against the
    plain fp32 formulation's autograd and the closed-form plain backward;
    two backward runs give the same bits; one count a backward."""
    gen = torch.Generator(device=cuda).manual_seed(c * 7 + b)
    ins = [t.requires_grad_(True)
           for t in _dwconv_inputs(gen, b, hw, c, dtype)]
    g = _rand(gen, *ins[0].shape, dtype=dtype)
    build.reset_launches()
    out = cbk.fused_dwconv_ln_train(*ins)
    got = torch.autograd.grad(out, ins, g)
    assert build.LAUNCHES["fused_dwconv_ln_train"] == 1
    assert build.LAUNCHES["fused_dwconv_ln_train_bwd"] == 1
    again = torch.autograd.grad(cbk.fused_dwconv_ln_train(*ins), ins, g)
    assert build.LAUNCHES["fused_dwconv_ln_train_bwd"] == 2
    for a, r in zip(got, again):
        assert torch.equal(a, r)
    ref_out = cbk.dwconv_ln_ref(*ins)
    ref = torch.autograd.grad(ref_out, ins, g)
    closed = cbk.dwconv_ln_bwd_ref(*[t.detach() for t in ins], g)
    _check(out, ref_out, dtype)
    for a, r, r2 in zip(got, ref, closed):
        _check(a, r, dtype)
        _check(a, r2, dtype)


def test_dwconv_ln_train_needs_some_grads(cuda):
    """Inputs that need no gradient get None, the others the kernels'."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    ins = _dwconv_inputs(gen, 2, (9, 13), 36, torch.bfloat16)
    ins[1].requires_grad_(True)
    ins[3].requires_grad_(True)
    g = _rand(gen, *ins[0].shape, dtype=torch.bfloat16)
    cbk.fused_dwconv_ln_train(*ins).backward(g)
    assert ins[0].grad is None and ins[2].grad is None
    closed = cbk.dwconv_ln_bwd_ref(*ins, g)
    _check(ins[1].grad, closed[1], torch.bfloat16)
    _check(ins[3].grad, closed[3], torch.bfloat16)


def test_forward_only_kernels_refuse_grad_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = _block_args(gen, 1, 9, 40, torch.float32)
    a["w1"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        cbk.fused_convnext_block(**a)
    with pytest.raises(RuntimeError, match="no backward"):
        cbk.fused_layernorm(a["x"], a["lns"], a["lnb"].requires_grad_(True))
    with torch.no_grad():
        cbk.fused_convnext_block(**a)


def _small_cfg(dtype=None):
    cfg = copy.deepcopy(DEFAULT_MODEL_CFG)
    cfg["backbone"].update(arch="atto", moe_block_inds=((), (), (0,), ()),
                           num_experts=4, top_k=2)
    cfg["neck"].update(in_channels=(40, 80, 160, 320), out_channels=32)
    cfg["sar"].update(nms_pre=50, max_per_img=10)
    cfg["rgb"].update(rpn_nms_pre=50, rpn_max=40, rcnn_max=10)
    if dtype:
        cfg["compute_dtype"] = dtype
    return cfg


def test_sar_slice_card_matches_host(cuda):
    """fp32: the kernels on the card against the plain versions on the host,
    stage by stage, then the detections from the same head outputs."""
    card = TriSourceDetector(_small_cfg(), seed=0)
    card.sar_bbox_head.gfl_cls.bias.fill_(0.5)
    host = TriSourceDetector(_small_cfg(), device="cpu", seed=0)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    imgs = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    cls_d, reg_d = card.head_sar(imgs)
    cls_h, reg_h = host.head_sar(imgs)
    for a, b in zip(cls_d + reg_d, cls_h + reg_h):
        _check(a.cpu(), b, torch.float32)
    dets_d = card.get_bboxes_sar(cls_d, reg_d, (64, 64))
    dets_h = host.get_bboxes_sar([c.cpu() for c in cls_d],
                                 [r.cpu() for r in reg_d], (64, 64))
    assert int(dets_h[2].sum()) > 0
    assert torch.equal(dets_d[2].cpu(), dets_h[2])
    assert torch.equal(dets_d[1].cpu(), dets_h[1])
    assert (dets_d[0].cpu() - dets_h[0]).abs().max().item() <= 1e-4


def test_sar_slice_bf16_goes_through_every_kernel(cuda):
    model = TriSourceDetector(_small_cfg("bfloat16"), seed=0)
    model.sar_bbox_head.gfl_cls.bias.fill_(0.5)
    imgs = torch.rand(2, 64, 64, 3, device=cuda)
    build.reset_launches()
    dets, labels, valid = model.simple_test(imgs, "sar", img_shape=(64, 64))
    torch.cuda.synchronize()
    # atto: 2+2+6+2 blocks, one of them MoE; the stem, 3 downsample and 4
    # output LayerNorms
    assert build.LAUNCHES == {"dwconv_ln": 12, "fused_convnext_block": 11,
                              "moe_ffn_grouped": 1, "hbb_iou": 0,
                              "fused_layernorm": 8, "rotated_iou": 0,
                              "rotated_iou_banded": 0,
                              "roi_align_rotated": 0,
                              "roi_align_rotated_bwd": 0,
                              "fused_dwconv_ln_train": 0,
                              "fused_dwconv_ln_train_bwd": 0,
                              "hbb_nms_mask": 1, "rotated_nms_mask": 0,
                              "rotated_nms_mask_banded": 0, "nms_keep": 1}
    assert dets.shape == (2, 10, 5) and bool(torch.isfinite(dets).all())
    assert int(valid.sum()) > 0


def _spread_class_scores(model, imgs):
    """Random weights leave the softmax near 1/27, under the score
    threshold: scale fc_cls so that the R-CNN NMS has candidates."""
    x = model.neck_rcnn(model.extract_feat(imgs))
    props, _, _ = model.get_proposals(*model.head_rpn(x, "rgb"), (64, 64))
    feats = model.roi_feats(x, props)
    for head in (model.rgb_roi_head, model.ifr_roi_head):
        logits, _ = head(feats)
        head.fc_cls.weight.mul_(3.0 / logits.float().std().item())


def test_joint_slice_bf16_goes_through_every_kernel(cuda):
    model = TriSourceDetector(_small_cfg("bfloat16"), seed=0)
    model.sar_bbox_head.gfl_cls.bias.fill_(0.5)
    sar, rgb, ifr = (torch.rand(n, 64, 64, 3, device=cuda)
                     for n in (2, 2, 1))
    with torch.no_grad():
        _spread_class_scores(model, rgb)
    build.reset_launches()
    out = model.simple_test_joint(sar, rgb, ifr, img_shape=(64, 64))
    torch.cuda.synchronize()
    # one backbone pass; the SAR NMS and the RPN NMS of 3 images x 5
    # levels (horizontal masks), the R-CNN NMS (banded mask); a keep each
    assert build.LAUNCHES == {"dwconv_ln": 12, "fused_convnext_block": 11,
                              "moe_ffn_grouped": 1, "hbb_iou": 0,
                              "fused_layernorm": 8, "rotated_iou": 0,
                              "rotated_iou_banded": 0,
                              "roi_align_rotated": 1,
                              "roi_align_rotated_bwd": 0,
                              "fused_dwconv_ln_train": 0,
                              "fused_dwconv_ln_train_bwd": 0,
                              "hbb_nms_mask": 2, "rotated_nms_mask": 0,
                              "rotated_nms_mask_banded": 1, "nms_keep": 3}
    for (dets, labels, valid), shape in zip(out, ((2, 10, 5), (2, 10, 6),
                                                  (1, 10, 6))):
        assert dets.shape == shape and bool(torch.isfinite(dets).all())
        assert int(valid.sum()) > 0
    build.reset_launches()
    dets, _, valid = model.aug_test(rgb, "rgb", img_shape=(64, 64))
    torch.cuda.synchronize()
    assert build.LAUNCHES["rotated_nms_mask"] == 1     # the merge
    assert build.LAUNCHES["rotated_iou"] == 0
    assert dets.shape == (2, 10, 6) and int(valid.sum()) > 0


def test_rcnn_detections_card_matches_host(cuda):
    """fp32: detections from the same logits, the banded IoU kernel on the
    card against the plain version on the host."""
    card = TriSourceDetector(_small_cfg(), seed=0)
    host = TriSourceDetector(_small_cfg(), device="cpu", seed=0)
    rng = np.random.RandomState(3)
    n = 300
    rois = np.stack([rng.uniform(5, 59, n), rng.uniform(5, 59, n),
                     rng.uniform(6, 30, n), rng.uniform(6, 30, n),
                     rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)
    args = [torch.from_numpy(a)[None] for a in (
        rng.normal(0, 2.5, (n, 27)).astype(np.float32),
        rng.normal(0, 0.5, (n, 5)).astype(np.float32), rois,
        rng.rand(n) > 0.15)]
    det_h = host.get_bboxes_rcnn(*args, (64, 64), max_per_img=2000)
    det_d = card.get_bboxes_rcnn(*[a.cuda() for a in args], (64, 64),
                                 max_per_img=2000)
    assert 20 < int(det_h[2].sum()) < 2000
    assert torch.equal(det_d[2].cpu(), det_h[2])
    assert torch.equal(det_d[1].cpu(), det_h[1])
    assert (det_d[0].cpu() - det_h[0]).abs().max().item() <= 1e-4


def _train_batch(seed, comp=(2, 1, 1), img=64, g=4):
    rng = np.random.RandomState(seed)

    def common(n):
        return {"img": rng.rand(n, img, img, 3).astype(np.float32),
                "gt_labels": rng.randint(0, 26, (n, g)).astype(np.int32),
                "gt_mask": np.ones((n, g), bool)}

    cx, cy = rng.uniform(12, img - 12, (2, comp[0], g))
    w, h = rng.uniform(6, 20, (2, comp[0], g))
    sar = dict(common(comp[0]), gt_bboxes=np.stack(
        [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        .astype(np.float32))

    def obbs(n):
        return np.stack([rng.uniform(12, img - 12, (n, g)),
                         rng.uniform(12, img - 12, (n, g)),
                         rng.uniform(8, 20, (n, g)), rng.uniform(5, 9, (n, g)),
                         rng.uniform(-1.2, 1.2, (n, g))],
                        -1).astype(np.float32)

    return {"sar": sar, "rgb": dict(common(comp[1]), gt_obbs=obbs(comp[1])),
            "ifr": dict(common(comp[2]), gt_obbs=obbs(comp[2]))}


def test_train_forward_card_matches_host(cuda):
    """fp32 train forward + backward of a small model, card against host,
    the same host-made draws and the card's proposals (the proposal NMS is
    a discrete function of float noise): losses within 1e-3 relative, the
    gradient norm of every subtree within 1e-2."""
    from sm3det_tpu_torch.models.detectors import trisource as tri_mod
    from sm3det_tpu_torch.train.train_state import batch_to, trainable_params
    card = TriSourceDetector(_small_cfg(), seed=0, trainable=True)
    host = TriSourceDetector(_small_cfg(), device="cpu", seed=0,
                             trainable=True)
    batch = _train_batch(0)
    real, recorded = tri_mod.rpn_get_proposals, []

    def record(*a, **kw):
        recorded.append(real(*a, **kw))
        return recorded[-1]

    def replay(*a, **kw):
        return tuple(t.cpu() for t in recorded.pop(0))

    out = {}
    for name, m, dev, fn in (("card", card, cuda, record),
                             ("host", host, "cpu", replay)):
        params = trainable_params(m)
        tri_mod.rpn_get_proposals = fn
        try:
            losses = m(batch_to(batch, dev),
                       gen=torch.Generator().manual_seed(1))
        finally:
            tri_mod.rpn_get_proposals = real
        grads = torch.autograd.grad(sum(losses.values()),
                                    list(params.values()))
        norms = {}
        for n, gr in zip(params, grads):
            top = n.split(".")[0]
            norms[top] = norms.get(top, 0.0) + float(gr.double().pow(2).sum())
        out[name] = ({k: float(v.detach()) for k, v in losses.items()},
                     norms)
    for k, v in out["host"][0].items():
        assert abs(out["card"][0][k] - v) <= 1e-3 * abs(v) + 1e-7, k
    for k, v in out["host"][1].items():
        assert abs(out["card"][1][k] ** 0.5 - v ** 0.5) <= 1e-2 * v ** 0.5, k


def test_bf16_train_step_goes_through_the_train_kernels(cuda):
    from sm3det_tpu_torch.train.dla import make_dla_config
    from sm3det_tpu_torch.train.optim import make_optimizer
    from sm3det_tpu_torch.train.train_state import (batch_to,
                                                    build_train_step,
                                                    init_train_state,
                                                    trainable_params)
    model = TriSourceDetector(_small_cfg("bfloat16"), seed=0, trainable=True)
    init_fn, update_fn, _ = make_optimizer(
        list(trainable_params(model)), warmup_iters=1,
        dla_cfg=make_dla_config(warmup_iters=1))
    state = init_train_state(model, init_fn)
    step = build_train_step(model, update_fn)
    batch = batch_to(_train_batch(1), cuda)
    p0 = [p.detach().clone() for p in state.params.values()]
    for _ in range(2):
        build.reset_launches()
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert max(float((p.detach() - q).abs().max())
               for p, q in zip(state.params.values(), p0)) > 0
    # 12 atto blocks; rgb and infrared: one proposal NMS (mask and keep),
    # one align forward and backward, one rotated IoU an image (assigner)
    assert build.LAUNCHES["fused_dwconv_ln_train"] == 12
    assert build.LAUNCHES["fused_dwconv_ln_train_bwd"] == 12
    assert build.LAUNCHES["hbb_nms_mask"] == 2
    assert build.LAUNCHES["nms_keep"] == 2
    assert build.LAUNCHES["hbb_iou"] == 0
    assert build.LAUNCHES["rotated_iou"] == 2
    assert build.LAUNCHES["roi_align_rotated"] == 2
    assert build.LAUNCHES["roi_align_rotated_bwd"] == 2
    for k in ("dwconv_ln", "fused_convnext_block", "moe_ffn_grouped",
              "fused_layernorm"):
        assert build.LAUNCHES[k] == 0, k


# ---- the eval's IoU: row 5's grouped matrix mode at eval shapes -------------

def _eval_blocks(gen, b, n, g, classes, device):
    """Detections (b, n, 5) near gts (b, g, 5), both sorted by a class of
    ``classes`` with some classes absent, padded to full size with
    INERT_GROUP rows; per image a different fill, one image with no
    detections where b > 1."""
    dets = torch.zeros(b, n, 5, device=device)
    gts = torch.zeros(b, g, 5, device=device)
    dg = torch.full((b, n), rik.INERT_GROUP, dtype=torch.int32,
                    device=device)
    gg = torch.full((b, g), rik.INERT_GROUP, dtype=torch.int32,
                    device=device)
    present = torch.randperm(classes, generator=torch.Generator(
        device="cpu").manual_seed(n * 7 + g))[:max(classes // 2, 1)]
    for i in range(b):
        nd = 0 if (b > 1 and i == 1) else max(n - 3 * i, 1)
        ng = max(g - i, 1)
        gt = _rboxes(gen, 1, ng, device, span=600.0)[0]
        gt[:, 2:4] = gt[:, 2:4].clamp(min=4.0)
        gts[i, :ng] = gt
        gc = present[torch.randint(0, len(present), (ng,), generator=gen,
                                   device=device).cpu()].to(device)
        gc, order = torch.sort(gc)
        gts[i, :ng] = gt[order]
        gg[i, :ng] = gc.int()
        if nd:
            pick = torch.randint(0, ng, (nd,), generator=gen, device=device)
            d = gts[i, pick] + torch.randn(nd, 5, generator=gen,
                                           device=device) * \
                torch.tensor([3.0, 3.0, 2.0, 2.0, 0.05], device=device)
            d[:, 2:4] = d[:, 2:4].clamp(min=1.0)
            dc, order = torch.sort(gg[i, pick])
            dets[i, :nd] = d[order]
            dg[i, :nd] = dc
    return dets, gts, dg, gg


@pytest.mark.parametrize("n", [1, 37, 2000])
@pytest.mark.parametrize("g", [1, 5, 300])
def test_rotated_iou_grouped_at_eval_shapes(cuda, n, g):
    gen = torch.Generator(device=cuda).manual_seed(n + 10 * g)
    dets, gts, dg, gg = _eval_blocks(gen, 3, n, g, 26, cuda)
    build.reset_launches()
    got = rik.rotated_iou(dets, gts, groups1=dg, groups2=gg)
    assert build.LAUNCHES["rotated_iou_banded"] == 1
    ref = rik.rotated_iou_ref(dets, gts, groups1=dg, groups2=gg)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (3, n, g)
    same = (dg[:, :, None] == gg[:, None, :]) & \
        (dg[:, :, None] < rik.INERT_GROUP)
    assert int(same.sum()) > 0
    assert torch.equal(got[same], ref[same])        # bit for bit
    if n > 1:
        assert float(ref[same].max()) > 0.3         # real overlaps


def _eval_case(seed, n_img=16, nc=6):
    """Per image a per-class list of rotated detections near the gts and
    the annotations (with ignore gts on even images), in numpy."""
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for i in range(n_img):
        k = rng.randint(1, 12)
        gts = np.stack([rng.uniform(50, 700, k), rng.uniform(50, 700, k),
                        rng.uniform(10, 80, k), rng.uniform(6, 40, k),
                        rng.uniform(-1.5, 1.5, k)], -1).astype(np.float32)
        labels = rng.randint(0, nc, k)
        ann = dict(bboxes=gts, labels=labels)
        if i % 2 == 0:
            ann["bboxes_ignore"] = gts[:1] + 200
            ann["labels_ignore"] = labels[:1]
        per_class = []
        for c in range(nc):
            src = gts[labels == c]
            d = np.concatenate([
                np.repeat(src, 3, 0) + rng.normal(0, 2, (3 * len(src), 5)) *
                [1, 1, 1, 1, 0.03],
                np.stack([rng.uniform(50, 700, 2), rng.uniform(50, 700, 2),
                          rng.uniform(10, 80, 2), rng.uniform(6, 40, 2),
                          rng.uniform(-1.5, 1.5, 2)], -1)]).astype(np.float32)
            d[:, 2:4] = np.maximum(d[:, 2:4], 1.0)
            per_class.append(np.concatenate(
                [d, rng.rand(len(d), 1).astype(np.float32)], 1))
        dets.append(per_class)
        anns.append(ann)
    return dets, anns


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_rbbox_map_on_the_card_equals_the_host(cuda, seed):
    from sm3det_tpu_torch.core.evaluation.eval_map import eval_rbbox_map
    dets, anns = _eval_case(seed)
    build.reset_launches()
    card = eval_rbbox_map(dets, anns, logger=None, device=cuda)
    assert build.LAUNCHES["rotated_iou_banded"] == 1     # one chunk
    host = eval_rbbox_map(dets, anns, logger=None, device="cpu")
    assert card == host
    assert 0.1 < card["mAP50"] <= 1.0
    hb = [[np.concatenate([d[:, :2] - 10, d[:, :2] + 10, d[:, 5:]], 1)
           for d in img] for img in dets]
    hann = [dict(bboxes=np.concatenate([a["bboxes"][:, :2] - 10,
                                        a["bboxes"][:, :2] + 10], 1),
                 labels=a["labels"]) for a in anns]
    build.reset_launches()
    card4 = eval_rbbox_map(hb, hann, box_dim=4, logger=None, device=cuda)
    assert build.LAUNCHES["hbb_iou"] == 1
    assert card4 == eval_rbbox_map(hb, hann, box_dim=4, logger=None,
                                   device="cpu")


@pytest.mark.parametrize("path", ["configs/local_configs/SM3Det_lsk_t.py",
                                  "configs/local_configs/SM3Det_van_t.py"])
def test_lsk_van_joint_bf16_makes_no_host_sync(cuda, path):
    """The LSK-T / VAN-T configs at full width, a bf16 joint forward over
    [2 : 1 : 1] x 800^2 under ``set_sync_debug_mode("error")``: no host
    synchronisation (the linear experts' capacity dispatch included), the
    LayerNorms through the kernel, the outputs equal an earlier run's."""
    from sm3det_tpu_torch.models.builder import build_detector
    from sm3det_tpu_torch.utils.config import Config
    model = build_detector(Config.fromfile(path).model, device=cuda,
                           compute_dtype="bfloat16", seed=0)
    model.sar_bbox_head.gfl_cls.bias.fill_(0.0)
    gen = torch.Generator(device=cuda).manual_seed(11)
    imgs = [torch.rand(n, 800, 800, 3, generator=gen, device=cuda)
            for n in (2, 1, 1)]
    first = model.simple_test_joint(*imgs)
    torch.cuda.synchronize()
    build.reset_launches()
    try:
        torch.cuda.set_sync_debug_mode("error")
        second = model.simple_test_joint(*imgs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # 34 LayerNorms: a patch embed's, two a block and an output's a stage
    assert build.LAUNCHES["fused_layernorm"] == 34
    assert build.LAUNCHES["roi_align_rotated"] == 1
    assert build.LAUNCHES["moe_ffn_grouped"] == 0
    for a, b in zip(first, second):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert bool(torch.isfinite(second[0][0]).all())
    assert int(second[0][2].sum()) > 0


# ---- the shapes of the TriSource variants and the zoo's detectors ----------

# the H2 SAR RPN at 800^2: min(1000, level) candidates of five levels
H2_RPN_N = 4 * 1000 + 13 * 13 * 3


def test_hbb_nms_mask_and_keep_at_the_h2_rpn_size(cuda):
    """Row 4's mask mode and the keep scan at the H2 SAR RPN's n = 4507
    candidates an image, the train step's 2 SAR images: the bits equal the
    plain version's, the keeps equal the plain greedy keep and two runs."""
    gen = torch.Generator(device=cuda).manual_seed(4507)
    boxes = _hbb_boxes(gen, 2, H2_RPN_N, cuda)
    build.reset_launches()
    got = hik.hbb_nms_mask(boxes, 0.7)
    assert build.LAUNCHES["hbb_nms_mask"] == 1
    ref = hik.hbb_nms_mask_ref(boxes, 0.7)
    torch.cuda.synchronize()
    assert got.shape == (2, H2_RPN_N, 141)
    assert torch.equal(got, ref)
    elig = torch.rand(2, H2_RPN_N, generator=gen, device=cuda) < 0.95
    keep = nkk.nms_keep(got, elig)
    assert torch.equal(keep, nkk.nms_keep_ref(ref, elig))
    assert torch.equal(keep, nkk.nms_keep(got, elig))
    assert 0 < int(keep.sum()) < int(elig.sum())


@pytest.mark.parametrize("g", [512, 256])
def test_rotated_iou_at_the_retina_assigner(cuda, g):
    """Row 5's matrix mode at the rotated RetinaNet assigner's shape: the
    120087 anchors of an 800^2 image against G padded gts (512 a DOTA
    image, 256 an infrared one), one launch through
    ``box_iou_rotated_chunked``, every defined IoU equal to the plain
    version's."""
    from sm3det_tpu_torch.models.dense_heads.rotated_retina_head import \
        make_retina_anchor_generator
    from sm3det_tpu_torch.ops.rotated_iou import box_iou_rotated_chunked
    gen = torch.Generator(device=cuda).manual_seed(g)
    sizes = [(s, s) for s in (100, 50, 25, 13, 7)]
    anchors = torch.cat(make_retina_anchor_generator().grid_anchors(
        sizes, device=cuda))[None]
    assert anchors.shape == (1, 120087, 5)
    gts = _rboxes(gen, 1, g, cuda, span=800.0)
    build.reset_launches()
    got = box_iou_rotated_chunked(anchors, gts)
    assert build.LAUNCHES["rotated_iou"] == 1
    ref = rik.rotated_iou_ref(anchors, gts)
    torch.cuda.synchronize()
    real_a = (anchors[..., 2] * anchors[..., 3]) > 0
    real_g = (gts[..., 2] * gts[..., 3]) > 0
    ok = real_a[..., :, None] == real_g[..., None, :]
    assert torch.equal(got * ok, ref * ok)
    assert int(((ref > 0.5) & ok).sum()) > g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_on_horizontal_integer_rois(cuda, dtype):
    """Rows 7 and 8 on the H2 SAR branch's RoIs: axis-aligned boxes with
    integer edges (angle 0, through ``hbb_to_roi5``), where bilinear taps
    land on pixel edges, 256 an image for 2 images, at C = 256: the
    forward and the feature gradient against the plain versions, with the
    tolerance of the tests above, two launches bit-equal."""
    from sm3det_tpu_torch.models.roi_heads.standard_roi_head import \
        hbb_to_roi5
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, n, size, c = 2, 512, 800, 256
    x1y1 = torch.randint(-20, size - 16, (n, 2), generator=gen, device=cuda)
    wh = torch.randint(1, 400, (n, 2), generator=gen, device=cuda)
    hbb = torch.cat([x1y1, x1y1 + wh], -1).float()
    hbb[::17, 2:] = hbb[::17, :2]                  # no size
    rois = torch.cat([torch.arange(b, device=cuda).repeat_interleave(
        n // b).float()[:, None], hbb_to_roi5(hbb)], -1)
    assert bool((rois[:, 5] == 0).all())
    feats = _pyramid(gen, b, size, c, dtype, cuda)
    lvls = route_levels(rois)
    got = rak.roi_align_rotated_pyramid_fused(feats, rois)
    _check(got, roi_align_rotated_pyramid(feats, rois, lvls, 7), dtype)
    assert torch.equal(got, rak.roi_align_rotated_pyramid_fused(feats, rois))
    shapes = [(b, size // s, size // s, c) for s in (4, 8, 16, 32)]
    g = _rand(gen, n, 7, 7, c, dtype=dtype)
    bwd = rak.roi_align_rotated_pyramid_bwd(g, rois, lvls, shapes, dtype)
    again = rak.roi_align_rotated_pyramid_bwd(g, rois, lvls, shapes, dtype)
    ref = rak.roi_align_rotated_pyramid_bwd_ref(g, rois, lvls, shapes, dtype)
    for a, a2, r in zip(bwd, again, ref):
        _check(a, r, dtype)
        assert torch.equal(a, a2)
