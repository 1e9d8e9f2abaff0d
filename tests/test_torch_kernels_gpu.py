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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c", SHAPES)
def test_dwconv_ln_kernel(cuda, dtype, b, hw, c):
    gen = torch.Generator(device=cuda).manual_seed(c)
    a = _block_args(gen, b, hw, c, dtype)
    args = [a[k] for k in ("x", "dwk", "dwb", "lns", "lnb")]
    build.reset_launches()
    got = cbk.fused_dwconv_ln(*args)
    assert build.LAUNCHES["dwconv_ln"] == 1
    _check(got, cbk.dwconv_ln_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c", SHAPES)
def test_layernorm_kernel(cuda, dtype, b, hw, c):
    gen = torch.Generator(device=cuda).manual_seed(c + 2)
    a = _block_args(gen, b, hw, c, dtype)
    args = (a["x"] * 3 + 1, a["lns"], a["lnb"])
    build.reset_launches()
    got = cbk.fused_layernorm(*args)
    assert build.LAUNCHES["fused_layernorm"] == 1
    _check(got, cbk.layernorm_math(*args), dtype)


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


def _small_cfg(dtype=None):
    cfg = copy.deepcopy(DEFAULT_MODEL_CFG)
    cfg["backbone"].update(arch="atto", moe_block_inds=((), (), (0,), ()),
                           num_experts=4, top_k=2)
    cfg["neck"].update(in_channels=(40, 80, 160, 320), out_channels=32)
    cfg["sar"].update(nms_pre=50, max_per_img=10)
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
                              "moe_ffn_grouped": 1, "hbb_iou": 1,
                              "fused_layernorm": 8}
    assert dets.shape == (2, 10, 5) and bool(torch.isfinite(dets).all())
    assert int(valid.sum()) > 0
