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
from sm3det_tpu_torch.ops.cuda import roi_align_kernel as rak
from sm3det_tpu_torch.ops.cuda import rotated_iou_kernel as rik
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,size,c", [(1, 50, 128, 32), (3, 777, 320, 64),
                                        (8, 4000, 800, 256)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "one_centre"])
@pytest.mark.parametrize("b,n,size,c", [(1, 50, 128, 32), (2, 1024, 800, 256)])
def test_roi_align_rotated_bwd_kernel(cuda, dtype, case, b, n, size, c):
    """Row 8: the scatter kernel against autograd of the plain align. fp32
    atomics add in no fixed order (1e-4 of the scale); bf16 rounds the fp32
    sum once (2^-6). ``one_centre``: every RoI on one point, so every
    sample's taps collide."""
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    rois = _rois(gen, b, n, size, cuda)
    if case == "one_centre":
        rois[:, 0] = 0.0
        rois[:, 1:3] = size / 2
        rois[:, 3:5] = 24 + torch.rand(n, 2, generator=gen, device=cuda) * 36
    lvls = route_levels(rois)
    shapes = [(b, size // s, size // s, c) for s in (4, 8, 16, 32)]
    g = _rand(gen, n, 7, 7, c, dtype=dtype)
    build.reset_launches()
    got = rak.roi_align_rotated_pyramid_bwd(g, rois, lvls, shapes, dtype)
    assert build.LAUNCHES["roi_align_rotated_bwd"] == 1
    ref = rak.roi_align_rotated_pyramid_bwd_ref(g, rois, lvls, shapes, dtype)
    for a, r in zip(got, ref):
        _check(a, r, dtype)


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
@pytest.mark.parametrize("b,hw,c", SHAPES)
def test_dwconv_ln_train(cuda, dtype, b, hw, c):
    """Row 10: the kernel forward and the recomputing backward against the
    plain fp32 formulation and its autograd."""
    gen = torch.Generator(device=cuda).manual_seed(hw * c)
    a = _block_args(gen, b, hw, c, dtype)
    ins = [a[k].requires_grad_(True)
           for k in ("x", "dwk", "dwb", "lns", "lnb")]
    g = _rand(gen, b, hw, hw, c, dtype=dtype)
    build.reset_launches()
    out = cbk.fused_dwconv_ln_train(*ins)
    got = (out,) + torch.autograd.grad(out, ins, g)
    assert build.LAUNCHES["fused_dwconv_ln_train"] == 1
    ref_out = cbk.dwconv_ln_ref(*ins)
    ref = (ref_out,) + torch.autograd.grad(ref_out, ins, g)
    for x, r in zip(got, ref):
        _check(x, r, dtype)


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
                              "moe_ffn_grouped": 1, "hbb_iou": 1,
                              "fused_layernorm": 8, "rotated_iou": 0,
                              "rotated_iou_banded": 0,
                              "roi_align_rotated": 0,
                              "roi_align_rotated_bwd": 0,
                              "fused_dwconv_ln_train": 0}
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
    # one backbone pass; the SAR NMS and the RPN NMS of 3 images x 5 levels
    assert build.LAUNCHES == {"dwconv_ln": 12, "fused_convnext_block": 11,
                              "moe_ffn_grouped": 1, "hbb_iou": 2,
                              "fused_layernorm": 8, "rotated_iou": 0,
                              "rotated_iou_banded": 1,
                              "roi_align_rotated": 1,
                              "roi_align_rotated_bwd": 0,
                              "fused_dwconv_ln_train": 0}
    for (dets, labels, valid), shape in zip(out, ((2, 10, 5), (2, 10, 6),
                                                  (1, 10, 6))):
        assert dets.shape == shape and bool(torch.isfinite(dets).all())
        assert int(valid.sum()) > 0
    build.reset_launches()
    dets, _, valid = model.aug_test(rgb, "rgb", img_shape=(64, 64))
    torch.cuda.synchronize()
    assert build.LAUNCHES["rotated_iou"] == 1          # the merge
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
    # 12 atto blocks; rgb and infrared: one proposal NMS, one align
    # forward and backward, one rotated IoU an image
    assert build.LAUNCHES["fused_dwconv_ln_train"] == 12
    assert build.LAUNCHES["hbb_iou"] == 2
    assert build.LAUNCHES["rotated_iou"] == 2
    assert build.LAUNCHES["roi_align_rotated"] == 2
    assert build.LAUNCHES["roi_align_rotated_bwd"] == 2
    for k in ("dwconv_ln", "fused_convnext_block", "moe_ffn_grouped",
              "fused_layernorm"):
        assert build.LAUNCHES[k] == 0, k
