"""The port's rotated-box geometry against the JAX package, on the CPU.

Box conversions, the two decoders, the RPN anchors, the plain rotated IoU
(against the jnp function and against the Pallas kernel in interpret mode)
and the rotated NMS family. The same numpy arrays, made from a seed, go
through both packages at fp32. Tolerances: 1e-5 for elementwise geometry on
coordinates of a few hundred pixels, 2e-5 for the IoU (a quotient of sums
of cross products whose order differs between XLA and PyTorch).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from sm3det_tpu.core.anchor import AnchorGenerator as JaxAnchorGenerator
from sm3det_tpu.core.bbox import coders as jcoders
from sm3det_tpu.ops import box_convert as jbc
from sm3det_tpu.ops.pallas.rotated_iou_kernel import (
    INERT_GROUP as JAX_INERT, box_iou_rotated_pallas)
from sm3det_tpu.ops.rotated_iou import box_iou_rotated as jax_iou
from sm3det_tpu_torch.core.bbox import coders as tcoders
from sm3det_tpu_torch.models.detectors.trisource import (
    make_rcnn_coder, make_rpn_anchor_generator, make_rpn_coder)
from sm3det_tpu_torch.ops import box_convert as tbc
from sm3det_tpu_torch.ops import nms as tnms
from sm3det_tpu_torch.ops.cuda import rotated_iou_kernel as rik
from sm3det_tpu_torch.ops.rotated_iou import box_iou_rotated, obb_corners
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)

# the package re-exports the function nms under the module's name
jnms = importlib.import_module("sm3det_tpu.ops.nms")
PI = np.pi


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _obbs(rng, k, span=300.0, lo=4.0, hi=60.0):
    return np.stack([rng.uniform(0, span, k), rng.uniform(0, span, k),
                     rng.uniform(lo, hi, k), rng.uniform(lo, hi, k),
                     rng.uniform(-1.55, 1.55, k)], -1).astype(np.float32)


def _same_rectangles(got, ref, tol=1e-4):
    """Boxes equal as rectangles: where a near-tie (w ~ h, or an angle at
    the le90 wrap) lets the two sides pick the other description of the same
    rectangle, the fields differ but the aligned IoU is 1."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    close = np.abs(got - ref).max(-1) <= 1e-4 * np.maximum(
        1.0, np.abs(ref).max(-1))
    if close.all():
        return
    iou = np.asarray(jax_iou(got[~close], ref[~close], aligned=True))
    assert (iou >= 1 - tol).all(), (got[~close], ref[~close], iou)


# ---- box_convert -----------------------------------------------------------

@pytest.mark.parametrize("version", ["le90", "le135", "oc"])
def test_norm_angle_matches_jax(version):
    rng = np.random.RandomState(0)
    a = np.concatenate([rng.uniform(-7, 7, 200),
                        [-PI, -PI / 2, -PI / 4, 0, PI / 4, PI / 2,
                         3 * PI / 4, PI]]).astype(np.float32)
    got = tbc.norm_angle(_t(a), version).numpy()
    ref = np.asarray(jbc.norm_angle(a, version))
    # an angle one rounding step from the wrap may land on either end of
    # the range: compare modulo the period (none for 'oc')
    d = np.abs(got - ref)
    if version != "oc":
        d = np.minimum(d, np.abs(d - PI))
    assert d.max() <= 1e-5


def test_obb2poly_obb2xyxy_match_jax():
    rng = np.random.RandomState(1)
    b = _obbs(rng, 300)
    b[:4, 4] = [-PI / 2, PI / 2 - 1e-6, 0.0, PI / 4]
    b[4:8, 3] = b[4:8, 2]                                     # w == h
    np.testing.assert_allclose(tbc.obb2poly(_t(b)).numpy(),
                               np.asarray(jbc.obb2poly(b)), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(tbc.obb2xyxy(_t(b)).numpy(),
                               np.asarray(jbc.obb2xyxy(b)), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(obb_corners(_t(b)).numpy().reshape(-1, 8),
                               np.asarray(jbc.obb2poly(b)), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("version", ["le90", "le135"])
def test_poly2obb_matches_jax(version):
    rng = np.random.RandomState(2)
    b = _obbs(rng, 300)
    b[:6, 4] = [-PI / 2, PI / 2 - 1e-6, 0.0, PI / 4, -PI / 4, 1.0]
    b[6:12, 3] = b[6:12, 2]                                   # squares
    polys = np.asarray(jbc.obb2poly(b))
    got = tbc.poly2obb(_t(polys), version).numpy()
    ref = np.asarray(jbc.poly2obb(polys, version))
    _same_rectangles(got, ref)
    _same_rectangles(got, b)                                  # round trip
    # the oc convention, refused until the leftovers were ported, now
    # gives JAX's boxes too
    _same_rectangles(tbc.poly2obb(_t(polys), "oc").numpy(),
                     np.asarray(jbc.poly2obb(polys, "oc")))


# ---- coders ----------------------------------------------------------------

def test_midpoint_offset_decode_matches_jax():
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 200, (400, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(8, 120, (400, 2))],
                             -1).astype(np.float32)
    deltas = rng.normal(0, 0.7, (400, 6)).astype(np.float32)
    deltas[:5, 4:] = 0.0                  # no offset: axis-aligned, w ~ h ties
    deltas[5:10, 4:] = [3.0, -3.0]        # clipped at +-0.5 after the stds
    got = make_rpn_coder("le90").decode(_t(anchors), _t(deltas)).numpy()
    jc = jcoders.MidpointOffsetCoder("le90", (0.,) * 6,
                                     (1., 1., 1., 1., 0.5, 0.5))
    ref = np.asarray(jc.decode(anchors, deltas))
    assert got.shape == ref.shape == (400, 5)
    _same_rectangles(got, ref)
    # batched leading dimensions
    got_b = make_rpn_coder("le90").decode(
        _t(anchors).reshape(4, 100, 4), _t(deltas).reshape(4, 100, 6))
    np.testing.assert_array_equal(got_b.reshape(400, 5).numpy(), got)


@pytest.mark.parametrize("max_shape", [None, (256, 320)])
def test_delta_xywha_decode_matches_jax(max_shape):
    rng = np.random.RandomState(4)
    rois = _obbs(rng, 400)
    rois[:4, 4] = [-PI / 2, PI / 2 - 1e-6, 0.0, PI / 4]
    deltas = rng.normal(0, 1.0, (400, 5)).astype(np.float32)
    deltas[:8] = 0.0
    rois[4:8, 3] = rois[4:8, 2]           # gw == gh: the edge swap's tie
    deltas[8:12, 2:4] = 40.0              # clipped by wh_ratio_clip
    got = make_rcnn_coder("le90").decode(_t(rois), _t(deltas),
                                         max_shape=max_shape).numpy()
    jc = jcoders.DeltaXYWHAOBBoxCoder(
        "le90", (0.,) * 5, (0.1, 0.1, 0.2, 0.2, 0.1), edge_swap=True,
        proj_xy=True)
    ref = np.asarray(jc.decode(rois, deltas, max_shape=max_shape))
    _same_rectangles(got, ref)
    if max_shape:
        assert got[:, 0].max() <= max_shape[1] - 1
        assert got[:, 1].max() <= max_shape[0] - 1
    plain = tcoders.DeltaXYWHAOBBoxCoder("le90")              # no swap, proj
    ref = np.asarray(jcoders.DeltaXYWHAOBBoxCoder("le90").decode(
        rois, deltas * 0.1))
    _same_rectangles(plain.decode(_t(rois), _t(deltas * 0.1)).numpy(), ref)


def test_rpn_anchor_generator_matches_jax():
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    ours = make_rpn_anchor_generator((4, 8, 16, 32, 64))
    ref = JaxAnchorGenerator(strides=(4, 8, 16, 32, 64),
                             ratios=[0.5, 1.0, 2.0], scales=[8])
    got = ours.grid_anchors(sizes, device="cpu")
    want = ref.grid_anchors(sizes)
    assert len(got) == 5
    for g, w, (h, wd) in zip(got, want, sizes):
        assert g.shape == (h * wd * 3, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert ours.grid_anchors(sizes, device="cpu")[0] is got[0]   # cached


# ---- rotated IoU -----------------------------------------------------------

IOU_TOL = 2e-5


# the JAX reference jitted: one compile a shape and mode
_jit_iou = jax.jit(jax_iou, static_argnames=("mode", "aligned"))


def test_box_iou_rotated_matches_jax():
    rng = np.random.RandomState(5)
    b1, b2 = _obbs(rng, 300, span=200), _obbs(rng, 170, span=200)
    b2[:5] = b1[:5]                                           # identical
    got = box_iou_rotated(_t(b1), _t(b2), row_chunk=64).numpy()
    ref = np.asarray(_jit_iou(b1, b2))
    assert got.shape == (300, 170)
    assert np.abs(got - ref).max() <= IOU_TOL
    assert np.abs(got[:5, :5].diagonal() - 1).max() <= 1e-4   # self-IoU
    assert (got > 0.05).mean() > 0.02                         # real overlaps
    one = box_iou_rotated(_t(b1), _t(b2)).numpy()             # one chunk
    np.testing.assert_array_equal(one, got)
    for mode in ("iou", "iof"):
        g = box_iou_rotated(_t(b1[:170]), _t(b2), mode=mode,
                            aligned=True).numpy()
        r = np.asarray(_jit_iou(b1[:170], b2, mode=mode, aligned=True))
        assert g.shape == (170,) and np.abs(g - r).max() <= IOU_TOL
    g = box_iou_rotated(_t(b1), _t(b2), mode="iof").numpy()
    assert np.abs(g - np.asarray(_jit_iou(b1, b2, mode="iof"))).max() \
        <= IOU_TOL
    # leading batch dimensions
    gb = box_iou_rotated(_t(b1).reshape(2, 150, 5),
                         _t(b2[:160]).reshape(2, 80, 5)).numpy()
    assert np.abs(gb[1] - ref[150:, 80:160]).max() <= IOU_TOL
    with pytest.raises(ValueError):
        box_iou_rotated(_t(b1), _t(b2), mode="giou")


def test_box_iou_rotated_special_pairs():
    """Identical, touching, disjoint, contained and zero-size boxes."""
    b = np.array([[50, 50, 40, 20, 0.3],       # 0
                  [50, 50, 40, 20, 0.3],       # 1 identical to 0
                  [90, 50, 40, 20, 0.0],       # 2
                  [130.01, 50, 40, 20, 0.0],   # 3 beside 2, 0.01 px apart
                  [400, 400, 30, 30, 1.0],     # 4 disjoint from all
                  [50, 50, 10, 5, 0.3],        # 5 inside 0
                  [0, 0, 0, 0, 0],             # 6 zero size
                  [0, 0, 0, 0, 0],
                  [130, 50, 40, 20, 0.0]],     # 8 shares an edge with 2
                 np.float32)
    got = box_iou_rotated(_t(b), _t(b)).numpy()
    ref = np.asarray(jax_iou(b, b))
    assert np.isfinite(got).all()
    real = b[:, 2] * b[:, 3] > 0
    both = real[:, None] == real[None, :]
    # a zero-size box against a real one is rounding noise over a union
    # near 0 in both packages (finite, read by no caller): not compared.
    # Two boxes that share an edge exactly (2 and 8) count the shared edge
    # as inside, an open boundary piece whose Green's sum is not an area:
    # the JAX package's value, which the port reproduces (here > 1)
    assert np.abs((got - ref) * both).max() <= IOU_TOL
    assert abs(got[0, 1] - 1) <= 1e-4 and abs(got[2, 2] - 1) <= 1e-4
    assert got[2, 3] <= 1e-4 and got[4, :4].max() == 0.0
    assert abs(got[5, 0] - 50 / 800) <= 1e-4
    assert got[6, 7] == 0.0 and got[6, 6] == 0.0


def test_rotated_iou_ref_matches_pallas_interpret():
    """The plain version of the CUDA kernel against the TPU kernel run in
    interpret mode: dense, triu and group-banded."""
    rng = np.random.RandomState(6)
    n = 300
    # coordinates to 200 px: the Green's sums are cross products of corner
    # coordinates, so their rounding noise grows with the square of the span
    b = _obbs(rng, n, span=200, lo=8, hi=64)
    groups = np.sort(rng.randint(0, 5, n)).astype(np.int32)
    groups[-9:] = JAX_INERT
    assert rik.INERT_GROUP == JAX_INERT
    dense = np.asarray(box_iou_rotated_pallas(b, b, interpret=True))
    got = rik.rotated_iou(_t(b), _t(b)).numpy()
    assert np.abs(got - dense).max() <= IOU_TOL

    # triu: the tile is the kernel's own (32 here, 128 there); on and
    # above the diagonal of the larger tile both are computed
    tri = rik.rotated_iou(_t(b), _t(b), triu=True).numpy()
    ptri = np.asarray(box_iou_rotated_pallas(b, b, triu=True,
                                             interpret=True))
    iu = np.triu_indices(n)
    np.testing.assert_array_equal(tri[iu], got[iu])
    assert np.abs(tri[iu] - ptri[iu]).max() <= IOU_TOL
    il = np.tril_indices(n, k=-1)
    low = (il[1] // rik.TILE) < (il[0] // rik.TILE)
    assert np.abs(tri[il[0][low], il[1][low]]).max() == 0.0

    same = (groups[:, None] == groups[None, :]) & \
        (groups[:, None] < JAX_INERT)
    band = rik.rotated_iou(_t(b), _t(b), groups1=_t(groups),
                           groups2=_t(groups)).numpy()
    pband = np.asarray(box_iou_rotated_pallas(
        b, b, groups1=groups, groups2=groups, interpret=True))
    assert np.abs((band - pband) * same).max() <= IOU_TOL
    assert np.abs(band * ~(groups[:, None] == groups[None, :])).max() == 0.0
    # the tiles the CUDA kernel skips hold no same-group pair
    need = rik.tile_need(n, n, False, _t(groups), _t(groups)).numpy()
    skipped = ~np.repeat(np.repeat(need, rik.TILE, 0), rik.TILE, 1)[:n, :n]
    assert skipped.any() and not (skipped & same).any()
    need_t = rik.tile_need(n, n, True, _t(groups), _t(groups)).numpy()
    assert (need_t == np.triu(need)).all()


def test_rotated_iou_wrapper_raises_off_cpu_and_card():
    b = torch.zeros(4, 5, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rik.rotated_iou(b, b)


# ---- rotated NMS -----------------------------------------------------------

def _candidates(rng, n, span=120.0):
    b = _obbs(rng, n, span=span, lo=10, hi=50)
    s = rng.uniform(0.05, 1, n).astype(np.float32)
    return b, s


def _assert_nms_equal(got, ref, box_tol=1e-5):
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=box_tol, rtol=1e-6)


@pytest.mark.parametrize("n", [150, 600])       # under and over one block
def test_nms_rotated_matches_jax(n):
    rng = np.random.RandomState(n)
    b, s = _candidates(rng, n)
    s[10:16] = s[10]                            # ties: lower index first
    b[11] = b[10]
    s[-5:] = -np.inf                            # padding
    got = tnms.nms_rotated(_t(b), _t(s), 0.1, max_out=100, score_thr=0.1)
    ref = jax.jit(lambda bb, ss: jnms.nms_rotated(
        bb, ss, 0.1, 100, score_thr=0.1))(b, s)
    assert 3 < int(got[2].sum()) < 100
    _assert_nms_equal(got, ref)
    # batched: two images at once equal each alone
    b2, s2 = _candidates(rng, n)
    both = tnms.nms_rotated(_t(np.stack([b, b2])), _t(np.stack([s, s2])),
                            0.1, max_out=100, score_thr=0.1)
    alone = tnms.nms_rotated(_t(b2), _t(s2), 0.1, max_out=100, score_thr=0.1)
    for x, y, z in zip(both, got, alone):
        np.testing.assert_array_equal(x[0].numpy(), y.numpy())
        np.testing.assert_array_equal(x[1].numpy(), z.numpy())


def test_nms_rotated_grouped_equals_ungrouped_and_jax():
    rng = np.random.RandomState(7)
    n = 400
    b, s = _candidates(rng, n, span=80)
    cls = rng.randint(0, 6, n)
    cls[cls == 3] = 4                           # a class with no candidate
    s[::9] = 0.01                               # under the score threshold
    shifted = b.copy()
    shifted[:, 0] += cls * 1000.0
    grouped = tnms.nms_rotated(_t(shifted), _t(s), 0.1, max_out=120,
                               score_thr=0.05, groups=_t(cls))
    plain = tnms.nms_rotated(_t(shifted), _t(s), 0.1, max_out=120,
                             score_thr=0.05)
    for g, p in zip(grouped, plain):
        np.testing.assert_array_equal(g.numpy(), p.numpy())
    ref = jax.jit(lambda bb, ss, gg: jnms.nms_rotated(
        bb, ss, 0.1, 120, score_thr=0.05, groups=gg))(
            shifted, s, cls.astype(np.int32))
    assert 10 < int(grouped[2].sum()) < 120
    _assert_nms_equal(grouped, ref, box_tol=1e-3)   # coordinates to 6000


@pytest.mark.parametrize("per_class_boxes", [False, True])
def test_multiclass_nms_rotated_matches_jax(per_class_boxes):
    rng = np.random.RandomState(8)
    n, c = 120, 5
    if per_class_boxes:
        boxes = np.stack([_obbs(rng, n, span=100, lo=10, hi=40)
                          for _ in range(c)], 1).reshape(n, c * 5)
    else:
        boxes = _obbs(rng, n, span=100, lo=10, hi=40)
    logits = rng.normal(0, 2.0, (n, c + 1)).astype(np.float32)
    logits[:, 2] = -20.0                        # class 2: no candidate
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    scores[7, 0] = scores[8, 0] = scores[9, 1] = 0.5      # tied scores
    scores = scores.astype(np.float32)
    got = tnms.multiclass_nms_rotated(_t(boxes), _t(scores), 0.05, 0.1,
                                      max_num=60, pre_nms=200)
    ref = jax.jit(lambda bb, ss: jnms.multiclass_nms_rotated(
        bb, ss, 0.05, 0.1, 60, pre_nms=200))(boxes, scores)
    labels = got[1].numpy()[got[2].numpy()]
    assert len(labels) > 10 and 2 not in labels and len(set(labels)) == 4
    _assert_nms_equal(got, ref)
    # batched over images
    b2 = np.stack([boxes, boxes[::-1]])
    s2 = np.stack([scores, scores[::-1]])
    both = tnms.multiclass_nms_rotated(_t(b2.copy()), _t(s2.copy()), 0.05,
                                       0.1, max_num=60, pre_nms=200)
    for x, y in zip(both, got):
        np.testing.assert_array_equal(x[0].numpy(), y.numpy())


@pytest.mark.parametrize("box_dim", [5, 4])
def test_aug_multiclass_nms_rotated_matches_jax(box_dim):
    rng = np.random.RandomState(9)
    dets, labels, valids = [], [], []
    base = _obbs(rng, 40, span=100, lo=10, hi=40)
    for k in range(2):
        b = base + rng.normal(0, 0.5, base.shape).astype(np.float32) * (k > 0)
        if box_dim == 4:
            b = np.asarray(jbc.obb2xyxy(b))
        sc = rng.uniform(0.1, 1, 40).astype(np.float32)
        dets.append(np.concatenate([b[:, :box_dim], sc[:, None]], -1))
        labels.append(rng.randint(0, 3, 40).astype(np.int32) if k == 0
                      else labels[0].copy())
        valids.append(rng.rand(40) > 0.2)
    got = tnms.aug_multiclass_nms_rotated(
        [_t(d) for d in dets], [_t(x).long() for x in labels],
        [_t(v) for v in valids], 0.1, max_out=80, box_dim=box_dim)
    ref = jax.jit(lambda d, x, v: jnms.aug_multiclass_nms_rotated(
        d, x, v, 0.1, 80, box_dim=box_dim))(dets, labels, valids)
    assert 5 < int(got[2].sum()) < int(sum(v.sum() for v in valids))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    # batched: a leading image dimension
    gb = tnms.aug_multiclass_nms_rotated(
        [_t(d)[None] for d in dets], [_t(x).long()[None] for x in labels],
        [_t(v)[None] for v in valids], 0.1, max_out=80, box_dim=box_dim)
    for x, y in zip(gb, got):
        np.testing.assert_array_equal(x[0].numpy(), y.numpy())
