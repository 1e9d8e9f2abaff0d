"""The RepPoints family and the CSL heads against the JAX package, on the
CPU, at fp32.

- The convex geometry op by op (``ops/geometry_extras.py``): the hull
  mask, ``min_area_polygons`` (rectangles compared as shapes: areas and
  sorted corners; a point set with parallel hull edges among the cases),
  ``points_in_polygons``, ``box_iou_quadri`` aligned and in blocks of rows
  (clockwise quads among them), ``convex_iou`` / ``convex_giou`` and their
  gradients, ``diff_iou_rotated``, ``nms_quadri`` (the keep through
  ``ops/nms.py``'s), ``chamfer_distance``. Values within 1e-5 of scale,
  gradients within 1e-4 of scale; index outputs equal.
- Where JAX's gradient is NaN, the port's is finite: ``convex_giou`` of
  point sets collapsed on one spot (a rectangle of zero size: JAX's
  ``jnp.linalg.norm`` of a zero-length edge) and ``spatial_border_loss``
  with a point on its gt's centre (the norm at 0).
- The assigners ``convex_assign`` and ``sas_assign`` (a gt centred on the
  grid: equal distances, ties to the lower index) equal to JAX's; the
  losses ``points_gaussian``, ``poly_gaussian``, ``kld_reppoints_loss``,
  ``spatial_border_loss``, ``smooth_focal_loss`` and their gradients
  within 1e-5 / 1e-4 of scale.
- ``CSLCoder``: encode for the four windows and the three angle versions
  and decode, equal to JAX's; ``CSLRetinaHead`` with ``csl_angle_loss``
  and ``CSLRotatedFCOSHead`` with ``csl_fcos_loss``: outputs within 1e-5
  of scale, losses within 1e-4 relative, gradients within 1e-4 of scale.
- The four detectors (``OrientedRepPoints``, ``RotatedRepPoints`` with
  ``spatial_border``, ``SAMRepPoints``, ``GRepPoints``) at the fixture of
  ``tests/test_torch_zoo.py`` (``atto``, 64 px, 4 classes, two images of
  four oriented gts, GroupNorm of 8 groups), parameters from the port's
  seeded init carried over by ``from_flax``: losses within 1e-4
  relative, each top-level subtree's gradient norm within 1e-4 relative.
  JAX's side is its detector's ``__call__`` in three compiled parts
  (backbone + neck and the head tower, whose forwards and VJPs the four
  share; the loss), a fraction of the compile time of four whole
  detectors. The
  port is handed JAX's pick among equal-area rectangles (``_JaxPicks``:
  a point set whose hull is a triangle has three).
- ``build_detector`` builds the detectors and the CSL heads by name; the
  Swin backbones still raise, naming ROADMAP item 7.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.core.bbox import angle_coder as jac
from sm3det_tpu.core.bbox import assigners as jas
from sm3det_tpu.models import losses as jlosses
from sm3det_tpu.models.dense_heads import oriented_reppoints_head as jrp
from sm3det_tpu.models.dense_heads import reppoints_variants as jrv
from sm3det_tpu.models.dense_heads import rotated_fcos_head as jfcos
from sm3det_tpu.models.dense_heads import rotated_retina_head as jrh
from sm3det_tpu.models.detectors import single_stage_zoo as jssz
from sm3det_tpu.models.detectors import zoo_extra as jze
from sm3det_tpu.ops import geometry_extras as jgeo
from sm3det_tpu_torch.convert import convert_tree, from_flax, to_flax
from sm3det_tpu_torch.core.bbox import angle_coder as pac
from sm3det_tpu_torch.core.bbox import assigners as pas
from sm3det_tpu_torch.models import builder
from sm3det_tpu_torch.models import losses as plosses
from sm3det_tpu_torch.models.dense_heads import rotated_fcos_head as pfcos
from sm3det_tpu_torch.models.dense_heads import rotated_retina_head as prh
from sm3det_tpu_torch.models.detectors import single_stage_zoo as pssz
from sm3det_tpu_torch.models.detectors import zoo_extra as pze
from sm3det_tpu_torch.ops import geometry_extras as pgeo
from sm3det_tpu_torch.train.train_state import batch_to

from test_detector_variants import APPLY_RNGS
from test_torch_zoo import CFG
from test_torch_zoo_rest import _layer_scales, _template
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)  # noqa: F401

NC, G = CFG["num_classes"], 4
CH = CFG["neck"]["out_channels"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().double().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float64)


def _close(got, ref, tol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _obbs(rng, n, lo=10, hi=50):
    return np.stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                     rng.uniform(4, 30, n), rng.uniform(2, 20, n),
                     rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)


def _point_sets(rng, n, k=9):
    c = rng.uniform(10, 50, (n, 1, 2))
    return (c + rng.randn(n, k, 2) * rng.uniform(2, 8, (n, 1, 1))).astype(
        np.float32)


def _polys(obbs):
    from sm3det_tpu_torch.ops.box_convert import obb2poly
    return obb2poly(_t(obbs)).numpy()


def _grad_pair(jfn, pfn, *args):
    """JAX's and the port's gradient of the sum of fn in every argument."""
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a)),
                          argnums=tuple(range(len(args)))))(
        *[jnp.asarray(a) for a in args])
    ts = [_t(a).requires_grad_(True) for a in args]
    pg = torch.autograd.grad(pfn(*ts).sum(), ts)
    return jg, pg


# ---- the convex geometry ----------------------------------------------------

def test_convex_hull_mask_against_scipy():
    """The hull vertices of random sets, without and with a validity mask,
    against ``scipy.spatial.ConvexHull``. JAX's function is no reference:
    it broadcasts the mask one axis short, so a batch of sets raises and a
    single set gets an (N, N) array (ROADMAP §3); no JAX path calls it."""
    from scipy.spatial import ConvexHull
    rng = np.random.RandomState(0)
    pts = _point_sets(rng, 32)
    with pytest.raises(ValueError, match="broadcast"):
        jax.jit(jgeo.convex_hull_mask)(jnp.asarray(pts))
    assert jax.jit(jgeo.convex_hull_mask)(jnp.asarray(pts[0])).shape == \
        (9, 9)
    valid = rng.rand(32, 9) > 0.3
    valid[:, :4] = True
    for v in (None, valid):
        got = pgeo.convex_hull_mask(_t(pts), None if v is None else _t(v))
        for i in range(32):
            keep = np.ones(9, bool) if v is None else v[i]
            want = np.zeros(9, bool)
            want[np.flatnonzero(keep)[ConvexHull(
                pts[i][keep].astype(np.float64)).vertices]] = True
            np.testing.assert_array_equal(got[i].numpy(), want)


def _shape_equal(got, ref):
    """Rectangles (N, 8) as shapes, whatever their first corner: equal
    areas and an aligned IoU of 1."""
    iou = pgeo.box_iou_quadri(_t(_np(got)).float(), _t(_np(ref)).float(),
                              aligned=True)
    area = pgeo._poly_area(_t(_np(got)).float().reshape(-1, 4, 2)).abs()
    ref_area = pgeo._poly_area(_t(_np(ref)).float().reshape(-1, 4, 2)).abs()
    _close(area, ref_area, 1e-5)
    assert float(iou.min()) > 0.9999


@pytest.mark.parametrize("case", ["random", "parallel_edges", "with_invalid"])
def test_min_area_polygons_match_jax(case):
    """The least-area rectangles of random sets, of rotated 3 x 3 grids
    (pairs of parallel hull edges: areas equal up to rounding, either edge
    may win) and of sets with invalid points, as shapes."""
    rng = np.random.RandomState(1)
    pts = _point_sets(rng, 48)
    valid = None
    if case == "parallel_edges":
        g = np.stack(np.meshgrid(np.arange(3.0), np.arange(3.0)), -1) \
            .reshape(9, 2) * np.array([7.0, 3.0])
        ang = rng.uniform(-np.pi, np.pi, 48)
        rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                        np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
        pts = (np.einsum("nij,kj->nki", rot, g)
               + rng.uniform(10, 50, (48, 1, 2))).astype(np.float32)
    elif case == "with_invalid":
        valid = rng.rand(48, 9) > 0.3
        valid[:, :3] = True
    got = pgeo.min_area_polygons(_t(pts), None if valid is None
                                 else _t(valid))
    ref = jax.jit(jgeo.min_area_polygons)(
        jnp.asarray(pts), None if valid is None else jnp.asarray(valid))
    _shape_equal(got, ref)
    # the rectangle holds every valid point
    quads = got.reshape(-1, 4, 2)
    for i in range(0, 48, 7):
        keep = slice(None) if valid is None else _t(valid[i])
        inside = pgeo.points_in_polygons(_t(pts[i])[keep],
                                         quads[i].reshape(1, 8) * 1.0001
                                         - quads[i].mean(0).repeat(4)
                                         * 0.0001)
        assert bool(inside.all())


def test_points_in_polygons_and_chamfer_match_jax():
    rng = np.random.RandomState(2)
    pts = rng.uniform(0, 64, (200, 2)).astype(np.float32)
    polys = _polys(_obbs(rng, 6))
    np.testing.assert_array_equal(
        pgeo.points_in_polygons(_t(pts), _t(polys)).numpy(),
        np.asarray(jax.jit(jgeo.points_in_polygons)(jnp.asarray(pts),
                                                    jnp.asarray(polys))))
    a, b = pts[:40], pts[40:70]
    va, vb = rng.rand(40) > 0.2, rng.rand(30) > 0.2
    for v1, v2 in ((None, None), (va, vb)):
        got = pgeo.chamfer_distance(
            _t(a), _t(b), None if v1 is None else _t(v1),
            None if v2 is None else _t(v2))
        ref = jax.jit(jgeo.chamfer_distance)(
            jnp.asarray(a), jnp.asarray(b),
            None if v1 is None else jnp.asarray(v1),
            None if v2 is None else jnp.asarray(v2))
        for g, r in zip(got, ref):
            _close(g, r, 1e-6)


def test_box_iou_quadri_matches_jax(monkeypatch):
    """Aligned and matrix IoUs, the matrix in blocks of 7 rows, a third of
    the quads wound clockwise, and ``diff_iou_rotated``."""
    rng = np.random.RandomState(3)
    o1, o2 = _obbs(rng, 30), _obbs(rng, 9)
    o2[:3] = o1[:3]                                  # identical pairs
    q1, q2 = _polys(o1), _polys(o2)
    q1[::3] = q1[::3].reshape(-1, 4, 2)[:, ::-1].reshape(-1, 8)
    ref = jax.jit(jgeo.box_iou_quadri)(jnp.asarray(q1), jnp.asarray(q2))
    monkeypatch.setattr(pgeo, "QUADRI_ROWS", 7)
    got = pgeo.box_iou_quadri(_t(q1), _t(q2))
    _close(got, ref, 1e-5)
    assert float(np.asarray(ref).max()) > 0.99
    ref_a = jax.jit(lambda a, b: jgeo.box_iou_quadri(a, b, aligned=True))(
        jnp.asarray(q1[:9]), jnp.asarray(q2))
    _close(pgeo.box_iou_quadri(_t(q1[:9]), _t(q2), aligned=True), ref_a,
           1e-5)
    _close(pgeo.diff_iou_rotated(_t(o1[:9]), _t(o2)),
           jax.jit(jgeo.diff_iou_rotated)(jnp.asarray(o1[:9]),
                                          jnp.asarray(o2)), 1e-5)


def test_convex_iou_and_giou_match_jax():
    rng = np.random.RandomState(4)
    pts = _point_sets(rng, 24)
    gts = _polys(_obbs(rng, 5))
    _close(pgeo.convex_iou(_t(pts), _t(gts)),
           jax.jit(jgeo.convex_iou)(jnp.asarray(pts), jnp.asarray(gts)),
           1e-5)
    aligned = gts[rng.randint(0, 5, 24)]
    _close(pgeo.convex_giou(_t(pts), _t(aligned)),
           jax.jit(jgeo.convex_giou)(jnp.asarray(pts), jnp.asarray(aligned)),
           1e-5)
    jg, pg = _grad_pair(jgeo.convex_giou, pgeo.convex_giou, pts, aligned)
    for g, r in zip(pg, jg):
        _close(g, r, 1e-4)


def test_convex_giou_gradient_finite_where_jax_is_nan():
    """Point sets collapsed on one spot (the init of a RepPoints head with
    zero offsets) make a rectangle of zero size: JAX's gradient is NaN
    (``jnp.linalg.norm`` of a zero-length edge in its intersection), the
    port's is finite, and both values agree."""
    rng = np.random.RandomState(5)
    pts = np.repeat(rng.uniform(20, 40, (6, 1, 2)), 9, axis=1).astype(
        np.float32)
    gts = _polys(_obbs(rng, 6, 20, 40))
    _close(pgeo.convex_giou(_t(pts), _t(gts)),
           jax.jit(jgeo.convex_giou)(jnp.asarray(pts), jnp.asarray(gts)),
           1e-5)
    jg, pg = _grad_pair(jgeo.convex_giou, pgeo.convex_giou, pts, gts)
    assert np.isnan(np.asarray(jg[0])).any()
    assert all(bool(torch.isfinite(g).all()) for g in pg)


@pytest.mark.parametrize("batched", [False, True])
def test_nms_quadri_matches_jax(batched):
    rng = np.random.RandomState(6)
    o = _obbs(rng, 60)
    o[30:] = o[:30] + rng.randn(30, 5).astype(np.float32) * [1, 1, 1, 1,
                                                             0.05]
    q = _polys(o)
    s = rng.rand(60).astype(np.float32)
    s[10] = s[11]                                    # a tie in score
    ref_i, ref_v = jax.jit(lambda a, b: jgeo.nms_quadri(a, b, 0.3, 40))(
        jnp.asarray(q), jnp.asarray(s))
    if batched:
        got_i, got_v = pgeo.nms_quadri(_t(q)[None].repeat(2, 1, 1),
                                       _t(s)[None].repeat(2, 1), 0.3, 40)
        got_i, got_v = got_i[1], got_v[1]
    else:
        got_i, got_v = pgeo.nms_quadri(_t(q), _t(s), 0.3, 40)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert 10 < int(got_v.sum()) < 60


# ---- assigners --------------------------------------------------------------

def test_convex_assign_matches_jax():
    rng = np.random.RandomState(7)
    gts = _obbs(rng, 4)
    mask = np.array([True, True, True, False])
    # point sets around the gts' corners and centres, some matching well
    pts = np.concatenate([
        _polys(gts).reshape(4, 4, 2).repeat(10, 0)[:, :, :]
        .reshape(40, 4, 2),
        np.repeat(gts[:, None, :2], 10, 0).reshape(40, 1, 2)], 1)
    pts = np.concatenate([pts, pts[:, :4] * 0.9 + pts[:, 4:] * 0.1], 1)
    pts = (pts + rng.randn(*pts.shape) * 2).astype(np.float32)
    polys = _polys(gts)
    got = pas.convex_assign(_t(pts), _t(polys), _t(mask))
    ref = jax.jit(jas.convex_assign)(jnp.asarray(pts), jnp.asarray(polys),
                                     jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int((got > 0).sum()) > 4 and int((got == 0).sum()) > 0
    batched = pas.convex_assign(_t(pts)[None].repeat(2, 1, 1, 1),
                                _t(polys)[None].repeat(2, 1, 1),
                                _t(mask)[None].repeat(2, 1))
    np.testing.assert_array_equal(batched[1].numpy(), np.asarray(ref))


def test_sas_assign_matches_jax_with_ties():
    from sm3det_tpu_torch.models.dense_heads.oriented_reppoints_head import \
        level_points
    feats = [torch.zeros(1, s, s, 1) for s in (8, 4, 2, 1, 1)]
    centers, strides = level_points(feats, (8, 16, 32, 64, 128), "cpu")
    # gt centres on grid points of the first level: four equal distances
    gts = np.array([[16.0, 16.0, 30, 20, 0.0], [40.0, 24.0, 14, 40, 0.6],
                    [32.0, 48.0, 50, 12, -1.2], [8, 8, 10, 10, 0]],
                   np.float32)
    mask = np.array([True, True, True, False])
    got = pas.sas_assign(centers, strides, _t(gts), _t(mask))
    ref = jax.jit(jas.sas_assign)(jnp.asarray(centers.numpy()),
                                  jnp.asarray(strides.numpy()),
                                  jnp.asarray(gts), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int((got > 0).sum()) >= 9


# ---- losses -----------------------------------------------------------------

def test_point_set_gaussians_and_kld_loss_match_jax():
    rng = np.random.RandomState(8)
    pts = _point_sets(rng, 30)
    polys = _polys(_obbs(rng, 30))
    w = (rng.rand(30) > 0.3).astype(np.float32)
    for pf, jf, args in (
            (plosses.points_gaussian, jlosses.points_gaussian, (pts,)),
            (plosses.poly_gaussian, jlosses.poly_gaussian, (polys,))):
        for g, r in zip(pf(*map(_t, args)), jax.jit(jf)(*args)):
            _close(g, r, 1e-5)
    got = plosses.kld_reppoints_loss(_t(pts), _t(polys), weight=_t(w),
                                     avg_factor=3.0)
    ref = jax.jit(lambda a, b, c: jlosses.kld_reppoints_loss(
        a, b, weight=c, avg_factor=3.0))(pts, polys, w)
    _close(got, ref, 1e-5)
    jg, pg = _grad_pair(
        lambda a, b: jlosses.kld_reppoints_loss(a, b, weight=jnp.asarray(w)),
        lambda a, b: plosses.kld_reppoints_loss(a, b, weight=_t(w)),
        pts, polys)
    for g, r in zip(pg, jg):
        _close(g, r, 1e-4)


def test_spatial_border_loss_matches_jax_and_stays_finite():
    """Values and gradients against JAX; one positive set has a point on
    its gt's centre, inside the gt, where JAX's gradient is NaN (the norm
    at 0 times the mask's 0) and the port's is finite."""
    rng = np.random.RandomState(9)
    obbs = _obbs(rng, 20)
    polys = _polys(obbs)
    pts = (obbs[:, None, :2] + rng.randn(20, 9, 2) * obbs[:, None, 2:3]
           * 0.6).astype(np.float32)
    w = (rng.rand(20) > 0.3).astype(np.float32)
    got = plosses.spatial_border_loss(_t(pts), _t(polys), _t(w))
    ref = jax.jit(jlosses.spatial_border_loss)(pts, polys, w)
    _close(got, ref, 1e-5)
    assert float(ref) > 0
    jg, pg = _grad_pair(
        lambda a: jlosses.spatial_border_loss(a, jnp.asarray(polys),
                                              jnp.asarray(w)),
        lambda a: plosses.spatial_border_loss(a, _t(polys), _t(w)), pts)
    _close(pg[0], jg[0], 1e-4)
    i = int(np.argmax(w))
    pts[i, 0] = _polys(obbs[i:i + 1]).reshape(4, 2).mean(0)
    jg, pg = _grad_pair(
        lambda a: jlosses.spatial_border_loss(a, jnp.asarray(polys),
                                              jnp.asarray(w)),
        lambda a: plosses.spatial_border_loss(a, _t(polys), _t(w)), pts)
    assert np.isnan(np.asarray(jg[0])).any()
    assert bool(torch.isfinite(pg[0]).all())
    ok = ~np.isnan(np.asarray(jg[0]))
    _close(pg[0].numpy()[ok], np.asarray(jg[0])[ok], 1e-4)


# ---- CSL --------------------------------------------------------------------

@pytest.mark.parametrize("version", ["oc", "le90", "le135"])
@pytest.mark.parametrize("window", ["gaussian", "triangle", "rect", "pulse"])
def test_csl_coder_matches_jax(version, window):
    rng = np.random.RandomState(10)
    lo, hi = (0.0, np.pi / 2) if version == "oc" else \
        ((-np.pi / 2, np.pi / 2) if version == "le90"
         else (-np.pi / 4, 3 * np.pi / 4))
    ang = rng.uniform(lo, hi, 64).astype(np.float32)
    ang[:3] = [lo, hi, (lo + hi) / 2]
    coder = pac.CSLCoder(version, omega=1, window=window, radius=6)
    jcoder = jac.CSLCoder(version, omega=1, window=window, radius=6)
    enc = coder.encode(_t(ang))
    ref = jcoder.encode(jnp.asarray(ang))
    _close(enc, ref, 1e-6)
    logits = rng.randn(64, coder.coding_len).astype(np.float32)
    _close(coder.decode(_t(logits)), jcoder.decode(jnp.asarray(logits)),
           1e-6)


def _head_params(jhead, feats, rng):
    p = jax.eval_shape(lambda f: jhead.init(jax.random.PRNGKey(0), f),
                       feats)["params"]
    return jax.tree.map(lambda v: np.asarray(rng.randn(*v.shape) * 0.1 + (
        1.0 if len(v.shape) < 2 else 0.0), np.float32), p)


def _load_head(port, params):
    sd = convert_tree(params, ("h",))
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                         strict=True)


def test_csl_retina_head_and_angle_loss_match_jax():
    rng = np.random.RandomState(11)
    feats = [rng.randn(2, s, s, CH).astype(np.float32) for s in (8, 4, 2)]
    jhead = jrh.CSLRetinaHead(num_classes=NC, feat_channels=CH)
    params = _head_params(jhead, feats, rng)
    port = prh.CSLRetinaHead(num_classes=NC, in_channels=CH,
                             feat_channels=CH)
    _load_head(port, params)
    coder, jcoder = pac.CSLCoder("le90"), jac.CSLCoder("le90")
    n = 9 * sum(s * s for s in (8, 4, 2))
    ang = rng.uniform(-np.pi / 2, np.pi / 2, (2, n)).astype(np.float32)
    pos = (rng.rand(2, n) > 0.8).astype(np.float32)

    def jloss(p, f):
        outs = jhead.apply({"params": p}, f)
        flat = jnp.concatenate([a.reshape(2, -1, jcoder.coding_len)
                                for a in outs[2]], 1)
        return jrh.csl_angle_loss(flat, ang, pos, jcoder,
                                  avg_factor=7.0), outs

    (ref_l, outs), ref_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, feats)
    got = port([_t(f) for f in feats])
    for g_lvls, r_lvls in zip(got, outs):
        for g, r in zip(g_lvls, r_lvls):
            _close(g, r, 1e-5)
    flat = torch.cat([a.reshape(2, -1, coder.coding_len) for a in got[2]],
                     1)
    loss = prh.csl_angle_loss(flat, _t(ang), _t(pos), coder,
                              avg_factor=7.0)
    assert abs(float(loss) - float(ref_l)) <= 1e-4 * abs(float(ref_l))
    grads = torch.autograd.grad(loss, [port.retina_angle_cls.weight])
    _close(grads[0].permute(2, 3, 1, 0),
           ref_g["retina_angle_cls"]["kernel"], 1e-4)


def test_csl_fcos_head_and_loss_match_jax():
    rng = np.random.RandomState(12)
    sizes = (8, 4, 2, 1, 1)
    feats = [rng.randn(2, s, s, CH).astype(np.float32) for s in sizes]
    jhead = jfcos.CSLRotatedFCOSHead(num_classes=NC, feat_channels=CH,
                                     gn_groups=8)
    params = _head_params(jhead, feats, rng)
    port = pfcos.CSLRotatedFCOSHead(num_classes=NC, in_channels=CH,
                                    feat_channels=CH, gn_groups=8)
    _load_head(port, params)
    assert not hasattr(port, "scale_angle") and not hasattr(port,
                                                            "fcos_angle")
    gts = np.stack([_obbs(rng, G, 12, 52) for _ in range(2)])
    gts[:, :, 2:4] += 20
    labels = rng.randint(0, NC, (2, G)).astype(np.int32)
    mask = np.ones((2, G), bool)
    mask[1, 3] = False

    def jloss(p, f):
        outs = jhead.apply({"params": p}, f)
        losses = jfcos.csl_fcos_loss(*outs, gts, labels, mask, NC)
        return sum(losses.values()), (losses, outs)

    (_, (ref_l, ref_outs)), ref_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params, feats)
    ref_l = {k: float(v) for k, v in ref_l.items()}
    outs = port([_t(f) for f in feats])
    for g_lvls, r_lvls in zip(outs, ref_outs):
        for g, r in zip(g_lvls, r_lvls):
            _close(g, r, 1e-5)
    got = pfcos.csl_fcos_loss(*outs, _t(gts), _t(labels), _t(mask), NC)
    assert set(got) == set(ref_l)
    for k, v in ref_l.items():
        assert abs(float(got[k]) - v) <= 1e-4 * abs(v) + 1e-9, (k, v)
    assert ref_l["loss_angle"] > 0 and ref_l["loss_bbox"] > 0
    names = ["fcos_angle_cls.weight", "fcos_reg.weight", "cls_conv0.weight"]
    grads = torch.autograd.grad(sum(got.values()),
                                [dict(port.named_parameters())[n]
                                 for n in names])
    for n, g in zip(names, grads):
        mod = n.split(".")[0]
        _close(g.permute(2, 3, 1, 0), ref_g[mod]["kernel"], 1e-4, n)


# ---- the four detectors -----------------------------------------------------

DETECTORS = {
    # (JAX class, port class, config overrides)
    "OrientedRepPoints": (jssz.OrientedRepPoints, pssz.OrientedRepPoints,
                          {}),
    "RotatedRepPoints": (jze.RotatedRepPoints, pze.RotatedRepPoints,
                         {"spatial_border": True}),
    "SAMRepPoints": (jze.SAMRepPoints, pze.SAMRepPoints, {}),
    "GRepPoints": (jze.GRepPoints, pze.GRepPoints, {}),
}


@pytest.fixture(scope="module")
def data():
    from test_detector_variants import _batch
    b = _batch(np.random.RandomState(0))
    return {k: np.concatenate([b["rgb"][k], b["ifr"][k]]) for k in b["rgb"]}


def _cfg(name):
    cfg = copy.deepcopy(CFG)
    cfg.update(gn_groups=8, **DETECTORS[name][2])
    return cfg


def _jax_loss(name, cfg):
    """The detector's loss of its head's outputs, as its ``__call__``
    computes it."""
    kw = dict(version=cfg.get("angle_version", "le90"))
    if name == "OrientedRepPoints":
        return lambda outs, b: jrp.reppoints_loss(
            *outs, b["gt_obbs"], b["gt_labels"], b["gt_mask"], NC, **kw)
    return lambda outs, b: jrv.reppoints_variant_loss(
        *outs, b["gt_obbs"], b["gt_labels"], b["gt_mask"], NC,
        variant=DETECTORS[name][0].variant,
        spatial_border=cfg.get("spatial_border", False), **kw)


class _JaxPicks:
    """JAX's choice among the least-area rectangles, handed to the port.

    Where a point set's hull is a triangle, its three edge rectangles have
    the same area in exact arithmetic and rounding picks one: JAX's pick
    moves with XLA's compile options and differs from the port's (6 of 172
    sets flip under a 1e-6 relative change of the offsets), and each pick
    is another rectangle. ``wrap`` records the rectangles JAX's
    ``min_area_polygons`` returns inside the compiled loss
    (``jax.debug.callback``: once an image under ``vmap``; some calls run
    twice under the gradient); ``pick`` replaces the port's
    ``geometry_extras._pick`` and takes, among the port's candidates
    within 1e-4 of the least area, the direction of JAX's rectangle (its
    first edge), from the recorded image whose rectangles all fit.
    ``flipped`` counts where that differs from the port's own pick; an
    image that no record fits raises."""

    def __init__(self):
        self.records, self.traced, self.calls, self.flipped = {}, 0, 0, 0

    def wrap(self, orig):
        def wrapped(points, valid=None):
            out = orig(points, valid)
            tag = self.traced
            self.traced += 1
            jax.debug.callback(
                lambda c, tag=tag: self.records.setdefault(tag, []).append(
                    np.asarray(c)), out)
            return out
        return wrapped

    def pick(self, area, ux, uy):
        """For each image of the port's call, JAX's rectangles that all
        fit among the recorded ones (the callbacks' order of images and
        calls is not kept)."""
        least = area.amin(-1, keepdim=True)
        near = area <= least + 1e-4 * least.abs() + 1e-6
        own = pgeo.first_least(area, ux, uy)
        out = own.clone()
        flat = [r for rec in self.records.values() for r in rec]
        for i in range(area.shape[0]):
            fits = []
            for r in flat:
                c = torch.from_numpy(r)
                u = c[..., 2:4] - c[..., 0:2]
                u = u / torch.clamp(torch.linalg.vector_norm(
                    u, dim=-1, keepdim=True), min=1e-12)
                score = torch.where(near[i], ux[i] * u[..., None, 0]
                                    + uy[i] * u[..., None, 1], -2.0)
                best = pgeo._argmax_first(score, -1)
                hit = torch.gather(score, -1, best[..., None])[..., 0] > 0.999
                real = torch.isfinite(least[i, ..., 0]) & (u.abs().sum(-1) > 0)
                fits.append((float(hit[real].float().mean()),
                             torch.where(real, best, own[i])))
            fit, best = max(fits, key=lambda f: f[0])
            assert fit == 1.0, ("JAX's rectangles are not least ones", fit)
            out[i] = best
        self.calls += 1
        self.flipped += int((out != own).sum())
        return out


@pytest.fixture(scope="module")
def shared(data):
    """What the four detectors share in JAX (one architecture:
    ``OrientedRepPoints``' backbone + neck, ``extract_feat``, and its head
    tower, which the variants' heads subclass unchanged): the params
    template, and the forward and VJP of the backbone + neck and of the
    head, each compiled once for all four."""
    jmodel = jssz.OrientedRepPoints(cfg=_cfg("OrientedRepPoints"))

    def feats(p, img):
        return jmodel.apply({"params": p}, img, train=True,
                            method=lambda m, x, train: m.extract_feat(
                                x, train=train)[0])

    def head(p, levels):
        return jmodel.apply({"params": {"bbox_head": p}}, levels,
                            method=lambda m, x: m.bbox_head(x))

    def vjp(fn):
        return jax.jit(lambda p, x, ct: jax.vjp(fn, p, x)[1](ct))

    return dict(template=_template(jmodel, data), feats=jax.jit(feats),
                feats_vjp=vjp(feats), head=jax.jit(head), head_vjp=vjp(head))


@pytest.fixture(scope="module", params=list(DETECTORS))
def detector(request, data, shared):
    """JAX's losses and subtree gradient norms of the detector, and the
    port's at the same parameters. The JAX detector's ``__call__`` is
    backbone + neck (``extract_feat``), ``bbox_head`` and its loss
    function: the reference runs those three, the first two from
    ``shared``, the loss under ``value_and_grad`` in its head outputs, and
    chains the gradients through the two VJPs."""
    name = request.param
    _, pcls, _ = DETECTORS[name]
    cfg = _cfg(name)
    port = pcls(cfg, device="cpu", trainable=True)
    params = to_flax(dict(port.state_dict()), shared["template"])
    params = _layer_scales(params, np.random.RandomState(1))
    p_bn = {k: params[k] for k in ("backbone", "neck")}
    levels = shared["feats"](p_bn, data["img"])
    outs = shared["head"](params["bbox_head"], levels)
    loss_fn = _jax_loss(name, cfg)

    def total(o, b):
        losses = loss_fn(o, b)
        return sum(losses.values()), losses

    picks = _JaxPicks()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jgeo, jrp):
            mp.setattr(mod, "min_area_polygons",
                       picks.wrap(jgeo.min_area_polygons))
        (_, losses), g_outs = jax.jit(jax.value_and_grad(
            total, has_aux=True))(outs, data)
        jax.effects_barrier()
    g_head, g_levels = shared["head_vjp"](params["bbox_head"], levels,
                                          g_outs)
    grads = dict(shared["feats_vjp"](p_bn, data["img"], g_levels)[0],
                 bbox_head=g_head)
    port.load_state_dict(from_flax(params), strict=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pgeo, "_pick", picks.pick)
        got = port(batch_to({"d": data}, "cpu")["d"],
                   gen=torch.Generator().manual_seed(0))
        p_grads = torch.autograd.grad(sum(got.values()),
                                      list(port.parameters()),
                                      allow_unused=True)
    assert picks.calls > 0
    sq = {}
    for (n, _), g in zip(port.named_parameters(), p_grads):
        top = n.split(".")[0]
        sq[top] = sq.get(top, 0.0) + (0.0 if g is None else float(
            (g.double() ** 2).sum()))
    norms = {k: float(np.sqrt(sum(float(np.sum(np.square(np.asarray(x))))
                                  for x in jax.tree.leaves(v))))
             for k, v in grads.items()}
    return dict(name=name, losses={k: float(v) for k, v in losses.items()},
                p_losses={k: float(v.detach()) for k, v in got.items()},
                norms=norms, p_norms={k: v ** 0.5 for k, v in sq.items()},
                finite=all(g is None or bool(torch.isfinite(g).all())
                           for g in p_grads), flipped=picks.flipped)


def test_reppoints_losses_match_jax(detector):
    ref, got = detector["losses"], detector["p_losses"]
    assert set(got) == set(ref)
    bad = [(k, got[k], ref[k]) for k in ref if not (
        np.isfinite(got[k]) and abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k])
        + 1e-9)]
    assert not bad, bad
    assert ref["loss_pts_init"] > 0 and ref["loss_pts_refine"] > 0
    if detector["name"] == "RotatedRepPoints":
        assert ref["loss_spatial_init"] > 0


def test_reppoints_gradient_norms_match_jax(detector):
    ref, got = detector["norms"], detector["p_norms"]
    assert set(got) == set(ref) and detector["finite"]
    bad = [(k, got[k], ref[k]) for k in ref
           if not abs(got[k] - ref[k]) <= 1e-4 * ref[k]]
    assert not bad, bad
    assert all(v > 0 for v in ref.values())


# ---- build_detector ---------------------------------------------------------

@pytest.mark.parametrize("mtype", ["OrientedRepPoints", "RotatedRepPoints",
                                   "SAMRepPoints", "GRepPoints", "ReDet"])
def test_builder_builds_the_slice(mtype):
    mc = copy.deepcopy(CFG)
    mc["type"] = mtype
    if mtype == "ReDet":
        mc["backbone"] = dict(type="ReResNet", stem_channels=4,
                              stage_channels=(4, 8, 16, 32),
                              stage_blocks=(1, 1, 1, 1))
        mc["neck"] = dict(type="ReFPN", in_channels=[32, 64, 128, 256],
                          out_channels=32, num_outs=5)
    model = builder.build_detector(mc, device="cpu", trainable=True)
    assert type(model) is builder.DETECTORS.get(mtype)
    assert all(p.device.type == "cpu" for p in model.parameters())
    if mtype == "ReDet":
        bad = copy.deepcopy(mc)
        bad["neck"]["in_channels"] = [32, 64, 128, 128]
        with pytest.raises(ValueError, match="level widths"):
            builder.build_detector(bad, device="cpu")


def test_builder_csl_heads_and_swin_still_raises():
    head = builder.HEADS.get("CSLRRetinaHead")(num_classes=NC,
                                               in_channels=CH,
                                               feat_channels=CH)
    assert head.retina_angle_cls.weight.shape[0] == 9 * 180
    head = builder.HEADS.get("CSLRFCOSHead")(num_classes=NC, in_channels=CH,
                                             feat_channels=CH, gn_groups=8)
    assert head.fcos_angle_cls.weight.shape[0] == 180
    assert builder.HEADS.get("RotatedAnchorFreeHead") is \
        pfcos.RotatedFCOSHead
    mc = copy.deepcopy(CFG)
    mc["type"] = "OrientedRepPoints"
    mc["backbone"]["type"] = "SwinTransformer_moe"
    with pytest.raises(NotImplementedError, match="item 7"):
        builder.build_detector(mc, device="cpu")
