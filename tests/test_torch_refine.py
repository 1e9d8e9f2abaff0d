"""The refinement detectors (R3Det, S2ANet), their ops and the rotated box
losses against the JAX package, on the CPU, at fp32.

Ops, on inputs made from a seed with numpy: ``hbb2obb`` / ``obb2hbb`` for
``le90``, ``le135`` and ``oc`` (bit for bit; ``obb2hbb`` within 2 ulps,
the libraries' cos / sin); ORConv's index tables and ``arf_expand`` (the
expanded kernel equal to JAX's element by element, after the layout
change), then ``rotation_invariant_pool`` of the ORConv output and the
base filter's gradient (within 1e-5 of scale: a wrong channel order keeps
every shape and changes every number); ``rotated_feature_align`` with
samples past the border, values and the features' gradient (within 1e-5
of scale); GWD, KLD (and the v1 KL distance), KFIoU and the rotated IoU
loss, values (elementwise, within 1e-5 of scale) and gradients against
``jax.grad`` (1e-4 of the gradient's scale), KFIoU and the IoU loss also
on degenerate positives (a zero width, a 1e-9 height, a box equal to its
target), their gradients within 1e-3 of scale where both packages' are
finite (a rank-one covariance's determinant is rounding noise of either
sign in both).

The detectors run at the fixture of ``tests/test_torch_zoo.py``
(``atto``, 64 px, 4 classes, 4 gts an image, two images, no MoE block,
no stochastic depth), their parameters the flax inits' tree (its
structure from ``jax.eval_shape``) holding the port's seeded inits,
carried over by ``from_flax``, the layer scales drawn from U(0.3, 0.8). JAX's
neck levels are computed once (with their VJP) and both detectors' heads
and losses in one compile. Held: every loss of R3Det and S2ANet, with
``refine_reg_loss`` ``smooth_l1`` and ``kfiou``, within 1e-4 relative;
the gradient norm of each top-level subtree (R3Det under smooth_l1,
S2ANet under kfiou) within 1e-4 relative; ``simple_test``'s neck levels,
refine-head outputs and refined anchors within 1e-4 of scale, then the
decode and NMS fed JAX's own head outputs: the same validity and labels,
boxes within 1e-4 of scale, scores within 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models import losses as jl
from sm3det_tpu.models.backbones.convnext import ConvNeXtMoE as JaxConvNeXt
from sm3det_tpu.models.dense_heads.rotated_retina_head import \
    RotatedRetinaHead as JaxRetinaHead
from sm3det_tpu.models.detectors import refine_detectors as jrd
from sm3det_tpu.models.necks.fpn import MultitaskFPN as JaxFPN
from sm3det_tpu.ops import box_convert as jbc
from sm3det_tpu.ops import geometry_extras as jge
from sm3det_tpu.ops import orientation as jor
from sm3det_tpu_torch.convert import convert_tree, from_flax, to_flax
from sm3det_tpu_torch.models import losses as tl
from sm3det_tpu_torch.models.detectors import refine_detectors as prd
from sm3det_tpu_torch.ops import box_convert as pbc
from sm3det_tpu_torch.ops import geometry_extras as pge
from sm3det_tpu_torch.ops import orientation as por
from sm3det_tpu_torch.train.train_state import batch_to

from test_detector_variants import IMG, _batch
from test_torch_zoo import CFG
from torch_jax_refs import DEFAULT, jax_refs_at_lowest_level  # noqa: F401

NC, CH = CFG["num_classes"], CFG["neck"]["out_channels"]
LEVELS = [max(IMG // s, 1) for s in (8, 16, 32, 64, 128)]
STRIDES = (8, 16, 32, 64, 128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, ref, tol, what=""):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _obbs(rng, n, lo=2.0):
    return np.stack([rng.uniform(0, 64, n), rng.uniform(0, 64, n),
                     rng.uniform(lo, 30, n), rng.uniform(lo, 20, n),
                     rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)


# ---- box conversions --------------------------------------------------------

@pytest.mark.parametrize("version", ["le90", "le135", "oc"])
def test_hbb2obb_obb2hbb(version):
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 64, (64, 2)).astype(np.float32)
    wh = rng.uniform(1, 30, (64, 2)).astype(np.float32)
    wh[:4, 1] = wh[:4, 0]                      # squares: no swap
    hbbs = np.concatenate([xy, xy + wh], -1)
    np.testing.assert_array_equal(
        _np(pbc.hbb2obb(_t(hbbs), version)),
        np.asarray(jbc.hbb2obb(hbbs, version)))
    # obb2hbb is hbb2obb of the enclosing box: bit for bit from JAX's
    # enclosing box, within 2 ulps from the port's own (XLA's and torch's
    # cos / sin may differ in the last bit)
    obbs = _obbs(rng, 64)
    ref = np.asarray(jbc.obb2hbb(obbs, version))
    np.testing.assert_array_equal(
        _np(pbc.hbb2obb(_t(jbc.obb2xyxy(obbs, version)), version)), ref)
    np.testing.assert_array_max_ulp(
        _np(pbc.obb2hbb(_t(obbs), version)), ref, maxulp=2)


# ---- ORConv -----------------------------------------------------------------

def test_orconv_tables_and_arf_expand():
    for k, o, r in ((3, 1, 8), (3, 8, 8), (1, 4, 4)):
        np.testing.assert_array_equal(por.orconv_indices(k, o, r),
                                      jor.orconv_indices(k, o, r))
    rng = np.random.RandomState(1)
    w = rng.randn(3, 3, 5, 2, 3).astype(np.float32)   # (k, k, Cin, O, Cout)
    ref = np.asarray(jor.arf_expand(w, 8))            # HWIO
    got = por.arf_expand(_t(w.transpose(4, 2, 3, 0, 1)), 8)
    np.testing.assert_array_equal(_np(got), ref.transpose(3, 2, 0, 1))


def test_orconv_rotation_invariant_pool():
    """ORConv then the pooling, element by element, and the base filter's
    gradient through the expansion."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 7, 16).astype(np.float32)
    mod = jrd.ORConv(out_channels=4, n_rot=8)
    params = {"weight": rng.randn(3, 3, 16, 1, 4).astype(np.float32),
              "bias": rng.randn(32).astype(np.float32)}

    def jf(p, x):
        return jor.rotation_invariant_pool(mod.apply({"params": p}, x), 8)

    ref, vjp = jax.vjp(jax.jit(jf), params, x)
    g = rng.randn(*ref.shape).astype(np.float32)
    gref = vjp(g)[0]
    port = prd.ORConv(16, 4, n_rot=8)
    sd = convert_tree(params, ("or_conv",))
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                         strict=True)
    got = por.rotation_invariant_pool(port(_t(x)), 8)
    assert tuple(got.shape) == (2, 6, 7, 4)
    _close(got, ref, 1e-5, "pooled")
    got.backward(_t(g))
    _close(port.weight.grad.numpy().transpose(3, 4, 1, 2, 0),
           gref["weight"], 1e-5, "weight grad")
    _close(port.bias.grad, gref["bias"], 1e-5, "bias grad")


# ---- rotated feature align --------------------------------------------------

@pytest.mark.parametrize("points", [1, 5])
def test_rotated_feature_align(points):
    rng = np.random.RandomState(3)
    b, h, w, c, stride = 2, 8, 10, 6, 8
    feats = rng.randn(b, h, w, c).astype(np.float32)
    boxes = np.stack([rng.uniform(-24, w * stride + 24, (b, h, w)),
                      rng.uniform(-24, h * stride + 24, (b, h, w)),
                      rng.uniform(4, 80, (b, h, w)),
                      rng.uniform(4, 60, (b, h, w)),
                      rng.uniform(-1.6, 1.6, (b, h, w))],
                     -1).astype(np.float32)
    sx = boxes[..., 0] / stride
    sy = boxes[..., 1] / stride
    assert ((sx < -1) | (sx > w) | (sy < -1) | (sy > h)).any()   # past
    assert ((sx > w - 1) & (sx <= w)).any()                      # clamped

    def jf(f):
        return jge.rotated_feature_align(f, boxes, points=points,
                                         spatial_scale=1.0 / stride)

    ref, vjp = jax.vjp(jax.jit(jf), feats)
    g = rng.randn(*ref.shape).astype(np.float32)
    ft = _t(feats).requires_grad_(True)
    got = pge.rotated_feature_align(ft, _t(boxes), points=points,
                                    spatial_scale=1.0 / stride)
    _close(got, ref, 1e-5, "align")
    got.backward(_t(g))
    _close(ft.grad, vjp(g)[0], 1e-5, "align grad")


# ---- the rotated box losses -------------------------------------------------

def _loss_inputs():
    rng = np.random.RandomState(4)
    n = 64
    p, t = _obbs(rng, n), _obbs(rng, n)
    t[:16] = p[:16] + rng.normal(0, 0.5, (16, 5)).astype(np.float32)
    w = (rng.rand(n) > 0.3).astype(np.float32)
    return p, t, w


def _degenerate(p, t, w):
    """Positives with a zero width, a 1e-9 height, or equal to their
    target."""
    p, t, w = p.copy(), t.copy(), w.copy()
    p[16:20, 2] = 0.0
    p[20:22, 3] = 1e-9
    t[22:24] = p[22:24]
    w[16:24] = 1.0
    return p, t, w


def _jax_loss(name, p, t, w):
    if name == "kld_v1":
        return jnp.sum(jl._kld_gauss_distance(p, t) * w)
    if name == "gwd":
        return jl.gwd_loss(p, t, weight=w, avg_factor=1.0)
    if name == "kld":
        return jl.kld_loss(p, t, weight=w, avg_factor=1.0)
    if name == "riou":
        return jl.rotated_iou_loss(p, t, weight=w, avg_factor=1.0)
    return jl.kfiou_loss(p * 0.1, t * 0.1, p, t, weight=w, avg_factor=1.0)


def _port_loss(name, p, t, w):
    if name == "kld_v1":
        return (tl._kld_gauss_distance(p, t) * w).sum()
    if name == "gwd":
        return tl.gwd_loss(p, t, weight=w, avg_factor=1.0)
    if name == "kld":
        return tl.kld_loss(p, t, weight=w, avg_factor=1.0)
    if name == "riou":
        return tl.rotated_iou_loss(p, t, weight=w, avg_factor=1.0)
    return tl.kfiou_loss(p * 0.1, t * 0.1, p, t, weight=w, avg_factor=1.0)


@pytest.mark.parametrize("name,degenerate", [
    ("gwd", False), ("kld", False), ("kld_v1", False), ("kfiou", False),
    ("riou", False), ("kfiou", True), ("riou", True)])
def test_rotated_box_losses(name, degenerate):
    """Elementwise values (one-hot weights on a vmapped JAX loss) and the
    gradient of the weighted sum with respect to the predictions."""
    p, t, w = _loss_inputs()
    if degenerate:
        p, t, w = _degenerate(p, t, w)
    eye = np.eye(len(p), dtype=np.float32)
    # XLA's default level: the KFIoU loss, whose determinants cancel, moves
    # past the tolerance at the lowest (FMA contraction differs)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda e: _jax_loss(name, p, t, e)), compiler_options=DEFAULT)(eye))
    gref = np.asarray(jax.jit(jax.grad(
        lambda q: _jax_loss(name, q, t, w)), compiler_options=DEFAULT)(p))
    pt = _t(p).requires_grad_(True)
    got = np.array([float(_port_loss(name, pt, _t(t), _t(e)).detach())
                    for e in eye])
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    _close(got, ref, 1e-5, "values")
    _port_loss(name, pt, _t(t), _t(w)).backward()
    g = pt.grad.numpy()
    # a degenerate box's covariance is rank one up to rounding: its
    # determinant, taken by cancellation, is noise of either sign in both
    # packages, and so is whether its gradient is finite
    regular = np.r_[0:16, 24:len(p)]
    scale = float(np.abs(gref[regular]).max())
    _close(g[regular], gref[regular], 1e-4, "gradients")
    both = np.isfinite(gref[16:24]) & np.isfinite(g[16:24])
    err = float(np.abs(g[16:24][both] - gref[16:24][both]).max())
    assert err <= 1e-3 * scale, ("degenerate gradients", err, scale)


# ---- R3Det and S2ANet -------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    b = _batch(np.random.RandomState(0))
    return {k: np.concatenate([b["rgb"][k], b["ifr"][k]]) for k in b["rgb"]}


def _init_all(key):
    """Flax inits of the backbone, the neck, the retina stage and the two
    refine heads (their parameters do not depend on the number of levels:
    the heads are inited on one)."""
    ks = jax.random.split(key, 5)
    bb = JaxConvNeXt(arch="atto", moe_block_inds=((), (), (), ()))
    feats = [jnp.zeros((1, IMG // s, IMG // s, c)) for s, c in
             zip((4, 8, 16, 32), CFG["neck"]["in_channels"])]
    neck = JaxFPN(in_channels=tuple(CFG["neck"]["in_channels"]),
                  out_channels=CH, num_outs=5, extra_level=1)
    lv, maps = [jnp.zeros((1, 8, 8, CH))], [jnp.zeros((1, 8, 8, 5))]
    return {
        "backbone": bb.init(ks[0], jnp.zeros((1, IMG, IMG, 3)))["params"],
        "neck": neck.init(ks[1], feats)["params"],
        "retina": JaxRetinaHead(num_classes=NC, num_anchors=1).init(
            ks[2], lv)["params"],
        "generic": jrd.RefineHead(num_classes=NC, feat_channels=CH).init(
            ks[3], lv, maps, (8,))["params"],
        "odm": jrd.ODMRefineHead(num_classes=NC, feat_channels=CH).init(
            ks[4], lv, maps, (8,))["params"]}


@pytest.fixture(scope="module")
def params():
    """The inits' tree (``jax.eval_shape``, a trace with no compile) holding
    the seeded inits of the port's R3Det (backbone, neck, retina stage,
    its refine head) and S2ANet (the ODM head), the layer scales drawn
    from U(0.3, 0.8)."""
    template = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                            jax.eval_shape(_init_all, jax.random.PRNGKey(0)))
    names = {"R3Det": {"backbone": "backbone", "neck": "neck",
                       "bbox_head": "retina", "refine_head0": "generic"},
             "S2ANet": {"refine_head0": "odm"}}
    state = {}
    for name, rename in names.items():
        for k, v in DETECTORS[name][1](CFG, device="cpu").state_dict() \
                .items():
            top, rest = k.split(".", 1)
            if top in rename:
                state[f"{rename[top]}.{rest}"] = v
    out = to_flax(state, template)
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key == "gamma" else np.asarray(v), out)


class _R3DetOnFeats(jrd.R3Det):
    """JAX's R3Det, its ``extract_feat`` handed the neck's levels."""

    def extract_feat(self, imgs, train=False):
        return list(imgs), None


class _S2ANetOnFeats(jrd.S2ANet):
    def extract_feat(self, imgs, train=False):
        return list(imgs), None


# (JAX class on the neck's levels, port class, refine head's params,
#  the refine_reg_loss whose gradient is compared, the other)
DETECTORS = {"R3Det": (_R3DetOnFeats, prd.R3Det, "generic", "smooth_l1",
                       "kfiou"),
             "S2ANet": (_S2ANetOnFeats, prd.S2ANet, "odm", "kfiou",
                        "smooth_l1")}


def _tree(params, name):
    return {"backbone": params["backbone"], "neck": params["neck"],
            "bbox_head": params["retina"],
            "refine_head0": params[DETECTORS[name][2]]}


def _cfg(reg_loss):
    c = copy.deepcopy(CFG)
    c["refine_reg_loss"] = reg_loss
    return c


def _norm(tree):
    return float(np.sqrt(sum(float(np.sum(np.square(np.asarray(v))))
                             for v in jax.tree_util.tree_leaves(tree))))


def _neck_levels(tree, imgs):
    return jrd.R3Det(cfg=CFG).apply(
        {"params": tree}, imgs,
        method=lambda m, x: m.extract_feat(x, train=True)[0])


@pytest.fixture(scope="module")
def jax_side(params, data):
    """JAX's neck levels (one compile, with their VJP), then per detector
    the heads' losses and gradient under one ``refine_reg_loss``, the
    losses under the other and ``simple_test``'s head outputs:
    {name: {reg_loss: losses}, name + "_norms": {subtree: gradient norm},
    name + "_heads": (cls, reg, refined anchors), "levels": the neck's
    levels}."""
    pb = {"backbone": params["backbone"], "neck": params["neck"]}
    levels, vjp = jax.vjp(jax.jit(_neck_levels), pb, data["img"])

    def losses(name, p, x, reg_loss):
        return DETECTORS[name][0](cfg=_cfg(reg_loss)).apply(
            {"params": p}, dict(data, img=x), train=True)

    def heads(shared, x):
        """Both detectors in one compile, their retina stages on the same
        parameters."""
        res = {}
        for name, (_, _, head, graded, other) in DETECTORS.items():
            ph = {"bbox_head": shared["retina"],
                  "refine_head0": shared[head]}

            def total(p, x):
                ls = losses(name, p, x, graded)
                return sum(ls.values()), ls
            res[name] = (jax.value_and_grad(total, argnums=(0, 1),
                                            has_aux=True)(ph, x),
                         losses(name, ph, x, other),
                         DETECTORS[name][0](cfg=CFG).apply(
                             {"params": ph}, x, method=_jax_heads))
        return res

    res = jax.jit(heads)({k: params[k] for k in ("retina", "generic",
                                                 "odm")}, levels)
    out = {"levels": levels}
    for name, (_, _, _, graded, other) in DETECTORS.items():
        ((_, ls), (gh, gx)), ls2, out[name + "_heads"] = res[name]
        gb = vjp(gx)[0]
        out[name] = {graded: {k: float(v) for k, v in ls.items()},
                     other: {k: float(v) for k, v in ls2.items()}}
        out[name + "_norms"] = {
            "backbone": _norm(gb["backbone"]), "neck": _norm(gb["neck"]),
            "bbox_head": _norm(gh["bbox_head"]),
            "refine_head0": _norm(gh["refine_head0"])}
    return out


def _port(name, params, reg_loss, trainable=True):
    port = DETECTORS[name][1](_cfg(reg_loss), device="cpu",
                              trainable=trainable)
    port.load_state_dict(from_flax(_tree(params, name)), strict=True)
    return port


@pytest.mark.parametrize("reg_loss", ["smooth_l1", "kfiou"])
@pytest.mark.parametrize("name", list(DETECTORS))
def test_losses_match_jax(params, data, jax_side, name, reg_loss):
    ref = jax_side[name][reg_loss]
    port = _port(name, params, reg_loss)
    losses = port(batch_to({"d": data}, "cpu")["d"])
    assert set(losses) == set(ref)
    got = {k: float(v.detach()) for k, v in losses.items()}
    bad = [(k, got[k], ref[k]) for k in ref if not (np.isfinite(got[k]) and
           abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]) + 1e-9)]
    assert not bad, bad
    assert ref["sr0_loss_bbox"] > 0 and ref["s0_loss_bbox"] > 0
    if reg_loss == DETECTORS[name][3]:
        grads = torch.autograd.grad(sum(losses.values()),
                                    list(port.parameters()),
                                    allow_unused=True)
        sq = {}
        for (n, _), g in zip(port.named_parameters(), grads):
            top = n.split(".")[0]
            sq[top] = sq.get(top, 0.0) + (
                0.0 if g is None else float((g.double() ** 2).sum()))
        ref_norms = jax_side[name + "_norms"]
        assert set(sq) == set(ref_norms)
        bad = [(k, sq[k] ** 0.5, ref_norms[k]) for k in ref_norms
               if not abs(sq[k] ** 0.5 - ref_norms[k]) <= 1e-4 * ref_norms[k]]
        assert not bad, bad


def _jax_heads(module, levels):
    """simple_test from the neck's levels up to the decode: the refine
    stage's outputs and its refined anchors (one refine stage)."""
    x = list(levels)
    cls_scores, bbox_preds = module.bbox_head(x)
    anchors_l = module._anchor_generator().grid_anchors(
        [tuple(s.shape[1:3]) for s in cls_scores])
    maps, flat = jrd._refine_anchor_maps(bbox_preds, anchors_l,
                                         module._coder())
    r_cls, r_reg = module.refine_heads[0](x, maps, STRIDES)
    return r_cls, r_reg, flat


_NMS = dict(score_thr=0.05, iou_thr=0.1, max_per_img=100)


@jax.jit
def _jax_get_bboxes(r_cls, r_reg, flat):
    coder = jrd.DeltaXYWHAOBBoxCoder(angle_range="le90",
                                     target_means=(0.,) * 5,
                                     target_stds=(1.,) * 5)
    return jrd.refine_get_bboxes(r_cls, r_reg, flat, coder, NC, **_NMS)


@pytest.mark.parametrize("name", list(DETECTORS))
def test_simple_test_matches_jax(params, data, jax_side, name):
    """The neck's levels and the refine stage's outputs against JAX's;
    then the decode and NMS fed JAX's own head outputs; then the entry
    point equal to that decode of the port's head outputs."""
    r_cls, r_reg, flat = jax_side[name + "_heads"]
    ref = _jax_get_bboxes(r_cls, r_reg, flat)
    port = _port(name, params, "smooth_l1", trainable=False)
    imgs = _t(data["img"])
    with torch.no_grad():
        x = port.extract_feat(imgs)
        _, _, maps, p_flat = port._first_stage(x)
        p_cls, p_reg = port.refine_heads[0](x, maps, prd.REFINE_STRIDES)
    for a, b in zip(x, jax_side["levels"]):
        _close(a, b, 1e-4, "levels")
    for a, b, what in zip(p_cls + p_reg + p_flat, r_cls + r_reg + flat,
                          ["cls"] * 5 + ["reg"] * 5 + ["anchors"] * 5):
        _close(a, b, 1e-4, what)
    got = prd.refine_get_bboxes(
        [_t(c) for c in r_cls], [_t(r) for r in r_reg],
        [_t(a) for a in flat], prd.make_refine_coder("le90"), NC, **_NMS)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(ref[2]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(ref[1]))
    assert int(np.asarray(ref[2]).sum()) > 10
    _close(got[0][..., :5], ref[0][..., :5], 1e-4, "boxes")
    _close(got[0][..., 5], ref[0][..., 5], 1e-5, "scores")
    full = port.simple_test(imgs, (IMG, IMG), **_NMS)
    own = prd.refine_get_bboxes(p_cls, p_reg, p_flat,
                                prd.make_refine_coder("le90"), NC, **_NMS)
    assert all(torch.equal(a, b) for a, b in zip(full, own))
