"""The heads and helpers of the TriSource variants and the zoo's detectors
against the JAX package, on the CPU, at fp32.

Module by module, on inputs made from a seed with numpy: the horizontal
delta coder (encode; decode with ``max_shape`` and ``wh_ratio_clip``), the
rotated anchor generator of the retina recipe, the sigmoid focal and L1
losses, the chunked rotated IoU (more rows than a chunk), the heads'
outputs (``RPNHead``, ``Shared2FCBBoxHead``, ``RotatedRetinaHead``, flax
inits carried over by ``convert_tree``), the horizontal RPN's loss and
proposals, the horizontal RoI sampling, loss, align and detections, and
the retina loss (L1 and Smooth L1) and detections. The samplers are handed
the uniform keys ``jax.random`` drew for the JAX function.

Tolerances: the coder, anchors and sampling exactly or within 1e-5 of
scale; losses within 1e-5 relative; head outputs, aligned features and
IoUs within 1e-5 of scale; proposals and detections with the same validity
and labels, boxes within 1e-4 of scale and scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.core.anchor import AnchorGenerator as JaxAnchorGenerator
from sm3det_tpu.core.bbox.coders import DeltaXYWHBBoxCoder as JaxCoder
from sm3det_tpu.models import losses as jax_losses
from sm3det_tpu.models.dense_heads import rotated_retina_head as jrh
from sm3det_tpu.models.dense_heads import rpn_head as jrpn
from sm3det_tpu.models.roi_heads import standard_roi_head as jsrh
from sm3det_tpu.ops.rotated_iou import \
    box_iou_rotated_chunked as jax_iou_chunked
from sm3det_tpu_torch.convert import convert_tree
from sm3det_tpu_torch.core.anchor import AnchorGenerator
from sm3det_tpu_torch.core.bbox.coders import DeltaXYWHBBoxCoder
from sm3det_tpu_torch.models import losses
from sm3det_tpu_torch.models.dense_heads import rotated_retina_head as prh
from sm3det_tpu_torch.models.dense_heads import rpn_head as prpn
from sm3det_tpu_torch.models.roi_heads import standard_roi_head as psrh
from sm3det_tpu_torch.ops.rotated_iou import box_iou_rotated_chunked

IMG = 64
C = 32
NC = 4
G = 4
LEVELS_R = (16, 8, 4, 2, 1)       # strides 4-64 at 64 px
LEVELS_S = (8, 4, 2, 1, 1)        # strides 8-128


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
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _rel(got, ref, tol=1e-5):
    got, ref = float(got), float(ref)
    assert np.isfinite(got) and abs(got - ref) <= tol * abs(ref) + 1e-9, \
        (got, ref)


def _split_keys(rng, b, p):
    """JAX's per-image sampler draws from one key: ``split(rng, b)``, then
    ``random_sample``'s split into two uniform key vectors."""
    kp, kn = [], []
    for r in jax.random.split(rng, b):
        rp, rn = jax.random.split(r)
        kp.append(np.asarray(jax.random.uniform(rp, (p,))))
        kn.append(np.asarray(jax.random.uniform(rn, (p,))))
    return _t(np.stack(kp)), _t(np.stack(kn))


def _image_keys(rng, p):
    """``random_sample``'s two uniform key vectors of one image."""
    rp, rn = jax.random.split(rng)
    return (_t(np.asarray(jax.random.uniform(rp, (p,)))),
            _t(np.asarray(jax.random.uniform(rn, (p,)))))


def _hbbs(rng, shape, lo=4, hi=28):
    cx, cy = rng.uniform(10, IMG - 10, (2,) + shape)
    w, h = rng.uniform(lo, hi, (2,) + shape)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    -1).astype(np.float32)


def _obbs(rng, shape):
    return np.stack([rng.uniform(12, IMG - 12, shape),
                     rng.uniform(12, IMG - 12, shape),
                     rng.uniform(10, 30, shape), rng.uniform(6, 14, shape),
                     rng.uniform(-1.4, 1.4, shape)], -1).astype(np.float32)


def _levels(rng, b, sizes, ch, scale=1.0):
    return [(rng.randn(b, s, s, ch) * scale).astype(np.float32)
            for s in sizes]


def _load(module, params, prefix="m"):
    sd = convert_tree(params, (prefix,))
    module.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                           strict=True)
    return module


# ---- coder, anchors, losses, IoU -----------------------------------------

@pytest.mark.parametrize("max_shape", [None, (IMG, IMG + 16)])
def test_delta_xywh_coder(max_shape):
    rng = np.random.RandomState(0)
    stds = (0.1, 0.1, 0.2, 0.2)
    jc, pc = JaxCoder(target_stds=stds), DeltaXYWHBBoxCoder(target_stds=stds)
    boxes, gts = _hbbs(rng, (64,)), _hbbs(rng, (64,))
    gts[:4, 2:] = gts[:4, :2]                    # zero-size gts
    _close(pc.encode(_t(boxes), _t(gts)), jc.encode(boxes, gts), 1e-5,
           "encode")
    deltas = rng.randn(64, 4).astype(np.float32)
    deltas[:8, 2:] *= 40                         # past wh_ratio_clip
    _close(pc.decode(_t(boxes), _t(deltas), max_shape=max_shape),
           jc.decode(boxes, deltas, max_shape=max_shape), 1e-5, "decode")


def test_rotated_anchor_generator():
    sizes = [(s, s) for s in LEVELS_S]
    ref = jrh.make_retina_anchor_generator().grid_anchors(sizes)
    got = prh.make_retina_anchor_generator().grid_anchors(sizes)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    assert ref[0].shape == (8 * 8 * 9, 5)


def test_focal_and_l1_losses():
    rng = np.random.RandomState(1)
    logits = rng.randn(200, NC).astype(np.float32) * 3
    labels = rng.randint(0, NC + 1, 200).astype(np.int32)
    w = (rng.rand(200) > 0.2).astype(np.float32)
    _rel(losses.sigmoid_focal_loss(_t(logits), _t(labels), weight=_t(w),
                                   avg_factor=7.0),
         jax_losses.sigmoid_focal_loss(logits, labels, weight=w,
                                       avg_factor=7.0))
    a, b = rng.randn(2, 200, 5).astype(np.float32)
    w5 = w[:, None].repeat(5, 1)
    _rel(losses.l1_loss(_t(a), _t(b), weight=_t(w5), avg_factor=3.0),
         jax_losses.l1_loss(a, b, weight=w5, avg_factor=3.0))
    _rel(losses.l1_loss(_t(a), _t(b)), jax_losses.l1_loss(a, b))


def test_box_iou_rotated_chunked():
    """More rows than one chunk (JAX maps over padded chunks)."""
    rng = np.random.RandomState(2)
    b1, b2 = _obbs(rng, (300,)), _obbs(rng, (7,))
    b1[:40, :2] = b2[rng.randint(0, 7, 40), :2]     # overlapping pairs
    ref = np.asarray(jax_iou_chunked(b1, b2, row_chunk=128))
    got = box_iou_rotated_chunked(_t(b1), _t(b2), row_chunk=128)
    assert got.shape == (300, 7) and (ref > 0.1).sum() > 20
    _close(got, ref, 1e-5)


# ---- heads ---------------------------------------------------------------

@pytest.fixture(scope="module")
def heads():
    """Flax inits of the three heads and the port's modules holding them."""
    rng = np.random.RandomState(3)
    key = jax.random.PRNGKey(0)
    x_r = _levels(rng, 2, LEVELS_R, C)
    x_s = _levels(rng, 2, LEVELS_S, C)
    roi = rng.randn(6, 7, 7, C).astype(np.float32)
    out = {"x_r": x_r, "x_s": x_s, "roi_x": roi}
    for name, jmod, pmod, x in (
            ("rpn", jrpn.RPNHead(), prpn.RPNHead(in_channels=C), x_r),
            ("roi", jsrh.Shared2FCBBoxHead(num_classes=NC),
             psrh.Shared2FCBBoxHead(num_classes=NC, in_channels=C), roi),
            ("retina", jrh.RotatedRetinaHead(num_classes=NC),
             prh.RotatedRetinaHead(num_classes=NC, in_channels=C), x_s)):
        params = jax.jit(jmod.init)(key, x)["params"]
        out[name] = (jax.jit(jmod.apply)({"params": params}, x),
                     _load(pmod, params), params)
    return out


def _arrays(out):
    if hasattr(out, "shape"):
        return [out]
    return [a for o in out for a in _arrays(o)]


@pytest.mark.parametrize("name", ["rpn", "roi", "retina"])
def test_head_outputs(heads, name):
    ref, mod, _ = heads[name]
    x = heads["roi_x"] if name == "roi" else \
        heads["x_s" if name == "retina" else "x_r"]
    with torch.no_grad():
        got = mod(_t(x) if name == "roi" else [_t(v) for v in x])
    got, ref = _arrays(got), _arrays(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        _close(g, r, 1e-5, name)


# ---- horizontal RPN --------------------------------------------------------

def _rpn_outputs(rng, b, gain=0.3):
    cls = [(rng.randn(b, s, s, 3) * 2).astype(np.float32) for s in LEVELS_R]
    reg = [(rng.randn(b, s, s, 12) * gain).astype(np.float32)
           for s in LEVELS_R]
    return cls, reg


def test_hbb_rpn_loss():
    rng = np.random.RandomState(4)
    cls, reg = _rpn_outputs(rng, 2)
    gts = _hbbs(rng, (2, G), 12, 40)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    key = jax.random.PRNGKey(11)
    jgen = JaxAnchorGenerator([4, 8, 16, 32, 64], [0.5, 1.0, 2.0], [8])
    ref = jax.jit(lambda k, c, r: jrpn.hbb_rpn_loss(
        k, c, r, gts, mask, jgen, JaxCoder()))(key, cls, reg)
    n_anchors = sum(c[0].size for c in cls)
    got = prpn.hbb_rpn_loss(
        _split_keys(key, 2, n_anchors), [_t(c) for c in cls],
        [_t(r) for r in reg], _t(gts), _t(mask),
        AnchorGenerator([4, 8, 16, 32, 64], [0.5, 1.0, 2.0], [8]),
        DeltaXYWHBBoxCoder())
    assert float(ref["loss_rpn_bbox"]) > 0
    for k in ("loss_rpn_cls", "loss_rpn_bbox"):
        _rel(got[k], ref[k])


@pytest.mark.parametrize("img_shape", [None, (IMG, IMG)])
def test_hbb_rpn_get_proposals(img_shape):
    """Up to 30 per level, 40 kept an image: candidates from every level,
    suppression across levels prevented by the level offset."""
    rng = np.random.RandomState(5)
    cls, reg = _rpn_outputs(rng, 2)
    jgen = JaxAnchorGenerator([4, 8, 16, 32, 64], [0.5, 1.0, 2.0], [8])
    ref = jax.jit(lambda c, r: jrpn.hbb_rpn_get_proposals(
        c, r, jgen, JaxCoder(), img_shape, nms_pre=30,
        max_per_img=40))(cls, reg)
    got = prpn.hbb_rpn_get_proposals(
        [_t(c) for c in cls], [_t(r) for r in reg],
        AnchorGenerator([4, 8, 16, 32, 64], [0.5, 1.0, 2.0], [8]),
        DeltaXYWHBBoxCoder(), img_shape, nms_pre=30, max_per_img=40)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(ref[2]))
    assert int(np.asarray(ref[2]).sum()) > 10
    _close(got[0], ref[0], 1e-4, "boxes")
    _close(got[1], ref[1], 1e-5, "scores")


# ---- horizontal RoI head ---------------------------------------------------

@pytest.fixture(scope="module")
def hbb_sampled():
    rng = np.random.RandomState(6)
    gts = _hbbs(rng, (G,), 12, 30)
    labels = rng.randint(0, NC, G).astype(np.int32)
    mask = np.array([1, 1, 1, 0], bool)
    props = np.concatenate([gts[:3] + rng.randn(3, 4).astype(np.float32),
                            _hbbs(rng, (45,), 8, 30)])
    pvalid = rng.rand(48) > 0.1
    key = jax.random.PRNGKey(12)
    ref = jsrh.sample_hbb_rois(key, props, pvalid, gts, labels, mask, num=32)
    got = psrh.sample_hbb_rois(
        _image_keys(key, G + 48), _t(props), _t(pvalid), _t(gts),
        _t(labels), _t(mask),
        psrh.candidate_gt_overlaps(_t(props)[None], _t(gts)[None])[0],
        num=32)
    return {"ref": ref, "got": got, "gts": gts, "labels": labels, "rng": rng}


def test_sample_hbb_rois(hbb_sampled):
    ref, got = hbb_sampled["ref"], hbb_sampled["got"]
    for k in ("pos_mask", "neg_mask", "gt_idx"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]), k)
    np.testing.assert_array_equal(_np(got["rois"]), np.asarray(ref["rois"]))
    assert 0 < int(np.asarray(ref["pos_mask"]).sum()) < 32


def test_hbb_head_loss(hbb_sampled):
    rng = hbb_sampled["rng"]
    logits = rng.randn(32, NC + 1).astype(np.float32)
    reg = (rng.randn(32, 4 * NC) * 0.3).astype(np.float32)
    stds = (0.1, 0.1, 0.2, 0.2)
    ref = jsrh.hbb_head_loss(logits, reg, hbb_sampled["ref"],
                             hbb_sampled["gts"], hbb_sampled["labels"],
                             JaxCoder(target_stds=stds), NC)
    got = psrh.hbb_head_loss(_t(logits), _t(reg), hbb_sampled["got"],
                             _t(hbb_sampled["gts"]),
                             _t(hbb_sampled["labels"]),
                             DeltaXYWHBBoxCoder(target_stds=stds), NC)
    _rel(got[0], ref[0])
    _rel(got[1], ref[1])
    assert int(got[2]) == int(ref[2]) and int(got[3]) == int(ref[3])


def test_hbb_head_get_bboxes():
    rng = np.random.RandomState(7)
    rois = _hbbs(rng, (60,), 8, 30)
    valid = rng.rand(60) > 0.1
    logits = (rng.randn(60, NC + 1) * 2).astype(np.float32)
    reg = (rng.randn(60, 4 * NC) * 0.3).astype(np.float32)
    ref = jax.jit(lambda lg, rg: jsrh.hbb_head_get_bboxes(
        lg, rg, rois, valid, JaxCoder(), NC, img_shape=(IMG, IMG),
        score_thr=0.1, max_per_img=30))(logits, reg)
    got = psrh.hbb_head_get_bboxes(_t(logits), _t(reg), _t(rois), _t(valid),
                                   DeltaXYWHBBoxCoder(), NC,
                                   img_shape=(IMG, IMG), score_thr=0.1,
                                   max_per_img=30)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(ref[2]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(ref[1]))
    assert int(np.asarray(ref[2]).sum()) > 5
    _close(got[0][..., :4], ref[0][..., :4], 1e-4, "boxes")
    _close(got[0][..., 4], ref[0][..., 4], 1e-5, "scores")


def test_extract_hbb_roi_feats():
    rng = np.random.RandomState(8)
    feats = _levels(rng, 2, LEVELS_R[:4], 8)
    boxes = np.concatenate([_hbbs(rng, (20,), 4, 20),
                            _hbbs(rng, (20,), 30, 60)])
    rois5 = np.concatenate([rng.randint(0, 2, (40, 1)).astype(np.float32),
                            boxes], -1)
    ref = jax.jit(jsrh.extract_hbb_roi_feats)(feats, rois5)
    got = psrh.extract_hbb_roi_feats([_t(f) for f in feats], _t(rois5))
    assert tuple(got.shape) == (40, 7, 7, 8)
    _close(got, ref, 1e-5)


# ---- rotated RetinaNet -----------------------------------------------------

def _retina_outputs(rng, b):
    cls = [(rng.randn(b, s, s, 9 * NC) * 2 - 2).astype(np.float32)
           for s in LEVELS_S]
    reg = [(rng.randn(b, s, s, 45) * 0.3).astype(np.float32)
           for s in LEVELS_S]
    return cls, reg


@pytest.mark.parametrize("reg_loss", ["l1", "smooth_l1"])
def test_retina_loss(reg_loss):
    rng = np.random.RandomState(9)
    cls, reg = _retina_outputs(rng, 2)
    gts = _obbs(rng, (2, G))
    labels = rng.randint(0, NC, (2, G)).astype(np.int32)
    mask = np.array([[1, 1, 0, 1], [1, 1, 1, 1]], bool)
    ref = jax.jit(lambda c, r: jrh.retina_loss(
        c, r, gts, labels, mask, jrh.make_retina_anchor_generator(),
        jrh.make_retina_coder(), NC, reg_loss=reg_loss))(cls, reg)
    got = prh.retina_loss([_t(c) for c in cls], [_t(r) for r in reg],
                          _t(gts), _t(labels), _t(mask),
                          prh.make_retina_anchor_generator(),
                          prh.make_retina_coder(), NC, reg_loss=reg_loss)
    assert float(ref["loss_bbox"]) > 0
    for k in ("loss_cls", "loss_bbox"):
        _rel(got[k], ref[k])


def test_retina_get_bboxes():
    rng = np.random.RandomState(10)
    cls, reg = _retina_outputs(rng, 2)
    ref = jax.jit(lambda c, r: jrh.retina_get_bboxes(
        c, r, jrh.make_retina_anchor_generator(), jrh.make_retina_coder(),
        NC, (IMG, IMG), nms_pre=100, score_thr=0.2,
        max_per_img=50))(cls, reg)
    got = prh.retina_get_bboxes([_t(c) for c in cls], [_t(r) for r in reg],
                                prh.make_retina_anchor_generator(),
                                prh.make_retina_coder(), NC, (IMG, IMG),
                                nms_pre=100, score_thr=0.2, max_per_img=50)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(ref[2]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(ref[1]))
    assert int(np.asarray(ref[2]).sum()) > 10
    _close(got[0][..., :5], ref[0][..., :5], 1e-4, "boxes")
    _close(got[0][..., 5], ref[0][..., 5], 1e-5, "scores")


def test_unported_retina_parts_raise():
    cls, reg = _retina_outputs(np.random.RandomState(0), 1)
    with pytest.raises(NotImplementedError, match="item 7"):
        prh.retina_loss([_t(c) for c in cls], [_t(r) for r in reg],
                        torch.zeros(1, G, 5), torch.zeros(1, G, dtype=int),
                        torch.ones(1, G, dtype=bool),
                        prh.make_retina_anchor_generator(),
                        prh.make_retina_coder(), NC, reg_loss="kld")
    with pytest.raises(NotImplementedError, match="angle_coder"):
        prh.CSLRetinaHead(num_classes=NC)
    with pytest.raises(NotImplementedError, match="angle_coder"):
        prh.csl_angle_loss(None, None, None, None)
