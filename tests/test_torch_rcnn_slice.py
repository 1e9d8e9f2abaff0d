"""The PyTorch port's RGB / infrared Oriented R-CNN slice and its joint
inference against the JAX package, on the CPU.

One small detector (ConvNeXt ``atto``, 64 px, 32-channel neck, one MoE block,
50 proposals a level, 40 an image, 10 detections) is initialised in JAX; its
flax params go through ``from_flax`` into the port, and both run the same
numpy images at fp32. Stages are compared one by one (RPN outputs, proposals
from the same RPN outputs, RoI features from the same proposals, logits,
detections from the same logits), then the entry points. Tolerances: 1e-4
absolute and relative for network outputs (fp32 summation order through a
dozen blocks), 1e-4 of the image size for boxes.

With random weights the 27-way softmax sits near 1/27 = 0.037, under
``rcnn_score_thr = 0.05``, and nothing would be detected: the ``fc_cls``
kernels are scaled up (in numpy, before either side reads them) until
several classes clear the threshold. Random ``rpn_reg`` weights also push
most midpoint offsets past their clamp at +-0.5, where the decoded proposal
is an exactly axis-aligned rectangle whose le90 angle is a tie between
-pi/2 and +pi/2: the same rectangle, but the RoI grid of one is the other's
turned by 180 degrees, so the logits differ. The ``rpn_reg`` kernels are
scaled down so that the offsets stay inside the clamp, as trained ones do.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.dense_heads.oriented_rpn_head import \
    rpn_get_proposals as jax_rpn_get_proposals
from sm3det_tpu.models.detectors import trisource as jtri
from sm3det_tpu.models.roi_heads.oriented_roi_head import (
    extract_rotated_roi_feats as jax_extract,
    roi_head_get_bboxes as jax_roi_head_get_bboxes)
from sm3det_tpu.ops.rotated_iou import box_iou_rotated as jax_iou
from sm3det_tpu_torch.convert import OPTIONAL_LEAVES, SUBTREES, from_flax
from sm3det_tpu_torch.models.detectors.trisource import (
    DEFAULT_MODEL_CFG, TriSourceDetector, make_rcnn_coder)
from sm3det_tpu_torch.models.roi_heads.oriented_roi_head import \
    roi_head_get_bboxes
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)

IMG = 64
SHAPE = (IMG, IMG)
TOL = dict(rtol=1e-4, atol=1e-4)
FC_CLS_GAIN = 12.0
RPN_REG_GAIN = 0.2


def _small(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["backbone"].update(arch="atto", moe_block_inds=((), (), (0,), ()),
                           num_experts=2, top_k=1)
    cfg["neck"].update(in_channels=(40, 80, 160, 320), out_channels=32)
    cfg["sar"].update(nms_pre=50, max_per_img=10)
    cfg["rgb"].update(rpn_nms_pre=50, rpn_max=40, rcnn_max=10)
    return cfg


def _jax_init_all(m, imgs):
    ids = jnp.zeros((imgs.shape[0],), jnp.int32)
    feats, _ = m.backbone(imgs, train=True, dataset_ids=ids)
    x = m._neck_rcnn(list(feats))
    for rpn, roi in ((m.rgb_rpn_head, m.rgb_roi_head),
                     (m.ifr_rpn_head, m.ifr_roi_head)):
        rpn(x)
        roi(jnp.zeros((1, 7, 7, x[0].shape[-1]), x[0].dtype))
    return m.sar_bbox_head(m._neck_sar(list(feats)))


def _jax_rpn(m, imgs, which):
    ids = jnp.zeros((imgs.shape[0],), jnp.int32)
    feats, _ = m.backbone(imgs, train=False, dataset_ids=ids)
    x = m._neck_rcnn(list(feats))
    head = m.rgb_rpn_head if which == "rgb" else m.ifr_rpn_head
    return x, head(x)


_RPN_JIT = {}


def rpn_ref(jmodel, which):
    """The jitted ``_jax_rpn`` of one modality, made once and shared by the
    tests that read it (a jitted lambda made per test compiles again)."""
    key = (id(jmodel), which)
    if key not in _RPN_JIT:
        _RPN_JIT[key] = jax.jit(lambda v, a: jmodel.apply(
            v, a, which, method=_jax_rpn))
    return _RPN_JIT[key]


def _jax_roi_head(m, roi_feats, which):
    head = m.rgb_roi_head if which == "rgb" else m.ifr_roi_head
    return head(roi_feats)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port's model, images by modality)."""
    rng = np.random.RandomState(0)
    imgs = {k: rng.rand(n, IMG, IMG, 3).astype(np.float32)
            for k, n in (("sar", 2), ("rgb", 2), ("ifr", 1))}
    cfg = _small(jtri.DEFAULT_MODEL_CFG)
    cfg["multi_tasks_reweight"] = "uncertainty"     # a tree with mtl_sigma
    jmodel = jtri.TriSourceDetector(cfg=cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jax.jit(lambda x: jmodel.init(
        {"params": keys[0], "dropout": keys[1], "moe_noise": keys[2]}, x,
        method=_jax_init_all))(imgs["sar"])["params"]
    params = jax.tree.map(np.asarray, params)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key == "gamma" else v, params)
    params["sar_bbox_head"]["gfl_cls"]["bias"] = np.full_like(
        params["sar_bbox_head"]["gfl_cls"]["bias"], 0.5)
    for head in ("rgb_roi_head", "ifr_roi_head"):
        params[head]["fc_cls"]["kernel"] = \
            params[head]["fc_cls"]["kernel"] * FC_CLS_GAIN
    for head in ("rgb_rpn_head", "ifr_rpn_head"):
        params[head]["rpn_reg"]["kernel"] = \
            params[head]["rpn_reg"]["kernel"] * RPN_REG_GAIN
    port_cfg = _small(DEFAULT_MODEL_CFG)
    port_cfg["multi_tasks_reweight"] = "uncertainty"   # it holds mtl_sigma
    port = TriSourceDetector(port_cfg, device="cpu")
    port.load_state_dict(from_flax(params), strict=True)
    return jmodel, {"params": params}, port, imgs


def _np(t):
    return t.detach().numpy()


def _close(got, ref, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(ref), **(tol or TOL))


def _same_obbs(got, ref, tol=1e-4):
    """Fieldwise within tol of the image size, or the same rectangle in its
    other description (a near-tie of w and h swaps them and turns the angle
    by 90 degrees)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    flat_g, flat_r = got.reshape(-1, 5), ref.reshape(-1, 5)
    close = np.abs(flat_g - flat_r).max(-1) <= tol * IMG
    if not close.all():
        iou = np.asarray(jax_iou(flat_g[~close], flat_r[~close],
                                 aligned=True))
        assert (iou >= 1 - 1e-4).all(), (flat_g[~close], flat_r[~close])


def _assert_dets(got, ref):
    dets, labels, valid = (_np(t) for t in got)
    rdets, rlabels, rvalid = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(valid, rvalid)
    np.testing.assert_array_equal(labels, rlabels)
    np.testing.assert_allclose(dets[..., -1], rdets[..., -1], atol=1e-4)
    if dets.shape[-1] == 6:
        _same_obbs(dets[..., :5], rdets[..., :5])
    else:
        np.testing.assert_allclose(dets, rdets, atol=1e-4 * IMG)


def test_from_flax_consumes_the_whole_tree(pair):
    _, variables, port, _ = pair
    params = variables["params"]
    assert set(params) == set(SUBTREES) | set(OPTIONAL_LEAVES)
    state = from_flax(params)
    n_leaves = sum(len(jax.tree_util.tree_leaves(params[s]))
                   for s in SUBTREES + OPTIONAL_LEAVES)
    assert len(state) == n_leaves
    assert set(state) == set(port.state_dict())
    np.testing.assert_array_equal(_np(state["mtl_sigma"]),
                                  params["mtl_sigma"])
    assert state["rgb_roi_head.shared_fc0.weight"].shape == (1024, 7 * 7 * 32)
    assert state["ifr_rpn_head.rpn_reg.weight"].shape == (18, 256, 1, 1)
    for bad_path in (("rgb_roi_head", "fc_reg", "unknown"), ("aux_head",)):
        bad = copy.deepcopy(params)
        node = bad
        for k in bad_path[:-1]:
            node = node[k]
        node[bad_path[-1]] = np.zeros(3, np.float32)
        with pytest.raises(KeyError, match=bad_path[-1]):
            from_flax(bad)


@pytest.mark.parametrize("which", ["rgb", "ifr"])
def test_rpn_head_outputs(pair, which):
    jmodel, variables, port, imgs = pair
    x_ref, (cls_ref, reg_ref) = rpn_ref(jmodel, which)(variables,
                                                       imgs[which])
    x = port.neck_rcnn(port.extract_feat(imgs[which]))
    cls, reg = port.head_rpn(x, which)
    assert len(x) == len(cls) == 5
    for g, r in zip(list(x) + cls + reg,
                    list(x_ref) + list(cls_ref) + list(reg_ref)):
        assert tuple(g.shape) == r.shape
        _close(g, r)


def test_rpn_get_proposals_from_the_same_outputs(pair):
    jmodel, variables, port, imgs = pair
    _, (cls_ref, reg_ref) = rpn_ref(jmodel, "rgb")(variables, imgs["rgb"])
    sizes = [int(np.prod(c.shape[1:])) for c in cls_ref]
    assert min(sizes) < 50 < max(sizes)        # the level padding runs
    r = port.cfg["rgb"]
    ref = jax.jit(lambda c, d: jax_rpn_get_proposals(
        list(c), list(d), jtri.make_rpn_anchor_generator(),
        jtri.make_rpn_coder("le90"), SHAPE, nms_pre=r["rpn_nms_pre"],
        max_per_img=r["rpn_max"], iou_thr=r["rpn_nms_iou"]))(
            cls_ref, reg_ref)
    got = port.get_proposals([torch.from_numpy(np.asarray(c))
                              for c in cls_ref],
                             [torch.from_numpy(np.asarray(c))
                              for c in reg_ref], SHAPE)
    assert got[0].shape == (2, 40, 5)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(ref[2]))
    assert 10 < int(got[2].sum())
    _close(got[1], ref[1], atol=1e-6, rtol=1e-6)
    _same_obbs(_np(got[0]), ref[0])


def test_roi_feats_and_logits_from_the_same_proposals(pair):
    jmodel, variables, port, imgs = pair
    x_ref, (cls_ref, reg_ref) = rpn_ref(jmodel, "rgb")(variables,
                                                       imgs["rgb"])
    x = [torch.from_numpy(np.asarray(f)) for f in x_ref]
    proposals, _, _ = port.get_proposals(
        [torch.from_numpy(np.asarray(c)) for c in cls_ref],
        [torch.from_numpy(np.asarray(c)) for c in reg_ref], SHAPE)
    feats = port.roi_feats(x, proposals)
    idx = np.repeat(np.arange(2, dtype=np.float32), 40)[:, None]
    rois6 = np.concatenate([idx, _np(proposals).reshape(-1, 5)], -1)
    feats_ref = jax_extract(list(x_ref[:4]), jnp.asarray(rois6))
    assert feats.shape == (80, 7, 7, 32)
    _close(feats, feats_ref, atol=1e-5, rtol=1e-5)
    for which, head in (("rgb", port.rgb_roi_head),
                        ("ifr", port.ifr_roi_head)):
        logits_ref, deltas_ref = jmodel.apply(
            variables, feats_ref, which, method=_jax_roi_head)
        logits, deltas = head(feats)
        assert logits.shape == (80, 27) and deltas.shape == (80, 5)
        _close(logits, logits_ref)
        _close(deltas, deltas_ref)


def test_rcnn_detections_from_the_same_logits(pair):
    jmodel, variables, port, imgs = pair
    rng = np.random.RandomState(3)
    n = 40
    rois = np.stack([rng.uniform(5, 59, n), rng.uniform(5, 59, n),
                     rng.uniform(6, 30, n), rng.uniform(6, 30, n),
                     rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)
    logits = rng.normal(0, 2.5, (n, 27)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (n, 5)).astype(np.float32)
    valid = rng.rand(n) > 0.15
    ref = jax.jit(lambda lg, dl, ro, va: jax_roi_head_get_bboxes(
        lg, dl, ro, va, jtri.make_rcnn_coder("le90"), 26, img_shape=SHAPE,
        max_per_img=30))(logits, deltas, rois, valid)
    got = roi_head_get_bboxes(
        torch.from_numpy(logits), torch.from_numpy(deltas),
        torch.from_numpy(rois), torch.from_numpy(valid),
        make_rcnn_coder("le90"), 26, img_shape=SHAPE, max_per_img=30)
    assert 5 < int(got[2].sum()) <= 30
    assert len(set(_np(got[1])[_np(got[2])].tolist())) > 3
    _assert_dets(got, ref)
    # through the detector's method, batched over two images
    both = port.get_bboxes_rcnn(
        torch.from_numpy(np.stack([logits, logits[::-1]])),
        torch.from_numpy(np.stack([deltas, deltas[::-1]])),
        torch.from_numpy(np.stack([rois, rois[::-1]])),
        torch.from_numpy(np.stack([valid, valid[::-1]])), SHAPE,
        max_per_img=30)
    for x, y in zip(both, got):
        np.testing.assert_array_equal(_np(x[0]), _np(y))


@pytest.mark.parametrize("which", ["rgb", "ifr"])
def test_simple_test_rcnn_detections(pair, which):
    jmodel, variables, port, imgs = pair
    ref = jax.jit(lambda v, a: jmodel.apply(
        v, a, SHAPE, method=f"simple_test_{which}"))(variables, imgs[which])
    got = port.simple_test(imgs[which], which, img_shape=SHAPE)
    assert got[0].shape == (imgs[which].shape[0], 10, 6)
    assert int(got[2].sum()) > 0                       # real detections
    assert len(set(_np(got[1])[_np(got[2])].tolist())) > 1
    _assert_dets(got, ref)


def test_simple_test_joint_matches_jax_and_per_modality(pair):
    jmodel, variables, port, imgs = pair
    ref = jax.jit(lambda v, a, b, c: jmodel.apply(
        v, a, b, c, SHAPE, method="simple_test_joint"))(
            variables, imgs["sar"], imgs["rgb"], imgs["ifr"])
    got = port.simple_test_joint(imgs["sar"], imgs["rgb"], imgs["ifr"],
                                 img_shape=SHAPE)
    for g, r, name in zip(got, ref, ("sar", "rgb", "ifr")):
        assert int(g[2].sum()) > 0, name
        _assert_dets(g, r)
        # the joint batch changes no image's result inside the port
        alone = port.simple_test(imgs[name], name, img_shape=SHAPE)
        np.testing.assert_array_equal(_np(g[2]), _np(alone[2]))
        np.testing.assert_array_equal(_np(g[1]), _np(alone[1]))
        np.testing.assert_allclose(_np(g[0]), _np(alone[0]), atol=1e-3,
                                   rtol=1e-4)


def test_aug_test_rgb_with_horizontal_flip(pair):
    jmodel, variables, port, imgs = pair
    ref = jax.jit(lambda v, a: jmodel.apply(
        v, a, "rgb", SHAPE, method="aug_test"))(variables, imgs["rgb"])
    got = port.aug_test(imgs["rgb"], "rgb", img_shape=SHAPE,
                        flip_directions=(None, "horizontal"))
    assert got[0].shape == (2, 10, 6) and int(got[2].sum()) > 0
    _assert_dets(got, ref)
    sar = port.aug_test(imgs["sar"], "sar", img_shape=SHAPE,
                        flip_directions=(None, "vertical"))
    assert sar[0].shape == (2, 10, 5) and int(sar[2].sum()) > 0


def test_aug_test_rgb_at_half_scale(pair):
    """``scales=(0.5, 1.0)``: the port resizes with ``F.interpolate(...,
    antialias=True)``, JAX with ``jax.image.resize(method="bilinear")``.
    The two half-scale images (1e-5), then the features and RPN outputs of
    the same half-scale image, then the merged detections of both scales
    and both flips."""
    jmodel, variables, port, imgs = pair
    x = imgs["rgb"]
    half = (IMG // 2, IMG // 2)
    ref_img = np.array(jax.image.resize(
        jnp.asarray(x), (x.shape[0],) + half + (3,), method="bilinear"))
    got_img = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=half, mode="bilinear",
        align_corners=False, antialias=True).permute(0, 2, 3, 1)
    _close(got_img, ref_img, atol=1e-5, rtol=1e-5)
    x_ref, (cls_ref, reg_ref) = rpn_ref(jmodel, "rgb")(variables, ref_img)
    feats = port.neck_rcnn(port.extract_feat(torch.from_numpy(ref_img)))
    cls, reg = port.head_rpn(feats, "rgb")
    for g, r in zip(list(feats) + cls + reg,
                    list(x_ref) + list(cls_ref) + list(reg_ref)):
        assert tuple(g.shape) == r.shape
        _close(g, r)
    ref = jax.jit(lambda v, a: jmodel.apply(
        v, a, "rgb", SHAPE, (0.5, 1.0), method="aug_test"))(variables, x)
    got = port.aug_test(x, "rgb", img_shape=SHAPE, scales=(0.5, 1.0))
    assert got[0].shape == (2, 10, 6) and int(got[2].sum()) > 0
    _assert_dets(got, ref)
