"""The PyTorch port's SAR slice against the JAX package's simple_test_sar.

One small detector (ConvNeXt ``atto``, 64 px, one MoE block with four
experts and top-2 routing) holds one parameter tree: the JAX init's
structure (``jax.eval_shape``, no compile) with the port's seeded init as
its values; ``from_flax`` loads it into the port, and both run the same
numpy images on the CPU.
The stages are compared one by one (backbone features, neck, head logits),
then the detections. Everything is fp32: the tolerance is 1e-4 absolute and
relative, the summation-order noise of fp32 through a dozen blocks.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.detectors.trisource import (
    DEFAULT_MODEL_CFG as JAX_CFG, TriSourceDetector as JaxDetector)
from sm3det_tpu_torch.convert import SUBTREES, from_flax, to_flax
from sm3det_tpu_torch.models.detectors.trisource import (
    DEFAULT_MODEL_CFG, TriSourceDetector)
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)

IMG = 64
TOL = dict(rtol=1e-4, atol=1e-4)


def _small(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["backbone"].update(arch="atto", moe_block_inds=((), (), (0,), ()),
                           num_experts=4, top_k=2)
    cfg["neck"].update(in_channels=(40, 80, 160, 320), out_channels=32)
    cfg["sar"].update(nms_pre=50, max_per_img=10)
    return cfg


def _jax_feats(m, imgs):
    ids = jnp.zeros((imgs.shape[0],), jnp.int32)
    feats, _ = m.backbone(imgs, train=False, dataset_ids=ids)
    return feats


def _jax_init_sar(m, imgs):
    # train=True so that the MoE's noisy-gate weight w_noise exists, as in
    # a training checkpoint; the RGB / infrared heads are touched so that
    # the tree is the whole detector's, as from_flax expects
    ids = jnp.zeros((imgs.shape[0],), jnp.int32)
    feats, _ = m.backbone(imgs, train=True, dataset_ids=ids)
    x = m._neck_rcnn(list(feats))
    for rpn, roi in ((m.rgb_rpn_head, m.rgb_roi_head),
                     (m.ifr_rpn_head, m.ifr_roi_head)):
        rpn(x)
        roi(jnp.zeros((1, 7, 7, x[0].shape[-1]), x[0].dtype))
    return m.sar_bbox_head(m._neck_sar(list(feats)))


def _jax_outs(m, imgs):
    """The backbone's features, the SAR neck's levels, the GFL head's
    logits and ``simple_test_sar``'s detections."""
    feats = _jax_feats(m, imgs)
    x = m._neck_sar(list(feats))
    return feats, x, m.sar_bbox_head(x), m.simple_test_sar(imgs, (IMG, IMG))




@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port's model, the images)."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(2, IMG, IMG, 3).astype(np.float32)
    jmodel = JaxDetector(cfg=_small(JAX_CFG))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    port = TriSourceDetector(_small(DEFAULT_MODEL_CFG), device="cpu")
    # the JAX init's tree (a trace, no compile) holding the port's seeded
    # init
    shapes = jax.eval_shape(lambda x: jmodel.init(
        {"params": keys[0], "dropout": keys[1], "moe_noise": keys[2]}, x,
        method=_jax_init_sar), imgs)["params"]
    params = to_flax(dict(port.state_dict()), jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    # the layer scale's 1e-6 init would hide every block's MLP; the
    # prior-probability bias (-4.6) would leave every score under
    # score_thr, and the NMS would compare nothing
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key == "gamma" else v, params)
    params["sar_bbox_head"]["gfl_cls"]["bias"] = np.full_like(
        params["sar_bbox_head"]["gfl_cls"]["bias"], 0.5)
    port.load_state_dict(from_flax(params), strict=True)
    return jmodel, {"params": params}, port, imgs


@pytest.fixture(scope="module")
def jax_ref(pair):
    """Every JAX output the tests hold, in one compile."""
    jmodel, variables, _, imgs = pair
    return jax.jit(lambda v, x: jmodel.apply(v, x, method=_jax_outs))(
        variables, imgs)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def test_from_flax_consumes_every_leaf(pair):
    _, variables, port, _ = pair
    state = from_flax(variables["params"])
    n_leaves = sum(len(jax.tree_util.tree_leaves(variables["params"][s]))
                   for s in SUBTREES)
    assert len(state) == n_leaves
    assert set(state) == set(port.state_dict())
    bad = copy.deepcopy(variables["params"])
    bad["neck"]["lateral1"]["unknown"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unknown"):
        from_flax(bad)


def test_backbone_features(pair, jax_ref):
    _, _, port, imgs = pair
    ref = jax_ref[0]
    got = port.extract_feat(imgs)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        _close(g, r)


def test_neck_outputs(pair, jax_ref):
    _, _, port, imgs = pair
    ref = jax_ref[1]
    got = port.neck(list(port.extract_feat(imgs)), start_level=1,
                    add_extra_convs="on_output")
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        _close(g, r)


def test_head_logits(pair, jax_ref):
    _, _, port, imgs = pair
    ref_cls, ref_reg = jax_ref[2]
    got_cls, got_reg = port.head_sar(imgs)
    for g, r in zip(got_cls + got_reg, list(ref_cls) + list(ref_reg)):
        _close(g, r)


def test_simple_test_sar_detections(pair, jax_ref):
    _, _, port, imgs = pair
    shape = (IMG, IMG)
    ref_dets, ref_labels, ref_valid = jax_ref[3]
    dets, labels, valid = port.simple_test(imgs, "sar", img_shape=shape)
    assert int(valid.sum()) > 0            # real detections
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    # boxes are in pixels (up to 64): 1e-4 relative is the fp32 noise
    _close(dets, ref_dets)


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TriSourceDetector(_small(DEFAULT_MODEL_CFG))


def test_later_slices_raise(pair):
    """What the port does not serve raises, and says so; what it has since
    ported builds as JAX's does: ``use_da`` without ``da_block_inds``
    makes no DA block, the linear gate is a zero (d, E) ``w_gate``, and a
    gate name that is neither "cosine" nor "linear" raises (the JAX
    package would build the cosine gate for it)."""
    _, _, port, imgs = pair
    with pytest.raises(ValueError):
        port.simple_test(imgs, "optical")
    cfg = _small(DEFAULT_MODEL_CFG)
    cfg["backbone"]["use_da"] = True
    blocks = list(TriSourceDetector(cfg, device="cpu").backbone.children())
    assert not any(getattr(b, "use_da", False) for b in blocks)
    cfg = _small(DEFAULT_MODEL_CFG)
    cfg["backbone"]["type"] = "SwinTransformer_moe"
    with pytest.raises(NotImplementedError, match="SwinTransformer_moe"):
        TriSourceDetector(cfg, device="cpu")
    cfg = _small(DEFAULT_MODEL_CFG)
    cfg["backbone"]["gate"] = "linear"
    ffn = TriSourceDetector(cfg, device="cpu",
                            trainable=True).backbone.stage2_block0.ffn
    assert ffn.gating == "linear" and tuple(ffn.w_gate.shape) == (160, 4)
    assert not ffn.w_gate.detach().any()
    cfg["backbone"]["gate"] = "top"
    with pytest.raises(ValueError, match="'cosine', 'linear'"):
        TriSourceDetector(cfg, device="cpu", trainable=True)
