"""The port's LSKNet-MoE TriSource detector against the JAX package, on the
CPU, and the building blocks it shares with the VAN-MoE one
(``tests/test_torch_van.py``).

A tiny backbone (``embed_dims (8, 16, 32, 64)``, ``depths (1, 1, 2, 1)``,
linear-expert MoE fc1 in stage 2 block 0 and stage 3 block 0 and fc2 in
stage 2 block 1, E = 4, k = 2) under the flagship's heads with a 32-channel
neck is initialised in JAX; ``from_flax`` carries its params into the port,
and both run the same numpy images at fp32. The stages are compared one by
one (backbone features, both necks, GFL and RPN logits), then the entry
points' detections. Tolerance: 1e-4 absolute and relative, as the ConvNeXt
slices (fp32 summation order), and 1e-4 of the image size for boxes.

The linear experts take the capacity dispatch at inference too, dropping
the routes past an expert's capacity: ``test_linear_moe_drops_as_jax``
holds the port's dispatch (``keep``, ``slot``) equal to JAX's arithmetic on
JAX's own routing at a capacity factor that drops routes, and the outputs
within the tolerance.

The layer scales (init 1e-2) are drawn from U(0.3, 0.8) so that every
block's branches move the features, and the heads are set up as in
``tests/test_torch_rcnn_slice.py`` so that the NMS sees candidates.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.detectors import trisource as jtri
from sm3det_tpu.models.moe import MoELayer as JaxMoELayer
from sm3det_tpu_torch.convert import SUBTREES, convert_tree, from_flax, to_flax
from sm3det_tpu_torch.models.detectors.trisource import (DEFAULT_MODEL_CFG,
                                                         TriSourceDetector)
from sm3det_tpu_torch.models.moe import (MoELayer, capacity_dispatch,
                                         capacity_of)
from sm3det_tpu_torch.models.builder import build_detector
from sm3det_tpu_torch.utils.config import Config

from test_torch_rcnn_slice import _assert_dets
from torch_jax_refs import jax_refs_at_lowest_level  # noqa: F401

IMG = 64
SHAPE = (IMG, IMG)
TOL = dict(rtol=1e-4, atol=1e-4)
DIMS = (8, 16, 32, 64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores, and the full-width builds' initialisers stall on
    oversubscribed ones."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def small_cfg(cfg, btype):
    cfg = copy.deepcopy(cfg)
    cfg["backbone"] = dict(
        type=btype, embed_dims=DIMS, depths=(1, 1, 2, 1),
        moe_block_inds_fc1=((), (), (0,), (0,)),
        moe_block_inds_fc2=((), (), (1,), ()),
        num_experts=4, top_k=2, gate="cosine")
    cfg["neck"].update(in_channels=DIMS, out_channels=32)
    cfg["sar"].update(nms_pre=50, max_per_img=10)
    cfg["rgb"].update(rpn_nms_pre=50, rpn_max=40, rcnn_max=10)
    return cfg


def _jax_init_all(m, imgs):
    # train=True so that the gates' w_noise exists, as in a training
    # checkpoint; every head is touched so that the tree is whole
    ids = jnp.zeros((imgs.shape[0],), jnp.int32)
    feats, _ = m.backbone(imgs, train=True, dataset_ids=ids)
    x = m._neck_rcnn(list(feats))
    for rpn, roi in ((m.rgb_rpn_head, m.rgb_roi_head),
                     (m.ifr_rpn_head, m.ifr_roi_head)):
        rpn(x)
        roi(jnp.zeros((1, 7, 7, x[0].shape[-1]), x[0].dtype))
    return m.sar_bbox_head(m._neck_sar(list(feats)))


def _jax_stages(m, imgs):
    ids = jnp.zeros((imgs.shape[0],), jnp.int32)
    feats, _ = m.backbone(imgs, train=False, dataset_ids=ids)
    sar_x = m._neck_sar(list(feats))
    x = m._neck_rcnn(list(feats))
    return (feats, sar_x, m.sar_bbox_head(sar_x), x, m.rgb_rpn_head(x))


def flax_params_of(port, init, *args):
    """The port's initial parameters as the flax tree that ``init(*args)``
    would return: the tree's structure from ``jax.eval_shape`` (a trace, no
    compile), its values through ``to_flax``."""
    shapes = jax.eval_shape(init, *args)["params"]
    template = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    return to_flax(dict(port.state_dict()), template)


def make_pair(btype):
    """(JAX model, its variables, the port's model, images by modality)."""
    rng = np.random.RandomState(0)
    imgs = {k: rng.rand(n, IMG, IMG, 3).astype(np.float32)
            for k, n in (("sar", 2), ("rgb", 2), ("ifr", 1))}
    jmodel = jtri.TriSourceDetector(cfg=small_cfg(jtri.DEFAULT_MODEL_CFG,
                                                  btype))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jax.jit(lambda x: jmodel.init(
        {"params": keys[0], "dropout": keys[1], "moe_noise": keys[2]}, x,
        method=_jax_init_all))(imgs["sar"])["params"]
    params = jax.tree.map(np.asarray, params)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key.startswith("layer_scale") else v, params)
    params["sar_bbox_head"]["gfl_cls"]["bias"] = np.full_like(
        params["sar_bbox_head"]["gfl_cls"]["bias"], 0.5)
    for head in ("rgb_roi_head", "ifr_roi_head"):
        params[head]["fc_cls"]["kernel"] = \
            params[head]["fc_cls"]["kernel"] * 12.0
    for head in ("rgb_rpn_head", "ifr_rpn_head"):
        params[head]["rpn_reg"]["kernel"] = \
            params[head]["rpn_reg"]["kernel"] * 0.2
    port = TriSourceDetector(small_cfg(DEFAULT_MODEL_CFG, btype),
                             device="cpu")
    port.load_state_dict(from_flax(params), strict=True)
    return jmodel, {"params": params}, port, imgs


def _np(t):
    return t.detach().numpy()


def _close(got, ref, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(ref), **(tol or TOL))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def check_from_flax(pair):
    """Every leaf is consumed, the names are the port's, and ``to_flax``
    gives the tree back leaf for leaf."""
    _, variables, port, _ = pair
    params = variables["params"]
    state = from_flax(params)
    n_leaves = sum(len(jax.tree_util.tree_leaves(params[s]))
                   for s in SUBTREES)
    assert len(state) == n_leaves
    assert set(state) == set(port.state_dict())
    back = dict(_flat(to_flax(dict(port.named_parameters()), params)))
    ref = dict(_flat(params))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    return state


def check_stages(pair):
    jmodel, variables, port, imgs = pair
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, method=_jax_stages))(
        variables, imgs["sar"])
    feats = port.extract_feat(imgs["sar"])
    sar_x = port.neck_sar(feats)
    cls, reg = port.sar_bbox_head(sar_x)
    x = port.neck_rcnn(feats)
    rpn_cls, rpn_reg = port.head_rpn(x, "rgb")
    got = (list(feats) + list(sar_x) + cls + reg + list(x) + rpn_cls
           + rpn_reg)
    want = jax.tree_util.tree_leaves(ref)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert [f.shape[-1] for f in feats] == list(DIMS)
    for g, w in zip(got, want):
        _close(g, w)


def check_simple_test(pair, which):
    jmodel, variables, port, imgs = pair
    ref = jax.jit(lambda v, a: jmodel.apply(
        v, a, SHAPE, method=f"simple_test_{which}"))(variables, imgs[which])
    got = port.simple_test(imgs[which], which, img_shape=SHAPE)
    assert int(got[2].sum()) > 0                       # real detections
    _assert_dets(got, ref)


def check_joint(pair):
    jmodel, variables, port, imgs = pair
    ref = jax.jit(lambda v, a, b, c: jmodel.apply(
        v, a, b, c, SHAPE, method="simple_test_joint"))(
            variables, imgs["sar"], imgs["rgb"], imgs["ifr"])
    got = port.simple_test_joint(imgs["sar"], imgs["rgb"], imgs["ifr"],
                                 img_shape=SHAPE)
    for g, r, name in zip(got, ref, ("sar", "rgb", "ifr")):
        assert int(g[2].sum()) > 0, name
        _assert_dets(g, r)


@pytest.fixture(scope="module")
def pair():
    return make_pair("LSKNet_moe_MultiInput")


def test_from_flax_round_trip(pair):
    state = check_from_flax(pair)
    w = state["backbone.stage2_block0.mlp.fc1.experts.w"]
    assert tuple(w.shape) == (4, 32, 128)              # (E, d, 4 d)
    assert tuple(state["backbone.stage2_block1.mlp.fc2.experts.b"].shape) \
        == (4, 32)
    assert tuple(state["backbone.stage0_block0.attn.spatial_gating_unit"
                       ".conv_spatial.weight"].shape) == (8, 1, 7, 7)
    assert "backbone.stem_single.weight" in state
    assert "backbone.stage1_block0.layer_scale_2" in state


def test_backbone_neck_and_head_outputs(pair):
    check_stages(pair)


@pytest.mark.parametrize("which", ["sar", "rgb"])
def test_simple_test_detections(pair, which):
    check_simple_test(pair, which)


def test_simple_test_joint(pair):
    check_joint(pair)


def _jax_moe_dispatch(top_k_idx, e, cap):
    """JAX's capacity arithmetic (``sm3det_tpu/models/moe.py``): the
    position of each route in its expert's bucket from a one-hot cumsum."""
    flat = top_k_idx.reshape(-1)
    oh = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    position = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=1)
    keep = position < cap
    slot = flat * cap + jnp.minimum(position, cap - 1)
    return np.asarray(keep), np.asarray(slot)


def test_linear_moe_drops_as_jax():
    """A linear-expert MoE at inference with capacity factor 0.5: the same
    routes, the same ``keep`` / ``slot`` (routes dropped), outputs within
    the tolerance."""
    rng = np.random.RandomState(3)
    n, d, o, e, k = 96, 16, 24, 4, 2
    x = rng.randn(n, d).astype(np.float32)
    jm = JaxMoELayer(dim=d, hidden=0, num_experts=e, top_k=k,
                     capacity_factor=0.5, expert_kind="linear", out_dim=o)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    params = jax.tree.map(np.asarray, jax.jit(lambda a: jm.init(
        {"params": keys[0], "moe_noise": keys[1]}, a, train=True))(x)
        ["params"])
    params["experts"]["b"] = rng.randn(e, o).astype(np.float32)
    (ref, _), inter = jax.jit(lambda p, a: jm.apply(
        {"params": p}, a, train=False, mutable=["intermediates"]))(
            params, x)
    ids = np.asarray(inter["intermediates"]["expert_ids"][0])
    drop = float(inter["intermediates"]["drop_fraction"][0])

    port = MoELayer(d, 0, num_experts=e, top_k=k, capacity_factor=0.5,
                    expert_kind="linear", out_dim=o)
    port.load_state_dict(convert_tree(params), strict=True)
    xt = torch.from_numpy(x)
    top_k_idx, _ = port.route(xt)
    np.testing.assert_array_equal(top_k_idx.numpy(), ids)
    cap = capacity_of(n, k, e, 0.5)
    _, _, slot, keep = capacity_dispatch(top_k_idx, e, cap)
    ref_keep, ref_slot = _jax_moe_dispatch(jnp.asarray(ids), e, cap)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    np.testing.assert_array_equal(slot.numpy(), ref_slot)
    assert 0.1 < drop == pytest.approx(1 - float(keep.float().mean()))
    with torch.no_grad():
        got = port(xt)
    assert got.shape == (n, o)
    _close(got, ref)


LSK_VAN_CONFIGS = [f"configs/local_configs/SM3Det_{b}_{s}.py"
                   for b in ("lsk", "van") for s in "tsb"] + [
    "configs/local_configs/main_SM3Det_lsk_t.py"]


@pytest.mark.parametrize("path", LSK_VAN_CONFIGS)
def test_build_detector_builds_the_config(monkeypatch, path):
    """The config builds at full width on the host (no forward): the
    backbone's stages have the config's widths and depths, its MoE fc1
    blocks are 8-expert top-3 linear-expert layers. The initialisers'
    draws, which no assertion reads, are skipped."""
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *args, **kwargs: t)
    cfg = Config.fromfile(path)
    b = cfg.model.backbone
    m = build_detector(cfg.model, device="cpu")
    bb = m.backbone
    assert type(bb).__name__ == ("LSKNetMoE" if "lsk" in path else "VANMoE")
    assert bb.depths == tuple(b.depths)
    for i, dim in enumerate(b.embed_dims):
        assert getattr(bb, f"embed_norm{i}").weight.shape == (dim,)
    for i, inds in enumerate(b.moe_block_inds_fc1):
        for j in range(b.depths[i]):
            fc1 = getattr(bb, f"stage{i}_block{j}").mlp.fc1
            assert isinstance(fc1, MoELayer) == (j in inds)
            if j in inds:
                assert (fc1.num_experts, fc1.top_k, fc1.expert_kind) == \
                    (8, 3, "linear")
    assert m.cfg["neck"]["in_channels"] == list(b.embed_dims)
