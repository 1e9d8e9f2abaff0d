"""The PyTorch port's modules against their JAX counterparts, on the CPU.

Each test makes its inputs with numpy from a seed, initialises the flax
module, converts its params with ``convert_tree`` and runs the same inputs
through both. Tolerances are fp32: 1e-4 absolute and relative (summation
order); integer results (indices, labels, masks) must be equal.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.core.anchor import AnchorGenerator as JaxAnchors
from sm3det_tpu.core.bbox.coders import DistancePointBBoxCoder as JaxCoder
from sm3det_tpu.models import layers as jlayers
from sm3det_tpu.models.backbones import convnext as jconvnext
from sm3det_tpu.models import moe as jmoe
from sm3det_tpu.models.dense_heads import gfl_head as jgfl
from sm3det_tpu.models.necks.fpn import MultitaskFPN as JaxFPN
import sm3det_tpu.ops.nms  # noqa: F401  (the package re-exports a function nms)
from sm3det_tpu_torch.convert import convert_tree
from sm3det_tpu_torch.core.anchor import AnchorGenerator
from sm3det_tpu_torch.core.bbox.coders import DistancePointBBoxCoder
from sm3det_tpu_torch.models import layers
from sm3det_tpu_torch.models.backbones import convnext
from sm3det_tpu_torch.models import moe
from sm3det_tpu_torch.models.dense_heads import gfl_head
from sm3det_tpu_torch.models.necks.fpn import MultitaskFPN
from sm3det_tpu_torch.ops import nms
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)

jnms = sys.modules["sm3det_tpu.ops.nms"]

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _load(module, params):
    """Convert flax params into ``module`` (strict: every key must match)."""
    module.load_state_dict(
        convert_tree(jax.tree.map(np.asarray, params)), strict=True)
    return module


def _randomize(params, rng, scale=0.2):
    """Replace every leaf by seeded noise around its init (norm scales stay
    near 1), so that no block is an identity."""
    def f(path, v):
        v = np.asarray(v, np.float32)
        noise = np.asarray(rng.randn(*v.shape), np.float32) * scale
        if path[-1].key in ("scale", "gamma") and v.ndim == 1:
            return 1.0 + noise
        return v + noise
    return jax.tree_util.tree_map_with_path(f, params)


# ---- layers ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_math(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 40) * 3 + 1).astype(np.float32)
    s = (1 + 0.1 * rng.randn(40)).astype(np.float32)
    b = (0.1 * rng.randn(40)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref = jconvnext.layernorm_math(jx, jnp.asarray(s).astype(dtype),
                                   jnp.asarray(b).astype(dtype))
    got = convnext.layernorm_math(_t(x).to(getattr(torch, dtype)),
                                  _t(s).to(getattr(torch, dtype)),
                                  _t(b).to(getattr(torch, dtype)))
    assert str(got.dtype)[6:] == str(ref.dtype)
    # bf16: one rounding step of the output (2^-8 relative, |y| up to ~4)
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -6)
    _close(got, np.asarray(ref, np.float32), **tol)


def test_gelu_policy():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    _close(layers.gelu(_t(x)), jlayers.gelu(jnp.asarray(x)), rtol=1e-6,
           atol=1e-6)
    xb = _t(x).to(torch.bfloat16)
    got = layers.gelu(xb)
    assert got.dtype == torch.bfloat16
    tanh_form = torch.nn.functional.gelu(xb.float(), approximate="tanh")
    assert torch.equal(got, tanh_form.to(torch.bfloat16))
    ref = jlayers.gelu(jnp.asarray(x).astype(jnp.bfloat16))
    # JAX evaluates the tanh form in bf16 steps: one bf16 rounding apart
    _close(got, np.asarray(ref, np.float32), rtol=2 ** -7, atol=2 ** -7)


def test_scale():
    s = layers.Scale(1.0)
    s.scale.data.fill_(2.5)
    assert torch.equal(s(torch.ones(3)), torch.full((3,), 2.5))


# ---- MoE -------------------------------------------------------------------


def test_cosine_topk_gate():
    rng = np.random.RandomState(1)
    x = rng.randn(50, 48).astype(np.float32)
    gate = jmoe.CosineTopKGate(48, 6)
    params = gate.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # temperature above log(100) must be clamped
    params = dict(params, temperature=np.full((1,), 5.0, np.float32))
    ref = gate.apply({"params": params}, jnp.asarray(x))
    port = _load(moe.CosineTopKGate(48, 6), params)
    _close(port(_t(x)), ref)


def _moe_pair(n, d, hid, e, k, seed, tie=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    layer = jmoe.MoELayer(dim=d, hidden=hid, num_experts=e, top_k=k)
    params = jax.jit(lambda v: layer.init(
        {"params": jax.random.PRNGKey(seed),
         "moe_noise": jax.random.PRNGKey(seed + 1)}, v, train=True))(
        x)["params"]
    params = _randomize(params, rng, 0.05)
    if tie:
        # experts 1 and 2 get the same gate column: their logits tie for
        # every token, and top-k must take the lower index first
        sim = np.array(params["w_gate"]["sim_matrix"])
        sim[:, 2] = sim[:, 1]
        params["w_gate"]["sim_matrix"] = sim
    port = _load(moe.MoELayer(d, hid, num_experts=e, top_k=k), params)
    return layer, {"params": params}, port, x


@pytest.mark.parametrize("n,d,hid,e,k,tie", [
    (300, 64, 128, 4, 2, False),      # tile 512
    (300, 64, 128, 4, 2, True),       # tied gate logits
    (90, 640, 64, 3, 1, False),       # d > 512: tile 256
])
def test_moe_layer_inference(n, d, hid, e, k, tie):
    layer, variables, port, x = _moe_pair(n, d, hid, e, k, seed=n + d,
                                          tie=tie)
    (ref, _), state = jax.jit(lambda v, a: layer.apply(
        v, a, train=False,
        capture_intermediates=lambda mdl, name: name == "grouped",
        mutable=["intermediates"]))(variables, x)
    ref_slots = state["intermediates"]["experts"]["grouped"][0]
    got = port(_t(x))
    _close(got, ref)

    # the slot layout itself is JAX's: the same expert outputs per slot
    logits = port.w_gate(_t(x))
    _, top_idx = moe.stable_topk(logits, k)
    if tie:
        assert bool((top_idx[:, :1] != 2).all())   # 1 is taken before 2
    src, tile_e, tile, _ = moe.group_aligned_dispatch(top_idx, e, d)
    assert tile == (256 if d > 512 else 512)
    slots = port.experts.grouped(_t(x)[src], tile_e)
    assert slots.shape == ref_slots.shape
    _close(slots, ref_slots)


def test_stable_topk_breaks_ties_to_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    vals, idx = moe.stable_topk(x, 3)
    assert idx.tolist() == [[1, 2, 4]]
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ref_idx).tolist()


# ---- ConvNeXt --------------------------------------------------------------


@pytest.mark.parametrize("use_moe", [False, True])
def test_convnext_block(use_moe):
    rng = np.random.RandomState(2)
    dim = 40
    x = rng.randn(2, 9, 11, dim).astype(np.float32)
    moe_cfg = dict(num_experts=3, top_k=2, gating="cosine",
                   noisy_gating=True) if use_moe else None
    block = jconvnext.ConvNeXtBlock(dim=dim, moe=moe_cfg)
    params = jax.jit(lambda v: block.init(
        {"params": jax.random.PRNGKey(0), "moe_noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, v, train=True))(x)["params"]
    params = _randomize(params, rng, 0.1)
    ref, _ = jax.jit(lambda p, v: block.apply({"params": p}, v))(params, x)
    port = _load(convnext.ConvNeXtBlock(dim, moe=moe_cfg), params)
    _close(port(_t(x)), ref)


def test_atto_backbone():
    rng = np.random.RandomState(3)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    kw = dict(arch="atto", moe_block_inds=((), (), (0, 3), (1,)),
              num_experts=3, top_k=2)
    jb = jconvnext.ConvNeXtMoE(multi_input=True, **kw)
    params = jax.jit(lambda v: jb.init(
        {"params": jax.random.PRNGKey(0), "moe_noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, v, train=True))(x)["params"]
    params = _randomize(params, rng, 0.05)
    ref, _ = jax.jit(lambda p, v: jb.apply({"params": p}, v, train=False))(
        params, jnp.asarray(x))
    port = _load(convnext.ConvNeXtMoE(**kw), params)
    got = port(_t(x))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        _close(g, r)


def test_unported_backbone_options_raise():
    """GRN and domain attention, once refused, now build as in JAX: GRN in
    every block, none with a layer scale; DA only in the ``da_block_inds``
    blocks, read only where the images' dataset ids are given."""
    m = convnext.ConvNeXtMoE(arch="atto", use_grn=True)
    blocks = {n: b for n, b in m.named_children() if "_block" in n}
    assert len(blocks) == 12 and all(
        b.gamma is None and isinstance(b.grn, layers.GRN)
        for b in blocks.values())
    assert not any(b.use_da for b in convnext.ConvNeXtMoE(
        arch="atto", use_da=True).children()
        if isinstance(b, convnext.ConvNeXtBlock))
    m = convnext.ConvNeXtMoE(arch="atto", use_da=True,
                             da_block_inds=((), (), (1,), ()))
    assert [n for n, b in m.named_children() if getattr(b, "use_da", False)
            ] == ["stage2_block1"]
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain, da = m(x), m(x, (0, 2))
    torch.testing.assert_close(da[1], plain[1], rtol=0, atol=0)
    assert float((da[2] - plain[2]).abs().max()) > 0


# ---- neck and head ---------------------------------------------------------


@pytest.mark.parametrize("start_level", [0, 1])
def test_multitask_fpn(start_level):
    rng = np.random.RandomState(4)
    chans = (8, 16, 24, 32)
    feats = [rng.randn(2, 32 // 2 ** i, 32 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate(chans)]
    fpn = JaxFPN(in_channels=chans, out_channels=16, num_outs=5)
    jf = [jnp.asarray(f) for f in feats]
    params = jax.jit(lambda f: fpn.init(
        jax.random.PRNGKey(0), f, start_level=start_level,
        add_extra_convs="on_output"))(jf)["params"]
    params = _randomize(params, rng, 0.05)
    ref = jax.jit(lambda p, f: fpn.apply(
        {"params": p}, f, start_level=start_level,
        add_extra_convs="on_output"))(params, jf)
    port = _load(MultitaskFPN(in_channels=chans, out_channels=16,
                              num_outs=5), params)
    got = port([_t(f) for f in feats], start_level=start_level,
               add_extra_convs="on_output")
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        _close(g, r)


def test_gfl_head_and_integral():
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, s, s, 64).astype(np.float32) for s in (8, 4, 2)]
    head = jgfl.GFLHead(num_classes=5, in_channels=64, feat_channels=64,
                        stacked_convs=2, strides=(8, 16, 32))
    jf = [jnp.asarray(f) for f in feats]
    params = _randomize(jax.jit(lambda f: head.init(
        jax.random.PRNGKey(0), f))(jf)["params"], rng, 0.05)
    ref_cls, ref_reg = jax.jit(lambda p, f: head.apply({"params": p}, f))(
        params, jf)
    port = _load(gfl_head.GFLHead(num_classes=5, in_channels=64,
                                  feat_channels=64, stacked_convs=2,
                                  strides=(8, 16, 32)), params)
    got_cls, got_reg = port([_t(f) for f in feats])
    for g, r in zip(got_cls + got_reg, list(ref_cls) + list(ref_reg)):
        _close(g, r)
    logits = rng.randn(7, 3, 4 * 17).astype(np.float32) * 3
    _close(gfl_head.integral(_t(logits), 16),
           jgfl.integral(jnp.asarray(logits), 16))


def test_gfl_get_bboxes():
    rng = np.random.RandomState(6)
    strides, nc = (8, 16, 32), 5
    sizes = (12, 6, 3)
    cls = [rng.randn(2, s, s, nc).astype(np.float32) for s in sizes]
    reg = [rng.randn(2, s, s, 68).astype(np.float32) for s in sizes]
    kw = dict(num_classes=nc, img_shape=(96, 96), strides=strides,
              nms_pre=40, score_thr=0.3, iou_thr=0.5, max_per_img=20)
    anchors = JaxAnchors(strides, [1.0], octave_base_scale=8,
                         scales_per_octave=1)
    ref = jax.jit(lambda c, r: jgfl.gfl_get_bboxes(c, r, anchors, **kw))(
        cls, reg)
    got = gfl_head.gfl_get_bboxes(
        [_t(c) for c in cls], [_t(r) for r in reg],
        AnchorGenerator(strides, [1.0], octave_base_scale=8,
                        scales_per_octave=1), **kw)
    assert int(got[2].sum()) > 0
    _close(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("kw", [
    dict(strides=(8, 16, 32, 64, 128), ratios=[1.0], octave_base_scale=8,
         scales_per_octave=1),
    dict(strides=(4, 8, 16, 32, 64), ratios=[0.5, 1.0, 2.0], scales=[8]),
])
def test_anchor_generator(kw):
    sizes = [(13, 9), (7, 5), (4, 3), (2, 2), (1, 1)]
    got = AnchorGenerator(**kw).grid_anchors(sizes, device="cpu")
    ref = JaxAnchors(**kw).grid_anchors(sizes)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_distance_point_coder():
    rng = np.random.RandomState(7)
    pts = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    dist = rng.uniform(0, 60, (50, 4)).astype(np.float32)
    got = DistancePointBBoxCoder().decode(_t(pts), _t(dist), (80, 90))
    ref = JaxCoder().decode(jnp.asarray(pts), jnp.asarray(dist), (80, 90))
    _close(got, ref)
    gts = np.concatenate([pts - 10, pts + 20], -1)
    got = DistancePointBBoxCoder().encode(_t(pts), _t(gts), max_dis=16)
    ref = JaxCoder().encode(jnp.asarray(pts), jnp.asarray(gts), max_dis=16)
    _close(got, ref)


# ---- NMS -------------------------------------------------------------------


def _boxes(rng, n, span=200.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(5, 60, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _scores(rng, n):
    s = rng.rand(n).astype(np.float32)
    s[5:15] = s[4]                     # ties keep the lower index first
    return s


def test_bbox_overlaps():
    rng = np.random.RandomState(8)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    _close(nms.bbox_overlaps(_t(a), _t(b)),
           jnms.bbox_overlaps(jnp.asarray(a), jnp.asarray(b)))
    _close(nms.bbox_overlaps(_t(a), _t(a), aligned=True, mode="iof"),
           jnms.bbox_overlaps(jnp.asarray(a), jnp.asarray(a), aligned=True,
                              mode="iof"))


def _assert_nms_equal(got, ref):
    for g, r in zip(got, ref):
        if g.dtype.is_floating_point:
            _close(g, r)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n", [200, 600])     # one block; blocked greedy
def test_nms(n):
    rng = np.random.RandomState(n)
    boxes = np.stack([_boxes(rng, n), _boxes(rng, n)])
    scores = np.stack([_scores(rng, n), _scores(rng, n)])
    got = nms.nms(_t(boxes), _t(scores), 0.5, 150, score_thr=0.1)
    for i in range(2):
        ref = jnms.nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5,
                       150, score_thr=0.1)
        assert int(np.asarray(ref[2]).sum()) > 0
        _assert_nms_equal([g[i] for g in got], ref)
    # one image, unbatched
    _assert_nms_equal(nms.nms(_t(boxes[0]), _t(scores[0]), 0.5, 150, 0.1),
                      [g[0] for g in got])


def test_greedy_keep_matches_sequential():
    rng = np.random.RandomState(9)
    n = 700
    sup = rng.rand(n, n) < 0.01
    elig = rng.rand(n) < 0.9
    keep = nms.greedy_keep(_t(sup), _t(elig)).numpy()
    ref = np.zeros(n, bool)
    for i in range(n):
        ref[i] = elig[i] and not (ref[:i] & sup[:i, i]).any()
    np.testing.assert_array_equal(keep, ref)


def test_batched_nms():
    rng = np.random.RandomState(10)
    n = 400
    boxes, scores = _boxes(rng, n), _scores(rng, n)
    idxs = rng.randint(0, 4, n).astype(np.int32)
    got = nms.batched_nms(_t(boxes), _t(scores), _t(idxs), 0.4, 120)
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(idxs), 0.4, 120)
    _assert_nms_equal(got, ref)


def test_multiclass_nms():
    rng = np.random.RandomState(11)
    n, nc = 300, 6
    boxes = _boxes(rng, n)
    scores = rng.rand(n, nc + 1).astype(np.float32)
    got = nms.multiclass_nms(_t(boxes), _t(scores), 0.3, 0.5, 100,
                             pre_nms=500)
    ref = jnms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3,
                              0.5, 100, pre_nms=500)
    assert int(got[2].sum()) > 0
    _assert_nms_equal(got, ref)
