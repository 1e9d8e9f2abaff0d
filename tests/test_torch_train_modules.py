"""The modules of the port's train step against the JAX package, on the CPU.

Each case feeds the same numpy inputs, and where a function draws random
numbers the same draws, to the JAX function and its port: the losses, the
assigners, the sampler (fed the very uniform keys ``jax.random.uniform``
makes inside ``random_sample``), the coders' encodes, stochastic depth and
the noisy capacity MoE (their draws handed to JAX by stubbing
``jax.random.bernoulli`` / ``jax.random.normal`` for the call), DLA and one
AdamW + DLA update, and the two training kernels' plain paths: the pyramid
RoI align's feature gradient (Pallas row 8) against ``jax.vjp`` of the exact
jnp path, and the trainable dw7x7 + LN (row 10) against ``jax.grad``
through ``fused_dwconv_ln_train`` in interpret mode. All at fp32; each
tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.core.bbox import assigners as jassign
from sm3det_tpu.core.bbox import coders as jcoders
from sm3det_tpu.core.bbox.samplers import random_sample as jax_random_sample
from sm3det_tpu.models import layers as jlayers
from sm3det_tpu.models import losses as jlosses
from sm3det_tpu.models import moe as jmoe
from sm3det_tpu.ops.pallas.convnext_block_kernel import \
    fused_dwconv_ln_train as jax_dwconv_ln_train
from sm3det_tpu.ops.roi_align_rotated import \
    roi_align_rotated_pyramid as jax_align
from sm3det_tpu.train import dla as jdla
from sm3det_tpu.train.optim import make_optimizer as jax_make_optimizer
from sm3det_tpu_torch.convert import convert_tree
from sm3det_tpu_torch.core.bbox import assigners, samplers
from sm3det_tpu_torch.core.bbox.coders import (DeltaXYWHAOBBoxCoder,
                                               DistancePointBBoxCoder,
                                               MidpointOffsetCoder)
from sm3det_tpu_torch.models import losses, moe
from sm3det_tpu_torch.models.layers import drop_path
from sm3det_tpu_torch.ops.cuda import build
from sm3det_tpu_torch.ops.cuda.convnext_block_kernel import \
    fused_dwconv_ln_train
from sm3det_tpu_torch.ops.cuda.roi_align_kernel import \
    roi_align_rotated_pyramid_fused
from sm3det_tpu_torch.ops.roi_align_rotated import route_levels
from sm3det_tpu_torch.train import dla
from sm3det_tpu_torch.train.optim import make_optimizer

TOL = dict(rtol=1e-5, atol=1e-6)     # fp32, summation order only


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), **(tol or TOL))


# ---- losses ----------------------------------------------------------------


def _loss_inputs(rng, n=64, c=5):
    logits = rng.randn(n, c).astype(np.float32) * 3
    labels = rng.randint(0, c + 1, n).astype(np.int32)       # c: background
    scores = rng.rand(n).astype(np.float32)
    weight = (rng.rand(n) > 0.3).astype(np.float32)
    boxes = rng.rand(2, n, 2).astype(np.float32) * 50
    wh = 1 + rng.rand(2, n, 2).astype(np.float32) * 30
    xyxy = np.concatenate([boxes, boxes + wh], -1)
    return logits, labels, scores, weight, xyxy


LOSS_CASES = ["sigmoid_ce", "softmax_ce", "qfl", "dfl", "smooth_l1", "giou"]


@pytest.mark.parametrize("name", LOSS_CASES)
@pytest.mark.parametrize("avg", [None, 7.0])
def test_losses(name, avg):
    rng = np.random.RandomState(LOSS_CASES.index(name))
    logits, labels, scores, weight, xyxy = _loss_inputs(rng)
    if name == "sigmoid_ce":
        tgt = (rng.rand(*logits.shape) > 0.5).astype(np.float32)
        args = (logits, tgt)
        wt = weight[:, None] * np.ones_like(logits)
        jf, tf = jlosses.sigmoid_cross_entropy, losses.sigmoid_cross_entropy
    elif name == "softmax_ce":
        args, wt = (logits, labels % logits.shape[1]), weight
        jf, tf = jlosses.softmax_cross_entropy, losses.softmax_cross_entropy
    elif name == "qfl":
        args, wt = (logits, labels, scores), weight
        jf, tf = jlosses.quality_focal_loss, losses.quality_focal_loss
    elif name == "dfl":
        tgt = (rng.rand(64) * 8).astype(np.float32)
        tgt[:3] = [0.0, 8.0 - 0.1, 4.0]                      # bin edges
        args, wt = (rng.randn(64, 9).astype(np.float32), tgt), weight
        jf, tf = (jlosses.distribution_focal_loss,
                  losses.distribution_focal_loss)
    elif name == "smooth_l1":
        args = (xyxy[0], xyxy[1])
        wt = weight[:, None] * np.ones((1, 4), np.float32)
        jf, tf = jlosses.smooth_l1_loss, losses.smooth_l1_loss
    else:
        args, wt = (xyxy[0], xyxy[1]), weight
        jf, tf = jlosses.giou_loss, losses.giou_loss
    ref = jf(*[jnp.asarray(a) for a in args], weight=jnp.asarray(wt),
             avg_factor=avg)
    got = tf(*[_t(a) for a in args], weight=_t(wt), avg_factor=avg)
    _close(got, ref)


# ---- assigners and sampler -------------------------------------------------


def test_max_iou_assign():
    """Padded gts, exact ties (a duplicated gt column, a prior at two gts'
    best IoU) and both low-quality settings."""
    rng = np.random.RandomState(3)
    ious = rng.rand(200, 6).astype(np.float32) * 0.9
    ious[:, 4] = ious[:, 1]
    ious[7, 2] = ious[7, 3] = 0.95
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    for lq in (True, False):
        kw = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                  match_low_quality=lq)
        ref = jassign.max_iou_assign(jnp.asarray(ious), jnp.asarray(mask),
                                     **kw)
        got = assigners.max_iou_assign(_t(ious), _t(mask), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_atss_assign():
    rng = np.random.RandomState(4)
    levels = [(16, 8), (8, 16), (4, 32)]
    pts, num = [], []
    for hw, s in levels:
        ys, xs = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
        c = np.stack([xs.ravel(), ys.ravel()], -1) * s + s / 2
        pts.append(np.concatenate([c - 4 * s, c + 4 * s], -1))
        num.append(hw * hw)
    anchors = np.concatenate(pts).astype(np.float32)
    centers = ((anchors[:, :2] + anchors[:, 2:]) / 2).astype(np.float32)
    cxy = rng.uniform(20, 110, (5, 2))
    wh = rng.uniform(10, 60, (5, 2))
    gts = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0], bool)
    from sm3det_tpu.ops.nms import bbox_overlaps as jax_overlaps
    ious = np.asarray(jax.jit(jax_overlaps)(jnp.asarray(anchors),
                                            jnp.asarray(gts)))
    ref_a, ref_o = jax.jit(
        lambda *a: jassign.atss_assign(*a, num, topk=9))(
        jnp.asarray(ious), jnp.asarray(centers), jnp.asarray(gts),
        jnp.asarray(mask))
    got_a, got_o = assigners.atss_assign(_t(ious), _t(centers), _t(gts),
                                         _t(mask), num, topk=9)
    assert int((got_a > 0).sum()) > 0
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(ref_a))
    _close(got_o, ref_o)


@pytest.mark.parametrize("num,frac", [(32, 0.5), (512, 0.25), (2048, 0.5)])
def test_random_sample_with_jax_keys(num, frac):
    """The port fed JAX's own uniform keys picks the same slots."""
    rng = np.random.RandomState(num)
    assigned = rng.choice([-1, 0, 0, 0, 1, 2, 3], 700).astype(np.int32)
    key = jax.random.PRNGKey(num)
    ref = jax_random_sample(key, jnp.asarray(assigned), num, frac)
    k_pos, k_neg = jax.random.split(key)
    keys = [_t(np.asarray(jax.random.uniform(k, (700,))))
            for k in (k_pos, k_neg)]
    got = samplers.random_sample(keys[0], keys[1], _t(assigned), num, frac)
    for k in ("pos_mask", "neg_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    used = np.asarray(ref["pos_mask"] | ref["neg_mask"])
    np.testing.assert_array_equal(got["inds"].numpy()[used],
                                  np.asarray(ref["inds"])[used])


# ---- coders ----------------------------------------------------------------


def _obbs(rng, n):
    return np.stack([rng.uniform(20, 300, n), rng.uniform(20, 300, n),
                     rng.uniform(4, 90, n), rng.uniform(4, 90, n),
                     rng.uniform(-1.6, 1.6, n)], -1).astype(np.float32)


@pytest.mark.parametrize("coder", ["midpoint", "delta_xywha", "distance"])
def test_encode(coder):
    rng = np.random.RandomState(5)
    n = 300
    if coder == "midpoint":
        xy = rng.uniform(0, 300, (n, 2))
        anchors = np.concatenate([xy, xy + rng.uniform(4, 80, (n, 2))], -1) \
            .astype(np.float32)
        gts = _obbs(rng, n)
        gts[:20, 4] = 0.0                         # axis-aligned: vertex ties
        kw = dict(angle_range="le90", target_means=(0.,) * 6,
                  target_stds=(1., 1., 1., 1., 0.5, 0.5))
        j, t = jcoders.MidpointOffsetCoder(**kw), MidpointOffsetCoder(**kw)
    elif coder == "delta_xywha":
        anchors, gts = _obbs(rng, n), _obbs(rng, n)
        kw = dict(angle_range="le90", target_means=(0.,) * 5,
                  target_stds=(0.1, 0.1, 0.2, 0.2, 0.1), edge_swap=True,
                  proj_xy=True)
        j, t = jcoders.DeltaXYWHAOBBoxCoder(**kw), DeltaXYWHAOBBoxCoder(**kw)
    else:
        anchors = rng.uniform(0, 100, (n, 2)).astype(np.float32)
        xy = rng.uniform(0, 100, (n, 2))
        gts = np.concatenate([xy, xy + rng.uniform(1, 40, (n, 2))], -1) \
            .astype(np.float32)
        j, t = jcoders.DistancePointBBoxCoder(), DistancePointBBoxCoder()
        _close(t.encode(_t(anchors), _t(gts), max_dis=8, eps=0.1),
               j.encode(jnp.asarray(anchors), jnp.asarray(gts), max_dis=8,
                        eps=0.1), rtol=1e-5, atol=1e-5)
    # deltas divide by box sizes (to 4 px) and stds (to 0.1): 1e-5 of the
    # value or 1e-4 absolute
    _close(t.encode(_t(anchors), _t(gts)),
           j.encode(jnp.asarray(anchors), jnp.asarray(gts)),
           rtol=1e-5, atol=1e-4)


# ---- stochastic depth and the training MoE ---------------------------------


def test_drop_path_with_fed_mask(monkeypatch):
    rng = np.random.RandomState(6)
    x = rng.randn(6, 5, 5, 8).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask).reshape(shape))
    ref = jlayers.DropPath(0.3).apply({}, jnp.asarray(x),
                                      deterministic=False,
                                      rngs={"dropout": jax.random.PRNGKey(0)})
    _close(drop_path(_t(x), 0.3, _t(mask)), ref)
    assert torch.equal(drop_path(_t(x), 0.3, None), _t(x))


@pytest.fixture(scope="module")
def moe_pair():
    """A noisy capacity MoE whose capacity factor drops routes, with its
    fed noise: (jax layer, params, port layer, x, noise, cotangent)."""
    n, d, hid, e, k, cf = 300, 48, 96, 4, 2, 0.6
    rng = np.random.RandomState(8)
    x = rng.randn(n, d).astype(np.float32)
    noise = rng.randn(n, e).astype(np.float32)
    g = rng.randn(n, d).astype(np.float32)
    layer = jmoe.MoELayer(dim=d, hidden=hid, num_experts=e, top_k=k,
                          capacity_factor=cf)
    params = jax.jit(lambda xx: layer.init(
        {"params": jax.random.PRNGKey(0), "moe_noise": jax.random.PRNGKey(1)},
        xx, train=True))(jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda v: np.asarray(v) + rng.randn(*v.shape).astype(np.float32)
        * 0.05, params)
    port = moe.MoELayer(d, hid, num_experts=e, top_k=k, capacity_factor=cf)
    port.load_state_dict(convert_tree(params), strict=True)
    return layer, params, port, x, noise, g


def test_capacity_moe_forward_aux_and_grads(moe_pair, monkeypatch):
    layer, params, port, x, noise, g = moe_pair
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **kw: jnp.asarray(noise))

    def f(p, xx):
        y, aux = layer.apply({"params": p}, xx, train=True,
                             rngs={"moe_noise": jax.random.PRNGKey(2)})
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (y_ref, aux_ref)), (gp_ref, gx_ref) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y, aux = port.forward_train(xt, _t(noise))
    cap = moe.capacity_of(300, 2, 4, 0.6)
    _, _, _, keep = moe.capacity_dispatch(
        moe.stable_topk(port.w_gate(_t(x)) + _t(noise) * (
            torch.nn.functional.softplus(_t(x) @ port.w_noise) + 1e-2),
            2)[1], 4, cap)
    assert 0 < int((~keep).sum()) < keep.numel()      # routes are dropped
    _close(y, y_ref)
    _close(aux, aux_ref, rtol=1e-4, atol=1e-7)
    grads = torch.autograd.grad((y * _t(g)).sum() + aux,
                                [xt] + list(port.parameters()))
    _close(grads[0], gx_ref, rtol=1e-4, atol=1e-5)
    ref_tree = convert_tree(jax.tree.map(np.asarray, gp_ref))
    for (name, _), gr in zip(port.named_parameters(), grads[1:]):
        scale = float(ref_tree[name].abs().max()) + 1e-12
        assert float((gr - ref_tree[name]).abs().max()) <= 1e-4 * scale, \
            name


# ---- DLA and the optimizer -------------------------------------------------


def _random_losses(rng):
    return {k: np.float32(rng.uniform(0.05, 2.0))
            for k, _ in jdla.DEFAULT_REWEIGHT_LOSSES}


@pytest.mark.parametrize("policy", ["sigmoid_kl", "min", "avg"])
def test_dla_multipliers_three_steps(policy):
    rng = np.random.RandomState(9)
    jcfg = jdla.make_dla_config(warmup_iters=1, backbone_policy=policy)
    tcfg = dla.make_dla_config(warmup_iters=1, backbone_policy=policy)
    js, ts = jdla.init_dla_state(jcfg), dla.init_dla_state(tcfg)
    for step in range(3):
        ls = _random_losses(rng)
        jm, js = jdla.dla_multipliers(
            js, {k: jnp.asarray(v) for k, v in ls.items()}, jcfg)
        tm, ts = dla.dla_multipliers(
            ts, {k: torch.tensor(v) for k, v in ls.items()}, tcfg)
        assert set(tm) == set(jm)
        for k in jm:
            assert abs(tm[k] - float(jm[k])) <= 1e-5 * abs(float(jm[k])), \
                (step, k)
        if step:
            assert any(abs(v - 1.0) > 1e-3 for v in tm.values())
        _close(ts.ema, js.ema)
    assert ts.steps == int(js.steps) == 3


def test_adamw_dla_update_small_tree():
    """Three AdamW + DLA updates (warmup 1, so the last two use the
    multipliers) on a small tree with every subnet, against
    ``make_optimizer``'s optax chain: the same arithmetic, 1e-5."""
    rng = np.random.RandomState(10)
    subnets = [s for _, s in jdla.DEFAULT_REWEIGHT_LOSSES]
    tree = {s: {"w": rng.randn(3, 4).astype(np.float32)}
            for s in dict.fromkeys(subnets)}
    tree["backbone"] = {"w": rng.randn(5).astype(np.float32)}
    names = [f"{s}.w" for s in tree]
    kw = dict(base_lr=1e-2, step_iters=(2,), warmup_iters=1)
    j_init, j_update, _ = jax_make_optimizer(
        dla_cfg=jdla.make_dla_config(warmup_iters=1), **kw)
    t_init, t_update, _ = make_optimizer(
        names, dla_cfg=dla.make_dla_config(warmup_iters=1), **kw)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = [_t(tree[n.split(".")[0]]["w"]).clone() for n in names]
    js, ts = j_init(jp), t_init(tp)
    for _ in range(3):
        grads = {s: {"w": rng.randn(*v["w"].shape).astype(np.float32)}
                 for s, v in tree.items()}
        ls = _random_losses(rng)
        upd, js = j_update(jax.tree.map(jnp.asarray, grads), js, jp,
                           {k: jnp.asarray(v) for k, v in ls.items()})
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        ts = t_update([_t(grads[n.split(".")[0]]["w"]) for n in names], ts,
                      tp, {k: torch.tensor(v) for k, v in ls.items()})
    for n, p in zip(names, tp):
        _close(p, jp[n.split(".")[0]]["w"], rtol=1e-5, atol=1e-6)


# ---- the two training kernels' plain paths ---------------------------------


def _align_case(case):
    rng = np.random.RandomState(2 if case == "random" else 7)
    bsz, c = 2, 64
    strides = (4, 8, 16, 32)
    feats = [rng.rand(bsz, 256 // s, 256 // s, c).astype(np.float32)
             for s in strides]
    if case == "random":
        n = 48
        rois = np.stack([
            rng.randint(0, bsz, n).astype(np.float32),
            rng.uniform(30, 220, n), rng.uniform(30, 220, n),
            rng.uniform(16, 140, n), rng.uniform(8, 140, n),
            rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)
    else:             # every RoI on one centre: all windows overlap
        n = 40
        rois = np.stack([
            np.zeros(n), np.full(n, 120.0), np.full(n, 120.0),
            rng.uniform(24, 60, n), rng.uniform(24, 60, n),
            rng.uniform(-1.4, 1.4, n)], -1).astype(np.float32)
    g = rng.randn(n, 7, 7, c).astype(np.float32)
    return feats, rois, g, strides


@pytest.mark.parametrize("case", ["random", "all_overlapping"])
def test_align_feature_gradient(case):
    """Row 8's plain path (autograd of the plain align, through the
    autograd.Function) against jax.vjp of the exact jnp path, with the
    port's levels. 1e-5 of the gradient's scale (fp32 sums of up to 40
    RoIs' taps in another order)."""
    feats, rois, g, strides = _align_case(case)
    lvls = route_levels(_t(rois)).numpy()

    @jax.jit
    def feat_grad(fs, gg):
        _, vjp = jax.vjp(lambda f: jax_align(list(f), jnp.asarray(rois),
                                             jnp.asarray(lvls), 7,
                                             featmap_strides=strides), fs)
        return vjp(gg)[0]

    ref = feat_grad(tuple(jnp.asarray(f) for f in feats), jnp.asarray(g))
    tf = [_t(f).requires_grad_(True) for f in feats]
    out = roi_align_rotated_pyramid_fused(tf, _t(rois), 7, strides)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, tf, _t(g))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_dwconv_ln_train_gradients():
    """Row 10's plain path (the autograd.Function on the host) against
    jax.grad through fused_dwconv_ln_train (Pallas forward in interpret
    mode, its recomputing VJP): value and the five gradients, 1e-5."""
    rng = np.random.RandomState(7)
    dim = 96
    x = rng.randn(2, 16, 16, dim).astype(np.float32)
    dwk = (rng.randn(7, 7, 1, dim) * 0.05).astype(np.float32)
    dwb = (rng.randn(dim) * 0.05).astype(np.float32)
    lns = (1.0 + rng.randn(dim) * 0.05).astype(np.float32)
    lnb = (rng.randn(dim) * 0.05).astype(np.float32)
    g = rng.randn(2, 16, 16, dim).astype(np.float32)

    def loss(*a):
        return jnp.sum(jax_dwconv_ln_train(*a, 1e-6, True) * g)

    args = [jnp.asarray(a) for a in (x, dwk, dwb, lns, lnb)]
    val = float(loss(*args))
    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    ins = [_t(x), _t(dwk.transpose(3, 2, 0, 1).copy()), _t(dwb), _t(lns),
           _t(lnb)]
    ins = [t.requires_grad_(True) for t in ins]
    out = fused_dwconv_ln_train(*ins)
    got_val = float((out * _t(g)).sum().detach())
    assert abs(got_val - val) <= 1e-5 * abs(val)
    got = torch.autograd.grad((out * _t(g)).sum(), ins)
    ref = [np.asarray(r) for r in ref]
    ref[1] = ref[1].transpose(3, 2, 0, 1)
    for a, b in zip(got, ref):
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_forward_only_kernels_refuse_grad():
    """A kernel without a backward refuses inputs that require grad while
    grad mode is on; under no_grad, or without such inputs, it runs."""
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        build.forbid_grad("k", torch.ones(2), w)
    with torch.no_grad():
        build.forbid_grad("k", torch.ones(2), w)
    build.forbid_grad("k", torch.ones(2), w.detach(), None)
