"""The port's backbone, neck, geometry and NMS leftovers against the JAX
package, on the CPU: GRN, blocks without layer scale, the linear MoE gate
and GRN experts, the FPN's extra-level modes, ``SimpleFPN``, the ``oc``
``poly2obb``, ``rbbox_flip``, ``gaussian2bbox``, ``soft_nms``, the
single-level ``roi_align_rotated`` and ``rotated_intersection_area_sorted``.

Inputs come from numpy seeds; flax params are converted by
``convert_tree`` and carried back by ``to_flax`` leaf for leaf. The JAX
references run jitted. Tolerances: 1e-4 absolute and relative at fp32
(summation order) unless a test says otherwise; indices, labels and masks
equal.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sm3det_tpu.models import layers as jlayers
from sm3det_tpu.models import moe as jmoe
from sm3det_tpu.models.backbones import convnext as jconvnext
from sm3det_tpu.models.necks import fpn as jfpn
from sm3det_tpu.ops import box_convert as jbc
from sm3det_tpu.ops import rotated_iou as jriou
# the package re-exports functions under these modules' names
import sm3det_tpu.ops.nms  # noqa: F401
import sm3det_tpu.ops.roi_align_rotated  # noqa: F401
from sm3det_tpu_torch.convert import convert_tree, to_flax
from sm3det_tpu_torch.models import layers, moe
from sm3det_tpu_torch.models.backbones import convnext
from sm3det_tpu_torch.models.necks import fpn
from sm3det_tpu_torch.ops import box_convert as bc
from sm3det_tpu_torch.ops import nms
from sm3det_tpu_torch.ops import roi_align_rotated as align
from sm3det_tpu_torch.ops import rotated_iou as riou
from torch_jax_refs import jax_refs_at_lowest_level  # noqa: F401

jnms = sys.modules["sm3det_tpu.ops.nms"]
jalign = sys.modules["sm3det_tpu.ops.roi_align_rotated"]

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _randomize(params, rng, scale=0.3):
    return jax.tree.map(lambda v: (np.asarray(v, np.float32) + rng.randn(
        *np.shape(v)).astype(np.float32) * scale), params)


def _load_round_trip(module, params):
    """``convert_tree`` into ``module`` (strict), then ``to_flax`` of its
    parameters gives the tree back leaf for leaf."""
    params = jax.tree.map(np.asarray, params)
    module.load_state_dict(convert_tree(params), strict=True)
    back = dict(_flat(to_flax(dict(module.named_parameters()), params)))
    ref = dict(_flat(params))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    return module


# ---- GRN and ConvNeXt blocks ---------------------------------------------

def test_grn():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    params = {"gamma": rng.randn(8).astype(np.float32),
              "beta": rng.randn(8).astype(np.float32)}
    ref = jlayers.GRN(8).apply({"params": params}, jnp.asarray(x))
    port = _load_round_trip(layers.GRN(8), params)
    _close(port(_t(x)), ref)
    zero = layers.GRN(8)                      # gamma = beta = 0: identity
    np.testing.assert_array_equal(zero(_t(x)).detach().numpy(), x)


BLOCK_KINDS = ("grn", "no_layer_scale", "grn_moe")


def _block_kw(kind):
    moe_cfg = dict(num_experts=3, top_k=2, gating="cosine",
                   noisy_gating=False, capacity_factor=1.0) \
        if kind == "grn_moe" else None
    return dict(use_grn=kind != "no_layer_scale", moe=moe_cfg,
                layer_scale_init_value=0.0 if kind == "no_layer_scale"
                else 1e-6)


@pytest.fixture(scope="module")
def block_refs():
    """Each kind's block: its params, input and JAX outputs at inference
    and in training, all kinds in one compile."""
    rng = np.random.RandomState(1)
    dim = 16
    x = rng.randn(2, 7, 9, dim).astype(np.float32)
    blocks = {k: jconvnext.ConvNeXtBlock(dim=dim, **_block_kw(k))
              for k in BLOCK_KINDS}
    params = jax.jit(lambda v: {k: b.init(jax.random.PRNGKey(0), v,
                                          train=True)["params"]
                                for k, b in blocks.items()})(x)
    params = {k: _randomize(params[k], rng, 0.2) for k in BLOCK_KINDS}
    refs = jax.jit(lambda p, v: {
        (k, t): b.apply({"params": p[k]}, v, train=t)[0]
        for k, b in blocks.items() for t in (False, True)})(params, x)
    return x, params, refs


@pytest.mark.parametrize("kind", BLOCK_KINDS)
@pytest.mark.parametrize("train", [False, True])
def test_convnext_block_options(block_refs, kind, train):
    """GRN blocks (no layer scale, as JAX: ``gamma`` only without GRN), a
    block with ``layer_scale_init_value=0`` (no ``gamma``; at inference the
    port hands the dense block kernel a scale of ones) and a GRN MoE
    block, at inference and in the training forward."""
    x, all_params, refs = block_refs
    params = all_params[kind]
    assert "gamma" not in params
    ref = refs[(kind, train)]
    port = _load_round_trip(convnext.ConvNeXtBlock(16, **_block_kw(kind)),
                            params)
    assert port.gamma is None
    if train:
        got, _ = port.forward_train(_t(x))
    else:
        with torch.no_grad():
            got = port(_t(x))
    _close(got, ref)


# ---- the linear gate ------------------------------------------------------

class _Noise(nn.Module):
    """The normal draws a root MoELayer's noisy gate makes from its first
    ``make_rng("moe_noise")``."""

    shape: tuple

    def __call__(self):
        return jax.random.normal(self.make_rng("moe_noise"), self.shape)


N_TOK, D_TOK, HID, N_EXP, TOP_K = 120, 16, 32, 4, 2
MOE_NOISE = jax.random.PRNGKey(1)


def _gate_layer():
    return jmoe.MoELayer(dim=D_TOK, hidden=HID, num_experts=N_EXP,
                         top_k=TOP_K, gating="linear", capacity_factor=0.5)


@pytest.fixture(scope="module")
def gate_refs():
    """A linear-gate MoE layer's params with ``w_gate`` at its zero init
    and random, and JAX's outputs, aux losses and routes at inference and
    in training for both, in one compile; the gate noise JAX draws."""
    rng = np.random.RandomState(2)
    x = rng.randn(N_TOK, D_TOK).astype(np.float32)
    layer = _gate_layer()
    params = jax.tree.map(np.asarray, jax.jit(lambda v: layer.init(
        {"params": jax.random.PRNGKey(0), "moe_noise": MOE_NOISE}, v,
        train=True))(x)["params"])
    assert not params["w_gate"].any()
    assert params["w_gate"].shape == (D_TOK, N_EXP)
    params["w_noise"] = rng.randn(D_TOK, N_EXP).astype(np.float32) * 0.1
    params["experts"] = _randomize(params["experts"], rng, 0.1)
    sets = {"zero": params, "random": dict(
        params, w_gate=rng.randn(D_TOK, N_EXP).astype(np.float32))}
    refs = jax.jit(lambda ps, v: {
        (g, t): layer.apply({"params": ps[g]}, v, train=t,
                            rngs={"moe_noise": MOE_NOISE},
                            mutable=["intermediates"])
        for g in sets for t in (False, True)})(sets, x)
    noise = np.asarray(_Noise((N_TOK, N_EXP)).apply(
        {}, rngs={"moe_noise": MOE_NOISE}))
    return x, sets, refs, noise


@pytest.mark.parametrize("w_gate", ["zero", "random"])
@pytest.mark.parametrize("train", [False, True])
def test_linear_gate(gate_refs, w_gate, train):
    """``x @ w_gate``: at its zero init every logit ties and the top-k is
    decided by tie-breaking alone (the port picks what ``lax.top_k``
    picks); with a random ``w_gate`` by the logits. Inference takes the
    no-drop grouped dispatch (row 3 on the card), training the noisy gate
    and the capacity dispatch, here with drops."""
    x, sets, refs, noise = gate_refs
    n, e, k = N_TOK, N_EXP, TOP_K
    (ref, ref_aux), inter = refs[(w_gate, train)]
    ref_ids = np.asarray(inter["intermediates"]["expert_ids"][0])
    port = _load_round_trip(moe.MoELayer(D_TOK, HID, num_experts=e,
                                         top_k=k, gating="linear",
                                         capacity_factor=0.5),
                            sets[w_gate])
    xt = _t(x)
    if train:
        got, aux = port.forward_train(xt, _t(noise))
        std = torch.nn.functional.softplus(xt @ port.w_noise) + 1e-2
        logits = port.gate_logits(xt) + _t(noise) * std
        ids = moe.stable_topk(logits, k)[1]
        _close(aux, ref_aux)
        keep = moe.capacity_dispatch(ids, e, moe.capacity_of(
            n, k, e, 0.5))[3]
        assert 0 < int((~keep).sum())              # routes were dropped
    else:
        with torch.no_grad():
            got = port(xt)
        ids = port.route(xt)[0]
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    if w_gate == "zero" and not train:
        assert (ref_ids == np.arange(k)).all()     # ties: the lowest ids
    _close(got, ref)


def test_gate_names():
    """The port takes "cosine" and "linear" and refuses any other name (the
    JAX package builds the cosine gate for it)."""
    with pytest.raises(ValueError, match="cosine.*linear"):
        moe.MoELayer(8, 16, num_experts=2, gating="top")
    assert isinstance(moe.MoELayer(8, 16, num_experts=2).w_gate,
                      moe.CosineTopKGate)


# ---- necks ----------------------------------------------------------------

CHANS = (8, 12, 16, 16)          # the last input as wide as the outputs,
#                                  so that "on_input" shares extra0's shape


@pytest.fixture(scope="module")
def fpn_pair():
    """One JAX MultitaskFPN (ReLU before the extra convs) and its outputs
    in every (start_level, mode), in one compile; the port's module."""
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, 16 // 2 ** i, 16 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate(CHANS)]
    neck = jfpn.FPN(in_channels=CHANS, out_channels=16, num_outs=5,
                    relu_before_extra_convs=True)
    params = _randomize(jax.jit(lambda f: neck.init(
        jax.random.PRNGKey(0), f))(feats)["params"], rng, 0.1)
    cases = [(sl, mode) for sl in (0, 1)
             for mode in (False, True, "on_input", "on_lateral")]
    refs = jax.jit(lambda p, f: [neck.apply(
        {"params": p}, f, start_level=sl, add_extra_convs=mode)
        for sl, mode in cases])(params, feats)
    port = _load_round_trip(fpn.FPN(CHANS, 16, 5,
                                    relu_before_extra_convs=True), params)
    return feats, dict(zip(cases, refs)), port


@pytest.mark.parametrize("start_level", [0, 1])
@pytest.mark.parametrize("mode", [False, True, "on_input", "on_lateral"])
def test_fpn_extra_level_modes(fpn_pair, start_level, mode):
    feats, refs, port = fpn_pair
    with torch.no_grad():
        got = port([_t(f) for f in feats], start_level=start_level,
                   add_extra_convs=mode)
    ref = refs[(start_level, mode)]
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        _close(g, r)


def test_fpn_mode_names():
    with pytest.raises(ValueError, match="on_inputs"):
        fpn.MultitaskFPN(CHANS, 16, add_extra_convs="on_inputs")
    wide = fpn.MultitaskFPN(CHANS[:3] + (24,), 16, add_extra_convs="on_input")
    assert wide.extra0.weight.shape[1] == 24 and \
        wide.extra1.weight.shape[1] == 16


def test_simple_fpn():
    """Asymmetric random transposed-conv kernels: the flax kernel is not
    flipped (``transpose_kernel=False``) and pads "SAME"; the port's
    ``UpConv2x2`` is held element by element, then the whole neck."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 6, 16).astype(np.float32)
    up = nn.ConvTranspose(5, (2, 2), strides=(2, 2))
    up_params = {"kernel": rng.randn(2, 2, 16, 5).astype(np.float32),
                 "bias": rng.randn(5).astype(np.float32)}
    ref_up = up.apply({"params": up_params}, jnp.asarray(x))
    port_up = fpn.UpConv2x2(16, 5)
    port_up.load_state_dict({k: _t(v) for k, v in up_params.items()})
    got_up = port_up(_t(x))
    assert tuple(got_up.shape) == ref_up.shape == (2, 8, 12, 5)
    _close(got_up, ref_up, rtol=1e-5, atol=1e-5)
    assert float(np.abs(np.asarray(ref_up[:, 0::2]) -
                        np.asarray(ref_up[:, 1::2])).max()) > 1e-2

    neck = jfpn.SimpleFPN(backbone_channel=16, out_channels=8, num_outs=6)
    params = _randomize(jax.jit(lambda v: neck.init(
        jax.random.PRNGKey(0), v))(x)["params"], rng, 0.3)
    ref = jax.jit(lambda p, v: neck.apply({"params": p}, v))(params, x)
    port = _load_round_trip(fpn.SimpleFPN(backbone_channel=16,
                                          out_channels=8, num_outs=6),
                            params)
    with torch.no_grad():
        got = port(_t(x))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        _close(g, r)


# ---- box conversions ------------------------------------------------------

def _obbs(rng, n, version):
    lo, hi = {"le90": (-np.pi / 2, np.pi / 2 - 1e-3),
              "le135": (-np.pi / 4, 3 * np.pi / 4 - 1e-3),
              "oc": (1e-3, np.pi / 2)}[version]
    a = rng.uniform(lo, hi, n)
    a[:4] = [lo, hi, 0.0 if version != "oc" else np.pi / 2, np.pi / 4]
    return np.stack([rng.uniform(0, 200, n), rng.uniform(0, 200, n),
                     rng.uniform(2, 60, n), rng.uniform(2, 60, n), a],
                    -1).astype(np.float32)


def test_poly2obb_oc():
    rng = np.random.RandomState(5)
    polys = jbc.obb2poly(jnp.asarray(_obbs(rng, 64, "oc")), "oc")
    polys = np.asarray(polys) + rng.randn(64, 8).astype(np.float32) * 0.01
    ref = jax.jit(lambda p: jbc.poly2obb(p, "oc"))(polys)
    got = bc.poly2obb(_t(polys), "oc")
    _close(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("version", ["oc", "le90", "le135"])
@pytest.mark.parametrize("direction", ["horizontal", "vertical", "diagonal"])
def test_rbbox_flip(version, direction):
    rng = np.random.RandomState(6)
    obbs = _obbs(rng, 64, version)
    ref = jax.jit(lambda o: jbc.rbbox_flip(o, (300, 400), direction,
                                           version))(obbs)
    got = bc.rbbox_flip(_t(obbs), (300, 400), direction, version)
    _close(got, ref, rtol=0, atol=1e-4)


def test_gaussian2bbox():
    """Element by element where the two SVDs' singular vectors have the
    same signs (decided from ``vt`` itself), and for every box as the same
    vertices in cyclic order, either way round, where they do not."""
    rng = np.random.RandomState(7)
    n = 64
    mu = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    a = rng.randn(n, 2, 2).astype(np.float32)
    var = (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(2)).astype(np.float32)
    var[:4] = np.diag([4.0, 1.0]).astype(np.float32)       # axis aligned
    ref = np.asarray(jax.jit(jbc.gaussian2bbox)(mu, var)).reshape(n, 4, 2)
    got = bc.gaussian2bbox(_t(mu), _t(var)).numpy().reshape(n, 4, 2)
    j_vt = np.asarray(jax.jit(lambda v: jnp.linalg.svd(v)[2])(var))
    t_vt = torch.linalg.svd(_t(var))[2].numpy()
    same = (np.sign(j_vt[:, :, 0] + 1e-12) == np.sign(t_vt[:, :, 0] + 1e-12)
            ).all(-1)
    np.testing.assert_allclose(got[same], ref[same], rtol=1e-4, atol=1e-3)
    for g, r in zip(got, ref):
        orders = [np.roll(r, s, 0) for s in range(4)] + \
            [np.roll(r[::-1], s, 0) for s in range(4)]
        assert min(np.abs(g - o).max() for o in orders) <= 1e-3


# ---- soft-NMS -------------------------------------------------------------

@pytest.mark.parametrize("method", ["linear", "gaussian", "naive"])
def test_soft_nms(method):
    """Tied scores included: the first of equal maxima is selected, as
    ``jnp.argmax`` selects it."""
    rng = np.random.RandomState(8)
    n = 60
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(5, 25, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    scores[[3, 9, 17]] = scores[5]
    boxes[9] = boxes[3]                            # a tie on the same box
    ref = jax.jit(lambda b, s: jnms.soft_nms(b, s, 0.3, 40,
                                             method=method))(boxes, scores)
    got = nms.soft_nms(_t(boxes), _t(scores), 0.3, 40, method=method)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    sel, valid = got[1].numpy(), got[2].numpy()
    decayed = (got[0][:, 4].numpy()[valid] < scores[sel[valid]]).any()
    assert valid.any() and (decayed or method == "naive")


# ---- RoI align, rotated intersection --------------------------------------

@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("clockwise", [True, False])
def test_roi_align_rotated_single_level(aligned, clockwise):
    rng = np.random.RandomState(9)
    feats = rng.randn(2, 12, 15, 6).astype(np.float32)
    n = 20
    rois = np.stack([rng.randint(0, 2, n), rng.uniform(-4, 64, n),
                     rng.uniform(-4, 52, n), rng.uniform(1, 40, n),
                     rng.uniform(1, 30, n), rng.uniform(-3, 3, n)],
                    -1).astype(np.float32)
    rois[0, 3:5] = 2.0                   # below a pixel at 1/4: aligned=False
    ref = jax.jit(lambda f, r: jalign.roi_align_rotated(
        f, r, 5, 0.25, 2, aligned, clockwise))(feats, rois)
    got = align.roi_align_rotated(_t(feats), _t(rois), 5, 0.25, 2, aligned,
                                  clockwise)
    assert got.dtype == torch.float32
    _close(got, ref, rtol=1e-4, atol=1e-5)


def test_rotated_intersection_area_sorted():
    """Random, identical, nested, touching and disjoint pairs, against
    JAX's oracle and the sort-free function."""
    rng = np.random.RandomState(10)
    n = 200
    b1 = np.stack([rng.uniform(0, 50, n), rng.uniform(0, 50, n),
                   rng.uniform(2, 30, n), rng.uniform(2, 30, n),
                   rng.uniform(-3, 3, n)], -1).astype(np.float32)
    b2 = b1 + np.concatenate([rng.randn(n, 2) * 8, rng.randn(n, 2) * 3,
                              rng.randn(n, 1)], -1).astype(np.float32)
    b2[:, 2:4] = np.abs(b2[:, 2:4]) + 1
    b2[:10] = b1[:10]                                     # identical
    b2[10:20, 2:4] = b1[10:20, 2:4] * 0.5                 # nested
    b2[20:30, 0] = b1[20:30, 0] + 500                     # disjoint
    c1 = jriou.obb_corners(jnp.asarray(b1))
    c2 = jriou.obb_corners(jnp.asarray(b2))
    ref = np.asarray(jax.jit(jriou.rotated_intersection_area_sorted)(c1, c2))
    got = riou.rotated_intersection_area_sorted(_t(c1), _t(c2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    assert (ref[:10] > 0).all() and (ref[20:30] == 0).all()
    sort_free = riou.rotated_intersection_area(_t(c1), _t(c2)).numpy()
    np.testing.assert_allclose(got, sort_free, rtol=1e-3, atol=1e-2)
