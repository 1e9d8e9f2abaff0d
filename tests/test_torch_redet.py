"""ReDet against the JAX package, on the CPU, at fp32.

- ``ops/orientation.py``: ``_rotation_interp_matrix`` and
  ``active_rotated_filter`` (equal / within 1e-6), ``orientation_align``
  with negative, large and exact-multiple angles and its gradients, and
  ``riroi_align_rotated`` (within 1e-5 of scale).
- The equivariant blocks: ``EquivariantConv`` (k = 1 and 3 through ORConv's
  tables, the 7x7 stride-2 lift through the rotation matrices),
  ``EquivariantLayerNorm`` and ``ReBasicBlock`` with its projection,
  parameters converted by ``from_flax``, within 1e-5 of scale.
- ``ReResNet`` and ``ReFPN``: every level within 1e-5 of scale at 64 px
  and at 72 px, where the top-down resizes are not exact halves (9 -> 18,
  5 -> 9, 3 -> 5: ``jax.image.resize``'s half-pixel nearest).
- Equivariance at 90 degrees: ``ReResNet`` at 33 px (every stride-2 step
  sees an odd size) and ``ReFPN`` on levels of 24, 12, 6, 3: rotating the
  input rotates each level and rolls its orientation channels by 2 of 8,
  within 1e-4 of scale.
- ``ReDet`` (stem 4, stages (4, 8, 16, 32), one block each, ReFPN 32, 4
  classes, two 64 px images of four oriented gts), parameters from the
  port's seeded init carried over by ``from_flax`` (the oriented RPN's
  regressor scaled by 0.2, as ``tests/test_torch_zoo.py`` does), the
  samplers handed the keys ``jax.random`` drew for JAX: its levels within
  1e-5 of scale, its losses within 1e-4 relative and each top-level
  subtree's gradient norm within 1e-4 relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sm3det_tpu.models.backbones import re_resnet as jre
from sm3det_tpu.models.detectors import redet_roitrans as jrd
from sm3det_tpu.ops import orientation as jori
from sm3det_tpu_torch.convert import convert_tree, from_flax, to_flax
from sm3det_tpu_torch.models.backbones import re_resnet as pre
from sm3det_tpu_torch.models.detectors import redet_roitrans as prd
from sm3det_tpu_torch.ops import orientation as pori
from sm3det_tpu_torch.train.train_state import batch_to

from test_detector_variants import APPLY_RNGS, IMG, _batch
from test_torch_zoo import N_ANCHORS, _split_keys, _StageRngs
from test_torch_zoo_rest import _template
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)  # noqa: F401

O = 8
CFG = dict(num_classes=4, angle_version="le90",
           backbone=dict(type="ReResNet", stem_channels=4,
                         stage_channels=(4, 8, 16, 32),
                         stage_blocks=(1, 1, 1, 1)),
           neck=dict(type="ReFPN", in_channels=[32, 64, 128, 256],
                     out_channels=32, num_outs=5))
G = 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol, what=""):
    got = got.detach().double().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _init(module, *args):
    """The flax module's params with random values: normal of scale 0.3,
    norms' scales about 1."""
    p = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a),
                       *args)["params"]
    rng = np.random.RandomState(3)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            rng.randn(*v.shape) * 0.3 + (1.0 if path[-1].key == "scale"
                                         else 0.0), np.float32), p)


def _load(port, params, name="m"):
    """``params`` of one flax module into ``port``, converted as the
    module ``name`` of a detector."""
    sd = convert_tree(params, (name,))
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                         strict=True)
    return port


# ---- orientation ops --------------------------------------------------------

def test_rotation_matrices_and_active_rotated_filter_match_jax():
    for k in (3, 5, 7):
        for ang in (0.0, 0.3, np.pi / 4, np.pi / 2, 2.5, -1.1):
            np.testing.assert_array_equal(
                pori._rotation_interp_matrix(k, ang),
                jori._rotation_interp_matrix(k, ang))
    rng = np.random.RandomState(0)
    w = rng.randn(3, 3, 2 * O, 5).astype(np.float32)     # (k, k, Cin O, Cout)
    ref = np.asarray(jax.jit(jori.active_rotated_filter)(jnp.asarray(w)))
    got = pori.active_rotated_filter(_t(w.transpose(3, 2, 0, 1)))
    _close(got.permute(0, 3, 4, 2, 1), ref, 1e-6)
    # 90 degrees is an exact rot90 of the kernel, the orientations rolled
    base = w.transpose(3, 2, 0, 1)
    want = np.roll(np.rot90(base.reshape(5, 2, O, 3, 3), -1, axes=(3, 4)),
                   2, axis=2).reshape(5, 2 * O, 3, 3)
    _close(got[2], want, 1e-6)


def test_orientation_align_matches_jax():
    rng = np.random.RandomState(1)
    pooled = rng.randn(12, 3, 3, 2 * O).astype(np.float32)
    theta = rng.uniform(-7, 7, 12).astype(np.float32)
    theta[:4] = [0.0, -2 * np.pi / O * 3, 2 * np.pi / O * 5, -1e-3]
    ref = jax.jit(jori.orientation_align)(jnp.asarray(pooled),
                                          jnp.asarray(theta))
    got = pori.orientation_align(_t(pooled), _t(theta))
    _close(got, ref, 1e-6)
    p5 = pooled.reshape(12, 3, 3, 2, O)
    _close(got[1], np.roll(p5[1], 3, axis=-1).reshape(3, 3, 2 * O), 1e-5)
    # the gradient in theta jumps at the multiples of 2 pi / O: which side
    # a multiple falls on is the last bit of theta / (2 pi / O)
    theta[1:3] += 0.01
    wts = rng.randn(12, 3, 3, 2 * O).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, t: jnp.sum(
        jori.orientation_align(p, t) * wts), argnums=(0, 1)))(
        jnp.asarray(pooled), jnp.asarray(theta))
    p_t, t_t = _t(pooled).requires_grad_(True), _t(theta).requires_grad_(True)
    pg = torch.autograd.grad((pori.orientation_align(p_t, t_t)
                              * _t(wts)).sum(), [p_t, t_t])
    for g, r in zip(pg, jg):
        _close(g, r, 1e-5)


def test_riroi_align_rotated_matches_jax():
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 16, 16, 2 * O).astype(np.float32)
    rois = np.concatenate([
        rng.randint(0, 2, (20, 1)), rng.uniform(8, 56, (20, 2)),
        rng.uniform(8, 40, (20, 2)), rng.uniform(-3, 3, (20, 1))],
        -1).astype(np.float32)
    ref = jax.jit(lambda f, r: jori.riroi_align_rotated(f, r, 7, 0.25))(
        jnp.asarray(feats), jnp.asarray(rois))
    got = pori.riroi_align_rotated(_t(feats), _t(rois), 7, 0.25)
    _close(got, ref, 1e-5)


# ---- the equivariant blocks -------------------------------------------------

@pytest.mark.parametrize("case", ["k1", "k3_stride2", "lift7", "layernorm",
                                  "block_projection"])
def test_equivariant_blocks_match_jax(case):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 11, 11, 3 if case == "lift7" else 3 * O).astype(
        np.float32)
    if case == "k1":
        jm = jre.EquivariantConv(5, 1)
        pm = pre.EquivariantConv(3 * O, 5, 1)
    elif case == "k3_stride2":
        jm = jre.EquivariantConv(5, 3, 2)
        pm = pre.EquivariantConv(3 * O, 5, 3, 2)
    elif case == "lift7":
        jm = jre.EquivariantConv(4, 7, 2, first_layer=True)
        pm = pre.EquivariantConv(3, 4, 7, 2, first_layer=True)
    elif case == "layernorm":
        jm = jre.EquivariantLayerNorm(O)
        pm = pre.EquivariantLayerNorm(3, O)
    else:
        jm = jre.ReBasicBlock(5, stride=2)
        pm = pre.ReBasicBlock(3 * O, 5, 2)
    params = _init(jm, x)
    ref = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, x)
    got = _load(pm, params, "norm1" if case == "layernorm" else "m")(_t(x))
    _close(got, ref, 1e-5, case)


class _Pair(nn.Module):
    """JAX's ReResNet and ReFPN of ReDet, levels of both."""
    cfg: dict

    @nn.compact
    def __call__(self, x):
        b, n = self.cfg["backbone"], self.cfg["neck"]
        feats, _ = jre.ReResNet(
            stem_channels=b["stem_channels"],
            stage_channels=b["stage_channels"],
            stage_blocks=b["stage_blocks"], name="backbone")(x)
        return feats, jre.ReFPN(out_channels=n["out_channels"],
                                num_outs=n["num_outs"], name="neck")(
            list(feats))


def _port_pair(cfg, params):
    b, n = cfg["backbone"], cfg["neck"]
    bb = pre.ReResNet(b["stem_channels"], b["stage_channels"],
                      b["stage_blocks"])
    neck = pre.ReFPN(n["in_channels"], n["out_channels"], n["num_outs"])
    sd = from_flax(params)
    for name, mod in (("backbone", bb), ("neck", neck)):
        mod.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()
                             if k.startswith(name + ".")}, strict=True)
    return bb, neck


@pytest.mark.parametrize("size", [64, 72])
def test_reresnet_refpn_match_jax(size):
    rng = np.random.RandomState(5)
    x = rng.rand(2, size, size, 3).astype(np.float32)
    jm = _Pair(CFG)
    params = _init(jm, x)
    feats_ref, outs_ref = jax.jit(lambda p, v: jm.apply({"params": p}, v))(
        params, x)
    bb, neck = _port_pair(CFG, params)
    with torch.no_grad():
        feats = bb(_t(x))
        outs = neck(feats)
    for lvl, (g, r) in enumerate(zip(feats, feats_ref)):
        _close(g, r, 1e-5, f"level {lvl}")
    for lvl, (g, r) in enumerate(zip(outs, outs_ref)):
        _close(g, r, 1e-5, f"neck {lvl}")
    if size == 72:
        assert [tuple(f.shape[1:3]) for f in feats] == [
            (18, 18), (9, 9), (5, 5), (3, 3)]


def _rot(x):
    """rot90 of NHWC maps counter-clockwise, as ``np.rot90`` of axes
    (1, 2)."""
    return torch.rot90(x, 1, dims=(1, 2))


def _orient_roll(y, shift):
    return torch.roll(y.reshape(y.shape[:-1] + (-1, O)), shift, dims=-1) \
        .reshape(y.shape)


def test_reresnet_and_refpn_equivariant_at_90_degrees():
    torch.manual_seed(0)
    b, n = CFG["backbone"], CFG["neck"]
    bb = pre.ReResNet(b["stem_channels"], b["stage_channels"],
                      b["stage_blocks"], gen=torch.Generator().manual_seed(1))
    neck = pre.ReFPN(n["in_channels"], n["out_channels"], n["num_outs"],
                     gen=torch.Generator().manual_seed(2))
    x = torch.rand(1, 33, 33, 3)
    with torch.no_grad():
        ys, ys_rot = bb(x), bb(_rot(x))
        for lvl, (y, yr) in enumerate(zip(ys, ys_rot)):
            _close(yr, _orient_roll(_rot(y), -2), 1e-4, f"level {lvl}")
        feats = [torch.randn(1, s, s, c) for s, c in zip(
            (24, 12, 6, 3), n["in_channels"])]
        outs = neck(feats)
        outs_rot = neck([_orient_roll(_rot(f), -2) for f in feats])
    assert [o.shape[1] for o in outs] == [24, 12, 6, 3, 2]
    for lvl, (y, yr) in enumerate(zip(outs, outs_rot)):
        _close(yr, _orient_roll(_rot(y), -2), 1e-4, f"neck {lvl}")


# ---- the detector -----------------------------------------------------------

def _top_level(mdl, method):
    return method == "__call__" and len(mdl.scope.path) == 1


@pytest.fixture(scope="module")
def redet():
    """One value_and_grad of JAX's ReDet (its backbone's and neck's
    outputs captured), and the port's losses, levels and subtree gradient
    norms at the same parameters and sampler draws."""
    b = _batch(np.random.RandomState(0))
    batch = {k: np.concatenate([b["rgb"][k], b["ifr"][k]]) for k in b["rgb"]}
    jmodel = jrd.ReDet(cfg=CFG)
    port = prd.ReDet(CFG, device="cpu", trainable=True)
    params = to_flax(dict(port.state_dict()), _template(jmodel, batch))
    params["rpn_head"]["rpn_reg"]["kernel"] *= 0.2

    def total(p, bt):
        losses, state = jmodel.apply(
            {"params": p}, bt, train=True, rngs=APPLY_RNGS,
            capture_intermediates=_top_level, mutable=["intermediates"])
        return sum(losses.values()), (losses, state["intermediates"])

    (_, (losses, inter)), grads = jax.jit(jax.value_and_grad(
        total, has_aux=True))(params, batch)
    port.load_state_dict(from_flax(params), strict=True)
    rngs = _StageRngs(2).apply({}, rngs={"sampling": APPLY_RNGS["sampling"]})
    keys = [_split_keys(r, len(batch["img"]), p)
            for r, p in zip(rngs, [N_ANCHORS, G + prd.PROPOSALS])]
    got = port(batch_to({"d": batch}, "cpu")["d"],
               gen=torch.Generator().manual_seed(0), sample_keys=keys)
    p_grads = torch.autograd.grad(sum(got.values()), list(port.parameters()),
                                  allow_unused=True)
    sq = {}
    for (nm, _), g in zip(port.named_parameters(), p_grads):
        top = nm.split(".")[0]
        sq[top] = sq.get(top, 0.0) + (0.0 if g is None else float(
            (g.double() ** 2).sum()))
    norms = {k: float(np.sqrt(sum(float(np.sum(np.square(np.asarray(x))))
                                  for x in jax.tree.leaves(v))))
             for k, v in grads.items()}
    with torch.no_grad():
        feats = port.backbone(_t(batch["img"]))
        outs = port.neck(feats)
    return dict(losses={k: float(v) for k, v in losses.items()},
                p_losses={k: float(v.detach()) for k, v in got.items()},
                norms=norms, p_norms={k: v ** 0.5 for k, v in sq.items()},
                feats=feats, outs=outs,
                inter={k: v["__call__"][0] for k, v in inter.items()})


def test_redet_levels_match_jax(redet):
    ref_feats = redet["inter"]["backbone"][0]
    for lvl, (g, r) in enumerate(zip(redet["feats"], ref_feats)):
        _close(g, r, 1e-5, f"level {lvl}")
    for lvl, (g, r) in enumerate(zip(redet["outs"], redet["inter"]["neck"])):
        _close(g, r, 1e-5, f"neck {lvl}")
    assert redet["outs"][0].shape == (2, IMG // 4, IMG // 4, 32)


def test_redet_losses_match_jax(redet):
    ref, got = redet["losses"], redet["p_losses"]
    assert set(got) == set(ref) == {"loss_rpn_cls", "loss_rpn_bbox",
                                    "loss_cls", "loss_bbox"}
    bad = [(k, got[k], ref[k]) for k in ref if not (
        np.isfinite(got[k]) and abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k])
        + 1e-9)]
    assert not bad, bad
    assert ref["loss_bbox"] > 0


def test_redet_gradient_norms_match_jax(redet):
    ref, got = redet["norms"], redet["p_norms"]
    assert set(got) == set(ref) == {"backbone", "neck", "rpn_head",
                                    "roi_head"}
    bad = [(k, got[k], ref[k]) for k in ref
           if not abs(got[k] - ref[k]) <= 1e-4 * ref[k]]
    assert not bad, bad
    assert all(v > 0 for v in ref.values())


def test_redet_refuses_other_backbones():
    from sm3det_tpu_torch.models import builder
    mc = copy.deepcopy(CFG)
    mc["type"] = "ReDet"
    mc["backbone"]["type"] = "ConvNeXt_moe"
    with pytest.raises(NotImplementedError, match="ReDet takes the ReResNet"):
        builder.build_detector(mc, device="cpu")
    mc = copy.deepcopy(CFG)
    mc["type"] = "ReDet"
    mc["backbone"]["depth"] = 50
    with pytest.raises(NotImplementedError, match="depth"):
        builder.build_detector(mc, device="cpu")
