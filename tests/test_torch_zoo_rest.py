"""The rest of the zoo against the JAX package, on the CPU, at fp32: the
single-stem LSKNet-MoE / VAN-MoE and their detectors, Gliding Vertex,
rotated FCOS, rotated ATSS and rotated Faster R-CNN.

The fixture is ``tests/test_torch_zoo.py``'s (64 px, 4 classes, two images
of four oriented gts, or two SAR images of horizontal gts), with a tiny
single-stem backbone: ``atto`` for the four detectors, LSK / VAN of dims
(8, 16, 24, 32) and depths (1, 1, 2, 1) for the single-stem detectors. The
parameters are the port's seeded init laid out as the flax inits
(``jax.eval_shape``, no compile) and carried over by ``from_flax``, layer
scales drawn from U(0.3, 0.8). The samplers are handed the keys
``jax.random`` drew for the JAX detector. The JAX references run under
``jax.jit`` at XLA's lowest backend optimisation level.

JAX's zoo factory builds a ConvNeXt whatever the backbone's type says, so
the references of the LSK / VAN detectors swap ``_build_backbone`` of
``sm3det_tpu.models.detectors.zoo`` for one that builds JAX's
``LSKNetMoE`` / ``VANMoE`` with ``multi_input=False``, in this process only
(``monkeypatch``).

Held: the single-stem backbones' levels within 1e-5 of scale; the LSK /
VAN detectors' backbone levels, neck levels and head outputs within 1e-5
of scale and their losses within 1e-4 relative; the four detectors'
losses within 1e-4 relative and each top-level subtree's gradient norm
within 1e-4 relative; the GV coders, ``gv_decode``, the FCOS coder and
head and ``atss_obb_assign`` (a near-tie of distances among them) against
JAX's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.core.bbox import gv_coders as jgv
from sm3det_tpu.models.backbones.lsknet import LSKNetMoE as JaxLSK
from sm3det_tpu.models.backbones.van import VANMoE as JaxVAN
from sm3det_tpu.models.dense_heads import rotated_atss_head as jatss
from sm3det_tpu.models.dense_heads import rotated_fcos_head as jfcos
from sm3det_tpu.models.detectors import single_stage_zoo as jssz
from sm3det_tpu.models.detectors import zoo as jzoo
from sm3det_tpu.models.detectors import zoo_extra as jze
from sm3det_tpu.models.roi_heads import cascade_heads as jch
from sm3det_tpu_torch.convert import convert_tree, from_flax, to_flax
from sm3det_tpu_torch.core.bbox import gv_coders as pgv
from sm3det_tpu_torch.models.backbones.lsknet import LSKNetMoE
from sm3det_tpu_torch.models.backbones.van import VANMoE
from sm3det_tpu_torch.models.dense_heads import rotated_atss_head as patss
from sm3det_tpu_torch.models.dense_heads import rotated_fcos_head as pfcos
from sm3det_tpu_torch.models.detectors import single_stage_zoo as pssz
from sm3det_tpu_torch.models.detectors import zoo as pzoo
from sm3det_tpu_torch.models.detectors import zoo_extra as pze
from sm3det_tpu_torch.models.roi_heads import cascade_heads as pch
from sm3det_tpu_torch.ops.box_convert import obb2xyxy, poly2obb
from sm3det_tpu_torch.ops.rotated_iou import box_iou_rotated
from sm3det_tpu_torch.train.train_state import batch_to

from test_detector_variants import APPLY_RNGS, IMG, _batch
from test_torch_zoo import CFG, N_ANCHORS, _split_keys, _StageRngs
from torch_jax_refs import jax_refs_at_lowest_level  # noqa: F401

NC, G = CFG["num_classes"], 4
CH = CFG["neck"]["out_channels"]
SMALL = dict(embed_dims=(8, 16, 24, 32), depths=(1, 1, 2, 1))
JAX_BACKBONES = {"LSKNet_moe": JaxLSK, "VAN_moe": JaxVAN}
PORT_BACKBONES = {"LSKNet_moe": LSKNetMoE, "VAN_moe": VANMoE}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's lowest backend
    optimisation level (each reference runs once)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


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


def _rel(got, ref, tol):
    bad = [(k, got[k], ref[k]) for k in ref if not (
        np.isfinite(got[k]) and abs(got[k] - ref[k]) <= tol * abs(ref[k])
        + 1e-9)]
    assert set(got) == set(ref) and not bad, (bad, set(got) ^ set(ref))


# ---- coders, decode, assigner ------------------------------------------------

def _obbs(rng, n):
    return np.stack([rng.uniform(10, 50, n), rng.uniform(10, 50, n),
                     rng.uniform(4, 30, n), rng.uniform(2, 20, n),
                     rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)


def test_gv_coders_round_trip_and_match_jax():
    rng = np.random.RandomState(0)
    obbs = _obbs(rng, 64)
    obbs[:4, 4] = 0.0                   # horizontal: two vertices tie
    fix = pgv.GVFixCoder("le90").encode(_t(obbs))
    ratio = pgv.GVRatioCoder("le90").encode(_t(obbs))
    _close(fix, jgv.GVFixCoder("le90").encode(jnp.asarray(obbs)), 1e-6)
    _close(ratio, jgv.GVRatioCoder("le90").encode(jnp.asarray(obbs)), 1e-6)
    # the round trip: the enclosing box and the fractions give a tilted box
    # back; a horizontal one (its fractions degenerate) comes back through
    # gv_decode's snap, its area ratio being 1
    hbbs = obb2xyxy(_t(obbs))
    polys = pgv.GVFixCoder("le90").decode(hbbs, fix)
    iou = box_iou_rotated(poly2obb(polys, "le90"), _t(obbs), aligned=True)
    assert float(iou[4:].min()) > 0.999
    snapped = pch.gv_decode(hbbs[:4], fix[:4], ratio[:4])
    assert float(box_iou_rotated(snapped, _t(obbs[:4]), aligned=True)
                 .min()) > 0.999
    ref = jgv.GVFixCoder("le90").decode(jnp.asarray(hbbs.numpy()),
                                        jnp.asarray(fix.numpy()))
    _close(polys, ref, 1e-6)
    # gv_decode: the polygon, or the horizontal box above the ratio thr
    r = rng.uniform(0.5, 1.0, (64, 1)).astype(np.float32)
    got = pch.gv_decode(hbbs, fix, _t(r))
    want = jch.gv_decode(jnp.asarray(hbbs.numpy()), jnp.asarray(fix.numpy()),
                         jnp.asarray(r))
    _close(got, want, 1e-5)


def test_fcos_coder_and_head_match_jax():
    rng = np.random.RandomState(1)
    pts = rng.uniform(0, 64, (50, 2)).astype(np.float32)
    obbs = _obbs(rng, 50)
    coder, jcoder = pfcos.DistanceAnglePointCoder(), \
        jfcos.DistanceAnglePointCoder()
    enc = coder.encode(_t(pts), _t(obbs))
    _close(enc, jcoder.encode(jnp.asarray(pts), jnp.asarray(obbs)), 1e-6)
    _close(coder.decode(_t(pts), enc),
           jcoder.decode(jnp.asarray(pts), jnp.asarray(enc.numpy())), 1e-6)
    feats = [rng.randn(2, s, s, CH).astype(np.float32) for s in (8, 4, 2,
                                                                  1, 1)]
    head = jfcos.RotatedFCOSHead(num_classes=NC, feat_channels=CH,
                                 gn_groups=8)
    p = jax.eval_shape(lambda f: head.init(jax.random.PRNGKey(0), f),
                       feats)["params"]
    p = jax.tree.map(lambda v: np.asarray(rng.randn(*v.shape) * 0.1 + (
        1.0 if len(v.shape) < 2 else 0.0), np.float32), p)
    ref = jax.jit(lambda q, f: head.apply({"params": q}, f))(p, feats)
    port = pfcos.RotatedFCOSHead(num_classes=NC, in_channels=CH,
                                 feat_channels=CH, gn_groups=8)
    sd = convert_tree(p, ("h",))
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                         strict=True)
    got = port([_t(f) for f in feats])
    for g_lvls, r_lvls in zip(got, ref):
        for g, r in zip(g_lvls, r_lvls):
            _close(g, r, 1e-5)


def test_atss_obb_assign_matches_jax_with_a_near_tie():
    """Priors on a stride-8 grid, gts centred between four priors (four
    equal distances: the per-level top-k keeps the lower indices), one gt
    masked out, IoUs with a candidate a hair above the mean + std."""
    from sm3det_tpu_torch.core.anchor import RotatedAnchorGenerator
    gen = RotatedAnchorGenerator(strides=(8, 16), ratios=[1.0],
                                 octave_base_scale=4, scales_per_octave=1)
    anchors = torch.cat(gen.grid_anchors([(8, 8), (4, 4)]))
    gts = np.array([[24.0, 24.0, 20, 12, 0.3], [40.0, 16.0, 14, 30, -0.7],
                    [20.0, 44.0, 26, 10, 1.1], [8, 8, 10, 10, 0]],
                   np.float32)
    mask = np.array([True, True, True, False])
    rng = np.random.RandomState(2)
    ious = rng.uniform(0, 0.9, (anchors.shape[0], 4)).astype(np.float32)
    ious[:, 3] = -1.0
    got = patss.atss_obb_assign(_t(ious), anchors[:, :2], _t(gts), _t(mask),
                                [64, 16], topk=3)
    ref = jatss.atss_obb_assign(jnp.asarray(ious),
                                jnp.asarray(anchors[:, :2].numpy()),
                                jnp.asarray(gts), jnp.asarray(mask),
                                [64, 16], topk=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int((got > 0).sum()) > 0


# ---- the single-stem LSK / VAN detectors -------------------------------------

def _lsk_van_backbone(btype):
    """What a JAX zoo factory that read the type would build."""
    def build(b):
        return JAX_BACKBONES[btype](
            embed_dims=tuple(b["embed_dims"]), depths=tuple(b["depths"]),
            drop_path_rate=b.get("drop_path_rate", 0.0), multi_input=False,
            name="backbone")
    return build


SINGLE_STEM = {
    # (JAX class, port class, backbone type, oriented gts)
    "LSK-OrientedRCNN": (jzoo.OrientedRCNN, pzoo.OrientedRCNN, "LSKNet_moe",
                         True),
    "VAN-GFL": (jzoo.GFLDetector, pzoo.GFLDetector, "VAN_moe", False),
}
HEADS = {"LSK-OrientedRCNN": ("rpn_head", "roi_head"),
         "VAN-GFL": ("bbox_head",)}


def _layer_scales(params, rng):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key in ("gamma", "layer_scale_1", "layer_scale_2")
        else np.asarray(v), params)


def _template(jmodel, batch):
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), **APPLY_RNGS}, b, train=True), batch)
    return jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                        shapes["params"])


def _top_level(mdl, method):
    return method == "__call__" and len(mdl.scope.path) == 1


@pytest.fixture(scope="module")
def data():
    b = _batch(np.random.RandomState(0))
    return {"hbb": b["sar"], "obb": {k: np.concatenate(
        [b["rgb"][k], b["ifr"][k]]) for k in b["rgb"]}}


@pytest.fixture(scope="module", params=list(SINGLE_STEM))
def single_stem(request, data):
    """One JAX train forward of the detector (``_build_backbone`` swapped):
    its losses and the top-level modules' outputs; the port detector with
    the same parameters."""
    name = request.param
    jcls, pcls, btype, obb = SINGLE_STEM[name]
    cfg = copy.deepcopy(CFG)
    cfg["backbone"] = dict(type=btype, drop_path_rate=0.0, **SMALL)
    cfg["neck"]["in_channels"] = list(SMALL["embed_dims"])
    batch = data["obb" if obb else "hbb"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jzoo, "_build_backbone", _lsk_van_backbone(btype))
        jmodel = jcls(cfg=cfg)
        port = pcls(cfg, device="cpu", trainable=True)
        params = to_flax(dict(port.state_dict()), _template(jmodel, batch))
        params = _layer_scales(params, np.random.RandomState(1))
        if obb:     # RPN offsets inside the clamp, as test_torch_zoo's
            params["rpn_head"]["rpn_reg"]["kernel"] *= 0.2
        losses, state = jax.jit(lambda p, b: jmodel.apply(
            {"params": p}, b, train=True, rngs=APPLY_RNGS,
            capture_intermediates=_top_level, mutable=["intermediates"]))(
                params, batch)
    port.load_state_dict(from_flax(params), strict=True)
    seen = {}
    for head in HEADS[name]:
        getattr(port, head).register_forward_hook(
            lambda m, a, out, head=head: seen.setdefault(head, out))
    keys = None
    if obb:
        rngs = _StageRngs(2).apply({}, rngs={
            "sampling": APPLY_RNGS["sampling"]})
        keys = [_split_keys(r, len(batch["img"]), p) for r, p in zip(
            rngs, [N_ANCHORS, G + CFG["rcnn"]["rpn_max"]])]
    kw = {} if keys is None else {"sample_keys": keys}
    got = port(batch_to({"d": batch}, "cpu")["d"],
               gen=torch.Generator().manual_seed(0), **kw)
    inter = jax.tree.map(np.asarray, state["intermediates"])
    return dict(name=name, port=port, batch=batch, seen=seen,
                losses={k: float(v) for k, v in losses.items()},
                p_losses={k: float(v.detach()) for k, v in got.items()},
                inter={k: v["__call__"][0] for k, v in inter.items()})


def test_single_stem_backbones_match_jax(single_stem):
    """The single stem is ``patch_embed0``; the inference and training
    forwards' levels against JAX's ``LSKNetMoE`` / ``VANMoE`` with
    ``multi_input=False`` (its train forward, which has no draw here)."""
    port, ref = single_stem["port"], single_stem["inter"]["backbone"][0]
    assert port.backbone.stem_name == "patch_embed0"
    assert hasattr(port.backbone, "patch_embed0")
    assert not hasattr(port.backbone, "stem_single")
    x = torch.from_numpy(single_stem["batch"]["img"])
    with torch.no_grad():
        infer = port.backbone(x)
        train, gate_loss = port.backbone.forward_train(x)
    assert gate_loss is None and len(infer) == len(ref) == 4
    for lvl, (a, b, r) in enumerate(zip(infer, train, ref)):
        _close(a, r, 1e-5, f"level {lvl}")
        _close(b, r, 1e-5, f"train level {lvl}")


def test_single_stem_detectors_match_jax(single_stem):
    """The neck's levels and the heads' outputs on JAX's inputs to them,
    the R-CNN head's on the RoIs sampled with JAX's draws, and the
    losses."""
    port, inter = single_stem["port"], single_stem["inter"]
    feats = [_t(f) for f in inter["backbone"][0]]
    with torch.no_grad():
        neck = port._neck(feats)
    for lvl, (a, r) in enumerate(zip(neck, inter["neck"])):
        _close(a, r, 1e-5, f"neck {lvl}")
    levels = [_t(n) for n in inter["neck"]]
    for head in HEADS[single_stem["name"]]:
        if head == "roi_head":
            got = single_stem["seen"]["roi_head"]
        else:
            with torch.no_grad():
                got = getattr(port, head)(levels)
        for i, (g, r) in enumerate(zip(jax.tree.leaves(
                [t.detach().numpy() for t in _flatten(got)]),
                jax.tree.leaves(inter[head]))):
            _close(g, r, 1e-5, f"{head} {i}")
    _rel(single_stem["p_losses"], single_stem["losses"], 1e-4)
    assert any(v > 0 for k, v in single_stem["losses"].items()
               if "bbox" in k)


def _flatten(x):
    if torch.is_tensor(x):
        return [x]
    return [t for item in x for t in _flatten(item)]


# ---- GV, rotated FCOS / ATSS / Faster R-CNN: losses and gradients --------

REST = {
    # (JAX class, port class, the samplers' candidates after the RPN's)
    "GlidingVertex": (jssz.GlidingVertex, pssz.GlidingVertex, G + 256),
    "RotatedFCOS": (jssz.RotatedFCOS, pssz.RotatedFCOS, None),
    "RotatedATSS": (jze.RotatedATSS, pze.RotatedATSS, None),
    "RotatedFasterRCNN": (jze.RotatedFasterRCNN, pze.RotatedFasterRCNN,
                          G + 256),
}


@pytest.fixture(scope="module", params=list(REST))
def rest(request, data):
    """One value_and_grad of the JAX detector, and the port's losses and
    subtree gradient norms at the same parameters and sampler draws."""
    name = request.param
    jcls, pcls, n_rois = REST[name]
    cfg = copy.deepcopy(CFG)
    cfg["gn_groups"] = 8
    batch = data["obb"]
    jmodel = jcls(cfg=cfg)
    port = pcls(cfg, device="cpu", trainable=True)
    params = to_flax(dict(port.state_dict()), _template(jmodel, batch))
    params = _layer_scales(params, np.random.RandomState(1))
    if name == "RotatedFCOS":
        # boxes of positive size, as a trained head predicts: JAX's IoU
        # gradient is NaN at a zero-size box (held apart below)
        params["bbox_head"]["fcos_reg"]["bias"] += 2.0

    def total(p, b):
        losses = jmodel.apply({"params": p}, b, train=True, rngs=APPLY_RNGS)
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        params, batch)
    port.load_state_dict(from_flax(params), strict=True)
    kw = {}
    if n_rois is not None:
        rngs = _StageRngs(2).apply({}, rngs={
            "sampling": APPLY_RNGS["sampling"]})
        kw["sample_keys"] = [_split_keys(r, len(batch["img"]), p)
                             for r, p in zip(rngs, [N_ANCHORS, n_rois])]
    got = port(batch_to({"d": batch}, "cpu")["d"],
               gen=torch.Generator().manual_seed(0), **kw)
    p_grads = torch.autograd.grad(sum(got.values()), list(port.parameters()),
                                  allow_unused=True)
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
                norms=norms, p_norms={k: v ** 0.5 for k, v in sq.items()})


def test_rest_losses_match_jax(rest):
    _rel(rest["p_losses"], rest["losses"], 1e-4)
    assert any(v > 0 for k, v in rest["losses"].items() if "bbox" in k)
    if rest["name"] == "GlidingVertex":
        assert rest["losses"]["loss_fix"] > 0 and \
            rest["losses"]["loss_ratio"] > 0


def test_rest_gradient_norms_match_jax(rest):
    ref, got = rest["norms"], rest["p_norms"]
    assert set(got) == set(ref)
    bad = [(k, got[k], ref[k]) for k in ref
           if not abs(got[k] - ref[k]) <= 1e-4 * ref[k]]
    assert not bad, bad
    assert all(v > 0 for v in ref.values())


def test_fcos_gradients_stay_finite_at_zero_size_boxes(data):
    """At init a fifth of FCOS's distance predictions are 0 (a ReLU), so
    boxes of width or height 0 reach the rotated IoU loss. JAX's gradient
    is NaN there (``jnp.linalg.norm`` of a zero-length edge,
    ``sm3det_tpu/ops/rotated_iou.py:73``); the port's is finite and the
    losses equal JAX's."""
    cfg = copy.deepcopy(CFG)
    cfg["gn_groups"] = 8
    batch = data["obb"]
    port = pssz.RotatedFCOS(cfg, device="cpu", trainable=True)
    x, _ = port.extract_feat_train(torch.from_numpy(batch["img"]))
    outs = [[o.detach().requires_grad_(True) for o in lvl]
            for lvl in port.bbox_head(x)]
    b = batch_to({"d": batch}, "cpu")["d"]
    got = pfcos.fcos_loss(*outs, b["gt_obbs"], b["gt_labels"],
                          b["gt_mask"], NC)
    pos_zero = [bool((p == 0).any()) for p in outs[1]]
    assert any(pos_zero)
    grads = torch.autograd.grad(got["loss_bbox"], outs[1])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    jouts = [[o.detach().numpy() for o in lvl] for lvl in outs]
    ref, jgrads = jax.jit(jax.value_and_grad(lambda reg: jfcos.fcos_loss(
        jouts[0], reg, jouts[2], jouts[3], batch["gt_obbs"],
        batch["gt_labels"], batch["gt_mask"], NC)["loss_bbox"]))(jouts[1])
    assert any(bool(np.isnan(np.asarray(g)).any()) for g in jgrads)
    np.testing.assert_allclose(float(got["loss_bbox"].detach()), float(ref),
                               rtol=1e-4)
