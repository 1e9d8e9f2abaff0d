"""RoI Transformer against the JAX package, on the CPU, at fp32.

The fixture is ``tests/test_torch_zoo.py``'s (``atto`` without MoE
blocks or stochastic depth, 64 px, 4 classes, two images of 4 oriented
gts); the parameters are the port's seeded init laid out as the flax
inits of each module (``jax.eval_shape``, no compile), carried over by
``from_flax``, the layer scales drawn from U(0.3, 0.8). The three
samplers (the RPN's 64 anchors, stage 1's 128 horizontal RoIs among the
gts and 256 proposals, stage 2's 128 rotated RoIs among the gts and
stage 1's boxes) are handed the keys ``jax.random`` drew for the JAX
detector: the root module's ``make_rng("sampling")`` sequence, then the
samplers' own splits.

Held: ``HBB2OBBBBoxHead`` and ``roi_trans_stage1`` (logits and decoded
boxes within 1e-5 of scale); the five losses within 1e-4 relative; the
gradient norm of each top-level subtree (backbone, neck, ``rpn_head``,
``stage1_head``, ``stage2_head``) within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sm3det_tpu.core.bbox.coders import DeltaXYWHAOBBoxCoder as JaxCoder
from sm3det_tpu.models.backbones.convnext import ConvNeXtMoE as JaxConvNeXt
from sm3det_tpu.models.dense_heads.rpn_head import RPNHead as JaxRPN
from sm3det_tpu.models.detectors.redet_roitrans import \
    RoITransformer as JaxRoITrans
from sm3det_tpu.models.necks.fpn import MultitaskFPN as JaxFPN
from sm3det_tpu.models.roi_heads import cascade_heads as jch
from sm3det_tpu.models.roi_heads.oriented_roi_head import \
    RotatedShared2FCBBoxHead as JaxRoIHead
from sm3det_tpu_torch.convert import convert_tree, from_flax, to_flax
from sm3det_tpu_torch.models.detectors.redet_roitrans import (
    RoITransformer, make_stage1_coder)
from sm3det_tpu_torch.models.roi_heads import cascade_heads as pch
from sm3det_tpu_torch.train.train_state import batch_to

from test_detector_variants import APPLY_RNGS, IMG, _batch
from test_torch_zoo import CFG
from torch_jax_refs import jax_refs_at_lowest_level  # noqa: F401

NC, G = CFG["num_classes"], 4
CH = CFG["neck"]["out_channels"]
N_ANCHORS = 3 * sum((IMG // s) ** 2 for s in (4, 8, 16, 32, 64))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol, what=""):
    got = got.detach().numpy().astype(np.float64)
    ref = np.asarray(ref).astype(np.float64)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


class _StageRngs(nn.Module):
    n: int

    def __call__(self):
        return [self.make_rng("sampling") for _ in range(self.n)]


def _split_keys(rng, b, p):
    kp, kn = [], []
    for r in jax.random.split(rng, b):
        rp, rn = jax.random.split(r)
        kp.append(np.asarray(jax.random.uniform(rp, (p,))))
        kn.append(np.asarray(jax.random.uniform(rn, (p,))))
    return _t(np.stack(kp)), _t(np.stack(kn))


def sample_keys(b):
    """The RPN's, stage 1's and stage 2's keys, as JAX draws them under
    ``APPLY_RNGS``."""
    sizes = [N_ANCHORS, G + 256, G + 128]
    rngs = _StageRngs(len(sizes)).apply(
        {}, rngs={"sampling": APPLY_RNGS["sampling"]})
    return [_split_keys(r, b, p) for r, p in zip(rngs, sizes)]


def _init_all(key):
    ks = jax.random.split(key, 5)
    feats = [jnp.zeros((1, IMG // s, IMG // s, c)) for s, c in
             zip((4, 8, 16, 32), CFG["neck"]["in_channels"])]
    roi = jnp.zeros((2, 7, 7, CH))
    return {
        "backbone": JaxConvNeXt(arch="atto", moe_block_inds=(
            (), (), (), ())).init(ks[0], jnp.zeros((1, IMG, IMG, 3)))
        ["params"],
        "neck": JaxFPN(in_channels=tuple(CFG["neck"]["in_channels"]),
                       out_channels=CH, num_outs=5, extra_level=1).init(
            ks[1], feats)["params"],
        "rpn_head": JaxRPN().init(ks[2], [jnp.zeros((1, 8, 8, CH))])
        ["params"],
        "stage1_head": jch.HBB2OBBBBoxHead(num_classes=NC).init(
            ks[3], roi)["params"],
        "stage2_head": JaxRoIHead(num_classes=NC).init(ks[4], roi)
        ["params"]}


@pytest.fixture(scope="module")
def setup():
    """The flax inits' tree (``jax.eval_shape``, a trace with no compile)
    holding the port RoI Transformer's seeded init."""
    template = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                            jax.eval_shape(_init_all, jax.random.PRNGKey(0)))
    params = to_flax(dict(RoITransformer(CFG, device="cpu").state_dict()),
                     template)
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key == "gamma" else np.asarray(v), params)
    b = _batch(np.random.RandomState(0))
    batch = {k: np.concatenate([b["rgb"][k], b["ifr"][k]])
             for k in b["rgb"]}
    return {"params": params, "batch": batch}


def _norm(leaves):
    return float(np.sqrt(sum(float(np.sum(np.square(np.asarray(v))))
                             for v in leaves)))


@pytest.fixture(scope="module")
def results(setup):
    """One value_and_grad of the JAX detector, and the port's losses and
    gradients at the same parameters and sampler draws."""
    params, batch = setup["params"], setup["batch"]
    jmodel = JaxRoITrans(cfg=CFG)

    def total(p, b):
        losses = jmodel.apply({"params": p}, b, train=True, rngs=APPLY_RNGS)
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        params, batch)
    port = RoITransformer(CFG, device="cpu", trainable=True)
    port.load_state_dict(from_flax(params), strict=True)
    got = port(batch_to({"d": batch}, "cpu")["d"],
               sample_keys=sample_keys(len(batch["img"])))
    p_grads = torch.autograd.grad(sum(got.values()), list(port.parameters()),
                                  allow_unused=True)
    sq = {}
    for (n, _), g in zip(port.named_parameters(), p_grads):
        top = n.split(".")[0]
        sq[top] = sq.get(top, 0.0) + (
            0.0 if g is None else float((g.double() ** 2).sum()))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "norms": {k: _norm(jax.tree_util.tree_leaves(v))
                      for k, v in grads.items()},
            "p_losses": {k: float(v.detach()) for k, v in got.items()},
            "p_norms": {k: v ** 0.5 for k, v in sq.items()}}


def test_stage1_head_and_decode():
    """``HBB2OBBBBoxHead`` on pooled features and ``roi_trans_stage1``'s
    decode against ``hbb2obb`` priors."""
    rng = np.random.RandomState(2)
    feats = [rng.randn(2, IMG // s, IMG // s, CH).astype(np.float32)
             for s in (4, 8, 16, 32)]
    xy = rng.uniform(0, 48, (24, 2))
    wh = rng.uniform(4, 40, (24, 2))
    rois5 = np.concatenate([rng.randint(0, 2, (24, 1)), xy, xy + wh],
                           -1).astype(np.float32)
    head = jch.HBB2OBBBBoxHead(num_classes=NC)
    p = head.init(jax.random.PRNGKey(3), jnp.zeros((2, 7, 7, CH)))["params"]
    coder = JaxCoder(angle_range="le90", target_means=(0.,) * 5,
                     target_stds=(0.1, 0.1, 0.2, 0.2, 0.1))
    ref_cls, ref_obbs = jax.jit(lambda p, f, r: jch.roi_trans_stage1(
        f, r, head.bind({"params": p}), coder, "le90"))(p, feats, rois5)
    port = pch.HBB2OBBBBoxHead(num_classes=NC, in_channels=CH)
    sd = convert_tree(p, ("h",))
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                         strict=True)
    cls, obbs = pch.roi_trans_stage1([_t(f) for f in feats], _t(rois5),
                                     port, make_stage1_coder("le90"), "le90")
    _close(cls, ref_cls, 1e-5, "logits")
    _close(obbs, ref_obbs, 1e-5, "boxes")


def test_losses_match_jax(results):
    ref, got = results["losses"], results["p_losses"]
    assert set(got) == set(ref) == {
        "loss_rpn_cls", "loss_rpn_bbox", "s1_loss_cls", "s1_loss_bbox",
        "s2_loss_cls", "s2_loss_bbox"}
    bad = [(k, got[k], ref[k]) for k in ref if not (np.isfinite(got[k]) and
           abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]) + 1e-9)]
    assert not bad, bad
    assert ref["s1_loss_bbox"] > 0 and ref["s2_loss_bbox"] > 0


def test_gradient_norms_match_jax(results):
    ref, got = results["norms"], results["p_norms"]
    assert set(got) == set(ref)
    bad = [(k, got[k], ref[k]) for k in ref
           if not abs(got[k] - ref[k]) <= 1e-4 * ref[k]]
    assert not bad, bad
    assert all(v > 0 for v in ref.values())
