"""The PyTorch port's flagship-structured train step against the JAX
package, on the CPU, at fp32.

One small detector (ConvNeXt ``atto``, 64 px, one MoE block, two experts)
is initialised once by JAX's ``init_trisource``; ``from_flax`` carries the
init into a trainable port, leaf for leaf. Both packages then take the
same numpy batch ([2 SAR : 1 RGB : 1 infrared], four gts an image).

jax.random and torch.Generator cannot make the same draws, so the config
leaves randomness no way to change the losses: no stochastic depth, no
gate noise, an RPN sampler of 2048 slots (twice the 1023 anchors at 64 px,
so even the positive cap takes every positive) and an R-CNN sampler of 512
(a positive cap of 128 over 4 gts + 64 proposals). Every candidate is then
sampled, and the summed losses do not depend on the draws.

Held: every loss within 1e-4 relative; every gradient leaf, mapped back to
its flax path by ``to_flax``, within 1e-3 of the leaf's norm; and after
three train steps with DLA switching on after two warmup steps, each
leaf's update p3 - p0 within 1e-2 of that leaf's largest update on
average over its elements.

Why on average: Adam's update is m / sqrt(v), about sign(g) at first. An
element whose gradient crosses zero between steps has m near 0, and there
the fp32 rounding of the two packages' gradients (which agree to 1.2e-5 of
each leaf's norm at every step when both start from the same parameters)
decides the direction: measured at this config, 0.01 % to 1 % of a leaf's
elements, most in the GFL towers, move by up to half of the leaf's largest
update apart. The mean error stays far below 1e-2 of it, and a fault that
scales a leaf (a wrong decay, bias correction or DLA multiplier) moves the
mean by a good part of the update.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.detectors.trisource import \
    TriSourceDetector as JaxDetector
from sm3det_tpu.train.dla import dla_multipliers as jax_dla_multipliers
from sm3det_tpu.train.dla import make_dla_config as jax_dla_config
from sm3det_tpu.train.optim import make_optimizer as jax_make_optimizer
from sm3det_tpu.train.train_state import init_trisource
from sm3det_tpu_torch.convert import from_flax, to_flax
from sm3det_tpu_torch.models.detectors.trisource import TriSourceDetector
from sm3det_tpu_torch.train.dla import make_dla_config
from sm3det_tpu_torch.train.optim import make_optimizer
from sm3det_tpu_torch.train.train_state import (batch_to, build_train_step,
                                                init_train_state,
                                                trainable_params)
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)

IMG = 64
G = 4
CFG = dict(
    num_classes=4,
    angle_version="le90",
    backbone=dict(arch="atto", drop_path_rate=0.0,
                  moe_block_inds=((), (), (0,), ()), num_experts=2, top_k=2,
                  gate="cosine", capacity_factor=2.0, noisy_gating=False),
    neck=dict(in_channels=(40, 80, 160, 320), out_channels=32,
              num_outs=5, extra_level=1, add_extra_convs="on_output"),
    sar=dict(strides=(8, 16, 32, 64, 128), reg_max=8,
             nms_pre=50, score_thr=0.05, nms_iou=0.6, max_per_img=20),
    rgb=dict(rpn_strides=(4, 8, 16, 32, 64), rpn_sample=2048,
             rcnn_sample=512, rpn_nms_pre=64, rpn_max=64, rpn_nms_iou=0.8,
             rcnn_score_thr=0.05, rcnn_nms_iou=0.1, rcnn_max=20),
)
RPN_REG_GAIN = 0.2       # keep the midpoint offsets inside their clamp
WARMUP = 2
STEPS = 3
LR = 1e-4


def make_batch(seed=0, n=(2, 1, 1)):
    rng = np.random.RandomState(seed)

    def boxes4(b):
        cx, cy = rng.uniform(10, IMG - 10, (2, b, G))
        w, h = rng.uniform(6, 16, (2, b, G))
        return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        -1).astype(np.float32)

    def boxes5(b):
        return np.stack([rng.uniform(12, IMG - 12, (b, G)),
                         rng.uniform(12, IMG - 12, (b, G)),
                         rng.uniform(8, 18, (b, G)),
                         rng.uniform(5, 8, (b, G)),
                         rng.uniform(-1.2, 1.2, (b, G))],
                        -1).astype(np.float32)

    def common(b):
        return {"img": rng.rand(b, IMG, IMG, 3).astype(np.float32),
                "gt_labels": rng.randint(0, 4, (b, G)).astype(np.int32),
                "gt_mask": np.ones((b, G), bool)}

    return {"sar": dict(common(n[0]), gt_bboxes=boxes4(n[0])),
            "rgb": dict(common(n[1]), gt_obbs=boxes5(n[1])),
            "ifr": dict(common(n[2]), gt_obbs=boxes5(n[2]))}


def _noisy(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["backbone"]["noisy_gating"] = True
    return cfg


def _drop_w_noise(tree):
    if isinstance(tree, dict):
        return {k: _drop_w_noise(v) for k, v in tree.items()
                if k != "w_noise"}
    return tree


@pytest.fixture(scope="module")
def setup():
    """One JAX training init (noisy gate, so the tree holds ``w_noise``)
    and one jitted value_and_grad of the noise-free model."""
    batch = make_batch()
    rng = np.random.RandomState(1)
    params = init_trisource(jax.random.PRNGKey(0), JaxDetector(_noisy(CFG)),
                            batch)
    params = jax.tree.map(np.asarray, params)
    noisy_params = params
    params = _drop_w_noise(params)
    # active blocks (layer scale well above its 1e-6 init) and RPN offsets
    # inside the clamp, as a trained model has them
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key == "gamma" else v, params)
    for head in ("rgb_rpn_head", "ifr_rpn_head"):
        params[head]["rpn_reg"]["kernel"] = \
            params[head]["rpn_reg"]["kernel"] * RPN_REG_GAIN
    jmodel = JaxDetector(CFG)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)

    def loss_fn(p, b):
        losses = jmodel.apply({"params": p}, b, source_ratio=(2, 1, 1),
                              train=True, rngs={"dropout": keys[0],
                                                "moe_noise": keys[1],
                                                "sampling": keys[2]})
        total = jnp.zeros(())
        for v in losses.values():
            total = total + v
        return total, losses

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return {"batch": batch, "params": params, "noisy_params": noisy_params,
            "vg": vg}


def _port(params):
    port = TriSourceDetector(CFG, device="cpu", trainable=True)
    port.load_state_dict(from_flax(params), strict=True)
    return port


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def test_from_flax_carries_a_training_init(setup):
    """A JAX training init (with the noisy gate's ``w_noise``) goes into
    the trainable port and back, leaf for leaf."""
    params = setup["noisy_params"]
    port = TriSourceDetector(_noisy(CFG), device="cpu", trainable=True)
    port.load_state_dict(from_flax(params), strict=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in port.parameters())
    assert port.training
    names = dict(port.named_parameters())
    assert "backbone.stage2_block0.ffn.w_noise" in names
    back = dict(_flat(to_flax(names, params)))
    ref = dict(_flat(params))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.fixture(scope="module")
def first_step(setup):
    """Losses and gradients of both packages on the same params."""
    out = setup["vg"](setup["params"], setup["batch"])
    (total, losses), grads = out
    port = _port(setup["params"])
    params = trainable_params(port)
    b = batch_to(setup["batch"], "cpu")
    p_losses = port(b, gen=torch.Generator().manual_seed(0))
    p_total = sum(p_losses.values())
    p_grads = torch.autograd.grad(p_total, list(params.values()))
    return {"jax_out": out,
            "losses": {k: float(v) for k, v in losses.items()},
            "total": float(total),
            "grads": dict(_flat(jax.tree.map(np.asarray, grads))),
            "p_losses": {k: float(v.detach()) for k, v in p_losses.items()},
            "p_total": float(p_total.detach()),
            "p_grads": dict(_flat(to_flax(dict(zip(params, p_grads)),
                                          setup["params"])))}


LOSS_KEYS = ("gate_loss", "sar_loss_cls", "sar_loss_bbox", "sar_loss_dfl",
             "rgb_loss_rpn_cls", "rgb_loss_rpn_bbox", "rgb_loss_cls",
             "rgb_loss_bbox", "ifr_loss_rpn_cls", "ifr_loss_rpn_bbox",
             "ifr_loss_cls", "ifr_loss_bbox")


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_losses_match_jax(first_step, key):
    got, ref = first_step["p_losses"][key], first_step["losses"][key]
    assert np.isfinite(got)
    assert abs(got - ref) <= 1e-4 * abs(ref) + 1e-9, (got, ref)


def test_loss_keys_and_total(first_step):
    assert set(first_step["p_losses"]) == set(first_step["losses"]) \
        == set(LOSS_KEYS)
    assert abs(first_step["p_total"] - first_step["total"]) <= \
        1e-4 * abs(first_step["total"])


@pytest.mark.parametrize("subtree", [
    "backbone", "neck", "sar_bbox_head", "rgb_rpn_head", "ifr_rpn_head",
    "rgb_roi_head", "ifr_roi_head"])
def test_gradients_match_jax(first_step, subtree):
    """Every leaf of the subtree within 1e-3 of its norm."""
    ref, got = first_step["grads"], first_step["p_grads"]
    keys = [k for k in ref if k.split("/")[0] == subtree]
    assert keys
    bad = []
    for k in keys:
        norm = float(np.linalg.norm(ref[k]))
        err = float(np.abs(got[k] - ref[k]).max())
        if not err <= 1e-3 * norm:
            bad.append((k, err, norm))
    assert not bad, bad


@pytest.fixture(scope="module")
def three_steps(setup, first_step):
    """p3 - p0 of both packages: three steps, DLA warmup of two. JAX's
    first step reuses ``first_step``'s value_and_grad at p0."""
    batch, params0 = setup["batch"], setup["params"]
    opt_kw = dict(base_lr=LR, step_iters=(100,), warmup_iters=WARMUP)
    j_init, j_update, _ = jax_make_optimizer(
        dla_cfg=jax_dla_config(warmup_iters=WARMUP), **opt_kw)
    j_update = jax.jit(j_update)
    p, opt = params0, jax.jit(j_init)(params0)
    for i in range(STEPS):
        (_, losses), grads = first_step["jax_out"] if i == 0 else \
            setup["vg"](p, batch)
        if i == STEPS - 1:
            j_mults, _ = jax_dla_multipliers(
                opt.dla, losses, jax_dla_config(warmup_iters=WARMUP))
        updates, opt = j_update(grads, opt, p, losses)
        p = jax.tree.map(lambda a, u: np.asarray(a) + np.asarray(u), p,
                         updates)
    j_delta = dict(_flat(jax.tree.map(
        lambda a, b: np.asarray(a) - np.asarray(b), p, params0)))

    port = _port(params0)
    names = list(trainable_params(port))
    init_fn, update_fn, _ = make_optimizer(
        names, dla_cfg=make_dla_config(warmup_iters=WARMUP), **opt_kw)
    state = init_train_state(port, init_fn)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    step = build_train_step(port, update_fn)
    b = batch_to(batch, "cpu")
    applied = []
    for _ in range(STEPS):
        state, metrics = step(state, b)
        applied.append(state.opt.mults)
    p_delta = dict(_flat(to_flax(
        {k: state.params[k] - p0[k] for k in names}, params0)))
    return {"j": j_delta, "p": p_delta, "metrics": metrics,
            "applied": applied,
            "j_mults": {k: float(v) for k, v in j_mults.items()},
            "dla_ema": state.opt.dla.ema, "steps": state.opt.step,
            "j_dla_ema": np.asarray(opt.dla.ema)}


@pytest.mark.parametrize("subtree", [
    "backbone", "neck", "sar_bbox_head", "rgb_rpn_head", "ifr_rpn_head",
    "rgb_roi_head", "ifr_roi_head"])
def test_three_step_updates_match_jax(three_steps, subtree):
    ref, got = three_steps["j"], three_steps["p"]
    keys = [k for k in ref if k.split("/")[0] == subtree]
    assert keys
    bad = []
    for k in keys:
        scale = float(np.abs(ref[k]).max())
        err = float(np.abs(got[k] - ref[k]).mean())
        if not err <= 1e-2 * scale:
            bad.append((k, err, scale))
    assert not bad, bad


def test_three_steps_dla_state(three_steps):
    """The EMAs agree with JAX's; the updates applied multipliers of 1
    during the warmup and, at the last step past it, JAX's multipliers,
    which are not all 1."""
    assert three_steps["steps"] == STEPS
    applied = three_steps["applied"]
    for mults in applied[:WARMUP]:
        assert mults and all(m == 1.0 for m in mults.values())
    last, ref = applied[-1], three_steps["j_mults"]
    assert last.keys() <= ref.keys()
    for k, m in last.items():
        assert abs(m - ref[k]) <= 1e-4 * abs(ref[k]), (k, m, ref[k])
    assert any(abs(m - 1.0) > 1e-3 for m in last.values())
    np.testing.assert_allclose(three_steps["dla_ema"].numpy(),
                               three_steps["j_dla_ema"], rtol=1e-4)
    assert all(np.isfinite(float(v)) for v in three_steps["metrics"].values())
