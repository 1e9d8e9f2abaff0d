"""The port's TriSourceVariant against the JAX package, on the CPU, at
fp32: the four stage combinations the variant configs use (sar / rot
stages 1/1, 1/2, 2/1, 2/2).

The fixture is ``tests/test_detector_variants.py``'s (ConvNeXt ``atto``
with one two-expert MoE block, 64 px, 4 classes, [2 SAR : 1 RGB : 1
infrared], four gts an image) without gate noise and stochastic depth:
jax.random and torch.Generator cannot make the same normal draws. The
parameters are flax's own inits: one ``init_trisource`` of the 2/2
variant (backbone, neck, the horizontal and oriented R-CNN heads), and
the GFL and rotated RetinaNet heads initialised on their own; ``from_flax``
carries each variant's tree into the port. The RPN regressors are scaled
by 0.2 (midpoint offsets inside their clamp) and the layer scales drawn
from U(0.3, 0.8) (active blocks), as a trained model has them.

The samplers' sizes are fixed by the JAX module (256 RPN anchors, 256 RoIs
on the SAR branch), so the draws decide which candidates count: the port
is handed the very keys ``jax.random.uniform`` drew for each sampler
(``forward(..., sample_keys=...)``; the stage keys come from flax's
``make_rng("sampling")`` sequence of the root module, then the JAX
samplers' own splits).

Held: every loss within 1e-4 relative; every gradient leaf, mapped back to
its flax path by ``to_flax``, within 1e-3 of the leaf's norm; and three
train steps with DLA over ``reweight_for_variant``'s (loss, subnet) map
(for 1/1 and 2/2, whose maps hold every head kind), switching on after two
warmup steps: each leaf's update p3 - p0 within
1e-2 of that leaf's largest update on average over its elements (why on
average: ``tests/test_torch_train_step.py``), the EMAs within 1e-4 and the
last step's multipliers within 1e-4 of JAX's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sm3det_tpu.models.dense_heads.gfl_head import GFLHead as JaxGFLHead
from sm3det_tpu.models.dense_heads.rotated_retina_head import \
    RotatedRetinaHead as JaxRetinaHead
from sm3det_tpu.models.detectors.trisource_variants import \
    TriSourceVariant as JaxVariant
from sm3det_tpu.train.dla import dla_multipliers as jax_dla_multipliers
from sm3det_tpu.train.dla import make_dla_config as jax_dla_config
from sm3det_tpu.train.dla import reweight_for_variant as jax_reweight
from sm3det_tpu.train.optim import make_optimizer as jax_make_optimizer
from sm3det_tpu.train.train_state import init_trisource
from sm3det_tpu_torch.convert import from_flax, to_flax
from sm3det_tpu_torch.models.detectors.trisource_variants import \
    TriSourceVariant
from sm3det_tpu_torch.train.dla import make_dla_config, reweight_for_variant
from sm3det_tpu_torch.train.optim import make_optimizer
from sm3det_tpu_torch.train.train_state import (batch_to, build_train_step,
                                                init_train_state,
                                                trainable_params)

from test_detector_variants import APPLY_RNGS, CFG as VARIANT_CFG, IMG, \
    _batch

CFG = copy.deepcopy(VARIANT_CFG)
CFG["backbone"].update(noisy_gating=False, drop_path_rate=0.0)
G = 4
STAGES = [(1, 1), (1, 2), (2, 1), (2, 2)]
RPN_REG_GAIN = 0.2
WARMUP = 2
STEPS = 3
LR = 1e-4
# anchors of the RPNs at 64 px: 3 a cell at strides 4-64
N_ANCHORS = 3 * sum((IMG // s) ** 2 for s in (4, 8, 16, 32, 64))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


class _StageRngs(nn.Module):
    """The first ``n`` ``make_rng("sampling")`` keys of a root module: the
    keys the variant's samplers start from."""

    n: int

    def __call__(self):
        return [self.make_rng("sampling") for _ in range(self.n)]


def _split_keys(rng, b, p):
    """JAX's sampler draws from one stage key: ``split(rng, b)``, then per
    image ``random_sample``'s split into the positives' and negatives'
    uniform keys over ``p`` candidates -> torch (b, p) pair."""
    kp, kn = [], []
    for r in jax.random.split(rng, b):
        rp, rn = jax.random.split(r)
        kp.append(np.asarray(jax.random.uniform(rp, (p,))))
        kn.append(np.asarray(jax.random.uniform(rn, (p,))))
    return torch.from_numpy(np.stack(kp)), torch.from_numpy(np.stack(kn))


def variant_sample_keys(stages, batch):
    """The (key_pos, key_neg) pairs the JAX variant's samplers draw under
    ``APPLY_RNGS``, in the order the port's forward asks for them."""
    sar, rot = stages
    n_sar, n_rgb = len(batch["sar"]["img"]), len(batch["rgb"]["img"])
    sizes = []
    if sar == 2:                       # the SAR RPN; 1000 proposals
        sizes += [(n_sar, N_ANCHORS), (n_sar, G + 1000)]
    if rot == 2:                       # per modality: RPN; rpn_max props
        sizes += [(n_rgb, N_ANCHORS), (n_rgb, G + CFG["rgb"]["rpn_max"])] * 2
    rngs = _StageRngs(len(sizes)).apply(
        {}, rngs={"sampling": APPLY_RNGS["sampling"]})
    return [_split_keys(r, b, p) for r, (b, p) in zip(rngs, sizes)]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


@pytest.fixture(scope="module")
def setup():
    """Every subtree the four variants need, from flax inits."""
    batch = _batch(np.random.RandomState(0))
    full = init_trisource(jax.random.PRNGKey(0),
                          JaxVariant(cfg=CFG, sar_stages=2, rot_stages=2),
                          batch)
    full = jax.tree.map(np.asarray, full)
    ch = CFG["neck"]["out_channels"]
    levels = [jnp.zeros((1, s, s, ch)) for s in (8, 4, 2, 1, 1)]
    heads = {}
    for name, mod in (("gfl", JaxGFLHead(num_classes=CFG["num_classes"])),
                      ("retina", JaxRetinaHead(
                          num_classes=CFG["num_classes"]))):
        heads[name] = jax.tree.map(np.asarray, jax.jit(
            lambda x, m=mod: m.init(jax.random.PRNGKey(7), x))(levels)
            ["params"])
    rng = np.random.RandomState(1)
    full = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key == "gamma" else v, full)
    for m in ("rgb", "ifr"):
        full[f"{m}_rpn_head"]["rpn_reg"]["kernel"] = \
            full[f"{m}_rpn_head"]["rpn_reg"]["kernel"] * RPN_REG_GAIN
    return {"batch": batch, "full": full, "heads": heads}


def variant_params(setup, stages):
    sar, rot = stages
    full, heads = setup["full"], setup["heads"]
    p = {"backbone": full["backbone"], "neck": full["neck"]}
    if sar == 1:
        p["sar_bbox_head"] = heads["gfl"]
    else:
        p.update(sar_rpn_head=full["sar_rpn_head"],
                 sar_roi_head=full["sar_roi_head"])
    for m in ("rgb", "ifr"):
        if rot == 1:
            p[f"{m}_bbox_head"] = heads["retina"]
        else:
            p[f"{m}_rpn_head"] = full[f"{m}_rpn_head"]
            p[f"{m}_roi_head"] = full[f"{m}_roi_head"]
    return p


def _port(params, stages, keys):
    port = TriSourceVariant(CFG, device="cpu", trainable=True,
                            sar_stages=stages[0], rot_stages=stages[1])
    port.load_state_dict(from_flax(params), strict=True)
    # every forward takes the JAX samplers' draws
    port.forward = lambda batch, gen=None: TriSourceVariant.forward(
        port, batch, gen, sample_keys=keys)
    return port


def _ids(s):
    return f"{s[0]}{s[1]}"


def variant_results(setup, stages):
    """One jitted value_and_grad of the JAX variant, its first step, and
    the port's losses and gradients at the same parameters; made once a
    module run."""
    cache = setup.setdefault("variants", {})
    if stages not in cache:
        cache[stages] = _variant(setup, stages)
    return cache[stages]


@pytest.fixture(scope="module", params=STAGES, ids=_ids)
def variant(request, setup):
    return variant_results(setup, request.param)


def _variant(setup, stages):
    params = variant_params(setup, stages)
    batch = setup["batch"]
    jmodel = JaxVariant(cfg=CFG, sar_stages=stages[0], rot_stages=stages[1])

    def loss_fn(p, b):
        losses = jmodel.apply({"params": p}, b, train=True, rngs=APPLY_RNGS)
        total = jnp.zeros(())
        for v in losses.values():
            total = total + v
        return total, losses

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    out = vg(params, batch)
    (total, losses), grads = out
    keys = variant_sample_keys(stages, batch)
    port = _port(params, stages, keys)
    tp = trainable_params(port)
    p_losses = port(batch_to(batch, "cpu"))
    p_total = sum(p_losses.values())
    p_grads = torch.autograd.grad(p_total, list(tp.values()),
                                  allow_unused=True)
    p_grads = [torch.zeros_like(p) if g is None else g
               for p, g in zip(tp.values(), p_grads)]
    return {"stages": stages, "params": params, "vg": vg, "jax_out": out,
            "keys": keys,
            "losses": {k: float(v) for k, v in losses.items()},
            "total": float(total),
            "grads": dict(_flat(jax.tree.map(np.asarray, grads))),
            "p_losses": {k: float(v.detach()) for k, v in p_losses.items()},
            "p_total": float(p_total.detach()),
            "p_grads": dict(_flat(to_flax(dict(zip(tp, p_grads)),
                                          params)))}


def test_losses_match_jax(variant):
    ref, got = variant["losses"], variant["p_losses"]
    assert set(got) == set(ref)
    names = {k for k, _ in reweight_for_variant(*variant["stages"])}
    assert set(ref) == names | {"gate_loss"}
    bad = [(k, got[k], ref[k]) for k in ref
           if not (np.isfinite(got[k])
                   and abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]) + 1e-9)]
    assert not bad, bad
    assert abs(variant["p_total"] - variant["total"]) <= \
        1e-4 * abs(variant["total"])


def test_gradients_match_jax(variant):
    """Every leaf within 1e-3 of its norm, and the heads' gradients not
    all zero."""
    ref, got = variant["grads"], variant["p_grads"]
    assert set(got) == set(ref)
    bad = []
    for k in ref:
        norm = float(np.linalg.norm(ref[k]))
        err = float(np.abs(got[k] - ref[k]).max())
        if not err <= 1e-3 * norm:
            bad.append((k, err, norm))
    assert not bad, bad
    for sub in variant["params"]:
        assert any(np.abs(v).max() > 0 for k, v in ref.items()
                   if k.split("/")[0] == sub), sub


def test_reweight_for_variant_matches_jax(variant):
    """The (loss, subnet) map, and the DLA labels it gives the port's
    parameters: every head subnet labels its own subtree."""
    from sm3det_tpu_torch.train.dla import label_params
    stages = variant["stages"]
    pairs = reweight_for_variant(*stages)
    assert pairs == jax_reweight(*stages)
    names = list(variant["p_grads"])
    labels = label_params([n.replace("/", ".") for n in names],
                          make_dla_config(pairs).subnets)
    for n, lab in zip(names, labels):
        top = n.split("/")[0]
        assert lab == (top if top.endswith("_head") else "_shared_"), n


@pytest.fixture(scope="module", params=[(1, 1), (2, 2)], ids=_ids)
def three_steps(request, setup):
    """p3 - p0 of both packages: three steps, DLA over the variant's map
    with a warmup of two, for the two combinations whose maps hold every
    head kind (the 1/2 and 2/1 maps are their halves). JAX's first step
    reuses the variant's value_and_grad at p0."""
    variant = variant_results(setup, request.param)
    stages, params0, batch = variant["stages"], variant["params"], \
        setup["batch"]
    opt_kw = dict(base_lr=LR, step_iters=(100,), warmup_iters=WARMUP)
    j_dla = jax_dla_config(reweight=jax_reweight(*stages),
                           warmup_iters=WARMUP)
    j_init, j_update, _ = jax_make_optimizer(dla_cfg=j_dla, **opt_kw)
    j_update = jax.jit(j_update)
    p, opt = params0, jax.jit(j_init)(params0)
    for i in range(STEPS):
        (_, losses), grads = variant["jax_out"] if i == 0 else \
            variant["vg"](p, batch)
        if i == STEPS - 1:
            j_mults, _ = jax_dla_multipliers(opt.dla, losses, j_dla)
        updates, opt = j_update(grads, opt, p, losses)
        p = jax.tree.map(lambda a, u: np.asarray(a) + np.asarray(u), p,
                         updates)
    j_delta = dict(_flat(jax.tree.map(
        lambda a, b: np.asarray(a) - np.asarray(b), p, params0)))

    port = _port(params0, stages, variant["keys"])
    names = list(trainable_params(port))
    init_fn, update_fn, _ = make_optimizer(
        names, dla_cfg=make_dla_config(reweight_for_variant(*stages),
                                       warmup_iters=WARMUP), **opt_kw)
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
            "dla_ema": state.opt.dla.ema, "j_dla_ema": np.asarray(
                opt.dla.ema)}


def test_three_dla_steps_match_jax(three_steps):
    ref, got = three_steps["j"], three_steps["p"]
    bad = []
    for k in ref:
        scale = float(np.abs(ref[k]).max())
        err = float(np.abs(got[k] - ref[k]).mean())
        if not err <= 1e-2 * scale:
            bad.append((k, err, scale))
    assert not bad, bad
    applied = three_steps["applied"]
    for mults in applied[:WARMUP]:
        assert mults and all(m == 1.0 for m in mults.values())
    last, j_mults = applied[-1], three_steps["j_mults"]
    assert last.keys() <= j_mults.keys()
    for k, m in last.items():
        assert abs(m - j_mults[k]) <= 1e-4 * abs(j_mults[k]), (k, m)
    assert any(abs(m - 1.0) > 1e-3 for m in last.values())
    np.testing.assert_allclose(three_steps["dla_ema"].numpy(),
                               three_steps["j_dla_ema"], rtol=1e-4)
    assert all(np.isfinite(float(v)) for v in three_steps["metrics"].values())
