"""The port's multi-task loss reweighting against the JAX package, on the
CPU, at fp32. (The uncertainty sum's losses and gradients, ``mtl_sigma``'s
among them, are held against ``jax.value_and_grad`` in
``tests/test_torch_lsk_train.py``.)

- ``mtl_sigma`` takes DLA's shared label and AdamW's decay, as in JAX.
- DWA: three ``build_train_step`` steps of both packages on three batches
  (so the weights leave 1 from step 2 on), on the noise-free tiny
  LSKNet-MoE detector of ``tests/test_torch_lsk_train.py``: the totals
  and the carried losses within 1e-4 relative at each step.
- The full-state checkpoint carries ``mtl_sigma`` (a master parameter)
  and DWA's carry; a resumed run equals an unbroken one bit for bit (gate
  noise and stochastic depth on, deterministic algorithms on).
- The train tool on ``configs/smoke_tiny.py`` with each mode, 2
  iterations.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.detectors.trisource import (
    REWEIGHT_LOSS_KEYS as JAX_KEYS, TriSourceDetector as JaxDetector)
from sm3det_tpu.train.optim import make_optimizer as jax_make_optimizer
from sm3det_tpu.train.train_state import TrainState as JaxTrainState
from sm3det_tpu.train.train_state import build_train_step as jax_build_step
from sm3det_tpu_torch.models.detectors.trisource import (REWEIGHT_LOSS_KEYS,
                                                         TriSourceDetector)
from sm3det_tpu_torch.tools import train as train_cli
from sm3det_tpu_torch.train import checkpoint as ckpt
from sm3det_tpu_torch.train.optim import make_optimizer
from sm3det_tpu_torch.train.train_state import (batch_to, build_train_step,
                                                dwa_weights,
                                                init_train_state,
                                                trainable_params)

from test_torch_lsk_train import LSK_CFG
from test_torch_lsknet import flax_params_of
from test_torch_train_loop import CFG as NOISY_CFG
from test_torch_train_loop import _assert_states_equal, _batch
from test_torch_train_step import make_batch
from torch_jax_refs import jax_refs_at_lowest_level  # noqa: F401

DWA_CFG = dict(LSK_CFG, multi_tasks_reweight=None)

OPT = dict(base_lr=1e-4, weight_decay=0.05, step_iters=(99,),
           warmup_iters=2, warmup_ratio=1.0 / 3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as ``tests/test_torch_train_loop.py``: the
    suite runs several test processes on the host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _with(cfg, mode):
    cfg = copy.deepcopy(cfg)
    cfg["multi_tasks_reweight"] = mode
    return cfg


def test_reweight_keys_are_jax_order():
    assert REWEIGHT_LOSS_KEYS == JAX_KEYS


# ---- uncertainty -------------------------------------------------------------

def test_mtl_sigma_takes_the_shared_label_and_decay_as_jax():
    """``mtl_sigma`` is labelled ``_shared_`` by DLA and decayed by AdamW
    in both packages: three updates with DLA on from step 2, from the same
    gradients and losses, give the same sigmas (within 1e-6 of their
    scale; the decay's share of the change is ~1e-3, the multiplier's
    several times that)."""
    import optax
    from sm3det_tpu.train.dla import label_params as jax_label_params
    from sm3det_tpu.train.dla import make_dla_config as jax_dla_config
    from sm3det_tpu_torch.train.dla import label_params, make_dla_config
    rng = np.random.RandomState(4)
    tree = {"mtl_sigma": rng.uniform(0.6, 1.4, 11).astype(np.float32)}
    for sub in ("backbone", "sar_bbox_head", "rgb_rpn_head", "rgb_roi_head",
                "ifr_rpn_head", "ifr_roi_head"):
        tree[sub] = {"w": rng.randn(3).astype(np.float32)}
    names = ["mtl_sigma"] + [f"{k}.w" for k in tree if k != "mtl_sigma"]
    subnets = make_dla_config().subnets
    assert jax_label_params(tree, jax_dla_config().subnets)["mtl_sigma"] \
        == label_params(names, subnets)[0] == "_shared_"
    losses = [{k: float(v) for k, v in zip(
        REWEIGHT_LOSS_KEYS, rng.uniform(0.2, 2.0, 11))} for _ in range(3)]
    grads = [{k: rng.randn(*np.shape(tree[k] if k == "mtl_sigma"
                                     else tree[k]["w"])).astype(np.float32)
              for k in tree} for _ in range(3)]
    kw = dict(base_lr=1e-2, weight_decay=0.05, step_iters=(99,),
              warmup_iters=1)
    j_init, j_update, _ = jax_make_optimizer(
        dla_cfg=jax_dla_config(warmup_iters=1), **kw)

    def nest(flat):
        return {k: v if k == "mtl_sigma" else {"w": v}
                for k, v in flat.items()}

    jp = {k: jnp.asarray(v) if k == "mtl_sigma" else
          {"w": jnp.asarray(v["w"])} for k, v in tree.items()}
    st = j_init(jp)
    for g, ls in zip(grads, losses):
        upd, st = j_update(jax.tree.map(jnp.asarray, nest(g)), st, jp,
                           {k: jnp.asarray(v) for k, v in ls.items()})
        jp = optax.apply_updates(jp, upd)

    ps = [torch.tensor(tree["mtl_sigma"])] + [
        torch.tensor(tree[n.split(".")[0]]["w"]) for n in names[1:]]
    init_fn, update_fn, _ = make_optimizer(
        names, dla_cfg=make_dla_config(warmup_iters=1), **kw)
    pst = init_fn(ps)
    for g, ls in zip(grads, losses):
        pst = update_fn([torch.tensor(g[n.split(".")[0]]) for n in names],
                        pst, ps, {k: torch.tensor(v) for k, v in ls.items()})
    assert pst.mults["_shared_"] != 1.0          # DLA is on at the end
    ref = np.asarray(jp["mtl_sigma"])
    np.testing.assert_allclose(ps[0].numpy(), ref,
                               atol=1e-6 * np.abs(ref).max())


# ---- DWA -----------------------------------------------------------------------

def test_dwa_three_steps_match_jax():
    batches = [make_batch(seed=s) for s in range(3)]
    port = TriSourceDetector(DWA_CFG, device="cpu", trainable=True)
    jmodel = JaxDetector(DWA_CFG)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    params = flax_params_of(port, lambda b: jmodel.init(
        {"params": keys[0], "dropout": keys[1], "moe_noise": keys[2],
         "sampling": keys[3]}, b, source_ratio=(2, 1, 1), train=True),
        batches[0])
    j_init, j_update, _ = jax_make_optimizer(**OPT)
    j_state = JaxTrainState(params=params, opt=j_init(params),
                            rng=jax.random.PRNGKey(3),
                            prev_losses=jnp.zeros(len(JAX_KEYS)))
    j_step = jax.jit(jax_build_step(jmodel, j_init, j_update,
                                    multi_tasks_reweight="dwa"))

    names = list(trainable_params(port))
    init_fn, update_fn, _ = make_optimizer(names, **OPT)
    state = init_train_state(port, init_fn, dwa=True)
    step = build_train_step(port, update_fn, multi_tasks_reweight="dwa")
    assert torch.equal(state.prev_losses, torch.zeros(11))

    weights = []
    for b in batches:
        j_state, j_m = j_step(j_state, b)
        prev = state.prev_losses
        state, m = step(state, batch_to(b, "cpu"))
        cur = torch.stack([m[k] for k in REWEIGHT_LOSS_KEYS])
        weights.append(dwa_weights(cur, prev))
        np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(state.prev_losses.numpy(),
                                   np.asarray(j_state.prev_losses),
                                   rtol=1e-4, atol=1e-7)
    assert torch.equal(weights[0], torch.ones(11))
    for w in weights[1:]:
        assert not torch.allclose(w, torch.ones(11))
        np.testing.assert_allclose(float(w.sum()), 11.0, rtol=1e-5)


def test_dwa_weights_formula():
    cur = torch.tensor([1.0, 2.0, 0.5])
    assert torch.equal(dwa_weights(cur, torch.zeros(3)), torch.ones(3))
    prev = torch.tensor([2.0, 2.0, 0.0])
    ratio = cur / torch.clamp(prev, min=1e-12)
    want = 3 * torch.softmax(ratio / 2.0, dim=0)
    assert torch.allclose(dwa_weights(cur, prev), want)


# ---- checkpoints and resume ------------------------------------------------------

def _fresh(mode, seed):
    model = TriSourceDetector(_with(NOISY_CFG, mode), device="cpu",
                              seed=seed, trainable=True)
    init_fn, update_fn, _ = make_optimizer(
        list(trainable_params(model)), base_lr=1e-3, warmup_iters=1)
    state = init_train_state(model, init_fn, seed=seed + 1,
                             dwa=mode == "dwa")
    return state, build_train_step(model, update_fn,
                                   multi_tasks_reweight=mode)


def _assert_same(a, b):
    _assert_states_equal(a, b)
    assert (a.prev_losses is None) == (b.prev_losses is None)
    if a.prev_losses is not None:
        assert torch.equal(a.prev_losses, b.prev_losses)


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("mode", ["uncertainty", "dwa"])
def test_checkpoint_carries_and_resume_is_bit_equal(tmp_path, mode,
                                                    deterministic):
    batches = [_batch(s) for s in range(4)]
    straight, step = _fresh(mode, 0)
    for b in batches:
        straight, m = step(straight, b)
    assert np.isfinite(float(m["loss"]))

    first, step = _fresh(mode, 0)
    for b in batches[:2]:
        first, _ = step(first, b)
    path = ckpt.save_train_state(str(tmp_path), 2, first)
    saved = torch.load(path, weights_only=True)
    if mode == "dwa":
        assert torch.equal(saved["prev_losses"], first.prev_losses)
        assert bool((first.prev_losses > 0).any())
    else:
        assert saved["prev_losses"] is None
        sigma = saved["params"]["mtl_sigma"]
        assert sigma.shape == (11,) and not torch.equal(sigma,
                                                        torch.ones(11))
    resumed, step = _fresh(mode, 3)
    resumed = ckpt.load_train_state(path, resumed)
    _assert_same(resumed, first)
    for b in batches[2:]:
        resumed, m2 = step(resumed, b)
    assert float(m2["loss"]) == float(m["loss"])
    _assert_same(resumed, straight)

    # a plain state does not take a DWA file, nor the other way round
    other = "uncertainty" if mode == "dwa" else "dwa"
    with pytest.raises(ValueError):
        ckpt.load_train_state(path, _fresh(other, 0)[0])


# ---- the train tool --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["uncertainty", "dwa"])
def test_cli_trains_with_reweighting(tmp_path, mode):
    wd = tmp_path / "wd"
    out = train_cli.main([
        "configs/smoke_tiny.py", "--synthetic-data", "--max-iters", "2",
        "--device", "cpu", "--work-dir", str(wd), "--cfg-options",
        f"model.multi_tasks_reweight={mode}", "checkpoint_interval=2"])
    state = out["state"]
    line = json.loads((wd / "train_log.jsonl").read_text().splitlines()[0])
    assert np.isfinite(line["loss"])
    saved = torch.load(wd / "iter_2.pth", weights_only=True)
    if mode == "uncertainty":
        assert "reweighted_total_losses" in line
        assert not torch.equal(state.params["mtl_sigma"], torch.ones(11))
        assert state.prev_losses is None
    else:
        assert "reweighted_total_losses" not in line
        assert "mtl_sigma" not in state.params
        assert torch.equal(saved["prev_losses"], state.prev_losses)
        assert bool((state.prev_losses > 0).any())


def test_cli_refuses_an_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match="multi_tasks_reweight"):
        train_cli.main(["configs/smoke_tiny.py", "--synthetic-data",
                        "--device", "cpu", "--work-dir", str(tmp_path),
                        "--cfg-options", "model.multi_tasks_reweight=gradnorm"])
