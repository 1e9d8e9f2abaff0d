"""The port's train step with the LSKNet-MoE backbone and the uncertainty
reweighting against the JAX package, on the CPU, at fp32.

The detector of ``tests/test_torch_train_step.py`` (heads, samplers that
take every candidate, four gts an image, [2 SAR : 1 RGB : 1 infrared] at
64 px) with the tiny LSKNet-MoE backbone of ``tests/test_torch_lsknet.py``
and ``multi_tasks_reweight="uncertainty"`` (``mtl_sigma`` drawn from
U(0.6, 1.4)): linear-expert MoE fc1 / fc2 without gate noise, stochastic
depth 0, and a capacity factor of 2, at which no route can be dropped in
training (an expert takes each token at most once, and its bucket holds
N). So the draws cannot change the losses. Held, against
``jax.value_and_grad`` of the loss JAX's ``build_train_step`` optimises
under uncertainty (the non-task losses plus ``reweighted_total_losses``):
every loss within 1e-4 relative, the task losses reported detached, and
every gradient leaf (mapped back to its flax path by ``to_flax``), the
MoE's and ``mtl_sigma``'s among them, within 1e-3 of the leaf's norm.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.detectors.trisource import (
    REWEIGHT_LOSS_KEYS as JAX_KEYS, TriSourceDetector as JaxDetector)
from sm3det_tpu.train.train_state import init_trisource
from sm3det_tpu_torch.convert import from_flax, to_flax
from sm3det_tpu_torch.models.detectors.trisource import (REWEIGHT_LOSS_KEYS,
                                                         TriSourceDetector)
from sm3det_tpu_torch.train.train_state import (batch_to, build_train_step,
                                                trainable_params)

from test_torch_lsknet import DIMS
from test_torch_train_step import CFG, RPN_REG_GAIN, make_batch
from torch_jax_refs import jax_refs_at_lowest_level  # noqa: F401

LSK_CFG = copy.deepcopy(CFG)
LSK_CFG["backbone"] = dict(
    type="LSKNet_moe_MultiInput", embed_dims=DIMS, depths=(1, 1, 2, 1),
    moe_block_inds_fc1=((), (), (0,), (0,)),
    moe_block_inds_fc2=((), (), (1,), ()), num_experts=4, top_k=2,
    gate="cosine", noisy_gating=False, capacity_factor=2.0,
    drop_path_rate=0.0)
LSK_CFG["neck"]["in_channels"] = DIMS
LSK_CFG["multi_tasks_reweight"] = "uncertainty"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


@pytest.fixture(scope="module")
def first_step():
    batch = make_batch()
    rng = np.random.RandomState(1)
    jmodel = JaxDetector(LSK_CFG)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    rngs = {"dropout": keys[0], "moe_noise": keys[1], "sampling": keys[2]}
    params = jax.tree.map(np.asarray, init_trisource(
        jax.random.PRNGKey(0), jmodel, batch))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key.startswith("layer_scale") else v, params)
    for head in ("rgb_rpn_head", "ifr_rpn_head"):
        params[head]["rpn_reg"]["kernel"] = \
            params[head]["rpn_reg"]["kernel"] * RPN_REG_GAIN
    params["mtl_sigma"] = rng.uniform(0.6, 1.4, 11).astype(np.float32)

    def loss_fn(p, b):
        losses = jmodel.apply({"params": p}, b, source_ratio=(2, 1, 1),
                              train=True, rngs=rngs)
        total = jnp.zeros(())
        for k, v in losses.items():     # JAX's build_train_step, uncertainty
            if k not in JAX_KEYS:
                total = total + v
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, batch)

    port = TriSourceDetector(LSK_CFG, device="cpu", trainable=True)
    port.load_state_dict(from_flax(params), strict=True)
    p = trainable_params(port)
    step = build_train_step(port, lambda *a: None)
    p_total, p_losses = step.loss_fn(p, batch_to(batch, "cpu"),
                                     torch.Generator().manual_seed(0))
    p_grads = torch.autograd.grad(p_total, list(p.values()))
    return dict(losses={k: float(v) for k, v in losses.items()},
                total=float(total), params=params,
                grads=dict(_flat(jax.tree.map(np.asarray, grads))),
                p_losses=p_losses, p_total=float(p_total.detach()),
                p_grads=dict(_flat(to_flax(dict(zip(p, p_grads)), params))))


def test_losses_match_jax(first_step):
    got, ref = first_step["p_losses"], first_step["losses"]
    assert set(got) == set(ref)
    assert list(got)[-1] == "reweighted_total_losses"
    assert ref["gate_loss"] > 0                  # the MoE layers' balance
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k].detach()), v, rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    # the task losses are reported detached: only the reweighted sum trains
    assert not any(got[k].requires_grad for k in REWEIGHT_LOSS_KEYS)
    np.testing.assert_allclose(first_step["p_total"], first_step["total"],
                               rtol=1e-4)


@pytest.mark.parametrize("subtree", ["backbone", "neck", "sar_bbox_head",
                                     "rgb_rpn_head", "ifr_rpn_head",
                                     "rgb_roi_head", "ifr_roi_head",
                                     "mtl_sigma"])
def test_gradients_match_jax(first_step, subtree):
    got, ref = first_step["p_grads"], first_step["grads"]
    keys = [k for k in ref if k.split("/")[0] == subtree]
    assert keys and set(keys) <= set(got)
    for k in keys:
        r = ref[k]
        scale = max(float(np.linalg.norm(r)), 1e-6)
        err = float(np.abs(got[k] - r).max())
        assert err <= 1e-3 * scale, (k, err, scale)
    if subtree == "backbone":
        # the linear experts and their gate receive gradients
        assert np.abs(ref["backbone/stage2_block0/mlp/fc1/experts/w"]
                      ).max() > 0
        assert np.abs(ref["backbone/stage2_block1/mlp/fc2/w_gate/"
                          "sim_matrix"]).max() > 0
    if subtree == "mtl_sigma":
        assert np.abs(ref["mtl_sigma"]).max() > 1e-3    # sigma is trained
