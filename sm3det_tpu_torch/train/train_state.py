"""The train step: forward, losses, backward, DLA and the AdamW update.

Port of ``sm3det_tpu/train/train_state.py::build_train_step`` and of the
bf16 policy (``train/extras.py::bf16_policy``): the fp32 master parameters
stay with the optimizer, the forward sees a copy cast to the compute dtype
through ``torch.func.functional_call``, so the gradients land on the fp32
masters, and the loss math is fp32 from the head outputs on. The random
draws (stochastic depth, MoE gate noise, the RPN and RoI samplers) come
from the state's ``torch.Generator``, which the step advances.

The loss is the plain sum of the loss dict, except under the two
``multi_tasks_reweight`` modes:

- ``"uncertainty"``: the model returns ``reweighted_total_losses``, which
  replaces the individual ``REWEIGHT_LOSS_KEYS`` losses in the sum;
- ``"dwa"`` (Dynamic Weight Averaging): those losses are weighted by
  ``n softmax((L_t / max(L_{t-1}, 1e-12)) / T)``, T = 2, all ones while
  the carried losses are all zero. The carry (``TrainState.prev_losses``)
  holds the detached losses of the step, 0 for an absent key, on the
  model's device: the step makes no host synchronisation for it.

With ``ema_decay`` the state carries an EMA of the parameters (mmcv's
``EMAHook``), updated after every step from the new parameters, as JAX's
``build_train_step(ema_decay=...)`` does (accumulation's skip steps
included); gradient accumulation lives in the optimizer
(``train/optim.py``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..models.detectors.trisource import REWEIGHT_LOSS_KEYS
from .extras import ema_update
from .optim import TrainOptState

DWA_T = 2.0


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]     # fp32 masters, the model's own
    opt: TrainOptState
    gen: torch.Generator
    # DWA: the last step's REWEIGHT_LOSS_KEYS losses (zeros: none yet)
    prev_losses: Optional[torch.Tensor] = None
    # the parameters' EMA, one fp32 tensor a parameter (None: no EMA)
    ema: Optional[List[torch.Tensor]] = None


def batch_to(batch, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """A batch of numpy arrays or tensors as tensors on ``device``. A
    pinned host tensor is copied with ``non_blocking=True``, so the copy
    does not hold the host; one from pageable memory waits for it."""
    def conv(v):
        t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        return t.to(device, non_blocking=t.is_pinned())
    return {k: {n: conv(v) for n, v in d.items()} for k, d in batch.items()}


def trainable_params(model) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def dwa_weights(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """DWA's loss weights from this step's losses ``cur`` (detached) and
    the carried ``prev``: ``n softmax((cur / max(prev, 1e-12)) / T)``, all
    ones while ``prev`` is all zero."""
    n = cur.shape[0]
    w = n * torch.softmax(cur / torch.clamp(prev, min=1e-12) / DWA_T, dim=0)
    return torch.where((prev > 0).any(), w, torch.ones_like(w))


def build_train_step(model, update_fn, multi_tasks_reweight=None,
                     ema_decay: float = 0.0):
    """Returns ``train_step(state, batch) -> (state, metrics)``: metrics
    hold every loss of the dict (detached) and the total ``loss``.
    ``multi_tasks_reweight``: None, ``"uncertainty"`` (in the model) or
    ``"dwa"`` (the state needs ``prev_losses``: ``init_train_state(...,
    dwa=True)``). ``ema_decay`` > 0 updates the state's ``ema``
    (``init_train_state(..., ema=True)``) after each step."""
    compute_dtype = model.compute_dtype
    dwa = multi_tasks_reweight == "dwa"

    def loss_fn(params, batch, gen, prev_losses=None):
        p = params if compute_dtype == torch.float32 else {
            k: v.to(compute_dtype) if v.dtype == torch.float32 else v
            for k, v in params.items()}
        losses = functional_call(model, p, (batch,), {"gen": gen})
        if "reweighted_total_losses" in losses:
            # the reweighted sum replaces the task losses (kept as metrics)
            total = sum(v for k, v in losses.items()
                        if k not in REWEIGHT_LOSS_KEYS)
        elif dwa:
            cur = torch.stack([losses[k] for k in REWEIGHT_LOSS_KEYS
                               if k in losses])
            bw = dwa_weights(cur.detach(), prev_losses)
            total = (cur * bw).sum() + sum(
                v for k, v in losses.items() if k not in REWEIGHT_LOSS_KEYS)
        else:
            total = sum(losses.values())
        return total, losses

    def train_step(state: TrainState, batch):
        names = list(state.params)
        masters = [state.params[k] for k in names]
        total, losses = loss_fn(state.params, batch, state.gen,
                                state.prev_losses)
        grads = torch.autograd.grad(total, masters, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(masters, grads)]
        opt = update_fn(grads, state.opt, masters, losses)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        prev = state.prev_losses
        if dwa:
            zero = total.new_zeros(())
            prev = torch.stack([metrics[k].float() if k in metrics else zero
                                for k in REWEIGHT_LOSS_KEYS])
        if ema_decay and state.ema is not None:
            ema_update(state.ema, masters, ema_decay)
        return state._replace(opt=opt, prev_losses=prev), metrics

    train_step.loss_fn = loss_fn      # for tools that time the parts
    return train_step


def init_train_state(model, init_fn, seed: int = 1, dwa: bool = False,
                     ema: bool = False) -> TrainState:
    """The model's trainable parameters as the masters, the optimizer
    state, and a host ``torch.Generator`` seeded with ``seed`` for the
    draws (host draws are the same whatever the model's device); with
    ``dwa`` the zero carry of DWA on the model's device; with ``ema`` the
    EMA, a copy of the parameters as they are now."""
    params = trainable_params(model)
    prev = torch.zeros(len(REWEIGHT_LOSS_KEYS), device=model.device) \
        if dwa else None
    return TrainState(params=params, opt=init_fn(list(params.values())),
                      gen=torch.Generator().manual_seed(seed),
                      prev_losses=prev,
                      ema=[p.detach().float().clone()
                           for p in params.values()] if ema else None)

