"""The train step: forward, losses, backward, DLA and the AdamW update.

Port of ``sm3det_tpu/train/train_state.py::build_train_step`` (flagship
path: the loss is the plain sum of the loss dict) and of the bf16 policy
(``train/extras.py::bf16_policy``): the fp32 master parameters stay with
the optimizer, the forward sees a copy cast to the compute dtype through
``torch.func.functional_call``, so the gradients land on the fp32 masters,
and the loss math is fp32 from the head outputs on. The random draws
(stochastic depth, MoE gate noise, the RPN and RoI samplers) come from the
state's ``torch.Generator``, which the step advances. The uncertainty and
DWA reweighting, EMA and accumulation are not ported.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from .optim import TrainOptState


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]     # fp32 masters, the model's own
    opt: TrainOptState
    gen: torch.Generator


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


def build_train_step(model, update_fn):
    """Returns ``train_step(state, batch) -> (state, metrics)``: metrics
    hold every loss of the dict (detached) and their sum ``loss``."""
    compute_dtype = model.compute_dtype

    def loss_fn(params, batch, gen):
        p = params if compute_dtype == torch.float32 else {
            k: v.to(compute_dtype) if v.dtype == torch.float32 else v
            for k, v in params.items()}
        losses = functional_call(model, p, (batch,), {"gen": gen})
        total = sum(losses.values())
        return total, losses

    def train_step(state: TrainState, batch):
        names = list(state.params)
        masters = [state.params[k] for k in names]
        total, losses = loss_fn(state.params, batch, state.gen)
        grads = torch.autograd.grad(total, masters, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(masters, grads)]
        opt = update_fn(grads, state.opt, masters, losses)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        return TrainState(params=state.params, opt=opt, gen=state.gen), \
            metrics

    train_step.loss_fn = loss_fn      # for tools that time the parts
    return train_step


def init_train_state(model, init_fn, seed: int = 1) -> TrainState:
    """The model's trainable parameters as the masters, the optimizer
    state, and a host ``torch.Generator`` seeded with ``seed`` for the
    draws (host draws are the same whatever the model's device)."""
    params = trainable_params(model)
    return TrainState(params=params, opt=init_fn(list(params.values())),
                      gen=torch.Generator().manual_seed(seed))

