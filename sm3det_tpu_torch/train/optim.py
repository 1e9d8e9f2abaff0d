"""AdamW with the step LR schedule, linear warmup and DLA multipliers.

Port of the flagship settings of ``sm3det_tpu/train/optim.py::
make_optimizer``: an optional global-norm gradient clip (``g * min(1,
clip / max(|g|, 1e-6))`` over all gradients together), then
``optax.scale_by_adam(b1, b2, eps)`` and
``add_decayed_weights(weight_decay)`` on every parameter, the result scaled
by ``-lr`` times the parameter's DLA multiplier (1 during warmup). The
update is written out in optax's order of operations:

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t = t + 1
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
    p = p - lr * mult * u

(eps outside the square root; the decay added to the Adam direction). The
moments are fp32 tensors beside the fp32 master parameters, updated with
PyTorch's multi-tensor ``_foreach`` operations; the parameters are updated
in place. The clip stays on the device (no host synchronisation). The LR
policies are ``"step"`` and ``"dynamic"`` (step with DLA); the other
policies, momentum schedules, accumulation and layer decay are not ported.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from .dla import (DLAConfig, DLAState, dla_multipliers, init_dla_state,
                  label_params)

POLICIES = ("step", "dynamic")
NOT_PORTED = "ROADMAP queue 1 item 3 (the rest of the train runtime)"


def make_lr_schedule(base_lr: float = 1e-4, step_iters: Sequence[int] = (),
                     gamma: float = 0.1, warmup_iters: int = 500,
                     warmup_ratio: float = 1.0 / 3.0):
    """mmcv's step policy with linear warmup: ``lr(it)``."""
    step_iters = tuple(step_iters)

    def schedule(it: int) -> float:
        lr = base_lr * gamma ** sum(it >= s for s in step_iters)
        if warmup_iters and it < warmup_iters:
            k = (1.0 - it / warmup_iters) * (1.0 - warmup_ratio)
            lr = lr * (1.0 - k)
        return lr

    return schedule


class TrainOptState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int
    dla: DLAState
    step: int
    mults: Dict[str, float]     # the DLA multipliers the last update applied


def make_optimizer(names: Sequence[str], base_lr: float = 1e-4,
                   weight_decay: float = 0.05, betas=(0.9, 0.999),
                   eps: float = 1e-8, step_iters: Sequence[int] = (),
                   gamma: float = 0.1, warmup_iters: int = 500,
                   warmup_ratio: float = 1.0 / 3.0,
                   dla_cfg: Optional[DLAConfig] = None,
                   grad_clip: Optional[float] = None,
                   lr_policy: str = "step", warmup: Optional[str] = "linear"):
    """``names``: the parameters' dotted names, in the order of the lists
    the functions take. ``grad_clip``: the global gradient norm's limit
    (None or 0: no clip). ``lr_policy`` ``"step"`` or ``"dynamic"`` (the
    caller passes ``dla_cfg``), ``warmup`` ``"linear"`` or None; others
    raise ``NotImplementedError``. Returns ``(init_fn(params) -> TrainOptState,
    update_fn(grads, state, params, losses) -> state, schedule)``;
    ``update_fn`` updates ``params`` in place and records in the state's
    ``mults`` the multiplier it applied to each parameter group (1 during
    warmup; empty without DLA)."""
    if lr_policy not in POLICIES:
        raise NotImplementedError(
            f"lr_config.policy {lr_policy!r} is not ported to "
            f"sm3det_tpu_torch (it has {POLICIES}): {NOT_PORTED}")
    if warmup not in ("linear", None):
        raise NotImplementedError(
            f"lr_config.warmup {warmup!r} is not ported: {NOT_PORTED}")
    schedule = make_lr_schedule(base_lr, step_iters, gamma,
                                warmup_iters if warmup else 0, warmup_ratio)
    b1, b2 = betas
    groups: Dict[str, List[int]] = {}
    if dla_cfg is not None:
        for i, lab in enumerate(label_params(names, dla_cfg.subnets)):
            groups.setdefault(lab, []).append(i)

    def init_fn(params):
        dla = init_dla_state(dla_cfg if dla_cfg is not None
                             else DLAConfig((), (), ()))
        return TrainOptState(
            mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
            nu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
            count=0, dla=dla, step=0, mults={})

    @torch.no_grad()
    def update_fn(grads, state: TrainOptState, params,
                  losses: Optional[Dict[str, torch.Tensor]] = None):
        grads = [g.float() for g in grads]
        if grad_clip:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.clamp(grad_clip / torch.clamp(norm, min=1e-6),
                                max=1.0)
            grads = torch._foreach_mul(grads, scale)
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        count = state.count + 1
        denom = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mu, 1.0 - b1 ** count)
        torch._foreach_div_(upd, denom)
        if weight_decay:
            torch._foreach_add_(upd, list(params), alpha=weight_decay)
        lr = schedule(state.step)
        dla_state, applied = state.dla, {}
        if dla_cfg is not None and losses is not None:
            mults, dla_state = dla_multipliers(state.dla, losses, dla_cfg)
            in_warmup = state.step < dla_cfg.warmup_iters
            for lab, idx in groups.items():
                applied[lab] = 1.0 if in_warmup else mults[lab]
                torch._foreach_mul_([upd[i] for i in idx],
                                    -lr * applied[lab])
        else:
            torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(list(params), upd)
        return TrainOptState(mu=mu, nu=nu, count=count, dla=dla_state,
                             step=state.step + 1, mults=applied)

    return init_fn, update_fn, schedule
