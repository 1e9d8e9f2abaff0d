"""AdamW with the LR-updater zoo, DLA multipliers, layer decay, momentum
schedules and gradient accumulation.

Port of ``sm3det_tpu/train/optim.py``: an optional global-norm gradient
clip (``g * min(1, clip / max(|g|, 1e-6))`` over all gradients together),
then ``optax.scale_by_adam(b1, b2, eps)`` (or, with ``momentum_policy``,
Adam whose b1 follows a momentum schedule, ``scale_by_adam_dynamic_b1``)
and ``add_decayed_weights(weight_decay)`` on every parameter, the result
scaled by ``-lr``, by the parameter's DLA multiplier (1 during warmup) and
by its layer-decay scale (``train/extras.py``). The update is written out
in optax's order of operations:

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t = t + 1
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
    p = p - lr * mult * scale * u

(eps outside the square root; the decay added to the Adam direction). The
moments are fp32 tensors beside the fp32 master parameters, updated with
PyTorch's multi-tensor ``_foreach`` operations; the parameters are updated
in place. The clip stays on the device (no host synchronisation).

The schedules are evaluated on the host in fp32, as JAX evaluates its jnp
schedules (0-d float32 tensors, not Python doubles): the 11 LR policies of
``make_lr_schedule`` ("dynamic" is "step" with DLA) under the constant,
linear or exp warmup, and the 4 momentum policies of
``make_momentum_schedule``. An unknown name raises ``ValueError``.

``accumulate=N`` (mmcv's ``GradientCumulativeOptimizerHook``): every step
adds its gradients to fp32 accumulators and advances the step counter, and
with it the LR schedule; the N-1 steps between applications leave the
parameters, the Adam state and the DLA state untouched; the N-th applies
the update of the mean gradient and zeroes the accumulators.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from .dla import (DLAConfig, DLAState, dla_multipliers, init_dla_state,
                  label_params)

POLICIES = ("step", "dynamic", "cosine", "flat_cosine", "cosine_restart",
            "cyclic", "one_cycle", "linear", "poly", "exp", "inv", "fixed")
WARMUPS = (None, "constant", "linear", "exp")
MOMENTUM_POLICIES = ("step", "cosine", "linear", "cyclic")


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _apply_warmup(lr, it, warmup, warmup_iters: int, warmup_ratio: float):
    """mmcv ``LrUpdaterHook.get_warmup_lr``: constant / linear / exp warmup
    of the regular lr, for ``it < warmup_iters``."""
    if not warmup_iters or warmup is None:
        return lr
    if warmup == "constant":
        warm = lr * warmup_ratio
    elif warmup == "linear":
        k = (1.0 - it / warmup_iters) * (1.0 - warmup_ratio)
        warm = lr * (1.0 - k)
    elif warmup == "exp":
        warm = lr * warmup_ratio ** (1.0 - it / warmup_iters)
    else:
        raise ValueError(f"unknown warmup {warmup!r}")
    return torch.where(it < warmup_iters, warm, lr)


def _annealing_cos(start, end, factor, weight=1.0):
    """mmcv ``annealing_cos``: cosine from ``weight * start + (1 - weight)
    * end`` to ``end``."""
    cos_out = torch.cos(math.pi * _f32(factor)) + 1.0
    return end + 0.5 * weight * (start - end) * cos_out


def _annealing_linear(start, end, factor):
    """mmcv ``annealing_linear``."""
    return start + (end - start) * factor


def _cyclic_value(it, base, target_ratio, cyclic_times, step_ratio_up,
                  anneal, gamma, max_iters):
    """mmcv's cyclic LR / momentum: per cycle an up phase to ``base *
    target_ratio[0]`` then down to ``base * target_ratio[1]``, cosine or
    linear within each phase, the max-base gap shrunk by ``gamma`` a
    cycle."""
    max_iter_per_phase = max_iters // cyclic_times
    iter_up = int(step_ratio_up * max_iter_per_phase)
    curr_iter = torch.remainder(it, max_iter_per_phase)
    curr_cycle = torch.floor_divide(it, max_iter_per_phase)
    scale = gamma ** curr_cycle
    fn = _annealing_cos if anneal == "cos" else _annealing_linear
    end_up = 1.0 - scale + target_ratio[0] * scale
    v_up = fn(base * 1.0, base * end_up,
              curr_iter / max(iter_up, 1) if iter_up > 0
              else torch.zeros_like(curr_iter))
    start_dn = 1.0 - scale + target_ratio[0] * scale
    v_dn = fn(base * start_dn, base * target_ratio[1],
              (curr_iter - iter_up) / max(max_iter_per_phase - iter_up, 1))
    return torch.where(curr_iter < iter_up, v_up, v_dn)


def _cosine_restart_value(it, base, target, periods, restart_weights):
    """mmcv ``CosineRestartLrUpdaterHook``: cosine within each period, each
    restart scaled by its weight; past the last period the final value."""
    cum, total = [], 0
    for p in periods:
        total += p
        cum.append(total)
    lr = _f32(base)
    for i, (p, w) in enumerate(zip(periods, restart_weights)):
        nearest = 0 if i == 0 else cum[i - 1]
        alpha = torch.clamp((it - nearest) / p, max=1.0)
        v = _annealing_cos(base, target, alpha, w)
        in_period = (it >= nearest) & (it < cum[i])
        lr = torch.where(in_period, v, lr)
    last = _annealing_cos(base, target, 1.0, restart_weights[-1])
    return torch.where(it >= cum[-1], last, lr)


def make_lr_schedule(policy: str = "step", base_lr: float = 1e-4,
                     step_iters: Sequence[int] = (), gamma: float = 0.1,
                     min_lr: Optional[float] = None,
                     min_lr_ratio: Optional[float] = None,
                     power: float = 1.0, max_iters: int = 1,
                     warmup: Optional[str] = "linear",
                     warmup_iters: int = 500,
                     warmup_ratio: float = 1.0 / 3.0,
                     periods: Sequence[int] = (),
                     restart_weights: Sequence[float] = (1.0,),
                     target_ratio=(10.0, 1e-4), cyclic_times: int = 1,
                     step_ratio_up: float = 0.4,
                     anneal_strategy: str = "cos",
                     cyclic_gamma: float = 1.0,
                     start_percent: float = 0.75,
                     div_factor: float = 25.0,
                     final_div_factor: float = 1e4):
    """The by-iteration LR policies of mmcv's ``lr_updater.py`` as
    ``schedule(it) -> float``, evaluated in fp32: ``step`` (x gamma at
    each of ``step_iters``, clipped below at ``min_lr``), ``cosine``,
    ``flat_cosine`` (flat until ``start_percent * max_iters``),
    ``cosine_restart``, ``cyclic`` (``cyclic_gamma`` the cycle decay),
    ``one_cycle`` (``base_lr`` the max lr), ``linear``, ``poly``, ``exp``,
    ``inv``, ``fixed``; ``dynamic`` is ``step`` (DLA scales it). The
    targets are ``base_lr * min_lr_ratio`` or ``min_lr`` (0 without
    either). Raises ``ValueError`` for an unknown policy or warmup."""
    if policy not in POLICIES:
        raise ValueError(f"unknown lr policy {policy!r} (one of "
                         f"{POLICIES})")
    if warmup not in WARMUPS:
        raise ValueError(f"unknown warmup {warmup!r} (one of {WARMUPS})")
    step_iters = tuple(step_iters)
    target = base_lr * min_lr_ratio if min_lr_ratio is not None \
        else (min_lr or 0.0)

    def regular(it):
        if policy in ("step", "dynamic"):
            exp = _f32(0.0)
            for s in step_iters:
                exp = exp + (it >= s).float()
            lr = base_lr * (gamma ** exp)
            return torch.clamp(lr, min=min_lr) if min_lr is not None else lr
        if policy == "cosine":
            frac = torch.clamp(it / max_iters, 0.0, 1.0)
            return target + 0.5 * (base_lr - target) * \
                (1.0 + torch.cos(math.pi * frac))
        if policy == "flat_cosine":
            start = round(max_iters * start_percent)
            frac = torch.clamp((it - start) / max(max_iters - start, 1),
                               0.0, 1.0)
            return torch.where(it < start, _f32(base_lr),
                               _annealing_cos(base_lr, target, frac))
        if policy == "cosine_restart":
            return _cosine_restart_value(it, base_lr, target, tuple(periods),
                                         tuple(restart_weights))
        if policy == "cyclic":
            return _cyclic_value(it, base_lr, tuple(target_ratio),
                                 cyclic_times, step_ratio_up,
                                 anneal_strategy, cyclic_gamma, max_iters)
        if policy == "one_cycle":
            fn = _annealing_cos if anneal_strategy == "cos" \
                else _annealing_linear
            base = base_lr / div_factor
            e1 = float(start_percent * max_iters) - 1
            e2 = max_iters - 1
            pct1 = torch.clamp(it / max(e1, 1e-9), 0.0, 1.0)
            pct2 = torch.clamp((it - e1) / max(e2 - e1, 1e-9), 0.0, 1.0)
            up = fn(base * 1.0, base * div_factor, pct1)
            down = fn(base * div_factor, base / final_div_factor, pct2)
            return torch.where(it <= e1, _f32(up), _f32(down))
        if policy == "linear":
            frac = torch.clamp(it / max_iters, 0.0, 1.0)
            return _annealing_linear(base_lr, target, frac)
        if policy == "poly":
            lo = min_lr or 0.0
            coeff = (1.0 - torch.clamp(it / max_iters, 0.0, 1.0)) ** power
            return (base_lr - lo) * coeff + lo
        if policy == "exp":
            return base_lr * gamma ** it
        if policy == "inv":
            return base_lr * (1.0 + gamma * it) ** (-power)
        return _f32(base_lr)                                  # fixed

    def schedule(it) -> float:
        it = _f32(it)
        return float(_apply_warmup(_f32(regular(it)), it, warmup,
                                   warmup_iters, warmup_ratio))

    return schedule


def make_momentum_schedule(policy: str = "cyclic",
                           base_momentum: float = 0.9,
                           step_iters: Sequence[int] = (),
                           gamma: float = 0.5,
                           min_momentum: Optional[float] = None,
                           min_momentum_ratio: Optional[float] = None,
                           max_iters: int = 1,
                           warmup: Optional[str] = None,
                           warmup_iters: int = 0,
                           warmup_ratio: float = 0.9,
                           target_ratio=(0.85 / 0.95, 1.0),
                           cyclic_times: int = 1,
                           step_ratio_up: float = 0.4,
                           anneal_strategy: str = "cos",
                           cyclic_gamma: float = 1.0):
    """mmcv's momentum updaters as ``schedule(it) -> float`` in fp32:
    ``step`` (x gamma at each of ``step_iters``, clipped below at
    ``min_momentum``), ``cosine`` / ``linear`` annealing to the target,
    ``cyclic``. The warmup divides the regular value (mmcv's
    ``get_warmup_momentum``), the inverse of the LR's."""
    if policy not in MOMENTUM_POLICIES:
        raise ValueError(f"unknown momentum policy {policy!r} (one of "
                         f"{MOMENTUM_POLICIES})")
    if warmup not in WARMUPS:
        raise ValueError(f"unknown warmup {warmup!r} (one of {WARMUPS})")
    step_iters = tuple(step_iters)

    def regular(it):
        if policy == "step":
            exp = _f32(0.0)
            for s in step_iters:
                exp = exp + (it >= s).float()
            m = base_momentum * (gamma ** exp)
            return torch.clamp(m, min=min_momentum) \
                if min_momentum is not None else m
        if policy in ("cosine", "linear"):
            target = base_momentum * min_momentum_ratio \
                if min_momentum_ratio is not None else min_momentum
            frac = torch.clamp(it / max_iters, 0.0, 1.0)
            fn = _annealing_cos if policy == "cosine" else _annealing_linear
            return fn(base_momentum, target, frac)
        return _cyclic_value(it, base_momentum, tuple(target_ratio),
                             cyclic_times, step_ratio_up, anneal_strategy,
                             cyclic_gamma, max_iters)

    def schedule(it) -> float:
        it = _f32(it)
        m = _f32(regular(it))
        if not warmup_iters or warmup is None:
            return float(m)
        if warmup == "constant":
            warm = m / warmup_ratio
        elif warmup == "linear":
            k = (1.0 - it / warmup_iters) * (1.0 - warmup_ratio)
            warm = m / (1.0 - k)
        else:
            warm = m / (warmup_ratio ** (1.0 - it / warmup_iters))
        return float(torch.where(it < warmup_iters, warm, m))

    return schedule


class TrainOptState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int                  # Adam's step count (applied updates)
    dla: DLAState
    step: int                   # every step, accumulation's skips included
    mults: Dict[str, float]     # the DLA multipliers the last update applied
    # accumulate > 1: the gradient sums since the last update and their
    # count (None and 0 otherwise)
    accum: Optional[List[torch.Tensor]] = None
    accum_count: int = 0


def make_optimizer(names: Sequence[str], base_lr: float = 1e-4,
                   weight_decay: float = 0.05, betas=(0.9, 0.999),
                   eps: float = 1e-8, step_iters: Sequence[int] = (),
                   gamma: float = 0.1, warmup_iters: int = 500,
                   warmup_ratio: float = 1.0 / 3.0,
                   dla_cfg: Optional[DLAConfig] = None,
                   grad_clip: Optional[float] = None,
                   lr_policy: str = "step", warmup: Optional[str] = "linear",
                   accumulate: int = 1, layer_decay: Optional[Dict] = None,
                   min_lr: Optional[float] = None,
                   min_lr_ratio: Optional[float] = None, power: float = 1.0,
                   max_iters: int = 1,
                   lr_schedule_kwargs: Optional[Dict] = None,
                   momentum_policy: Optional[str] = None,
                   momentum_kwargs: Optional[Dict] = None):
    """``names``: the parameters' dotted names, in the order of the lists
    the functions take. ``grad_clip``: the global gradient norm's limit
    (None or 0: no clip). ``lr_policy`` / ``warmup`` and the schedule's
    settings (``lr_schedule_kwargs`` for the policies' own) as in
    ``make_lr_schedule``; ``"dynamic"`` takes ``dla_cfg``.
    ``layer_decay=dict(rate, num_layers)`` scales each parameter's update
    by ``rate ** (num_layers - depth)`` (``extras.layer_decay_scales``).
    ``momentum_policy`` (with ``momentum_kwargs``) drives Adam's b1 from
    ``make_momentum_schedule`` (``base_momentum`` = ``betas[0]``),
    evaluated at Adam's count. Returns ``(init_fn(params) ->
    TrainOptState, update_fn(grads, state, params, losses) -> state,
    schedule)``; ``update_fn`` updates ``params`` in place and records in
    the state's ``mults`` the multiplier it applied to each parameter group
    (1 during warmup; empty without DLA); ``update_fn.lr_scales`` maps each
    name to its layer-decay scale."""
    schedule = make_lr_schedule(
        lr_policy, base_lr, step_iters, gamma, min_lr=min_lr,
        min_lr_ratio=min_lr_ratio, power=power, max_iters=max_iters,
        warmup=warmup, warmup_iters=warmup_iters, warmup_ratio=warmup_ratio,
        **(lr_schedule_kwargs or {}))
    m_sched = None
    if momentum_policy is not None:
        m_sched = make_momentum_schedule(
            momentum_policy, base_momentum=betas[0], max_iters=max_iters,
            **(momentum_kwargs or {}))
    b1, b2 = betas
    labels = label_params(names, dla_cfg.subnets) if dla_cfg is not None \
        else [None] * len(names)
    scales = [1.0] * len(names)
    if layer_decay is not None:
        from .extras import layer_decay_scales
        scales = layer_decay_scales(
            names, num_layers=int(layer_decay["num_layers"]),
            decay_rate=float(layer_decay["rate"]))
    # the parameters of one (DLA label, layer-decay scale), multiplied
    # together
    groups: Dict[tuple, List[int]] = {}
    for i, key in enumerate(zip(labels, scales)):
        groups.setdefault(key, []).append(i)

    def init_fn(params):
        dla = init_dla_state(dla_cfg if dla_cfg is not None
                             else DLAConfig((), (), ()))
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return TrainOptState(
            mu=zeros, nu=[torch.zeros_like(z) for z in zeros], count=0,
            dla=dla, step=0, mults={},
            accum=[torch.zeros_like(z) for z in zeros]
            if accumulate > 1 else None)

    def apply(grads, state: TrainOptState, params, losses):
        if grad_clip:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.clamp(grad_clip / torch.clamp(norm, min=1e-6),
                                max=1.0)
            grads = torch._foreach_mul(grads, scale)
        beta1 = b1 if m_sched is None else m_sched(state.count)
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, beta1)
        torch._foreach_add_(mu, grads, alpha=1.0 - beta1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        count = state.count + 1
        denom = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(mu, 1.0 - beta1 ** count)
        torch._foreach_div_(upd, denom)
        if weight_decay:
            torch._foreach_add_(upd, list(params), alpha=weight_decay)
        lr = schedule(state.step)
        dla_state, applied = state.dla, {}
        if dla_cfg is not None and losses is not None:
            mults, dla_state = dla_multipliers(state.dla, losses, dla_cfg)
            in_warmup = state.step < dla_cfg.warmup_iters
            applied = {lab: 1.0 if in_warmup else mults[lab]
                       for lab in set(labels)}
        for (lab, s), idx in groups.items():
            torch._foreach_mul_([upd[i] for i in idx],
                                -lr * applied.get(lab, 1.0) * s)
        torch._foreach_add_(list(params), upd)
        return state._replace(mu=mu, nu=nu, count=count, dla=dla_state,
                              step=state.step + 1, mults=applied)

    @torch.no_grad()
    def update_fn(grads, state: TrainOptState, params,
                  losses: Optional[Dict[str, torch.Tensor]] = None):
        grads = [g.float() for g in grads]
        if accumulate <= 1:
            return apply(grads, state, params, losses)
        torch._foreach_add_(state.accum, grads)
        n = state.accum_count + 1
        if n < accumulate:
            return state._replace(step=state.step + 1, accum_count=n)
        mean = torch._foreach_div(state.accum, float(accumulate))
        new = apply(mean, state, params, losses)
        for a in state.accum:
            a.zero_()
        return new._replace(accum_count=0)

    # each parameter's layer-decay scale, for tools that report it
    update_fn.lr_scales = dict(zip(names, scales))
    return init_fn, update_fn, schedule
