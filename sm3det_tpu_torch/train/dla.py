"""Dynamic Learning-rate Adjustment (DLA).

Port of ``sm3det_tpu/train/dla.py`` (the reference's
``mmrotate/core/hook/dynamic_lr.py``): per-head multipliers
``N * softmax((ema_i / loss_i) / T)`` averaged per subnet, a shared
(backbone and neck) multiplier from the ``sigmoid_kl`` policy (or ``min``,
``avg``, ``max``, ``kl``) over the softmaxed loss distributions, and an EMA
of every loss that updates each step; the multipliers switch on once
``steps >= warmup_iters``. ``reweight_for_variant`` gives the
``TriSourceVariant`` heads' (loss, subnet) pairs. The losses keep the ``{sar,rgb,ifr}_loss_*``
names. The state is a few fp32 numbers on the host: the train step reads
the losses there once a step.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, NamedTuple, Sequence, Tuple

import torch

DEFAULT_REWEIGHT_LOSSES: Tuple[Tuple[str, str], ...] = (
    ("sar_loss_cls", "sar_bbox_head"),
    ("sar_loss_bbox", "sar_bbox_head"),
    ("sar_loss_dfl", "sar_bbox_head"),
    ("rgb_loss_rpn_cls", "rgb_rpn_head"),
    ("rgb_loss_rpn_bbox", "rgb_rpn_head"),
    ("rgb_loss_cls", "rgb_roi_head"),
    ("rgb_loss_bbox", "rgb_roi_head"),
    ("ifr_loss_rpn_cls", "ifr_rpn_head"),
    ("ifr_loss_rpn_bbox", "ifr_rpn_head"),
    ("ifr_loss_cls", "ifr_roi_head"),
    ("ifr_loss_bbox", "ifr_roi_head"),
)


def reweight_for_variant(sar_stages: int, rot_stages: int
                         ) -> Tuple[Tuple[str, str], ...]:
    """The (loss, subnet) pairs of a ``TriSourceVariant``: its loss names
    and the heads that make them (``reweight_for_variant`` of the JAX
    package; the caller passes both stage numbers)."""
    out = []
    if sar_stages == 1:
        out += [("sar_loss_cls", "sar_bbox_head"),
                ("sar_loss_bbox", "sar_bbox_head"),
                ("sar_loss_dfl", "sar_bbox_head")]
    else:
        out += [("sar_loss_rpn_cls", "sar_rpn_head"),
                ("sar_loss_rpn_bbox", "sar_rpn_head"),
                ("sar_loss_cls", "sar_roi_head"),
                ("sar_loss_bbox", "sar_roi_head")]
    for m in ("rgb", "ifr"):
        if rot_stages == 1:
            out += [(f"{m}_loss_cls", f"{m}_bbox_head"),
                    (f"{m}_loss_bbox", f"{m}_bbox_head")]
        else:
            out += [(f"{m}_loss_rpn_cls", f"{m}_rpn_head"),
                    (f"{m}_loss_rpn_bbox", f"{m}_rpn_head"),
                    (f"{m}_loss_cls", f"{m}_roi_head"),
                    (f"{m}_loss_bbox", f"{m}_roi_head")]
    return tuple(out)


class DLAState(NamedTuple):
    ema: torch.Tensor          # (L,) per-loss EMA
    initialized: torch.Tensor  # (L,) bool: EMA seeded with a first value
    steps: int


class DLAConfig(NamedTuple):
    loss_names: Tuple[str, ...]
    subnet_of: Tuple[str, ...]          # subnet per loss, same order
    subnets: Tuple[str, ...]            # unique subnet names
    T: float = 3.0
    b: float = 0.4
    ema_beta: float = 0.001
    backbone_policy: str = "sigmoid_kl"
    head_policy: str = "normal"
    warmup_iters: int = 500


def make_dla_config(reweight=DEFAULT_REWEIGHT_LOSSES, T=3.0, b=0.4,
                    ema_beta=0.001, backbone_policy="sigmoid_kl",
                    head_policy="normal", warmup_iters=500) -> DLAConfig:
    names = tuple(k for k, _ in reweight)
    subnet_of = tuple(v for _, v in reweight)
    subnets = tuple(dict.fromkeys(subnet_of))
    return DLAConfig(names, subnet_of, subnets, T, b, ema_beta,
                     backbone_policy, head_policy, warmup_iters)


def init_dla_state(cfg: DLAConfig) -> DLAState:
    n = max(len(cfg.loss_names), 1)
    return DLAState(ema=torch.full((n,), 1e-3),
                    initialized=torch.zeros((n,), dtype=torch.bool),
                    steps=0)


def _kl(p, q):
    """KL(p || q) / len, torch ``F.kl_div(q.log(), p, 'batchmean')``."""
    return (p * (torch.log(torch.clamp(p, min=1e-12))
                 - torch.log(torch.clamp(q, min=1e-12)))).sum() / p.shape[0]


def dla_multipliers(state: DLAState, losses: Dict[str, torch.Tensor],
                    cfg: DLAConfig):
    """One DLA step: (multiplier per subnet and ``"_shared_"``, as Python
    floats; the new state). The multipliers are 1 while the EMA primes."""
    cur = torch.stack([torch.as_tensor(losses[k]).detach().float()
                       for k in cfg.loss_names]).cpu()
    n = cur.shape[0]
    ema = state.ema
    primed = state.steps >= cfg.warmup_iters
    if cfg.head_policy == "reverse":
        w = cur / torch.clamp(ema, min=1e-12)
    else:
        w = ema / torch.clamp(cur, min=1e-12)
    batch_weight = n * torch.softmax(w / cfg.T, dim=0)
    if not (primed and cfg.head_policy != "None"):
        batch_weight = torch.ones_like(batch_weight)
    mults = {}
    for s in cfg.subnets:
        mask = torch.tensor([1.0 if sn == s else 0.0 for sn in cfg.subnet_of])
        mults[s] = (batch_weight * mask).sum() / mask.sum()
    vals = torch.stack(list(mults.values()))
    if cfg.backbone_policy == "min":
        shared = vals.min()
    elif cfg.backbone_policy == "avg":
        shared = vals.mean()
    elif cfg.backbone_policy == "max":
        shared = vals.max()
    elif cfg.backbone_policy in ("kl", "sigmoid_kl"):
        kl = _kl(torch.softmax(ema, dim=0), torch.softmax(cur, dim=0))
        if cfg.backbone_policy == "kl":
            shared = 1.0 + (1.0 - kl) / math.sqrt(cfg.T)
        else:
            shared = torch.sigmoid((1.0 - kl - cfg.b) * cfg.T) * 2.0
    else:
        shared = torch.ones(())
    mults["_shared_"] = shared if primed else torch.ones(())
    beta = cfg.ema_beta
    new_ema = torch.where(state.initialized, (1 - beta) * ema + beta * cur,
                          cur)
    new_state = DLAState(ema=new_ema,
                         initialized=torch.ones_like(state.initialized),
                         steps=state.steps + 1)
    return {k: float(v) for k, v in mults.items()}, new_state


def label_params(names: Iterable[str], subnets: Sequence[str]):
    """Subnet label (or ``"_shared_"``) of each dotted parameter name: the
    first subnet that is a substring of one of the name's components. Raises
    if a subnet labels no parameter."""
    labels = []
    for name in names:
        comps = name.split(".")
        labels.append(next((s for s in subnets
                            if any(s in comp for comp in comps)),
                           "_shared_"))
    missing = [s for s in subnets if s not in labels]
    if missing:
        raise ValueError(f"DLA subnets {missing} matched no parameter; "
                         f"labels seen: {sorted(set(labels))}")
    return labels
