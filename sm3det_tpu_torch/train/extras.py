"""Training extras: the parameters' EMA and the layer-decay scales.

Port of ``sm3det_tpu/train/extras.py``:

- ``ema_update``: mmcv's ``EMAHook``, ``ema = decay * ema + (1 - decay) *
  params``, in place on the EMA's tensors; the train step applies it after
  the update, from the new parameters (``train/train_state.py``).
- ``layer_decay_scales``: the per-parameter LR multipliers of
  ``LayerDecayOptimizerConstructor``, ``rate ** (num_layers - depth)``,
  the depth picked from the parameter's flax path as JAX picks it
  (``convert.flax_modules`` gives the path a port name is converted from):
  ``stem`` anywhere in a key, ``patch_embed`` or ``pos_embed`` -> 0 (the
  adapter's SPM ``stem1`` / ``stem2`` convs too); ``stage{i}_block{j}``
  -> 3i + j + 1; ``block{i}`` -> i + 1; anything else -> ``num_layers``
  (scale 1). The bf16 policy lives in the train step.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..convert import flax_modules


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float = 0.9998):
    """``ema = decay * ema + (1 - decay) * params``, in place (the two
    products rounded, then added, as JAX computes it)."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(
        [p.float() for p in params], 1.0 - decay))


def layer_depth(keys: Sequence[str], num_layers: int) -> int:
    """JAX's default depth of a flax path (``layer_decay_scales``)."""
    for s in keys:
        if "stem" in s or "patch_embed" in s or s == "pos_embed":
            return 0
        if s.startswith("stage"):
            try:
                stage = int(s[5])
                block = int(s.split("block")[1].split("_")[0])
            except (ValueError, IndexError):
                return num_layers
            return stage * 3 + block + 1
        if s.startswith("block") and s[5:].isdigit():
            return int(s[5:]) + 1
    return num_layers


def layer_decay_scales(names: Sequence[str], num_layers: int,
                       decay_rate: float) -> List[float]:
    """One LR multiplier a parameter (port names, as ``state_dict`` keys):
    ``decay_rate ** (num_layers - min(depth, num_layers))``."""
    return [decay_rate ** (num_layers - min(
        layer_depth(flax_modules(n), num_layers), num_layers))
        for n in names]
