"""Parameter checkpoints of the port.

Part of the port of ``sm3det_tpu/train/checkpoint.py``: the params-only
save and load of the eval tools, and ``find_latest_checkpoint``.

The port's format is a ``torch.save`` file of ``{"format", "keys",
"state_dict"}``: the model's ``state_dict`` on the host and its key list,
which follows the flax module paths (``convert.py``). The JAX package's
orbax checkpoints are not read here: orbax is a JAX library, and JAX
params reach the port through ``convert.from_flax``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

FORMAT = "sm3det_tpu_torch.params.v1"


def save_params(path: str, model: torch.nn.Module) -> str:
    """Write ``model``'s parameters and buffers to ``path``."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"format": FORMAT, "keys": list(sd), "state_dict": sd}, path)
    return path


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load parameters saved by :func:`save_params` into ``model``, cast to
    its dtypes on its device. Raises ``ValueError`` if the names or the
    shapes differ from the model's."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or obj.get("format") != FORMAT:
        raise ValueError(f"checkpoint {path}: not a {FORMAT} file")
    got = obj["state_dict"]
    want = model.state_dict()
    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    if missing or unexpected or list(got) != obj["keys"]:
        raise ValueError(
            f"checkpoint {path} does not match the model: missing "
            f"{missing[:8]}, unexpected {unexpected[:8]}")
    for k, t in want.items():
        if tuple(got[k].shape) != tuple(t.shape):
            raise ValueError(
                f"checkpoint {path}: {k} has shape {tuple(got[k].shape)}, "
                f"the model {tuple(t.shape)}")
    model.load_state_dict(
        {k: got[k].to(dtype=t.dtype) for k, t in want.items()}, strict=True)
    return model


def find_latest_checkpoint(work_dir: str) -> Optional[str]:
    """The ``iter_N`` (or ``iter_N.pth``) entry of ``work_dir`` with the
    largest N, or None."""
    if not os.path.isdir(work_dir):
        return None
    best, best_iter = None, -1
    for name in os.listdir(work_dir):
        m = re.fullmatch(r"iter_(\d+)(\.pth)?", name)
        if m and int(m.group(1)) > best_iter:
            best_iter = int(m.group(1))
            best = os.path.join(work_dir, name)
    return best
