"""Where the port's entry points run: the card unless the caller asks."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card and raises without one; only an explicit
    ``"cpu"`` runs the plain versions on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run its plain versions on the host")
        return torch.device("cuda")
    return torch.device(device)
