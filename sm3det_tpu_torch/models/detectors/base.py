"""What every detector of the port shares: where its parameters live, in
which dtype, and how images reach them.

A detector is built on ``device`` (the CUDA card unless ``"cpu"``, see
``device.resolve_device``). ``trainable=False`` (inference) casts its
parameters to the compute dtype (``cfg["compute_dtype"]``, fp32 without
it) and freezes them in eval mode; ``trainable=True`` keeps fp32
parameters that require grad, in train mode, and the train step hands the
forward a copy in the compute dtype (``train/train_state.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ...device import resolve_device

# what the port's NotImplementedError messages cite for the zoo's parts it
# has not ported
ZOO = "ROADMAP queue 1 item 7 (the zoo)"


class DetectorBase(nn.Module):
    def _place(self, cfg: Dict[str, Any], device, trainable: bool):
        """Set the compute dtype from ``cfg`` and move the parameters to
        ``device`` in the dtype ``trainable`` asks for."""
        dt = cfg.get("compute_dtype")
        self.compute_dtype = getattr(torch, dt) if dt else torch.float32
        self.to(device=resolve_device(device),
                dtype=torch.float32 if trainable else self.compute_dtype)
        self.train(trainable)
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _cast_in(self, imgs):
        """Images (numpy or tensor, (B, H, W, 3)) on the model's device in
        the compute dtype."""
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        return imgs.to(device=self.device, dtype=self.compute_dtype)
