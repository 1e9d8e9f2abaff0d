"""Logger backends.

Port of ``sm3det_tpu/train/loggers.py`` (mmcv ``runner/hooks/logger/``):
``TextLogger`` (console + ``<work_dir>/train_log.jsonl``, what the loop
writes itself), and ``TensorBoardLogger`` and ``WandbLogger``, whose
packages are imported only when they are built; ``build_loggers`` skips a
backend whose package is missing.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


class TextLogger:
    """Console and ``<work_dir>/train_log.jsonl``."""

    def __init__(self, work_dir: str):
        self.path = os.path.join(work_dir, "train_log.jsonl")
        os.makedirs(work_dir, exist_ok=True)

    def log(self, metrics: Dict[str, float], step: int):
        line = {"iter": step, **metrics}
        print(json.dumps(line))
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")

    def close(self):
        pass


class TensorBoardLogger:
    """Scalars to a TensorBoard event file (needs ``tensorboard``)."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "tensorboard unavailable; use TextLogger") from e
        self.writer = SummaryWriter(log_dir)

    def log(self, metrics: Dict[str, float], step: int):
        for k, v in metrics.items():
            self.writer.add_scalar(k, v, step)

    def close(self):
        self.writer.close()


class WandbLogger:
    """Scalars to a Weights & Biases run (needs ``wandb``)."""

    def __init__(self, project: str, name: Optional[str] = None, **kw):
        import wandb
        self.run = wandb.init(project=project, name=name, **kw)

    def log(self, metrics: Dict[str, float], step: int):
        self.run.log(metrics, step=step)

    def close(self):
        self.run.finish()


def build_loggers(cfg_list, work_dir: str):
    """``["text", "tensorboard", "wandb"]`` -> logger objects; a backend
    whose package is missing is skipped with a message."""
    out = []
    for item in cfg_list or ["text"]:
        try:
            if item == "text":
                out.append(TextLogger(work_dir))
            elif item == "tensorboard":
                out.append(TensorBoardLogger(os.path.join(work_dir, "tb")))
            elif item == "wandb":
                out.append(WandbLogger(project="sm3det_tpu"))
        except ImportError:
            print(f"logger {item!r} unavailable; skipped")
    return out
