"""The iteration loop: train steps, windowed logs, checkpoints, evals.

Port of ``sm3det_tpu/train/loop.py`` (mmcv's ``IterBasedRunner`` and its
hooks). A step's host work is the next batch (the loader's queue and its
copy to the device) and the step itself. The metrics are summed on the
device every step (``torch.stack`` of the detached losses added to one
running vector) and fetched once every ``log_interval`` steps: the loop
adds no host synchronisation a step beyond the step's own. Checkpoints
(``train/checkpoint.py::save_train_state``) and the eval hooks run at
their intervals.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .checkpoint import save_train_state


class LogBuffer:
    """Windowed means (mmcv ``LogBuffer``)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.hist: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.window))

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self.hist[k].append(float(v))

    def averages(self) -> Dict[str, float]:
        return {k: float(np.mean(v)) for k, v in self.hist.items()}


def run_training(train_step: Callable, state, data_iter: Iterator,
                 max_iters: int, work_dir: str,
                 device_put: Optional[Callable] = None,
                 log_interval: int = 50,
                 checkpoint_interval: Optional[int] = None,
                 eval_fns: Optional[Dict[str, Callable]] = None,
                 eval_interval: Optional[int] = None,
                 logger=print, start_iter: int = 0,
                 stats: Optional[Dict] = None):
    """Run iterations ``start_iter`` .. ``max_iters - 1``; returns the
    final state. Every ``log_interval`` iterations one line goes to
    ``<work_dir>/train_log.jsonl``: ``iter``, ``elapsed_s``,
    ``data_time`` and ``step_time`` (host seconds an iteration spent
    waiting for the batch and in the step's call) and the window's mean
    of every metric. Each eval hook's scalar results go there too, as a
    ``"mode": "val"`` line. ``stats``, if given, receives ``iters``,
    ``data_wait_s`` (all the host's waits for batches), ``iter_end_s``
    (the host clock as each iteration's step returned), ``log_lines``,
    ``checkpoints`` (path, bytes, seconds) and ``evals`` (iteration,
    name, result, seconds)."""
    os.makedirs(work_dir, exist_ok=True)
    log_path = os.path.join(work_dir, "train_log.jsonl")
    st = stats if stats is not None else {}
    st.update(iters=0, data_wait_s=0.0, iter_end_s=[], log_lines=[],
              checkpoints=[], evals=[])
    acc_vec = None
    n_acc = 0
    keys = None
    t_data, t_step = 0.0, 0.0
    t0 = time.perf_counter()

    for it in range(start_iter, max_iters):
        td = time.perf_counter()
        batch = next(data_iter)
        if device_put is not None:
            batch = device_put(batch)
        waited = time.perf_counter() - td
        t_data += waited
        st["data_wait_s"] += waited

        ts = time.perf_counter()
        state, metrics = train_step(state, batch)
        st["iter_end_s"].append(time.perf_counter())
        t_step += st["iter_end_s"][-1] - ts
        keys = sorted(metrics)
        vec = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                           for k in keys])
        acc_vec = vec if acc_vec is None else acc_vec + vec
        n_acc += 1
        st["iters"] += 1

        if (it + 1) % log_interval == 0 and n_acc:
            # the loop's one fetch from the device, once a window
            vals = acc_vec.cpu().numpy() / n_acc
            avg = dict(zip(keys, (float(v) for v in vals)))
            acc_vec, n_acc = None, 0
            elapsed = time.perf_counter() - t0
            line = {
                "iter": it + 1, "elapsed_s": round(elapsed, 1),
                "data_time": round(t_data / log_interval, 4),
                "step_time": round(t_step / log_interval, 4),
                **{k: round(v, 5) for k, v in avg.items()},
            }
            logger(f"[{it + 1}/{max_iters}] " + json.dumps(line))
            with open(log_path, "a") as f:
                f.write(json.dumps(line) + "\n")
            st["log_lines"].append(line)
            t_data, t_step = 0.0, 0.0

        if checkpoint_interval and (it + 1) % checkpoint_interval == 0:
            tc = time.perf_counter()
            path = save_train_state(work_dir, it + 1, state)
            st["checkpoints"].append((path, os.path.getsize(path),
                                      time.perf_counter() - tc))
            logger(f"checkpoint saved: {path}")

        if eval_fns and eval_interval and (it + 1) % eval_interval == 0:
            for name, fn in eval_fns.items():
                te = time.perf_counter()
                res = fn(state)
                st["evals"].append((it + 1, name, res,
                                    time.perf_counter() - te))
                logger(f"eval[{name}] @ {it + 1}: {res}")
                line = {"iter": it + 1, "mode": "val", "dataset": name}
                line.update({k: v for k, v in res.items()
                             if isinstance(v, (int, float))})
                with open(log_path, "a") as f:
                    f.write(json.dumps(line) + "\n")

    return state
