"""Checkpoints of the port: parameters, the whole train state, and
ingestion of a torch ConvNeXt checkpoint.

Port of ``sm3det_tpu/train/checkpoint.py``:

- ``save_params`` / ``load_params``: the parameters alone, for the eval
  tools: a ``torch.save`` file of ``{"format", "keys", "state_dict"}``,
  the model's ``state_dict`` on the host and its key list, which follows
  the flax module paths (``convert.py``).
- ``save_train_state`` / ``load_train_state``: the whole ``TrainState``
  for resume (the JAX package's orbax ``save_checkpoint``): the fp32
  masters (``mtl_sigma`` among them under the uncertainty reweighting),
  AdamW's ``mu``, ``nu`` and ``count``, ``step``, the DLA state and the
  multipliers last applied, DWA's carried losses, and the state of the
  step's ``torch.Generator``, as ``<work_dir>/iter_N.pth``.
- ``find_latest_checkpoint``: the ``iter_N`` entry with the largest N.
- ``load_torch_state_dict`` and ``convnext_torch_to_port``: an mm-style
  ConvNeXt checkpoint mapped onto the port's backbone, a dense FFN fanned
  out into every expert of an MoE block and the stem into the
  ``stem_single`` slot.

The JAX package's orbax checkpoints are not read here: orbax is a JAX
library, and JAX params reach the port through ``convert.from_flax``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

FORMAT = "sm3det_tpu_torch.params.v1"
TRAIN_FORMAT = "sm3det_tpu_torch.train_state.v1"


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


def save_train_state(work_dir: str, step: int, state) -> str:
    """Write ``state`` (a ``train_state.TrainState``) to
    ``<work_dir>/iter_<step>.pth``. The card is synchronised once, then
    every tensor is copied to the host."""
    if any(p.is_cuda for p in state.params.values()):
        torch.cuda.synchronize()
    names = list(state.params)
    opt = state.opt

    def host(ts):
        return {n: t.detach().cpu() for n, t in zip(names, ts)}

    obj = {"format": TRAIN_FORMAT, "names": names,
           "params": host(state.params.values()),
           "mu": host(opt.mu), "nu": host(opt.nu),
           "count": int(opt.count), "step": int(opt.step),
           "dla": {"ema": opt.dla.ema.detach().cpu(),
                   "initialized": opt.dla.initialized.detach().cpu(),
                   "steps": int(opt.dla.steps)},
           "mults": {k: float(v) for k, v in opt.mults.items()},
           "prev_losses": None if state.prev_losses is None
           else state.prev_losses.detach().cpu(),
           "gen_state": state.gen.get_state()}
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(work_dir), f"iter_{step}.pth")
    torch.save(obj, path)
    return path


def load_train_state(path: str, state):
    """Load a file of :func:`save_train_state` into ``state``: the
    parameters and moments are copied into ``state``'s own tensors (so a
    model whose parameters are the masters sees them), the generator's
    state is set; returns the ``TrainState`` with the saved counters.
    Raises ``ValueError`` if the names or the shapes differ."""
    from .dla import DLAState
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or obj.get("format") != TRAIN_FORMAT:
        raise ValueError(f"checkpoint {path}: not a {TRAIN_FORMAT} file")
    names = list(state.params)
    if obj["names"] != names:
        missing = sorted(set(names) - set(obj["names"]))
        unexpected = sorted(set(obj["names"]) - set(names))
        raise ValueError(
            f"checkpoint {path} does not match the train state: missing "
            f"{missing[:8]}, unexpected {unexpected[:8]}")
    opt = state.opt
    saved_prev = obj.get("prev_losses")
    if (saved_prev is None) != (state.prev_losses is None) or (
            saved_prev is not None and
            saved_prev.shape != state.prev_losses.shape):
        raise ValueError(
            f"checkpoint {path}: DWA carry "
            f"{None if saved_prev is None else tuple(saved_prev.shape)}, "
            f"the train state "
            f"{None if state.prev_losses is None else tuple(state.prev_losses.shape)}")
    if tuple(obj["dla"]["ema"].shape) != tuple(opt.dla.ema.shape):
        raise ValueError(f"checkpoint {path}: DLA state of shape "
                         f"{tuple(obj['dla']['ema'].shape)}, the train "
                         f"state {tuple(opt.dla.ema.shape)}")
    targets = (("params", list(state.params.values())), ("mu", opt.mu),
               ("nu", opt.nu))
    for key, ts in targets:
        for n, t in zip(names, ts):
            if tuple(obj[key][n].shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint {path}: {key} {n} has shape "
                    f"{tuple(obj[key][n].shape)}, the train state "
                    f"{tuple(t.shape)}")
    with torch.no_grad():
        for key, ts in targets:
            for n, t in zip(names, ts):
                t.copy_(obj[key][n])
        if saved_prev is not None:
            state.prev_losses.copy_(saved_prev)
    state.gen.set_state(obj["gen_state"])
    dla = DLAState(
        ema=obj["dla"]["ema"].to(opt.dla.ema.dtype),
        initialized=obj["dla"]["initialized"].to(torch.bool),
        steps=int(obj["dla"]["steps"]))
    new_opt = opt._replace(count=int(obj["count"]), step=int(obj["step"]),
                           dla=dla, mults=dict(obj["mults"]))
    return state._replace(opt=new_opt)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.pth`` (its ``state_dict`` entry when it has one) or a
    ``.safetensors`` file as a dict of CPU tensors. A ``.pth`` is
    unpickled in full (an mm checkpoint's ``meta`` holds arbitrary
    objects): load only files you trust."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.detach().cpu() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def convnext_torch_to_port(sd, state_dict: Dict[str, torch.Tensor],
                           prefix: str = "backbone.",
                           ) -> Dict[str, torch.Tensor]:
    """Map an mm-style ConvNeXt checkpoint ``sd`` (``downsample_layers``,
    ``stages.i.j.{depthwise_conv, norm, gamma, ffn.pointwise_conv1/2}``,
    ``norm{i}``; keys with or without ``prefix``) onto the port's
    ``state_dict`` (``backbone.stem_single``, ``stage{i}_block{j}``, ...),
    and return the new state dict; keys the checkpoint lacks keep their
    value. Torch convs keep their layout; a dense FFN's (out, in) weights
    become the port's (in, out) kernels and, in an MoE block, are
    replicated into every expert; a trained MoE block's experts are
    stacked. The stem goes into ``stem_single`` (or ``stem_conv``), from
    ``dataset_stems.single`` when the checkpoint has it (the MultiInput
    layout, whose ``downsample_layers.0`` holds only the LayerNorm)."""
    out = dict(state_dict)
    bb = "backbone."

    def get(key):
        v = sd.get(prefix + key, sd.get(key))
        return None if v is None else torch.as_tensor(np.asarray(v))

    def put(name, v):
        if v is None:
            return
        name = bb + name
        if name not in out:
            raise KeyError(f"convnext_torch_to_port: the model has no "
                           f"{name}")
        if tuple(v.shape) != tuple(out[name].shape):
            raise ValueError(
                f"convnext_torch_to_port: {name} has shape "
                f"{tuple(out[name].shape)}, the checkpoint "
                f"{tuple(v.shape)}")
        out[name] = v.to(out[name].dtype).contiguous()

    stem = "stem_single" if bb + "stem_single.weight" in out \
        else "stem_conv"
    if get("dataset_stems.single.weight") is not None:
        put(f"{stem}.weight", get("dataset_stems.single.weight"))
        put(f"{stem}.bias", get("dataset_stems.single.bias"))
        put("stem_norm.weight", get("downsample_layers.0.0.weight"))
        put("stem_norm.bias", get("downsample_layers.0.0.bias"))
    elif get("downsample_layers.0.0.weight") is not None:
        put(f"{stem}.weight", get("downsample_layers.0.0.weight"))
        put(f"{stem}.bias", get("downsample_layers.0.0.bias"))
        put("stem_norm.weight", get("downsample_layers.0.1.weight"))
        put("stem_norm.bias", get("downsample_layers.0.1.bias"))

    for i in range(1, 4):
        if get(f"downsample_layers.{i}.0.weight") is None:
            continue
        put(f"downsample_norm{i}.weight",
            get(f"downsample_layers.{i}.0.weight"))
        put(f"downsample_norm{i}.bias", get(f"downsample_layers.{i}.0.bias"))
        put(f"downsample_conv{i}.weight",
            get(f"downsample_layers.{i}.1.weight"))
        put(f"downsample_conv{i}.bias", get(f"downsample_layers.{i}.1.bias"))

    blocks = sorted({m.groups() for m in (
        re.fullmatch(re.escape(bb) + r"stage(\d+)_block(\d+)\..*", k)
        for k in out) if m}, key=lambda g: (int(g[0]), int(g[1])))
    for si, bi in blocks:
        tp = f"stages.{si}.{bi}."
        blk = f"stage{si}_block{bi}."
        if get(tp + "depthwise_conv.weight") is None:
            continue
        put(blk + "dwconv.weight", get(tp + "depthwise_conv.weight"))
        put(blk + "dwconv.bias", get(tp + "depthwise_conv.bias"))
        put(blk + "norm.weight", get(tp + "norm.weight"))
        put(blk + "norm.bias", get(tp + "norm.bias"))
        if bb + blk + "gamma" in out:
            put(blk + "gamma", get(tp + "gamma"))
        w1 = get(tp + "ffn.pointwise_conv1.weight")
        b1 = get(tp + "ffn.pointwise_conv1.bias")
        w2 = get(tp + "ffn.pointwise_conv2.weight")
        b2 = get(tp + "ffn.pointwise_conv2.bias")
        moe_w1 = get(tp + "ffn.experts.0.pointwise_conv1.weight")
        if w1 is None and moe_w1 is None:
            continue
        ex = blk + "ffn.experts."
        if bb + ex + "w1" in out:
            e = out[bb + ex + "w1"].shape[0]
            if moe_w1 is not None:
                # a trained MoE checkpoint: stack the experts' FFNs
                def stack(name, t):
                    vs = [get(tp + f"ffn.experts.{j}.{name}") for j in
                          range(e)]
                    return torch.stack([v.T if t else v for v in vs])
                put(ex + "w1", stack("pointwise_conv1.weight", True))
                put(ex + "b1", stack("pointwise_conv1.bias", False))
                put(ex + "w2", stack("pointwise_conv2.weight", True))
                put(ex + "b2", stack("pointwise_conv2.bias", False))
            else:
                # a dense checkpoint: the FFN into every expert
                put(ex + "w1", w1.T.unsqueeze(0).repeat(e, 1, 1))
                put(ex + "b1", b1.unsqueeze(0).repeat(e, 1))
                put(ex + "w2", w2.T.unsqueeze(0).repeat(e, 1, 1))
                put(ex + "b2", b2.unsqueeze(0).repeat(e, 1))
            g = blk + "ffn.w_gate."
            if get(tp + "ffn.w_gate.sim_matrix") is not None and \
                    bb + g + "sim_matrix" in out:
                put(g + "sim_matrix", get(tp + "ffn.w_gate.sim_matrix"))
                put(g + "temperature", get(tp + "ffn.w_gate.temperature"))
                put(g + "cosine_projector.weight",
                    get(tp + "ffn.w_gate.cosine_projector.weight"))
                put(g + "cosine_projector.bias",
                    get(tp + "ffn.w_gate.cosine_projector.bias"))
            if bb + blk + "ffn.w_noise" in out:
                put(blk + "ffn.w_noise", get(tp + "ffn.w_noise"))
        else:
            put(blk + "pwconv1.kernel", w1.T)
            put(blk + "pwconv1.bias", b1)
            put(blk + "pwconv2.kernel", w2.T)
            put(blk + "pwconv2.bias", b2)

    for i in range(4):
        if get(f"norm{i}.weight") is not None and \
                bb + f"out_norm{i}.weight" in out:
            put(f"out_norm{i}.weight", get(f"norm{i}.weight"))
            put(f"out_norm{i}.bias", get(f"norm{i}.bias"))
    return out
