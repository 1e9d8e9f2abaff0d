"""Convert the JAX package's flax parameters into the port's state_dict.

``from_flax(params)`` takes the flax ``params`` tree (nested dicts of numpy
arrays) of a ``TriSourceDetector`` and converts every leaf under
``backbone``, ``neck``, ``sar_bbox_head`` and the four RGB / infrared heads
(``{rgb,ifr}_rpn_head``, ``{rgb,ifr}_roi_head``); it raises on a leaf that
no rule consumes and on a top-level entry it does not know. The one entry
it knows and skips is ``mtl_sigma``, the uncertainty-reweighting sigmas of
the training loss, which inference does not read. Module names follow the
flax keys (``backbone.stage2_block0.ffn.experts.w1``,
``neck.lateral1.weight``, ``sar_bbox_head.cls_gn0.weight``,
``rgb_roi_head.shared_fc0.weight``, ...):

- conv kernels HWIO -> OIHW, the depthwise (7, 7, 1, C) -> (C, 1, 7, 7);
- the ConvNeXt pointwise Dense kernels keep the (in, out) layout that the
  GEMM kernel reads; the gate's ``cosine_projector`` and the RoI heads'
  Dense layers become Linear weights (out, in);
- MoE stacks ``w1 (E, d, h)``, ``b1``, ``w2 (E, h, d)``, ``b2`` stay
  stacked, as do ``w_gate/{temperature, sim_matrix}`` and ``w_noise``;
- LayerNorm/GroupNorm ``scale``/``bias`` -> ``weight``/``bias``; the
  ``gamma`` vectors and the scalar ``Scale``s keep their names.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

SUBTREES = ("backbone", "neck", "sar_bbox_head", "rgb_rpn_head",
            "ifr_rpn_head", "rgb_roi_head", "ifr_roi_head")
# top-level entries of the training path that inference does not read
SKIPPED = ("mtl_sigma",)
_LINEAR = {"cosine_projector", "shared_fc0", "shared_fc1", "fc_cls", "fc_reg"}
_KEPT = {"gamma", "temperature", "sim_matrix", "w_noise", "w1", "b1", "w2",
         "b2"}
_NORM = re.compile(r".*norm\d*|(cls|reg)_gn\d+")


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _convert(path: tuple, v: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    name, arr = None, v
    if leaf == "kernel" and v.ndim == 4:
        name, arr = "weight", v.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and v.ndim == 2 and parent.startswith("pwconv"):
        name = "kernel"
    elif leaf == "kernel" and v.ndim == 2 and parent in _LINEAR:
        name, arr = "weight", v.T
    elif leaf == "bias":
        name = "bias"
    elif leaf == "scale" and re.fullmatch(r"scale\d+", parent) \
            and v.ndim == 0:
        name = "scale"
    elif leaf == "scale" and _NORM.fullmatch(parent):
        name = "weight"
    elif leaf in _KEPT:
        name = leaf
    if name is None:
        raise KeyError(f"from_flax: no rule for {'/'.join(path)} "
                       f"{tuple(v.shape)}")
    return ".".join([*mods, name]), arr


def convert_tree(tree: Dict, prefix: Tuple[str, ...] = ()
                 ) -> Dict[str, torch.Tensor]:
    """Convert every leaf of a flax subtree (a module's params); keys are
    prefixed with ``prefix`` joined by dots. Raises on an unknown leaf."""
    out = {}
    for path, v in _leaves(tree, prefix):
        key, arr = _convert(path, v)
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """flax params tree -> the port's ``TriSourceDetector`` state_dict."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    missing = [s for s in SUBTREES if s not in params]
    if missing:
        raise KeyError(f"from_flax: no {missing} in the params tree")
    unknown = [k for k in params if k not in SUBTREES + SKIPPED]
    if unknown:
        raise KeyError(f"from_flax: no rule for the subtrees {unknown}")
    out = {}
    for sub in SUBTREES:
        out.update(convert_tree(params[sub], (sub,)))
    return out
