"""Convert the JAX package's flax parameters into the port's state_dict.

``from_flax(params)`` takes the flax ``params`` tree (nested dicts of numpy
arrays) of a detector and converts every leaf under its top-level
entries: ``backbone`` and ``neck``; the TriSource heads
(``sar_bbox_head``, ``sar_rpn_head``, ``sar_roi_head``,
``{rgb,ifr}_{rpn,roi,bbox}_head``); the single-dataset detectors' heads
(``rpn_head``, ``roi_head``, ``bbox_head``, the cascade's
``bbox_head{i}``, and the horizontal RetinaNet's top-level
``cls_conv{i}``, ``reg_conv{i}``, ``retina_cls`` and ``retina_reg``); and
``mtl_sigma`` (the uncertainty reweighting's sigmas) where the tree has
it. It raises on a leaf that no rule consumes and on a top-level entry it
does not know.
Module names follow the flax keys (``backbone.stage2_block0.ffn.experts.w1``,
``backbone.stage2_block0.mlp.fc1.experts.w``, ``neck.lateral1.weight``,
``sar_bbox_head.cls_gn0.weight``, ``rgb_roi_head.shared_fc0.weight``, ...),
for a ConvNeXt, LSKNet or VAN backbone:

- conv kernels HWIO -> OIHW (the stems, patch embeds, 1x1 convs, the
  squeeze conv, the heads' convs), the depthwise (k, k, 1, C) ->
  (C, 1, k, k);
- the ConvNeXt pointwise Dense kernels keep the (in, out) layout that the
  GEMM kernel reads; the gate's ``cosine_projector`` and the RoI heads'
  Dense layers become Linear weights (out, in);
- MoE stacks ``w1 (E, d, h)``, ``b1``, ``w2 (E, h, d)``, ``b2`` and the
  linear experts' ``w (E, d, o)``, ``b (E, o)`` stay stacked, as do
  ``w_gate/{temperature, sim_matrix}`` and ``w_noise``;
- LayerNorm/GroupNorm ``scale``/``bias`` -> ``weight``/``bias``; the
  ``gamma`` and ``layer_scale_{1,2}`` vectors, ``mtl_sigma`` and the
  scalar ``Scale``s keep their names.

``to_flax(tensors, template)`` is the reverse map, for the port's
gradients or parameters: it lays them out as the flax tree ``template``
(the params they were converted from), leaf for leaf.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# the flagship's top-level subtrees
SUBTREES = ("backbone", "neck", "sar_bbox_head", "rgb_rpn_head",
            "ifr_rpn_head", "rgb_roi_head", "ifr_roi_head")
# every top-level module name a detector of the port may have
_TOP = re.compile(r"backbone|neck|((sar|rgb|ifr)_)?(bbox|rpn|roi)_head"
                  r"|bbox_head\d+|(cls|reg)_conv\d+|retina_(cls|reg)")
# top-level leaves a tree may hold: the uncertainty reweighting's sigmas
OPTIONAL_LEAVES = ("mtl_sigma",)
_LINEAR = {"cosine_projector", "shared_fc0", "shared_fc1", "fc_cls", "fc_reg"}
_KEPT = {"gamma", "temperature", "sim_matrix", "w_noise", "w1", "b1", "w2",
         "b2", "w", "b", "layer_scale_1", "layer_scale_2", "mtl_sigma"}
_NORM = re.compile(r".*norm\d*|(cls|reg)_gn\d+")


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


# the layout change of each rule and its inverse
_HWIO_TO_OIHW = ((3, 2, 0, 1), (2, 3, 1, 0))
_TRANSPOSE = ((1, 0), (1, 0))


def _rule(path: tuple, v: np.ndarray):
    """(port name, permutation pair or None) of one flax leaf."""
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    name, perm = None, None
    if leaf == "kernel" and v.ndim == 4:
        name, perm = "weight", _HWIO_TO_OIHW
    elif leaf == "kernel" and v.ndim == 2 and parent.startswith("pwconv"):
        name = "kernel"
    elif leaf == "kernel" and v.ndim == 2 and parent in _LINEAR:
        name, perm = "weight", _TRANSPOSE
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
    return ".".join([*mods, name]), perm


def _convert(path: tuple, v: np.ndarray) -> Tuple[str, np.ndarray]:
    name, perm = _rule(path, v)
    return name, v if perm is None else v.transpose(perm[0])


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
    """flax params tree -> the port's detector state_dict."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    missing = [s for s in ("backbone", "neck") if s not in params]
    if missing:
        raise KeyError(f"from_flax: no {missing} in the params tree")
    unknown = [k for k in params if not _TOP.fullmatch(k)
               and k not in OPTIONAL_LEAVES]
    if unknown:
        raise KeyError(f"from_flax: no rule for the subtrees {unknown}")
    out = {}
    for sub in params:
        out.update(convert_tree(params[sub], (sub,)))
    return out


def to_flax(tensors: Dict[str, torch.Tensor], template: Dict) -> Dict:
    """The port's tensors (by state_dict name, e.g. gradients) laid out as
    the flax tree ``template`` (nested dicts, the params ``from_flax``
    converted): one numpy fp32 array per template leaf, in flax's layout.
    Raises if a template leaf has no tensor."""
    if "params" in template and len(template) == 1:
        template = template["params"]
    out: Dict = {}
    for sub in template:
        for path, v in _leaves(template[sub], (sub,)):
            name, perm = _rule(path, v)
            arr = tensors[name].detach().float().cpu().numpy()
            if perm is not None:
                arr = arr.transpose(perm[1])
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = arr.copy()   # C order; keeps a 0-d leaf 0-d
    return out
