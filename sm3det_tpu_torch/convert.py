"""Convert the JAX package's flax parameters into the port's state_dict.

``from_flax(params)`` takes the flax ``params`` tree (nested dicts of numpy
arrays) of a detector and converts every leaf under its top-level
entries: ``backbone`` and ``neck``; the TriSource heads
(``sar_bbox_head``, ``sar_rpn_head``, ``sar_roi_head``,
``{rgb,ifr}_{rpn,roi,bbox}_head``); the single-dataset detectors' heads
(``rpn_head``, ``roi_head``, ``bbox_head``, the cascade's
``bbox_head{i}``, the horizontal RetinaNet's top-level ``cls_conv{i}``,
``reg_conv{i}``, ``retina_cls`` and ``retina_reg``, R3Det's and S2ANet's
``refine_head{i}``, RoI Transformer's ``stage1_head`` and
``stage2_head``); and
``mtl_sigma`` (the uncertainty reweighting's sigmas) where the tree has
it. It raises on a leaf that no rule consumes and on a top-level entry it
does not know.
Module names follow the flax keys (``backbone.stage2_block0.ffn.experts.w1``,
``backbone.stage2_block0.mlp.fc1.experts.w``, ``neck.lateral1.weight``,
``sar_bbox_head.cls_gn0.weight``, ``rgb_roi_head.shared_fc0.weight``, ...),
for a ConvNeXt, LSKNet, VAN or InternViT-adapter backbone
(``backbone.block3.qkv.weight``, ``backbone.spm.gn1.weight``,
``backbone.extract0.sampling_offsets.weight``, ``backbone.pos_embed``):

- conv kernels HWIO -> OIHW (the stems, patch embeds, 1x1 convs, the
  squeeze conv, the heads' convs), the depthwise (k, k, 1, C) ->
  (C, 1, k, k); ORConv's base ``weight`` (k, k, Cin, O_in, Cout) ->
  (Cout, Cin, O_in, k, k);
- the ConvNeXt pointwise Dense kernels keep the (in, out) layout that the
  GEMM kernel reads, and ``SimpleFPN``'s transposed-conv kernels
  (``fpn1_up1``, ``fpn1_up2``, ``fpn2_up``) their flax (2, 2, in, out)
  layout, which ``UpConv2x2`` reads; the gate's ``cosine_projector``, the
  RoI heads' Dense layers and the Domain-Attention layers' bias-free
  ``fc{d}_{0,1}`` become Linear weights (out, in), and so do the ViT's
  and the adapter's Dense layers (``qkv``, ``proj``, ``fc1``, ``fc2``,
  ``vit_proj``, ``vit_unproj``, the deformable attention's
  ``value_proj``, ``sampling_offsets``, ``attention_weights`` and
  ``output_proj``);
- MoE stacks ``w1 (E, d, h)``, ``b1``, ``w2 (E, h, d)``, ``b2`` and the
  linear experts' ``w (E, d, o)``, ``b (E, o)`` stay stacked, as do
  ``w_gate/{temperature, sim_matrix}``, the linear gate's ``w_gate (d,
  E)`` and ``w_noise``;
- LayerNorm/GroupNorm ``scale``/``bias`` -> ``weight``/``bias`` (the
  SPM's ``gn{i}`` among them); an RMSNorm's ``weight`` (the ViT's
  ``q_norm`` / ``k_norm``) keeps its name; the ``gamma``,
  ``layer_scale_{1,2}`` and ``ls{1,2}`` vectors, ``pos_embed``, GRN's
  ``gamma`` / ``beta``, ``mtl_sigma`` and the scalar ``Scale``s keep their
  names (a block without layer scale has no ``gamma``, in either tree).

A port name is the flax module path joined by dots, then the leaf's name:
``flax_modules`` gives that path back (``train/extras.py`` picks each
parameter's layer-decay depth from it).

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
                  r"|bbox_head\d+|(cls|reg)_conv\d+|retina_(cls|reg)"
                  r"|refine_head\d+|stage[12]_head")
# top-level leaves a tree may hold: the uncertainty reweighting's sigmas
OPTIONAL_LEAVES = ("mtl_sigma",)
_LINEAR = re.compile(r"cosine_projector|shared_fc[01]|fc_cls|fc_reg"
                     r"|fc\d+_[01]|qkv|proj|fc[12]|vit_(un)?proj|value_proj"
                     r"|sampling_offsets|attention_weights|output_proj")
_KEPT = {"gamma", "beta", "temperature", "sim_matrix", "w_gate", "w_noise",
         "w1", "b1", "w2", "b2", "w", "b", "layer_scale_1", "layer_scale_2",
         "mtl_sigma", "pos_embed", "ls1", "ls2"}
# SimpleFPN's transposed convs: the kernel stays in the flax layout
_UPCONV = {"fpn1_up1", "fpn1_up2", "fpn2_up"}
_NORM = re.compile(r".*norm\d*|(cls|reg)_gn\d+|gn\d+")


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


# the layout change of each rule and its inverse
_HWIO_TO_OIHW = ((3, 2, 0, 1), (2, 3, 1, 0))
_TRANSPOSE = ((1, 0), (1, 0))
_ORCONV = ((4, 2, 3, 0, 1), (3, 4, 1, 2, 0))


def _rule(path: tuple, v: np.ndarray):
    """(port name, permutation pair or None) of one flax leaf."""
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    name, perm = None, None
    if leaf == "kernel" and v.ndim == 4 and parent in _UPCONV:
        name = "kernel"
    elif leaf == "kernel" and v.ndim == 4:
        name, perm = "weight", _HWIO_TO_OIHW
    elif leaf == "weight" and v.ndim == 5 and parent == "or_conv":
        name, perm = "weight", _ORCONV
    elif leaf == "kernel" and v.ndim == 2 and parent.startswith("pwconv"):
        name = "kernel"
    elif leaf == "kernel" and v.ndim == 2 and _LINEAR.fullmatch(parent):
        name, perm = "weight", _TRANSPOSE
    elif leaf == "bias":
        name = "bias"
    elif leaf == "scale" and re.fullmatch(r"scale\d+", parent) \
            and v.ndim == 0:
        name = "scale"
    elif leaf == "scale" and _NORM.fullmatch(parent):
        name = "weight"
    elif leaf == "weight" and v.ndim == 1 and _NORM.fullmatch(parent):
        name = "weight"                # an RMSNorm's (the ViT's)
    elif leaf in _KEPT:
        name = leaf
    if name is None:
        raise KeyError(f"from_flax: no rule for {'/'.join(path)} "
                       f"{tuple(v.shape)}")
    return ".".join([*mods, name]), perm


def flax_modules(port_name: str) -> Tuple[str, ...]:
    """The flax path a port parameter is converted from: the module path,
    and the leaf where it is one of the named vectors ``from_flax`` keeps
    (``pos_embed``, ``ls1``, ``gamma``, ...). A layer's own leaf
    (``kernel`` / ``scale`` / ``weight`` / ``bias``) is left out: its flax
    name depends on the layer, and no path rule reads it."""
    *mods, leaf = port_name.split(".")
    return tuple(mods) + ((leaf,) if leaf in _KEPT else ())


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
