"""Model registries and the detector builder of the config files.

Port of the registry part of ``sm3det_tpu/models/__init__.py``: the names a
config's ``type`` may take, and ``normalize_model_cfg``. The port registers
what it has:

- detectors: ``TriSourceDetector`` with a ConvNeXt-MoE (Domain Attention
  included), LSKNet-MoE or VAN-MoE backbone (``ConvNeXt_moe``,
  ``ConvNeXt_moe_MultiInput``, ``ConvNeXt_DA_MultiInput``, ``LSKNet``,
  ``LSKNet_moe_MultiInput``, ``VAN``, ``VAN_moe_MultiInput``) or the
  BabelRS ViT-Adapter (``InternViTAdapter``; ``InternViT`` names the same
  class, as in JAX, and the TriSource factory refuses it, as JAX's does),
  ``TriSourceVariant`` (its ``sar_stages`` / ``rot_stages`` from the
  config), and the single-dataset ``OrientedRCNN``, ``GFL``,
  ``RotatedRetinaNet``, ``FasterRCNN``, ``CascadeRCNN``, ``RetinaNet``,
  ``R3Det``, ``S2ANet``, ``RoITransformer``, ``GlidingVertex``,
  ``RotatedFCOS``, ``RotatedFasterRCNN``, ``RotatedATSS`` and the RepPoints
  family (``OrientedRepPoints``, ``RotatedRepPoints``, ``SAMRepPoints``,
  ``GRepPoints``) on a single-stem backbone: the ConvNeXt
  (``ConvNeXt_moe`` or no backbone type), ``LSKNet_moe`` or ``VAN_moe``;
  and ``ReDet`` on its own ``ReResNet`` backbone and ``ReFPN`` neck (the
  only detector either is taken for: JAX's ReDet builds them whatever
  the config names, the port raises for any other type there);
- the necks ``MultitaskFPN`` and ``FPN`` (the same module: every detector
  builds it and calls it with ``add_extra_convs="on_output"`` on each
  branch, as JAX's do, so a config's ``add_extra_convs`` and
  ``relu_before_extra_convs`` are checked but reach no detector, as in
  JAX; they are the module's own options, library API) and ``SimpleFPN``
  (library API: it takes one stride-16 map, which no ported backbone
  makes, so a detector config naming it raises), and the heads those
  detectors use, the CSL heads (``CSLRRetinaHead``, ``CSLRFCOSHead``)
  among them.

Every other name the JAX package registers raises ``NotImplementedError``
naming the ROADMAP item that ports it; nothing falls back to the flagship.

``build_detector`` does what the eval and train tools do with a config's
``model`` dict: it drops ``type`` and the backbone's ``pretrained``, makes
the ``moe_block_inds`` lists tuples and builds the detector on ``device``,
for inference or, with ``trainable=True``, for training.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from ..utils.registry import BACKBONES, DETECTORS, HEADS, NECKS
from .backbones.convnext import ConvNeXtMoE
from .backbones.intern_vit import InternViTAdapter
from .backbones.lsknet import LSKNetMoE
from .backbones.re_resnet import ReFPN, ReResNet
from .backbones.van import VANMoE
from .dense_heads.gfl_head import GFLHead
from .dense_heads.oriented_reppoints_head import OrientedRepPointsHead
from .dense_heads.oriented_rpn_head import OrientedRPNHead
from .dense_heads.rotated_atss_head import RotatedATSSHead
from .dense_heads.rotated_fcos_head import (CSLRotatedFCOSHead,
                                            RotatedFCOSHead)
from .dense_heads.rotated_retina_head import CSLRetinaHead, RotatedRetinaHead
from .dense_heads.rpn_head import RPNHead
from .detectors.base import ZOO
from .detectors.hbb_detectors import CascadeRCNN, FasterRCNN, RetinaNet
from .detectors.redet_roitrans import ReDet, RoITransformer
from .detectors.refine_detectors import (ODMRefineHead, R3Det, RefineHead,
                                         S2ANet)
from .detectors.single_stage_zoo import (GlidingVertex, OrientedRepPoints,
                                         RotatedFCOS)
from .detectors.trisource import TriSourceDetector
from .detectors.trisource_variants import DEFAULT_STAGES, TriSourceVariant
from .detectors.zoo import GFLDetector, OrientedRCNN, RotatedRetinaNet
from .detectors.zoo_extra import (GRepPoints, RotatedATSS,
                                  RotatedFasterRCNN, RotatedRepPoints,
                                  SAMRepPoints)
from .necks.fpn import FPN, MultitaskFPN, SimpleFPN, check_extra_convs
from .roi_heads.cascade_heads import GVBBoxHead, HBB2OBBBBoxHead
from .roi_heads.oriented_roi_head import RotatedShared2FCBBoxHead
from .roi_heads.standard_roi_head import Shared2FCBBoxHead


def _unported(kind: str, name: str, item: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"{kind} {name!r} is not ported to sm3det_tpu_torch: {item}")
    build.__name__ = name
    return build


for _name in ("ConvNeXt_moe", "ConvNeXt_moe_MultiInput",
              "ConvNeXt_DA_MultiInput"):
    BACKBONES.register_module(_name, module=ConvNeXtMoE)
for _name, _cls in (("LSKNet", LSKNetMoE), ("LSKNet_moe_MultiInput",
                                            LSKNetMoE),
                    ("VAN", VANMoE), ("VAN_moe_MultiInput", VANMoE),
                    ("LSKNet_moe", LSKNetMoE), ("VAN_moe", VANMoE),
                    ("InternViT", InternViTAdapter),
                    ("InternViTAdapter", InternViTAdapter),
                    ("ReResNet", ReResNet)):
    BACKBONES.register_module(_name, module=_cls)
for _name, _cls in (("MultitaskFPN", MultitaskFPN), ("FPN", FPN),
                    ("SimpleFPN", SimpleFPN), ("ReFPN", ReFPN)):
    NECKS.register_module(_name, module=_cls)
for _name, _cls in (("TriSourceDetector", TriSourceDetector),
                    ("TriSourceVariant", TriSourceVariant),
                    ("OrientedRCNN", OrientedRCNN), ("GFL", GFLDetector),
                    ("RotatedRetinaNet", RotatedRetinaNet),
                    ("FasterRCNN", FasterRCNN), ("CascadeRCNN", CascadeRCNN),
                    ("RetinaNet", RetinaNet), ("R3Det", R3Det),
                    ("S2ANet", S2ANet), ("RoITransformer", RoITransformer),
                    ("GlidingVertex", GlidingVertex),
                    ("RotatedFCOS", RotatedFCOS),
                    ("RotatedFasterRCNN", RotatedFasterRCNN),
                    ("RotatedATSS", RotatedATSS), ("ReDet", ReDet),
                    ("OrientedRepPoints", OrientedRepPoints),
                    ("RotatedRepPoints", RotatedRepPoints),
                    ("SAMRepPoints", SAMRepPoints),
                    ("GRepPoints", GRepPoints)):
    DETECTORS.register_module(_name, module=_cls)
# the JAX package's head names (the KFIoU ones select the box loss through
# normalize_model_cfg)
for _name, _cls in (("GFLHead", GFLHead), ("OrientedRPNHead", OrientedRPNHead),
                    ("RotatedRetinaHead", RotatedRetinaHead),
                    ("RotatedAnchorHead", RotatedRetinaHead),
                    ("KFIoURRetinaHead", RotatedRetinaHead),
                    ("CSLRRetinaHead", CSLRetinaHead), ("RPNHead", RPNHead),
                    ("RotatedRPNHead", RPNHead),
                    ("RotatedShared2FCBBoxHead", RotatedShared2FCBBoxHead),
                    ("Shared2FCBBoxHead", Shared2FCBBoxHead),
                    ("HBB2OBBBBoxHead", HBB2OBBBBoxHead),
                    ("ODMRefineHead", ODMRefineHead),
                    ("RotatedRetinaRefineHead", RefineHead),
                    ("KFIoUODMRefineHead", ODMRefineHead),
                    ("KFIoURRetinaRefineHead", RefineHead),
                    ("GVBBoxHead", GVBBoxHead),
                    ("RotatedFCOSHead", RotatedFCOSHead),
                    ("RotatedAnchorFreeHead", RotatedFCOSHead),
                    ("RotatedATSSHead", RotatedATSSHead),
                    ("OrientedRepPointsHead", OrientedRepPointsHead),
                    ("RotatedRepPointsHead", OrientedRepPointsHead),
                    ("SAMRepPointsHead", OrientedRepPointsHead),
                    ("CSLRFCOSHead", CSLRotatedFCOSHead)):
    HEADS.register_module(_name, module=_cls)

for _name in ("SwinTransformer_moe", "SwinTransformer_MoE",
              "SwinTransformer"):
    BACKBONES.register_module(_name, module=_unported("backbone", _name,
                                                      ZOO))

# the backbone keys TriSourceDetector reads (besides pretrained)
_BACKBONE_KEYS = {"type", "arch", "drop_path_rate", "moe_block_inds",
                  "num_experts", "top_k", "gate", "noisy_gating",
                  "capacity_factor", "use_da", "da_block_inds", "embed_dims",
                  "depths", "moe_block_inds_fc1", "moe_block_inds_fc2"}
# the keys the InternViT adapter reads; of the two more its configs hold,
# which JAX ignores, only the forms that change nothing are taken
_VIT_KEYS = {"type", "embed_dim", "depth", "num_heads", "patch_size",
             "interaction_indexes", "adapter_dim", "multi_input",
             "moe_block_inds"}
_INDEX_KEYS = ("moe_block_inds", "da_block_inds", "moe_block_inds_fc1",
               "moe_block_inds_fc2")
_NECK_KEYS = {"in_channels", "out_channels", "num_outs", "extra_level",
              "add_extra_convs", "relu_before_extra_convs"}
# what ReDet reads of its backbone and neck
_RE_BACKBONE_KEYS = {"type", "stem_channels", "stage_channels",
                     "stage_blocks"}
_RE_NECK_KEYS = {"type", "in_channels", "out_channels", "num_outs"}


def normalize_model_cfg(mc):
    """Translate the reference's KFIoU head types into the ``reg_loss`` /
    ``refine_reg_loss`` keys, in place, and return ``mc``."""
    def _head_type(d):
        return d.get("type", "") if isinstance(d, dict) else ""

    if _head_type(mc.get("bbox_head")).startswith("KFIoU"):
        mc.setdefault("reg_loss", "kfiou")
    for key in ("refine_head", "refine_heads"):
        heads = mc.get(key)
        heads = heads if isinstance(heads, (list, tuple)) else [heads]
        if any(_head_type(h).startswith("KFIoU") for h in heads):
            mc.setdefault("refine_reg_loss", "kfiou")
    return mc


def _check_redet(det_type: str, mc: Dict[str, Any]):
    """Raise unless ``mc`` is a ReDet on a ReResNet backbone and a ReFPN
    neck, with only the keys they read; the neck's ``in_channels``, where
    given, must be the backbone's level widths (JAX ignores the key and
    ``ReFPN`` takes the widths it is given). Drops the neck's type."""
    b, n = mc["backbone"], mc["neck"]
    btype, ntype = b.get("type"), n.get("type", "ReFPN")
    if det_type != "ReDet":
        raise NotImplementedError(
            f"backbone 'ReResNet' is ReDet's (its levels carry the "
            f"orientation channels ReFPN reads), not a {det_type!r}'s: the "
            f"other detectors take the ConvNeXt, LSKNet_moe or VAN_moe "
            f"({ZOO})")
    if btype != "ReResNet" or ntype != "ReFPN":
        raise NotImplementedError(
            f"ReDet takes the ReResNet backbone and the ReFPN neck, not "
            f"{btype or 'ConvNeXt_moe'!r} / {ntype!r} (JAX's ReDet builds "
            f"them whatever the config names)")
    for part, keys, allowed in (("backbone", b, _RE_BACKBONE_KEYS),
                                ("neck", n, _RE_NECK_KEYS)):
        extra = sorted(set(keys) - allowed)
        if extra:
            raise NotImplementedError(
                f"ReDet {part} keys {extra} are not taken: its factory reads "
                f"none of them")
    from .detectors.redet_roitrans import ORIENTATIONS, RE_STAGES
    widths = [c * ORIENTATIONS for c in b.get("stage_channels", RE_STAGES)]
    if "in_channels" in n and list(n["in_channels"]) != widths:
        raise ValueError(f"ReDet neck in_channels {list(n['in_channels'])} "
                         f"are not the ReResNet's level widths {widths}")
    n.pop("type", None)


def _check_vit_keys(b: Dict[str, Any]):
    """Raise, naming the key, for what the InternViT adapter's factory
    would ignore: a key it does not read, ``multi_input`` other than True
    (JAX builds the MultiInput stem whatever it says) or a MoE block."""
    extra = sorted(set(b) - _VIT_KEYS)
    if extra:
        raise NotImplementedError(
            f"backbone keys {extra} are not taken for InternViTAdapter: its "
            f"factory reads none of them (the JAX package's ignores them)")
    if b.get("multi_input", True) is not True:
        raise NotImplementedError(
            f"backbone key multi_input={b['multi_input']!r}: the "
            f"InternViTAdapter of a TriSource detector has the MultiInput "
            f"stem (JAX's factory ignores the key)")
    if any(tuple(x) for x in b.get("moe_block_inds", ())):
        raise NotImplementedError(
            f"backbone key moe_block_inds={b['moe_block_inds']!r}: the "
            f"InternViTAdapter has no MoE block (JAX's factory ignores the "
            f"key)")


def resolve_model_cfg(cfg_model: Dict[str, Any],
                      compute_dtype: Optional[str] = None, img_size=None):
    """What ``build_detector`` builds from a config's ``model`` dict, without
    building it: ``(detector class, its cfg, constructor keywords)``.
    Raises as ``build_detector`` does for a type, key or mode the port does
    not take. ``img_size`` (the config's) goes into the cfg of a detector
    whose backbone fixes its grid at build (the InternViT adapter)."""
    if hasattr(cfg_model, "to_dict"):
        cfg_model = cfg_model.to_dict()
    mc = normalize_model_cfg(copy.deepcopy(dict(cfg_model)))
    det_type = mc.pop("type", "TriSourceDetector")
    _check_built(DETECTORS, det_type)
    kwargs = {}
    if det_type == "TriSourceVariant":
        kwargs = dict(sar_stages=mc.pop("sar_stages", DEFAULT_STAGES),
                      rot_stages=mc.pop("rot_stages", DEFAULT_STAGES))
    b = mc["backbone"]
    b.pop("pretrained", None)
    _check_built(BACKBONES, b.get("type", "ConvNeXt_moe"))
    if det_type == "ReDet" or b.get("type") == "ReResNet":
        _check_redet(det_type, mc)
        return DETECTORS.get(det_type), mc, kwargs
    vit = b.get("type") in ("InternViT", "InternViTAdapter")
    if vit:
        _check_vit_keys(b)
        if img_size is not None:
            mc["img_size"] = img_size
    extra = [] if vit else sorted(set(b) - _BACKBONE_KEYS)
    if extra:
        raise NotImplementedError(
            f"backbone keys {extra} are not taken: the detectors' backbone "
            f"factories read none of them (the JAX package's ignore them)")
    for key in _INDEX_KEYS:
        if key in b:
            b[key] = tuple(tuple(x) for x in b[key])
    n = mc["neck"]
    neck_type = n.pop("type", "MultitaskFPN")
    _check_built(NECKS, neck_type)
    if neck_type == "SimpleFPN":
        raise NotImplementedError(
            f"neck 'SimpleFPN' takes one stride-16 map, from a plain ViT "
            f"backbone, which no ported detector has: {ZOO}")
    extra = sorted(set(n) - _NECK_KEYS)
    if extra:
        raise NotImplementedError(
            f"neck keys {extra} are not taken: the detectors' necks read "
            f"none of them (the JAX package's ignore them)")
    check_extra_convs(n.get("add_extra_convs", "on_output"))
    if compute_dtype:
        mc["compute_dtype"] = compute_dtype
    if mc.get("compute_dtype") == "float32":
        del mc["compute_dtype"]
    return DETECTORS.get(det_type), mc, kwargs


def build_detector(cfg_model: Dict[str, Any], device=None,
                   compute_dtype: Optional[str] = None, seed: int = 0,
                   trainable: bool = False, img_size=None):
    """A detector from a config's ``model`` dict, parameters from ``seed``,
    on ``device`` (the card unless ``"cpu"``). ``compute_dtype``
    ``"bfloat16"`` runs the forward in bf16: an inference model holds its
    parameters in it; a ``trainable`` one holds fp32 masters that require
    grad, in train mode (the train step hands the forward a copy in the
    compute dtype). A config's ``model.compute_dtype`` is used when
    ``compute_dtype`` is None. ``img_size`` is the config's: the InternViT
    adapter's position embedding is built for its token grid (JAX's tools
    initialise at it), and that backbone raises without it."""
    det_cls, mc, kwargs = resolve_model_cfg(cfg_model, compute_dtype,
                                            img_size)
    return det_cls(cfg=mc, device=device, seed=seed, trainable=trainable,
                   **kwargs)


def _check_built(registry, name: str):
    """Raise unless ``name`` is a class the port has (an unported name's
    entry raises when called)."""
    entry = registry.get(name)
    if not isinstance(entry, type):
        entry()
