"""Model registries and the detector builder of the config files.

Port of the registry part of ``sm3det_tpu/models/__init__.py``: the names a
config's ``type`` may take, and ``normalize_model_cfg``. The port registers
what it has:

- detectors: ``TriSourceDetector`` with a ConvNeXt-MoE, LSKNet-MoE or
  VAN-MoE backbone (``ConvNeXt_moe``, ``ConvNeXt_moe_MultiInput``,
  ``LSKNet``, ``LSKNet_moe_MultiInput``, ``VAN``, ``VAN_moe_MultiInput``),
  ``TriSourceVariant`` (its ``sar_stages`` / ``rot_stages`` from the
  config), and the single-dataset ``OrientedRCNN``, ``GFL``,
  ``RotatedRetinaNet``, ``FasterRCNN``, ``CascadeRCNN``, ``RetinaNet``,
  ``R3Det``, ``S2ANet`` and ``RoITransformer`` on the single-stem
  ConvNeXt (``ConvNeXt_moe`` or no backbone type);
- the ``MultitaskFPN``, and the heads those detectors use.

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
from .backbones.lsknet import LSKNetMoE
from .backbones.van import VANMoE
from .dense_heads.gfl_head import GFLHead
from .dense_heads.oriented_rpn_head import OrientedRPNHead
from .dense_heads.rotated_retina_head import CSLRetinaHead, RotatedRetinaHead
from .dense_heads.rpn_head import RPNHead
from .detectors.hbb_detectors import CascadeRCNN, FasterRCNN, RetinaNet
from .detectors.redet_roitrans import RoITransformer
from .detectors.refine_detectors import (ODMRefineHead, R3Det, RefineHead,
                                         S2ANet)
from .detectors.trisource import TriSourceDetector
from .detectors.trisource_variants import DEFAULT_STAGES, TriSourceVariant
from .detectors.zoo import GFLDetector, OrientedRCNN, RotatedRetinaNet
from .necks.fpn import MultitaskFPN
from .roi_heads.cascade_heads import HBB2OBBBBoxHead
from .roi_heads.oriented_roi_head import RotatedShared2FCBBoxHead
from .roi_heads.standard_roi_head import Shared2FCBBoxHead

ZOO = "ROADMAP queue 1 item 7 (the zoo)"
LEFTOVERS = "ROADMAP queue 1 item 5 (backbone and neck leftovers)"


def _unported(kind: str, name: str, item: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"{kind} {name!r} is not ported to sm3det_tpu_torch: {item}")
    build.__name__ = name
    return build


BACKBONES.register_module("ConvNeXt_moe", module=ConvNeXtMoE)
BACKBONES.register_module("ConvNeXt_moe_MultiInput", module=ConvNeXtMoE)
for _name, _cls in (("LSKNet", LSKNetMoE), ("LSKNet_moe_MultiInput",
                                            LSKNetMoE),
                    ("VAN", VANMoE), ("VAN_moe_MultiInput", VANMoE)):
    BACKBONES.register_module(_name, module=_cls)
NECKS.register_module("MultitaskFPN", module=MultitaskFPN)
for _name, _cls in (("TriSourceDetector", TriSourceDetector),
                    ("TriSourceVariant", TriSourceVariant),
                    ("OrientedRCNN", OrientedRCNN), ("GFL", GFLDetector),
                    ("RotatedRetinaNet", RotatedRetinaNet),
                    ("FasterRCNN", FasterRCNN), ("CascadeRCNN", CascadeRCNN),
                    ("RetinaNet", RetinaNet), ("R3Det", R3Det),
                    ("S2ANet", S2ANet), ("RoITransformer", RoITransformer)):
    DETECTORS.register_module(_name, module=_cls)
# the JAX package's head names (the KFIoU ones select the box loss through
# normalize_model_cfg); CSLRRetinaHead raises on construction
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
                    ("KFIoURRetinaRefineHead", RefineHead)):
    HEADS.register_module(_name, module=_cls)
for _name in ("RotatedFCOSHead", "OrientedRepPointsHead", "GVBBoxHead",
              "RotatedATSSHead", "RotatedRepPointsHead", "SAMRepPointsHead",
              "CSLRFCOSHead", "RotatedAnchorFreeHead"):
    HEADS.register_module(_name, module=_unported("head", _name, ZOO))

for _name, _item in [("ConvNeXt_DA_MultiInput", LEFTOVERS)] + [
        (n, ZOO) for n in (
            "LSKNet_moe", "VAN_moe", "SwinTransformer_moe",
            "SwinTransformer_MoE", "SwinTransformer", "InternViT",
            "InternViTAdapter", "ReResNet")]:
    BACKBONES.register_module(_name, module=_unported("backbone", _name,
                                                      _item))
for _name, _item in (("FPN", LEFTOVERS), ("SimpleFPN", LEFTOVERS),
                     ("ReFPN", ZOO)):
    NECKS.register_module(_name, module=_unported("neck", _name, _item))
for _name in ("ReDet", "RotatedFCOS", "GlidingVertex", "OrientedRepPoints",
              "RotatedFasterRCNN", "RotatedRepPoints", "SAMRepPoints",
              "GRepPoints", "RotatedATSS"):
    DETECTORS.register_module(_name, module=_unported("detector", _name,
                                                      ZOO))

# the backbone keys TriSourceDetector reads (besides pretrained)
_BACKBONE_KEYS = {"type", "arch", "drop_path_rate", "moe_block_inds", "num_experts",
                  "top_k", "gate", "noisy_gating", "capacity_factor",
                  "use_da", "embed_dims", "depths", "moe_block_inds_fc1",
                  "moe_block_inds_fc2"}
_INDEX_KEYS = ("moe_block_inds", "moe_block_inds_fc1", "moe_block_inds_fc2")
_NECK_KEYS = {"in_channels", "out_channels", "num_outs", "extra_level",
              "add_extra_convs"}


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


def build_detector(cfg_model: Dict[str, Any], device=None,
                   compute_dtype: Optional[str] = None, seed: int = 0,
                   trainable: bool = False):
    """A detector from a config's ``model`` dict, parameters from ``seed``,
    on ``device`` (the card unless ``"cpu"``). ``compute_dtype``
    ``"bfloat16"`` runs the forward in bf16: an inference model holds its
    parameters in it; a ``trainable`` one holds fp32 masters that require
    grad, in train mode (the train step hands the forward a copy in the
    compute dtype). A config's ``model.compute_dtype`` is used when
    ``compute_dtype`` is None."""
    if hasattr(cfg_model, "to_dict"):
        cfg_model = cfg_model.to_dict()
    mc = normalize_model_cfg(copy.deepcopy(dict(cfg_model)))
    det_type = mc.pop("type", "TriSourceDetector")
    det_cls = DETECTORS.get(det_type)
    kwargs = {}
    if det_type == "TriSourceVariant":
        kwargs = dict(sar_stages=mc.pop("sar_stages", DEFAULT_STAGES),
                      rot_stages=mc.pop("rot_stages", DEFAULT_STAGES))
    b = mc["backbone"]
    b.pop("pretrained", None)
    _check_built(BACKBONES, b.get("type", "ConvNeXt_moe"))
    extra = sorted(set(b) - _BACKBONE_KEYS)
    if extra:
        raise NotImplementedError(
            f"backbone keys {extra} are not ported: {LEFTOVERS}")
    for key in _INDEX_KEYS:
        if key in b:
            b[key] = tuple(tuple(x) for x in b[key])
    n = mc["neck"]
    _check_built(NECKS, n.pop("type", "MultitaskFPN"))
    extra = sorted(set(n) - _NECK_KEYS)
    if extra or n.get("add_extra_convs", "on_output") != "on_output":
        raise NotImplementedError(
            f"neck settings {extra or n['add_extra_convs']!r} are not "
            f"ported: {LEFTOVERS}")
    if compute_dtype:
        mc["compute_dtype"] = compute_dtype
    if mc.get("compute_dtype") == "float32":
        del mc["compute_dtype"]
    return det_cls(cfg=mc, device=device, seed=seed, trainable=trainable,
                   **kwargs)


def _check_built(registry, name: str):
    """Raise unless ``name`` is a class the port has (an unported name's
    entry raises when called)."""
    entry = registry.get(name)
    if not isinstance(entry, type):
        entry()
