"""Model registries and the detector builder of the config files.

Port of the registry part of ``sm3det_tpu/models/__init__.py``: the names a
config's ``type`` may take, and ``normalize_model_cfg``. The port registers
what it has: the ``TriSourceDetector`` with a ConvNeXt-MoE backbone
(``ConvNeXt_moe``, ``ConvNeXt_moe_MultiInput``) and the ``MultitaskFPN``.
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

from ..utils.registry import BACKBONES, DETECTORS, NECKS
from .backbones.convnext import ConvNeXtMoE
from .detectors.trisource import TriSourceDetector
from .necks.fpn import MultitaskFPN

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
NECKS.register_module("MultitaskFPN", module=MultitaskFPN)
DETECTORS.register_module("TriSourceDetector", module=TriSourceDetector)

for _name, _item in [("ConvNeXt_DA_MultiInput", LEFTOVERS)] + [
        (n, ZOO) for n in (
            "LSKNet_moe", "LSKNet_moe_MultiInput", "LSKNet", "VAN",
            "VAN_moe", "VAN_moe_MultiInput", "SwinTransformer_moe",
            "SwinTransformer_MoE", "SwinTransformer", "InternViT",
            "InternViTAdapter", "ReResNet")]:
    BACKBONES.register_module(_name, module=_unported("backbone", _name,
                                                      _item))
for _name, _item in (("FPN", LEFTOVERS), ("SimpleFPN", LEFTOVERS),
                     ("ReFPN", ZOO)):
    NECKS.register_module(_name, module=_unported("neck", _name, _item))
for _name in ("TriSourceVariant", "OrientedRCNN", "RotatedRetinaNet", "GFL",
              "R3Det", "S2ANet", "ReDet", "RoITransformer", "RotatedFCOS",
              "GlidingVertex", "OrientedRepPoints", "RotatedFasterRCNN",
              "RotatedRepPoints", "SAMRepPoints", "GRepPoints",
              "RotatedATSS", "FasterRCNN", "CascadeRCNN", "RetinaNet"):
    DETECTORS.register_module(_name, module=_unported("detector", _name,
                                                      ZOO))

# the backbone keys TriSourceDetector reads (besides type and pretrained)
_BACKBONE_KEYS = {"arch", "drop_path_rate", "moe_block_inds", "num_experts",
                  "top_k", "gate", "noisy_gating", "capacity_factor",
                  "use_da"}
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
    det_cls = DETECTORS.get(mc.pop("type", "TriSourceDetector"))
    b = mc["backbone"]
    b.pop("pretrained", None)
    _check_built(BACKBONES, b.pop("type", "ConvNeXt_moe"))
    extra = sorted(set(b) - _BACKBONE_KEYS)
    if extra:
        raise NotImplementedError(
            f"backbone keys {extra} are not ported: {LEFTOVERS}")
    if "moe_block_inds" in b:
        b["moe_block_inds"] = tuple(tuple(x) for x in b["moe_block_inds"])
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
    return det_cls(cfg=mc, device=device, seed=seed, trainable=trainable)


def _check_built(registry, name: str):
    """Raise unless ``name`` is a class the port has (an unported name's
    entry raises when called)."""
    entry = registry.get(name)
    if not isinstance(entry, type):
        entry()
