"""The TriSource head-combination variants.

Port of ``sm3det_tpu/models/detectors/trisource_variants.py``: one module,
``TriSourceVariant(cfg, sar_stages, rot_stages)``, over the flagship's
shared backbone (``build_multi_input_backbone``) and ``MultitaskFPN``:

- ``sar_stages=1``: the SAR GFL head (``sar_bbox_head``); ``2``: a
  horizontal Faster R-CNN (``sar_rpn_head``, ``sar_roi_head``) with the
  JAX module's fixed settings: anchors of strides 4-64, ratios (0.5, 1, 2)
  and scale 8, 1000 proposals an image from the top 1000 of each level,
  256 sampled RoIs;
- ``rot_stages=1``: a rotated RetinaNet head per modality
  (``{rgb,ifr}_bbox_head``, L1 on the retina coder's deltas); ``2``: the
  flagship's Oriented R-CNN branches (``{rgb,ifr}_rpn_head``,
  ``{rgb,ifr}_roi_head``).

The 1/2 pair is the flagship's own combination. ``forward(batch, gen)``
returns the loss dict of the JAX ``__call__``. The JAX package has no
inference for the variants (no ``simple_test``), and neither has the
port. The GFL, RPN and RetinaNet heads use the JAX module's defaults
(``reg_max`` 16, 256 feature channels), whatever the config's ``sar``
section says.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from ...core.bbox.samplers import SampleKeys
from ..dense_heads.gfl_head import GFLHead, gfl_loss
from ..dense_heads.oriented_rpn_head import OrientedRPNHead
from ..dense_heads.rotated_retina_head import (RotatedRetinaHead,
                                               make_retina_anchor_generator,
                                               make_retina_coder,
                                               retina_loss)
from ..dense_heads.rpn_head import RPNHead
from ..necks.fpn import MultitaskFPN
from ..roi_heads.oriented_roi_head import RotatedShared2FCBBoxHead
from ..roi_heads.standard_roi_head import Shared2FCBBoxHead
from .base import DetectorBase
from .hbb_detectors import hbb_rcnn_losses
from .trisource import (build_multi_input_backbone, composition_ids,
                        make_rpn_anchor_generator, make_sar_anchor_generator,
                        oriented_rcnn_losses, roi_feats)

STAGES = (1, 2)
# the stage numbers of a config that leaves them out (the JAX module's
# defaults)
DEFAULT_STAGES = 1


class TriSourceVariant(DetectorBase):
    """SM3Det with ``sar_stages`` / ``rot_stages`` in {1, 2}. ``cfg``
    follows the flagship's ``DEFAULT_MODEL_CFG``; parameters from
    ``seed`` on ``device``, as ``TriSourceDetector``'s."""

    def __init__(self, cfg: Dict[str, Any], device=None, seed: int = 0,
                 trainable: bool = False, sar_stages: int = DEFAULT_STAGES,
                 rot_stages: int = DEFAULT_STAGES):
        super().__init__()
        if sar_stages not in STAGES or rot_stages not in STAGES:
            raise ValueError(f"sar_stages / rot_stages ({sar_stages}, "
                             f"{rot_stages}): each one of {STAGES}")
        if cfg.get("multi_tasks_reweight") is not None:
            raise ValueError("TriSourceVariant takes no "
                             "multi_tasks_reweight (the JAX module has "
                             "none)")
        self.cfg = c = copy.deepcopy(cfg)
        self.sar_stages, self.rot_stages = sar_stages, rot_stages
        gen = torch.Generator().manual_seed(seed)
        self.backbone = build_multi_input_backbone(c["backbone"], gen,
                                                   c.get("img_size"))
        n = c["neck"]
        ch = n["out_channels"]
        self.neck = MultitaskFPN(
            in_channels=tuple(n["in_channels"]), out_channels=ch,
            num_outs=n["num_outs"], extra_level=n.get("extra_level", 1),
            gen=gen)
        nc = c["num_classes"]
        if sar_stages == 1:
            self.sar_bbox_head = GFLHead(num_classes=nc, in_channels=ch,
                                         gen=gen)
        else:
            self.sar_rpn_head = RPNHead(in_channels=ch, gen=gen)
            self.sar_roi_head = Shared2FCBBoxHead(num_classes=nc,
                                                  in_channels=ch, gen=gen)
        for m in ("rgb", "ifr"):
            if rot_stages == 1:
                setattr(self, f"{m}_bbox_head", RotatedRetinaHead(
                    num_classes=nc, in_channels=ch, gen=gen))
            else:
                setattr(self, f"{m}_rpn_head",
                        OrientedRPNHead(in_channels=ch, gen=gen))
        if rot_stages == 2:
            for m in ("rgb", "ifr"):
                setattr(self, f"{m}_roi_head", RotatedShared2FCBBoxHead(
                    num_classes=nc, in_channels=ch, gen=gen))
        self._place(c, device, trainable)

    def forward(self, batch, gen: torch.Generator | None = None,
                sample_keys=None):
        """Training forward: the loss dict of the JAX ``__call__``.

        ``batch`` as ``TriSourceDetector.forward``'s. ``gen`` draws, in
        order, the backbone's stochastic-depth masks and gate noise, then
        the samplers' keys: the SAR RPN's and RoIs' (H2), then per R2
        modality the RPN's and the RoIs'. ``sample_keys`` (a list of
        (key_pos, key_neg) pairs) replaces the samplers' draws.
        """
        c = self.cfg
        nc = c["num_classes"]
        keys = SampleKeys(gen, sample_keys)
        imgs = [self._cast_in(batch[k]["img"]) for k in ("sar", "rgb", "ifr")]
        n_sar, n_rgb = imgs[0].shape[0], imgs[1].shape[0]
        feats, gate_loss = self.backbone.forward_train(
            torch.cat(imgs, 0), gen,
            composition_ids(n_sar, n_rgb, imgs[2].shape[0]))
        losses: Dict[str, torch.Tensor] = {}
        if gate_loss is not None:
            losses["gate_loss"] = gate_loss

        sar = batch["sar"]
        sar_f = [f[:n_sar] for f in feats]
        if self.sar_stages == 1:
            x = self.neck(sar_f, start_level=1, add_extra_convs="on_output")
            cls_scores, bbox_preds = self.sar_bbox_head(x)
            sl = gfl_loss(
                [s.float() for s in cls_scores],
                [p.float() for p in bbox_preds], sar["gt_bboxes"],
                sar["gt_labels"], sar["gt_mask"],
                make_sar_anchor_generator(), nc)
        else:
            x = self.neck(sar_f, start_level=0, add_extra_convs="on_output")
            sl = hbb_rcnn_losses(x, self.sar_rpn_head, [self.sar_roi_head],
                                 sar, keys, nc)
        losses.update({f"sar_{k}": v for k, v in sl.items()})

        r = c["rgb"]
        for key, sl_m in (("rgb", slice(n_sar, n_sar + n_rgb)),
                          ("ifr", slice(n_sar + n_rgb, None))):
            data = batch[key]
            feats_m = [f[sl_m] for f in feats]
            if self.rot_stages == 1:
                x = self.neck(feats_m, start_level=1,
                              add_extra_convs="on_output")
                cls_scores, bbox_preds = getattr(self, f"{key}_bbox_head")(x)
                rl = retina_loss(
                    [s.float() for s in cls_scores],
                    [p.float() for p in bbox_preds], data["gt_obbs"],
                    data["gt_labels"], data["gt_mask"],
                    make_retina_anchor_generator(),
                    make_retina_coder(c["angle_version"]), nc,
                    reg_loss="l1")
            else:
                x = self.neck(feats_m, start_level=0,
                              add_extra_convs="on_output")
                rl = oriented_rcnn_losses(
                    x, getattr(self, f"{key}_rpn_head"),
                    getattr(self, f"{key}_roi_head"), data, keys,
                    make_rpn_anchor_generator(), c["angle_version"], nc,
                    rcnn_sample=r["rcnn_sample"],
                    rpn_nms_pre=r["rpn_nms_pre"], rpn_max=r["rpn_max"],
                    rpn_nms_iou=r["rpn_nms_iou"])
            losses.update({f"{key}_{k}": v for k, v in rl.items()})
        return losses


def TriSourceOneOneDetector(cfg, **kwargs):
    """H1-R1: SAR GFL + RGB / infrared rotated RetinaNet."""
    return TriSourceVariant(cfg, sar_stages=1, rot_stages=1, **kwargs)


def TriSourceTwoOneDetector(cfg, **kwargs):
    """H2-R1: SAR Faster R-CNN + RGB / infrared rotated RetinaNet."""
    return TriSourceVariant(cfg, sar_stages=2, rot_stages=1, **kwargs)


def TriSourceTwoTwoDetector(cfg, **kwargs):
    """H2-R2: SAR Faster R-CNN + RGB / infrared Oriented R-CNN."""
    return TriSourceVariant(cfg, sar_stages=2, rot_stages=2, **kwargs)
