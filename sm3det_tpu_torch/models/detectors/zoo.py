"""Single-dataset rotated and horizontal detectors.

Port of ``sm3det_tpu/models/detectors/zoo.py``: ``OrientedRCNN`` (the
DOTA / DroneVehicle specialists), ``GFLDetector`` (registered as ``GFL``,
the SARDet specialist) and ``RotatedRetinaNet``, each a single-stem
backbone, the ``MultitaskFPN`` and the heads of the TriSource branches,
with the training losses (``forward(batch, gen)``, ``batch`` one
modality's {img, gt_obbs or gt_bboxes, gt_labels, gt_mask}) and
``simple_test(imgs, img_shape)``.

The backbone is built from the config's ``type``: ``ConvNeXt_moe``, or no
type, is the single-stem ConvNeXt(-MoE) (``stem_conv``); the JAX module
builds a ConvNeXt whatever the type says. The single-stem LSKNet / VAN
(``LSKNet_moe``, ``VAN_moe``) are not ported and raise.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from ...core.bbox.samplers import SampleKeys
from ..backbones.convnext import ConvNeXtMoE
from ..dense_heads.gfl_head import GFLHead, gfl_get_bboxes, gfl_loss
from ..dense_heads.oriented_rpn_head import (OrientedRPNHead,
                                             rpn_get_proposals)
from ..dense_heads.rotated_retina_head import (RotatedRetinaHead,
                                               make_retina_anchor_generator,
                                               make_retina_coder,
                                               retina_get_bboxes,
                                               retina_loss)
from ..necks.fpn import MultitaskFPN
from ..roi_heads.oriented_roi_head import (RotatedShared2FCBBoxHead,
                                           roi_head_get_bboxes)
from .base import DetectorBase
from .trisource import (make_rcnn_coder, make_rpn_anchor_generator,
                        make_rpn_coder, make_sar_anchor_generator,
                        oriented_rcnn_losses, roi_feats)

ZOO = "ROADMAP queue 1 item 7 (the zoo)"
SINGLE_STEM_CONVNEXT = (None, "ConvNeXt_moe")


def build_zoo_backbone(b: Dict[str, Any],
                       gen: torch.Generator | None = None):
    """The single-stem backbone of a zoo config's ``backbone`` dict."""
    btype = b.get("type")
    if btype not in SINGLE_STEM_CONVNEXT:
        raise NotImplementedError(
            f"a single-dataset detector's backbone {btype!r} is not ported "
            f"to sm3det_tpu_torch (only the single-stem ConvNeXt is): {ZOO}")
    return ConvNeXtMoE(
        arch=b.get("arch", "tiny"),
        drop_path_rate=b.get("drop_path_rate", 0.0),
        moe_block_inds=tuple(tuple(i) for i in b.get(
            "moe_block_inds", ((), (), (), ()))),
        num_experts=b.get("num_experts", 2), top_k=b.get("top_k", 2),
        gate=b.get("gate", "cosine"),
        noisy_gating=b.get("noisy_gating", True),
        capacity_factor=b.get("capacity_factor", 1.5), multi_input=False,
        gen=gen)


class ZooDetector(DetectorBase):
    """A single-stem backbone and the ``MultitaskFPN`` from ``start_level``
    (0: strides 4-64, 1: strides 8-128); the subclass adds its heads in
    ``build_heads``. Parameters from ``seed`` on ``device``, as the
    TriSource detectors'."""

    start_level = 0

    def __init__(self, cfg: Dict[str, Any], device=None, seed: int = 0,
                 trainable: bool = False):
        super().__init__()
        self.cfg = c = copy.deepcopy(cfg)
        gen = torch.Generator().manual_seed(seed)
        self.backbone = build_zoo_backbone(c["backbone"], gen)
        n = c["neck"]
        self.neck = MultitaskFPN(
            in_channels=tuple(n["in_channels"]),
            out_channels=n["out_channels"], num_outs=n.get("num_outs", 5),
            extra_level=n.get("extra_level", 1), gen=gen)
        self.build_heads(c, n["out_channels"], gen)
        self._place(c, device, trainable)

    def build_heads(self, c, channels: int, gen):
        raise NotImplementedError

    def _neck(self, feats):
        return self.neck(list(feats), start_level=self.start_level,
                         add_extra_convs="on_output")

    def extract_feat(self, imgs):
        """Backbone (inference forward) and neck."""
        return self._neck(self.backbone(self._cast_in(imgs)))

    def extract_feat_train(self, imgs, gen: torch.Generator | None = None):
        """Backbone (training forward) and neck: (levels, gate_loss)."""
        feats, gate_loss = self.backbone.forward_train(self._cast_in(imgs),
                                                       gen)
        return self._neck(feats), gate_loss


class OrientedRCNN(ZooDetector):
    """Two-stage Oriented R-CNN; the config's ``rcnn`` section sets the
    samplers, the proposals and the test NMS."""

    def build_heads(self, c, channels, gen):
        self.rpn_head = OrientedRPNHead(in_channels=channels, gen=gen)
        self.roi_head = RotatedShared2FCBBoxHead(
            num_classes=c["num_classes"], in_channels=channels, gen=gen)

    def forward(self, batch, gen: torch.Generator | None = None,
                sample_keys=None):
        """Training losses; ``gen`` draws the backbone's masks and noise,
        then the RPN sampler's keys and the RoI sampler's (``sample_keys``
        replaces the samplers' draws)."""
        c = self.cfg
        r = c.get("rcnn", {})
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        losses = {} if gate_loss is None else {"gate_loss": gate_loss}
        losses.update(oriented_rcnn_losses(
            x, self.rpn_head, self.roi_head, batch,
            SampleKeys(gen, sample_keys), make_rpn_anchor_generator(),
            c.get("angle_version", "le90"), c["num_classes"],
            rpn_sample=r.get("rpn_sample", 256),
            rcnn_sample=r.get("rcnn_sample", 512),
            rpn_nms_pre=r.get("rpn_nms_pre", 2000),
            rpn_max=r.get("rpn_max", 2000),
            rpn_nms_iou=r.get("rpn_nms_iou", 0.8)))
        return losses

    def get_proposals(self, rpn_cls, rpn_reg, img_shape):
        """Proposal decode, top-k and per-level NMS in fp32."""
        r = self.cfg.get("rcnn", {})
        return rpn_get_proposals(
            [s.float() for s in rpn_cls], [p.float() for p in rpn_reg],
            make_rpn_anchor_generator(),
            make_rpn_coder(self.cfg.get("angle_version", "le90")),
            img_shape, nms_pre=r.get("rpn_nms_pre", 2000),
            max_per_img=r.get("rpn_max", 2000),
            iou_thr=r.get("rpn_nms_iou", 0.8))

    def get_bboxes(self, cls_logits, reg_pred, proposals, p_valid,
                   img_shape):
        """R-CNN decode and multi-class rotated NMS in fp32."""
        c = self.cfg
        r = c.get("rcnn", {})
        return roi_head_get_bboxes(
            cls_logits.float(), reg_pred.float(), proposals, p_valid,
            make_rcnn_coder(c.get("angle_version", "le90")),
            c["num_classes"], img_shape=img_shape,
            score_thr=r.get("score_thr", 0.05), iou_thr=r.get("nms_iou", 0.1),
            max_per_img=r.get("max_per_img", 2000))

    @torch.no_grad()
    def simple_test(self, imgs, img_shape):
        """(dets (B, max_per_img, 6), labels, valid)."""
        x = self.extract_feat(imgs)
        proposals, _, p_valid = self.get_proposals(*self.rpn_head(x),
                                                   img_shape)
        bsz, s = proposals.shape[:2]
        cls_logits, reg_pred = self.roi_head(roi_feats(x, proposals))
        return self.get_bboxes(cls_logits.reshape(bsz, s, -1),
                               reg_pred.reshape(bsz, s, -1), proposals,
                               p_valid, img_shape)


class GFLDetector(ZooDetector):
    """Single-stage horizontal GFL (the JAX head's defaults: ``reg_max``
    16, strides 8-128)."""

    start_level = 1

    def build_heads(self, c, channels, gen):
        self.bbox_head = GFLHead(num_classes=c["num_classes"],
                                 in_channels=channels, gen=gen)

    def forward(self, batch, gen: torch.Generator | None = None):
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        cls_scores, bbox_preds = self.bbox_head(x)
        losses = gfl_loss(
            [s.float() for s in cls_scores], [p.float() for p in bbox_preds],
            batch["gt_bboxes"], batch["gt_labels"], batch["gt_mask"],
            make_sar_anchor_generator(), self.cfg["num_classes"])
        if gate_loss is not None:
            losses["gate_loss"] = gate_loss
        return losses

    @torch.no_grad()
    def simple_test(self, imgs, img_shape):
        """(dets (B, 100, 5), labels, valid)."""
        cls_scores, bbox_preds = self.bbox_head(self.extract_feat(imgs))
        return gfl_get_bboxes(
            [s.float() for s in cls_scores], [p.float() for p in bbox_preds],
            make_sar_anchor_generator(), self.cfg["num_classes"], img_shape)


class RotatedRetinaNet(ZooDetector):
    """Single-stage rotated RetinaNet (``reg_loss`` ``"l1"`` unless the
    config says ``"smooth_l1"``)."""

    start_level = 1

    def build_heads(self, c, channels, gen):
        self.bbox_head = RotatedRetinaHead(num_classes=c["num_classes"],
                                           in_channels=channels, gen=gen)

    def forward(self, batch, gen: torch.Generator | None = None):
        c = self.cfg
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        cls_scores, bbox_preds = self.bbox_head(x)
        losses = retina_loss(
            [s.float() for s in cls_scores], [p.float() for p in bbox_preds],
            batch["gt_obbs"], batch["gt_labels"], batch["gt_mask"],
            make_retina_anchor_generator(),
            make_retina_coder(c.get("angle_version", "le90")),
            c["num_classes"], reg_loss=c.get("reg_loss", "l1"))
        if gate_loss is not None:
            losses["gate_loss"] = gate_loss
        return losses

    @torch.no_grad()
    def simple_test(self, imgs, img_shape):
        """(dets (B, 2000, 6), labels, valid)."""
        c = self.cfg
        cls_scores, bbox_preds = self.bbox_head(self.extract_feat(imgs))
        return retina_get_bboxes(
            [s.float() for s in cls_scores], [p.float() for p in bbox_preds],
            make_retina_anchor_generator(),
            make_retina_coder(c.get("angle_version", "le90")),
            c["num_classes"], img_shape)
