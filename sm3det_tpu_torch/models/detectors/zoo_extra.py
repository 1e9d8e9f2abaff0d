"""Rotated Faster R-CNN, rotated ATSS and the RepPoints variants.

Port of ``RotatedFasterRCNN``, ``RotatedATSS``, ``RotatedRepPoints``,
``SAMRepPoints`` and ``GRepPoints`` of
``sm3det_tpu/models/detectors/zoo_extra.py``, with the training losses
only, as in JAX:

- ``RotatedFasterRCNN``: the ``MultitaskFPN`` from stride 4, the
  horizontal RPN on the gts' enclosing boxes (``rpn_sample`` anchors,
  ``rpn_nms_pre`` / ``rpn_max`` proposals an image, default 64 / 256 /
  256), ``rcnn_sample`` horizontal RoIs (128) pooled at angle 0 (row 7
  forward, row 8 backward on the card) into ``HBB2OBBBBoxHead``, whose
  deltas against ``hbb2obb`` of the RoI regress the oriented gts: RoI
  Transformer's stage 1 under the names ``loss_cls`` / ``loss_bbox``;
- ``RotatedATSS``: the neck from stride 8 and ``RotatedATSSHead`` (one
  anchor a cell) with ``atss_loss``; the assigner's IoU is row 5's matrix
  mode on the card;
- ``RotatedRepPoints``, ``SAMRepPoints``, ``GRepPoints``: Oriented
  RepPoints' neck and tower with ``reppoints_variant_loss`` of the
  ``rotated``, ``sam`` and ``kld`` variants (the config's
  ``spatial_border`` adds the spatial border losses).
"""

from __future__ import annotations

import torch

from ...core.bbox.coders import DeltaXYWHAOBBoxCoder
from ...core.bbox.samplers import SampleKeys
from ...ops.box_convert import obb2xyxy
from ..dense_heads.reppoints_variants import reppoints_variant_loss
from ..dense_heads.rotated_atss_head import (RotatedATSSHead, atss_loss,
                                             make_atss_anchor_generator)
from ..dense_heads.rpn_head import RPNHead
from ..roi_heads.cascade_heads import HBB2OBBBBoxHead
from .redet_roitrans import hbb2obb_stage_losses, hbb_rpn_rois
from .single_stage_zoo import OrientedRepPoints
from .zoo import ZooDetector


class RotatedFasterRCNN(ZooDetector):
    """``rpn_head`` and ``bbox_head`` (``HBB2OBBBBoxHead``)."""

    start_level = 0

    def build_heads(self, c, channels, gen):
        self.rpn_head = RPNHead(in_channels=channels, gen=gen)
        self.bbox_head = HBB2OBBBBoxHead(num_classes=c["num_classes"],
                                         in_channels=channels, gen=gen)

    def forward(self, batch, gen: torch.Generator | None = None,
                sample_keys=None):
        """Training losses; ``gen`` draws the backbone's masks and noise,
        then the RPN sampler's keys and the RoI sampler's (``sample_keys``
        replaces the samplers' draws)."""
        c = self.cfg
        version = c.get("angle_version", "le90")
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        losses = {} if gate_loss is None else {"gate_loss": gate_loss}
        gt_obbs, labels = batch["gt_obbs"], batch["gt_labels"]
        rpn_losses, rois5, sampled = hbb_rpn_rois(
            x, self.rpn_head, obb2xyxy(gt_obbs, version), labels,
            batch["gt_mask"], SampleKeys(gen, sample_keys),
            rpn_sample=c.get("rpn_sample", 64),
            proposals=c.get("rpn_nms_pre", 256),
            roi_sample=c.get("rcnn_sample", 128),
            max_per_img=c.get("rpn_max", 256))
        losses.update(rpn_losses)
        losses["loss_cls"], losses["loss_bbox"], _ = hbb2obb_stage_losses(
            x, rois5, sampled, self.bbox_head, gt_obbs, labels,
            c["num_classes"], version)
        return losses


class RotatedATSS(ZooDetector):
    """``bbox_head`` (``RotatedATSSHead``); ``atss_topk`` candidates a
    level (9)."""

    start_level = 1

    def build_heads(self, c, channels, gen):
        self.bbox_head = RotatedATSSHead(num_classes=c["num_classes"],
                                         in_channels=channels,
                                         feat_channels=channels, gen=gen)

    def forward(self, batch, gen: torch.Generator | None = None):
        c = self.cfg
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        cls_s, reg_s = self.bbox_head(x)
        losses = atss_loss(
            [s.float() for s in cls_s], [p.float() for p in reg_s],
            batch["gt_obbs"], batch["gt_labels"], batch["gt_mask"],
            make_atss_anchor_generator(),
            DeltaXYWHAOBBoxCoder(angle_range=c.get("angle_version", "le90")),
            c["num_classes"], topk=c.get("atss_topk", 9))
        if gate_loss is not None:
            losses["gate_loss"] = gate_loss
        return losses


class _RepPointsVariant(OrientedRepPoints):
    """``OrientedRepPoints``' head (``OrientedRepPointsHead``, registered
    under the variants' head names too); the loss differs."""

    variant = "rotated"

    def loss(self, outs, batch):
        c = self.cfg
        return reppoints_variant_loss(
            *outs, batch["gt_obbs"], batch["gt_labels"], batch["gt_mask"],
            c["num_classes"], version=c.get("angle_version", "le90"),
            variant=self.variant,
            spatial_border=c.get("spatial_border", False))


class RotatedRepPoints(_RepPointsVariant):
    """The convex GIoU recipe, MaxConvexIoU refine assignment."""


class SAMRepPoints(_RepPointsVariant):
    """SASM: the refine stage assigned by ``sas_assign``."""

    variant = "sam"


class GRepPoints(_RepPointsVariant):
    """G-RepPoints: the KLD point-set loss on both stages."""

    variant = "kld"
