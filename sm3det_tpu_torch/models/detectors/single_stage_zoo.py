"""Gliding Vertex, rotated FCOS and Oriented RepPoints.

Port of ``GlidingVertex``, ``RotatedFCOS`` and ``OrientedRepPoints`` of
``sm3det_tpu/models/detectors/single_stage_zoo.py``, with the training
losses only, as in JAX (``forward(batch, gen)``, ``batch`` one modality's
{img, gt_obbs, gt_labels, gt_mask}):

- ``GlidingVertex``: the ``MultitaskFPN`` from stride 4, the horizontal RPN
  on the gts' enclosing boxes (64 anchors sampled an image, 256 proposals),
  128 horizontal RoIs an image sampled among the gts and the proposals,
  pooled at angle 0 (row 7 forward, row 8 backward on the card) into
  ``GVBBoxHead``: softmax cross-entropy, Smooth L1 on the horizontal deltas
  (``loss_bbox``), on the sliding fractions (``loss_fix``, beta 1/3) and on
  the area ratio (``loss_ratio``, beta 1/3, times 16);
- ``RotatedFCOS``: the neck from stride 8 (P3-P7) and ``RotatedFCOSHead``
  with ``fcos_loss``;
- ``OrientedRepPoints``: the neck from stride 8 and
  ``OrientedRepPointsHead`` (GroupNorm of ``gn_groups`` groups) with
  ``reppoints_loss``.
"""

from __future__ import annotations

import torch

from ...core.bbox.coders import DeltaXYWHBBoxCoder
from ...core.bbox.gv_coders import GVFixCoder, GVRatioCoder
from ...core.bbox.samplers import SampleKeys
from ...ops.box_convert import obb2xyxy
from ..dense_heads.oriented_reppoints_head import (OrientedRepPointsHead,
                                                   reppoints_loss)
from ..dense_heads.rotated_fcos_head import RotatedFCOSHead, fcos_loss
from ..dense_heads.rpn_head import RPNHead
from ..losses import smooth_l1_loss, softmax_cross_entropy
from ..roi_heads.cascade_heads import GVBBoxHead
from ..roi_heads.standard_roi_head import extract_hbb_roi_feats
from .redet_roitrans import hbb_rpn_rois, sampled_targets
from .zoo import ZooDetector


class GlidingVertex(ZooDetector):
    """``rpn_head`` and ``roi_head`` (``GVBBoxHead``)."""

    start_level = 0

    def build_heads(self, c, channels, gen):
        self.rpn_head = RPNHead(in_channels=channels, gen=gen)
        self.roi_head = GVBBoxHead(num_classes=c["num_classes"],
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
        gt_hbbs = obb2xyxy(gt_obbs, version)
        rpn_losses, rois5, sampled = hbb_rpn_rois(
            x, self.rpn_head, gt_hbbs, labels, batch["gt_mask"],
            SampleKeys(gen, sample_keys))
        losses.update(rpn_losses)
        cls, reg, fix, ratio = (o.float() for o in self.roi_head(
            extract_hbb_roi_feats(x, rois5)))
        pos, valid, gt_obb_per, lab = sampled_targets(
            sampled, gt_obbs, labels, c["num_classes"])
        gt_hbb_per = obb2xyxy(gt_obb_per, version)
        w = pos[:, None].float()
        n_valid = torch.clamp(valid.sum().float(), min=1.0)
        n_pos = torch.clamp(pos.sum().float(), min=1.0)
        losses["loss_cls"] = softmax_cross_entropy(
            cls, lab, weight=valid.float(), avg_factor=1.0) / n_valid
        losses["loss_bbox"] = smooth_l1_loss(
            reg, DeltaXYWHBBoxCoder().encode(rois5[:, 1:5], gt_hbb_per),
            beta=1.0, weight=w, avg_factor=1.0) / (n_pos * 4)
        losses["loss_fix"] = smooth_l1_loss(
            fix, GVFixCoder(version).encode(gt_obb_per), beta=1.0 / 3.0,
            weight=w, avg_factor=1.0) / (n_pos * 4)
        losses["loss_ratio"] = smooth_l1_loss(
            ratio, GVRatioCoder(version).encode(gt_obb_per), beta=1.0 / 3.0,
            weight=w, avg_factor=1.0) / n_pos * 16
        return losses


class RotatedFCOS(ZooDetector):
    """``bbox_head`` (``RotatedFCOSHead``, GroupNorm of ``gn_groups``
    groups)."""

    start_level = 1

    def build_heads(self, c, channels, gen):
        self.bbox_head = RotatedFCOSHead(
            num_classes=c["num_classes"], in_channels=channels,
            feat_channels=channels, gn_groups=c.get("gn_groups", 32),
            gen=gen)

    def forward(self, batch, gen: torch.Generator | None = None):
        c = self.cfg
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        outs = [[o.float() for o in lvl] for lvl in self.bbox_head(x)]
        losses = fcos_loss(*outs, batch["gt_obbs"], batch["gt_labels"],
                           batch["gt_mask"], c["num_classes"],
                           version=c.get("angle_version", "le90"))
        if gate_loss is not None:
            losses["gate_loss"] = gate_loss
        return losses


class OrientedRepPoints(ZooDetector):
    """``bbox_head`` (``OrientedRepPointsHead``, GroupNorm of
    ``gn_groups`` groups)."""

    start_level = 1
    head_cls = OrientedRepPointsHead

    def build_heads(self, c, channels, gen):
        self.bbox_head = self.head_cls(
            num_classes=c["num_classes"], in_channels=channels,
            feat_channels=channels, gn_groups=c.get("gn_groups", 32),
            gen=gen)

    def loss(self, outs, batch):
        c = self.cfg
        return reppoints_loss(*outs, batch["gt_obbs"], batch["gt_labels"],
                              batch["gt_mask"], c["num_classes"],
                              version=c.get("angle_version", "le90"))

    def forward(self, batch, gen: torch.Generator | None = None):
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        losses = self.loss(self.bbox_head(x), batch)
        if gate_loss is not None:
            losses["gate_loss"] = gate_loss
        return losses
