"""Horizontal-box detectors: Faster R-CNN, Cascade R-CNN, RetinaNet.

Port of ``sm3det_tpu/models/detectors/hbb_detectors.py`` (the SARDet
specialists ``sardet50k_convnext_t_{frcnn,cascade,retina}``), with the
training losses only, as in JAX: a single-stem backbone, the
``MultitaskFPN``, then

- ``FasterRCNN`` / ``CascadeRCNN``: the horizontal ``RPNHead``, then one
  or three ``Shared2FCBBoxHead`` stages (``bbox_head{i}``); the cascade's
  stages sample at IoU 0.5 / 0.6 / 0.7 with delta stds ``STAGE_STDS``,
  each stage's sampled RoIs decoded by its first class's deltas as the
  next stage's proposals; ``hbb_rcnn_losses`` is also the SAR branch of
  the H2 TriSource variants;
- ``RetinaNet``: the RetinaNet layers at the top level of the model (as
  the flax module holds them), 9 anchors a cell, sigmoid focal loss and
  Smooth L1 (beta 0.11) on the horizontal deltas.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from ...core.anchor import AnchorGenerator
from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.coders import DeltaXYWHBBoxCoder
from ...core.bbox.samplers import SampleKeys
from ...ops.nms import bbox_overlaps
from ..dense_heads.rotated_retina_head import (build_retina_layers,
                                               retina_forward)
from ..dense_heads.rpn_head import (RPNHead, hbb_rpn_get_proposals,
                                    hbb_rpn_loss)
from ..losses import sigmoid_focal_loss, smooth_l1_loss
from ..roi_heads.standard_roi_head import (Shared2FCBBoxHead,
                                           candidate_gt_overlaps,
                                           hbb_head_loss, sample_hbb_rois)
from .trisource import roi_feats
from .zoo import ZooDetector

# the cascade's stage IoU thresholds and delta stds (mmdet CascadeRCNN)
STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))


@functools.lru_cache(maxsize=None)
def make_hbb_rpn_anchor_generator():
    """The horizontal RPN's anchors: strides 4-64, scale 8, ratios
    (0.5, 1, 2); made once (it keeps the grids it has made on a device)."""
    return AnchorGenerator(strides=[4, 8, 16, 32, 64],
                           ratios=[0.5, 1.0, 2.0], scales=[8])


@functools.lru_cache(maxsize=None)
def make_hbb_retina_anchor_generator():
    """RetinaNet's horizontal anchors: strides 8-128, 3 scales an octave
    from 4, ratios (0.5, 1, 2)."""
    return AnchorGenerator(strides=[8, 16, 32, 64, 128],
                           ratios=[0.5, 1.0, 2.0], octave_base_scale=4,
                           scales_per_octave=3)


def hbb_rcnn_losses(x, rpn_head, roi_heads: Sequence, data,
                    keys: SampleKeys, num_classes: int,
                    rpn_sample: int = 256, nms_pre: int = 1000,
                    max_per_img: int = 1000, rcnn_sample: int = 256,
                    stage_ious=(0.5,), stage_stds=((1., 1., 1., 1.),)):
    """The losses of a horizontal Faster (one head) or Cascade R-CNN on the
    neck's levels ``x``: the RPN loss, the proposals (no gradient), then
    per stage the RoI sampling at ``stage_ious[i]``, the align at angle 0
    and the R-CNN loss on deltas of ``stage_stds[i]``. ``data``:
    {gt_bboxes (B, G, 4), gt_labels, gt_mask}; ``keys`` gives the RPN
    sampler's keys, then each stage's RoI sampler's. Returns
    dict(loss_rpn_cls, loss_rpn_bbox, loss_cls, loss_bbox), the stage
    losses as ``s{i}_loss_cls`` / ``s{i}_loss_bbox`` with several
    stages."""
    gen = make_hbb_rpn_anchor_generator()
    rpn_coder = DeltaXYWHBBoxCoder()
    gts, labels, mask = data["gt_bboxes"], data["gt_labels"], data["gt_mask"]
    rpn_cls, rpn_reg = rpn_head(x)
    rpn_cls = [s.float() for s in rpn_cls]
    rpn_reg = [p.float() for p in rpn_reg]
    bsz = rpn_cls[0].shape[0]
    dev = rpn_cls[0].device
    n_anchors = sum(s[0].numel() for s in rpn_cls)
    losses = hbb_rpn_loss(keys(n_anchors, bsz, dev), rpn_cls, rpn_reg, gts,
                          mask, gen, rpn_coder, num_sample=rpn_sample)
    with torch.no_grad():
        cur, cur_valid = hbb_rpn_get_proposals(
            [s.detach() for s in rpn_cls], [p.detach() for p in rpn_reg],
            gen, rpn_coder, None, nms_pre=nms_pre,
            max_per_img=max_per_img)[::2]
    for stage, roi_head in enumerate(roi_heads):
        iou = stage_ious[stage]
        coder = DeltaXYWHBBoxCoder(target_stds=stage_stds[stage])
        with torch.no_grad():
            rkeys = keys(gts.shape[1] + cur.shape[1], bsz, dev)
            ious = candidate_gt_overlaps(cur, gts)
            sampled = [sample_hbb_rois(
                (rkeys[0][i], rkeys[1][i]), cur[i], cur_valid[i], gts[i],
                labels[i], mask[i], ious[i], num=rcnn_sample,
                pos_iou_thr=iou, neg_iou_thr=iou, min_pos_iou=iou)
                for i in range(bsz)]
            rois = torch.stack([sm["rois"] for sm in sampled])
        s = rois.shape[1]
        cls_logits, reg_pred = roi_head(roi_feats(x, rois, box_dim=4))
        cls_logits = cls_logits.reshape(bsz, s, -1).float()
        reg_pred = reg_pred.reshape(bsz, s, -1).float()
        l_cls = l_reg = 0.0
        n_valid = 0
        for i in range(bsz):
            lc, lr, nv, _ = hbb_head_loss(cls_logits[i], reg_pred[i],
                                          sampled[i], gts[i], labels[i],
                                          coder, num_classes)
            l_cls, l_reg, n_valid = l_cls + lc, l_reg + lr, n_valid + nv
        total = torch.clamp(n_valid.float(), min=1.0)
        prefix = "" if len(roi_heads) == 1 else f"s{stage}_"
        losses[f"{prefix}loss_cls"] = l_cls / total
        losses[f"{prefix}loss_bbox"] = l_reg / total
        if stage + 1 < len(roi_heads):
            # the next stage's proposals: this stage's RoIs refined
            cur = coder.decode(rois, reg_pred.detach()[..., :4])
            cur_valid = torch.stack([sm["pos_mask"] | sm["neg_mask"]
                                     for sm in sampled])
    return losses


class _TwoStageHBB(ZooDetector):
    num_stages = 1

    def build_heads(self, c, channels, gen):
        self.rpn_head = RPNHead(in_channels=channels, gen=gen)
        for i in range(self.num_stages):
            setattr(self, f"bbox_head{i}", Shared2FCBBoxHead(
                num_classes=c["num_classes"], in_channels=channels,
                gen=gen))

    def forward(self, batch, gen: torch.Generator | None = None,
                sample_keys=None):
        """Training losses; ``gen`` draws the backbone's masks and noise,
        then the RPN sampler's keys and each stage's RoI sampler's
        (``sample_keys`` replaces the samplers' draws)."""
        c = self.cfg
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        losses = {} if gate_loss is None else {"gate_loss": gate_loss}
        losses.update(hbb_rcnn_losses(
            x, self.rpn_head,
            [getattr(self, f"bbox_head{i}") for i in range(self.num_stages)],
            batch, SampleKeys(gen, sample_keys), c["num_classes"],
            rpn_sample=c.get("rpn_sample", 64),
            nms_pre=c.get("rpn_nms_pre", 256),
            max_per_img=c.get("rpn_max", 256),
            rcnn_sample=c.get("rcnn_sample", 128),
            stage_ious=STAGE_IOUS, stage_stds=STAGE_STDS))
        return losses


class FasterRCNN(_TwoStageHBB):
    """One R-CNN stage (mmdet FasterRCNN)."""

    num_stages = 1


class CascadeRCNN(_TwoStageHBB):
    """Three R-CNN stages at rising IoU thresholds."""

    num_stages = 3


class RetinaNet(ZooDetector):
    """Horizontal RetinaNet (mmdet RetinaNet): its towers as wide as the
    neck."""

    start_level = 1

    def build_heads(self, c, channels, gen):
        build_retina_layers(self, c["num_classes"], channels, channels, 4,
                            9, 4, gen)

    def forward(self, batch, gen: torch.Generator | None = None):
        nc = self.cfg["num_classes"]
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        cls_scores, bbox_preds = retina_forward(self, x)
        dev = cls_scores[0].device
        coder = DeltaXYWHBBoxCoder()
        sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors = torch.cat(make_hbb_retina_anchor_generator().grid_anchors(
            sizes, device=dev), dim=0)
        b = cls_scores[0].shape[0]
        flat_cls = torch.cat([s.float().reshape(b, -1, nc)
                              for s in cls_scores], dim=1)
        flat_reg = torch.cat([p.float().reshape(b, -1, 4)
                              for p in bbox_preds], dim=1)
        l_cls = l_reg = 0.0
        n_pos = 0
        for i in range(b):
            gts, mask = batch["gt_bboxes"][i], batch["gt_mask"][i]
            ious = bbox_overlaps(anchors, gts)
            ious = torch.where(mask[None, :], ious,
                               torch.full_like(ious, -1.0))
            assigned = max_iou_assign(ious, mask, pos_iou_thr=0.5,
                                      neg_iou_thr=0.4, min_pos_iou=0.0,
                                      match_low_quality=True)
            pos = assigned > 0
            gt_idx = torch.clamp(assigned.long() - 1, min=0)
            cls_t = torch.where(pos, batch["gt_labels"][i][gt_idx].long(),
                                nc)
            l_cls = l_cls + sigmoid_focal_loss(
                flat_cls[i], cls_t, weight=(pos | (assigned == 0)).float(),
                avg_factor=1.0)
            l_reg = l_reg + smooth_l1_loss(
                flat_reg[i], coder.encode(anchors, gts[gt_idx]), beta=0.11,
                weight=pos[:, None].float(), avg_factor=1.0)
            n_pos = n_pos + pos.sum()
        total = torch.clamp(torch.as_tensor(n_pos, device=dev).float(),
                            min=1.0)
        losses = {"loss_cls": l_cls / total, "loss_bbox": l_reg / total}
        if gate_loss is not None:
            losses["gate_loss"] = gate_loss
        return losses
