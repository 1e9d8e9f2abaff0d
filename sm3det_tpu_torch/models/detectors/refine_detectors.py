"""Refinement-stage rotated detectors: R3Det and S2ANet.

Port of ``sm3det_tpu/models/detectors/refine_detectors.py``, NHWC:

- ``R3Det``: a single-stem backbone, the ``MultitaskFPN`` from stride 8,
  a rotated RetinaNet stage with one square anchor a cell (``s0_`` losses:
  sigmoid focal, Smooth L1 beta 0.11), then refine stages (``sr{i}_``):
  each location's anchor refined by the first stage's regression
  (detached), the features re-sampled at the refined anchors
  (``ops/geometry_extras.py::rotated_feature_align``, 5 points) and a
  ``RefineHead`` regressing from the refined anchors; the refine
  assigner is MaxIoU at 0.6 / 0.5 on the rotated IoU (row 5's matrix mode
  on the card, one launch a stage), the box loss Smooth L1 or, with
  ``refine_reg_loss="kfiou"``, KFIoU;
- ``S2ANet``: the same skeleton whose refine stage is the ODM head
  (``ODMRefineHead``): the aligned features through ``ORConv`` (one base
  filter an output plane, expanded into 8 rotated copies), the regressor
  on those orientation-sensitive features, the classifier on their
  rotation-invariant pooling.

``simple_test`` decodes the last stage's outputs against its own refined
anchors and runs the multi-class rotated NMS (row 6's banded mask mode and
the keep scan on the card).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchor import RotatedAnchorGenerator
from ...core.bbox.assigners import max_iou_assign
from ...core.bbox.coders import DeltaXYWHAOBBoxCoder
from ...ops.geometry_extras import rotated_feature_align
from ...ops.nms import _take, multiclass_nms_rotated
from ...ops.orientation import arf_expand, rotation_invariant_pool
from ...ops.rotated_iou import box_iou_rotated_chunked
from ..dense_heads.rotated_retina_head import RotatedRetinaHead, retina_loss
from ..layers import Conv2d
from ..losses import kfiou_loss, sigmoid_focal_loss, smooth_l1_loss
from ..moe import stable_topk
from .zoo import ZooDetector

REFINE_STRIDES = (8, 16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def make_refine_anchor_generator():
    """One square anchor a cell (octave base scale 4), strides 8-128; made
    once (it keeps the grids it has made on a device)."""
    return RotatedAnchorGenerator(strides=list(REFINE_STRIDES), ratios=[1.0],
                                  octave_base_scale=4, scales_per_octave=1)


def make_refine_coder(version="le90"):
    """The refinement detectors' delta coder: every target std 1.0."""
    return DeltaXYWHAOBBoxCoder(angle_range=version, target_means=(0.,) * 5,
                                target_stds=(1., 1., 1., 1., 1.))


def _towers(module, x, stacked_convs, cf=None):
    """The cls and reg towers (3x3 conv + ReLU each layer) on ``x`` (the
    cls tower on ``cf`` when given)."""
    cf = x if cf is None else cf
    rf = x
    for i in range(stacked_convs):
        cf = torch.relu(getattr(module, f"cls_conv{i}")(cf))
    for i in range(stacked_convs):
        rf = torch.relu(getattr(module, f"reg_conv{i}")(rf))
    return cf, rf


class RefineHead(nn.Module):
    """R3Det's refine stage: features aligned to the refined anchors, two
    3x3 conv layers a tower, then ``refine_cls`` and ``refine_reg`` with
    one anchor a location."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 2,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.stacked_convs = stacked_convs
        for tower in ("cls", "reg"):
            for i in range(stacked_convs):
                setattr(self, f"{tower}_conv{i}", Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1, gen=gen))
        self.refine_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                                 gen=gen)
        self.refine_reg = Conv2d(feat_channels, 5, 3, padding=1, gen=gen)

    def forward(self, feats, refined_anchors_maps, strides):
        """feats / refined maps: per level (B, H, W, C) / (B, H, W, 5).
        Returns per level cls (B, H, W, classes), reg (B, H, W, 5)."""
        cls_scores, bbox_preds = [], []
        for x, anchors, stride in zip(feats, refined_anchors_maps, strides):
            x = rotated_feature_align(x, anchors, points=5,
                                      spatial_scale=1.0 / stride)
            cf, rf = _towers(self, x, self.stacked_convs)
            cls_scores.append(self.refine_cls(cf))
            bbox_preds.append(self.refine_reg(rf))
        return cls_scores, bbox_preds


class ORConv(nn.Module):
    """Oriented convolution: one base filter an output plane, ``weight``
    (Cout, Cin, n_orient, k, k), expanded by ``arf_expand`` into ``n_rot``
    rotated copies; output channels (Cout, n_rot), rotation fastest, the
    bias added after the convolution."""

    def __init__(self, in_channels: int, out_channels: int,
                 n_orient: int = 1, n_rot: int = 8, kernel_size: int = 3,
                 gen: torch.Generator | None = None):
        super().__init__()
        k = kernel_size
        cin = in_channels // n_orient
        self.n_rot, self.kernel_size = n_rot, k
        self.weight = nn.Parameter(torch.randn(
            out_channels, cin, n_orient, k, k, generator=gen)
            * math.sqrt(2.0 / (cin * n_orient * k * k)))
        self.bias = nn.Parameter(torch.zeros(out_channels * n_rot))

    def forward(self, x):
        kernel = arf_expand(self.weight, self.n_rot).to(x.dtype)
        pad = self.kernel_size // 2
        y = F.conv2d(x.permute(0, 3, 1, 2), kernel, None, 1, pad)
        return y.permute(0, 2, 3, 1) + self.bias.to(y.dtype)


class ODMRefineHead(nn.Module):
    """S2ANet's Oriented Detection Module: the aligned features through
    ``or_conv`` (``feat_channels / n_rot`` planes x ``n_rot`` rotations);
    the reg tower on them, the cls tower on their rotation-invariant
    pooling (``feat_channels / n_rot`` channels into ``cls_conv0``), then
    ``odm_cls`` and ``odm_reg``."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 2,
                 n_rot: int = 8, gen: torch.Generator | None = None):
        super().__init__()
        self.stacked_convs, self.n_rot = stacked_convs, n_rot
        planes = feat_channels // n_rot
        self.or_conv = ORConv(in_channels, planes, n_rot=n_rot, gen=gen)
        for tower, first in (("cls", planes), ("reg", planes * n_rot)):
            for i in range(stacked_convs):
                setattr(self, f"{tower}_conv{i}", Conv2d(
                    first if i == 0 else feat_channels, feat_channels, 3,
                    padding=1, gen=gen))
        self.odm_cls = Conv2d(feat_channels, num_classes, 3, padding=1,
                              gen=gen)
        self.odm_reg = Conv2d(feat_channels, 5, 3, padding=1, gen=gen)

    def forward(self, feats, refined_anchors_maps, strides):
        cls_scores, bbox_preds = [], []
        for x, anchors, stride in zip(feats, refined_anchors_maps, strides):
            x = rotated_feature_align(x, anchors, points=5,
                                      spatial_scale=1.0 / stride)
            or_feat = self.or_conv(x)
            cf, rf = _towers(self, or_feat, self.stacked_convs,
                             rotation_invariant_pool(or_feat, self.n_rot))
            cls_scores.append(self.odm_cls(cf))
            bbox_preds.append(self.odm_reg(rf))
        return cls_scores, bbox_preds


def refine_anchor_maps(bbox_preds, anchors_l, coder: DeltaXYWHAOBBoxCoder):
    """Each location's anchor refined by the stage-1 regression, with no
    gradient to it: (maps (B, H, W, 5) per level, flat (B, N_lvl, 5) per
    level), fp32."""
    maps, flat = [], []
    for bp, a in zip(bbox_preds, anchors_l):
        b, h, w, _ = bp.shape
        deltas = bp.detach().float().reshape(b, -1, 5)
        ref = coder.decode(a[None].expand(deltas.shape), deltas)
        maps.append(ref.reshape(b, h, w, 5))
        flat.append(ref)
    return maps, flat


def refine_loss(cls_scores, bbox_preds, refined_anchors, gt_obbs,
                gt_labels, gt_mask, coder: DeltaXYWHAOBBoxCoder,
                num_classes: int, reg_loss: str = "smooth_l1"):
    """One refine stage's losses over a batch: per-level outputs in fp32,
    the refined anchors (B, N, 5) of every location. MaxIoU (0.6 / 0.5,
    low-quality matches) on the rotated IoU of the refined anchors with
    the gts, sigmoid focal loss on the assigned (positive or negative)
    locations, Smooth L1 (beta 0.11) or KFIoU on the positives. Returns
    (loss_cls, loss_bbox), each divided by the batch's positives."""
    b = cls_scores[0].shape[0]
    flat_cls = torch.cat([s.reshape(b, -1, num_classes) for s in cls_scores],
                         dim=1)
    flat_reg = torch.cat([p.reshape(b, -1, 5) for p in bbox_preds], dim=1)
    ious_all = box_iou_rotated_chunked(refined_anchors, gt_obbs)
    l_cls = l_reg = 0.0
    n_pos = 0
    for i in range(b):
        gts, mask, anchors = gt_obbs[i], gt_mask[i], refined_anchors[i]
        ious = torch.where(mask[None, :], ious_all[i],
                           torch.full_like(ious_all[i], -1.0))
        assigned = max_iou_assign(ious, mask, pos_iou_thr=0.6,
                                  neg_iou_thr=0.5, min_pos_iou=0.0,
                                  match_low_quality=True)
        pos = assigned > 0
        gt_idx = torch.clamp(assigned.long() - 1, min=0)
        tgt_cls = torch.where(pos, gt_labels[i][gt_idx].long(), num_classes)
        l_cls = l_cls + sigmoid_focal_loss(
            flat_cls[i], tgt_cls, weight=(assigned >= 0).float(),
            avg_factor=1.0)
        targets = coder.encode(anchors, gts[gt_idx])
        if reg_loss == "kfiou":
            l_reg = l_reg + kfiou_loss(
                flat_reg[i], targets, coder.decode(anchors, flat_reg[i]),
                gts[gt_idx], weight=pos.float(), avg_factor=1.0)
        else:
            l_reg = l_reg + smooth_l1_loss(
                flat_reg[i], targets, beta=0.11, weight=pos[:, None].float(),
                avg_factor=1.0)
        n_pos = n_pos + pos.sum()
    total = torch.clamp(n_pos.float(), min=1.0)
    return l_cls / total, l_reg / total


def refine_get_bboxes(cls_scores, bbox_preds, refined_anchors,
                      coder: DeltaXYWHAOBBoxCoder, num_classes: int,
                      nms_pre: int = 2000, score_thr: float = 0.05,
                      iou_thr: float = 0.1, max_per_img: int = 2000):
    """Per level the top ``nms_pre`` locations by their best class score
    (``stable_topk``: ties to the lower index, as ``lax.top_k``), decoded
    against the refined anchors (B, N_lvl, 5) of that level; then the
    multi-class rotated NMS over all levels' candidates. Returns
    (dets (B, max_per_img, 6), labels, valid)."""
    b = cls_scores[0].shape[0]
    cand_boxes, cand_scores = [], []
    for cls_s, reg_s, anc in zip(cls_scores, bbox_preds, refined_anchors):
        scores = torch.sigmoid(cls_s.reshape(b, -1, num_classes))
        k = min(nms_pre, scores.shape[1])
        _, top_idx = stable_topk(scores.amax(dim=-1), k)
        cand_boxes.append(coder.decode(
            _take(anc, top_idx), _take(reg_s.reshape(b, -1, 5), top_idx)))
        cand_scores.append(_take(scores, top_idx))
    boxes = torch.cat(cand_boxes, dim=1)
    scores = torch.cat(cand_scores, dim=1)
    scores = torch.cat([scores, scores.new_zeros(scores.shape[:2] + (1,))],
                       dim=-1)
    return multiclass_nms_rotated(
        boxes, scores, score_thr=score_thr, iou_thr=iou_thr,
        max_num=max_per_img, pre_nms=min(2000, boxes.shape[1]))


class R3Det(ZooDetector):
    """A rotated RetinaNet stage and ``num_refine_stages`` refine stages
    (``refine_head{i}``); ``cfg["refine_reg_loss"]`` ``"smooth_l1"``
    (default) or ``"kfiou"``."""

    start_level = 1
    num_refine_stages = 1
    refine_head_type = "generic"        # "generic" (R3Det) | "odm" (S2ANet)

    def build_heads(self, c, channels, gen):
        self.bbox_head = RotatedRetinaHead(num_classes=c["num_classes"],
                                           in_channels=channels,
                                           num_anchors=1, gen=gen)
        head_cls = ODMRefineHead if self.refine_head_type == "odm" \
            else RefineHead
        for i in range(self.num_refine_stages):
            setattr(self, f"refine_head{i}", head_cls(
                num_classes=c["num_classes"], in_channels=channels,
                feat_channels=channels, gen=gen))

    @property
    def refine_heads(self) -> Sequence[nn.Module]:
        return [getattr(self, f"refine_head{i}")
                for i in range(self.num_refine_stages)]

    def _coder(self):
        return make_refine_coder(self.cfg.get("angle_version", "le90"))

    def _first_stage(self, x):
        """Stage-1 outputs in fp32, the anchors of its levels and the
        refined anchors (maps and flat)."""
        cls_scores, bbox_preds = self.bbox_head(x)
        cls_scores = [s.float() for s in cls_scores]
        bbox_preds = [p.float() for p in bbox_preds]
        sizes = [tuple(s.shape[1:3]) for s in cls_scores]
        anchors_l = make_refine_anchor_generator().grid_anchors(
            sizes, device=cls_scores[0].device)
        maps, flat = refine_anchor_maps(bbox_preds, anchors_l, self._coder())
        return cls_scores, bbox_preds, maps, flat

    def forward(self, batch, gen: torch.Generator | None = None):
        """Training losses: ``s0_loss_cls`` / ``s0_loss_bbox`` of the retina
        stage, ``sr{i}_loss_cls`` / ``sr{i}_loss_bbox`` of each refine
        stage (each from the stage-1 refined anchors), and the gate loss
        of an MoE backbone; ``gen`` draws the backbone's masks and
        noise."""
        c = self.cfg
        nc = c["num_classes"]
        coder = self._coder()
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        losses = {} if gate_loss is None else {"gate_loss": gate_loss}
        cls_scores, bbox_preds, maps, flat = self._first_stage(x)
        s1 = retina_loss(cls_scores, bbox_preds, batch["gt_obbs"],
                         batch["gt_labels"], batch["gt_mask"],
                         make_refine_anchor_generator(), coder, nc)
        losses.update({f"s0_{k}": v for k, v in s1.items()})
        refined = torch.cat(flat, dim=1)
        for i, head in enumerate(self.refine_heads):
            r_cls, r_reg = head(x, maps, REFINE_STRIDES)
            l_cls, l_reg = refine_loss(
                [s.float() for s in r_cls], [p.float() for p in r_reg],
                refined, batch["gt_obbs"], batch["gt_labels"],
                batch["gt_mask"], coder, nc,
                reg_loss=c.get("refine_reg_loss", "smooth_l1"))
            losses[f"sr{i}_loss_cls"] = l_cls
            losses[f"sr{i}_loss_bbox"] = l_reg
        return losses

    @torch.no_grad()
    def simple_test(self, imgs, img_shape=(800, 800), score_thr: float = 0.05,
                    iou_thr: float = 0.1, max_per_img: int = 2000):
        """The stage-1 regression refines the anchors, each refine stage
        but the last refines them again, and the last stage's outputs are
        decoded against its own refined anchors into the multi-class
        rotated NMS. Returns (dets (B, max_per_img, 6), labels, valid)."""
        del img_shape
        coder = self._coder()
        x = self.extract_feat(imgs)
        _, _, maps, flat = self._first_stage(x)
        heads = self.refine_heads
        r_cls = r_reg = None
        for i, head in enumerate(heads):
            r_cls, r_reg = head(x, maps, REFINE_STRIDES)
            if i + 1 < len(heads):
                maps = [coder.decode(m.reshape(m.shape[0], -1, 5),
                                     p.float().reshape(p.shape[0], -1, 5))
                        .reshape(m.shape) for m, p in zip(maps, r_reg)]
                flat = [m.reshape(m.shape[0], -1, 5) for m in maps]
        return refine_get_bboxes(
            [s.float() for s in r_cls], [p.float() for p in r_reg], flat,
            coder, self.cfg["num_classes"], score_thr=score_thr,
            iou_thr=iou_thr, max_per_img=max_per_img)


class S2ANet(R3Det):
    """R3Det's skeleton with one refine stage, the ODM head."""

    refine_head_type = "odm"
