"""ReDet and RoI Transformer.

Port of ``sm3det_tpu/models/detectors/redet_roitrans.py``, the training
losses only, as in JAX:

``ReDet``: the equivariant ``ReResNet`` and ``ReFPN`` (the C8 orientation
channels kept through the neck), the oriented RPN (64 sampled anchors an
image; its 256 best anchors an image into the NMS, which keeps 256: row
4's mask mode and the keep scan on the card), 128 rotated RoIs an image
sampled among the gts and the proposals (the assigner's IoU is row 5's
matrix mode on the card), the pyramid rotated align (rows 7 and 8), each
RoI's orientation channels aligned to its angle (``orientation_align``,
RiRoI align's second half), the rotated shared-2fc head and its loss. The
samplers' keys come from ``SampleKeys``: the RPN's, then the RoIs'.

``RoITransformer``: a single-stem backbone, the ``MultitaskFPN`` from
stride 4,

1. the horizontal RPN on the gts' enclosing boxes (``rpn_head``: 64
   sampled anchors an image; 256 proposals an image after its NMS, row 4's
   mask mode and the keep scan on the card);
2. stage 1 (``stage1_head``, ``HBB2OBBBBoxHead``): 128 horizontal RoIs an
   image sampled among the gts and the proposals, pooled at angle 0,
   classified and regressed to oriented boxes against ``hbb2obb`` of the
   RoI (``s1_loss_cls``, ``s1_loss_bbox``);
3. stage 2 (``stage2_head``, ``RotatedShared2FCBBoxHead``): 128 rotated
   RoIs an image sampled among the gts and stage 1's boxes (no gradient
   to them; the assigner's IoU is row 5's matrix mode on the card), the
   rotated align, the R-CNN loss (``s2_loss_cls``, ``s2_loss_bbox``).

The three samplers' keys come from ``SampleKeys``, in that order.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from ...core.bbox.coders import DeltaXYWHAOBBoxCoder, DeltaXYWHBBoxCoder
from ...core.bbox.samplers import SampleKeys
from ...ops.box_convert import hbb2obb, obb2xyxy
from ...ops.orientation import orientation_align
from ..backbones.re_resnet import ReFPN, ReResNet
from ..dense_heads.oriented_rpn_head import OrientedRPNHead
from ..dense_heads.rpn_head import (RPNHead, hbb_rpn_get_proposals,
                                    hbb_rpn_loss)
from ..losses import smooth_l1_loss, softmax_cross_entropy
from ..roi_heads.cascade_heads import HBB2OBBBBoxHead, roi_trans_stage1
from ..roi_heads.oriented_roi_head import (RotatedShared2FCBBoxHead,
                                           bbox_head_loss, candidate_gt_ious,
                                           sample_rois_for_training)
from ..roi_heads.standard_roi_head import (candidate_gt_overlaps,
                                           sample_hbb_rois)
from .base import DetectorBase
from .hbb_detectors import make_hbb_rpn_anchor_generator
from .trisource import (make_rcnn_coder, make_rpn_anchor_generator,
                        oriented_rcnn_losses, roi_feats)
from .zoo import ZooDetector

RPN_SAMPLE = 64         # anchors sampled an image by the RPN loss
PROPOSALS = 256         # proposals an image (nms_pre and max_per_img)
ROI_SAMPLE = 128        # RoIs sampled an image by each stage


def hbb_rpn_rois(x, rpn_head, gt_hbbs, labels, mask, keys: SampleKeys,
                 rpn_sample: int = RPN_SAMPLE, proposals: int = PROPOSALS,
                 roi_sample: int = ROI_SAMPLE, max_per_img: int | None = None):
    """The horizontal RPN of a gts' enclosing boxes (B, G, 4) and the RoIs
    sampled for the next stage: the RPN loss on ``rpn_sample`` anchors an
    image, the ``proposals`` best anchors an image into its NMS, which
    keeps ``max_per_img`` (default ``proposals``; row 4's mask mode and the
    keep scan on the card; no gradient), then ``roi_sample``
    horizontal RoIs an image among the gts and the proposals. ``keys``
    gives the RPN sampler's keys, then the RoI sampler's. Returns
    (dict(loss_rpn_cls, loss_rpn_bbox), rois5 (B * roi_sample, 5) with the
    batch index first, the images' samples)."""
    bsz, dev = gt_hbbs.shape[0], gt_hbbs.device
    anchor_gen = make_hbb_rpn_anchor_generator()
    hbb_coder = DeltaXYWHBBoxCoder()
    rpn_cls, rpn_reg = rpn_head(x)
    rpn_cls = [s.float() for s in rpn_cls]
    rpn_reg = [p.float() for p in rpn_reg]
    n_anchors = sum(s[0].numel() for s in rpn_cls)
    losses = hbb_rpn_loss(keys(n_anchors, bsz, dev), rpn_cls, rpn_reg,
                          gt_hbbs, mask, anchor_gen, hbb_coder,
                          num_sample=rpn_sample)
    with torch.no_grad():
        props, _, p_valid = hbb_rpn_get_proposals(
            [s.detach() for s in rpn_cls], [p.detach() for p in rpn_reg],
            anchor_gen, hbb_coder, None, nms_pre=proposals,
            max_per_img=max_per_img or proposals)
        k1 = keys(gt_hbbs.shape[1] + props.shape[1], bsz, dev)
        ious = candidate_gt_overlaps(props, gt_hbbs)
        sampled = [sample_hbb_rois(
            (k1[0][i], k1[1][i]), props[i], p_valid[i], gt_hbbs[i],
            labels[i], mask[i], ious[i], num=roi_sample)
            for i in range(bsz)]
        rois = torch.stack([sm["rois"] for sm in sampled])
        bidx = torch.arange(bsz, dtype=rois.dtype, device=dev) \
            .repeat_interleave(rois.shape[1])[:, None]
        rois5 = torch.cat([bidx, rois.reshape(-1, 4)], dim=-1)
    return losses, rois5, sampled


def sampled_targets(sampled, gts, labels, num_classes: int):
    """The flattened positives, valid slots, each RoI's gt (B * S, D) and
    its label (the background ``num_classes`` off the positives)."""
    pos = torch.cat([sm["pos_mask"] for sm in sampled])
    valid = pos | torch.cat([sm["neg_mask"] for sm in sampled])
    gt_idx = torch.stack([sm["gt_idx"] for sm in sampled])
    d = gts.shape[-1]
    per_roi = torch.gather(gts, 1, gt_idx[..., None].expand(-1, -1, d)) \
        .reshape(-1, d)
    lab = torch.where(pos, torch.gather(labels, 1, gt_idx).reshape(-1).long(),
                      num_classes)
    return pos, valid, per_roi, lab


def hbb2obb_stage_losses(x, rois5, sampled, head, gt_obbs, labels,
                         num_classes: int, version: str):
    """RoI Transformer's stage 1 (and RotatedFasterRCNN's R-CNN) on the
    sampled horizontal RoIs: softmax cross-entropy over the valid slots and
    Smooth L1 of the deltas of the decoded boxes against the gts'
    (``make_stage1_coder``), each divided on the device by max(count, 1)
    (5 a positive for the box loss). Returns (loss_cls, loss_bbox, the
    decoded boxes (B * S, 5))."""
    coder = make_stage1_coder(version)
    cls, obbs = roi_trans_stage1(x, rois5, head, coder, version)
    pos, valid, gts_per_roi, lab = sampled_targets(sampled, gt_obbs, labels,
                                                   num_classes)
    l_cls = softmax_cross_entropy(cls, lab, weight=valid.float(),
                                  avg_factor=1.0) / \
        torch.clamp(valid.sum().float(), min=1.0)
    priors = hbb2obb(rois5[:, 1:5], version)
    l_bbox = smooth_l1_loss(
        coder.encode(priors, obbs), coder.encode(priors, gts_per_roi),
        beta=1.0, weight=pos[:, None].float(), avg_factor=1.0) / \
        torch.clamp(pos.sum().float() * 5, min=1.0)
    return l_cls, l_bbox, obbs


def make_stage1_coder(version="le90"):
    """Stage 1's deltas of an oriented box against an ``hbb2obb`` prior."""
    return DeltaXYWHAOBBoxCoder(angle_range=version, target_means=(0.,) * 5,
                                target_stds=(0.1, 0.1, 0.2, 0.2, 0.1))


class RoITransformer(ZooDetector):
    """``rpn_head``, ``stage1_head`` and ``stage2_head``."""

    start_level = 0

    def build_heads(self, c, channels, gen):
        self.rpn_head = RPNHead(in_channels=channels, gen=gen)
        self.stage1_head = HBB2OBBBBoxHead(num_classes=c["num_classes"],
                                           in_channels=channels, gen=gen)
        self.stage2_head = RotatedShared2FCBBoxHead(
            num_classes=c["num_classes"], in_channels=channels, gen=gen)

    def forward(self, batch, gen: torch.Generator | None = None,
                sample_keys=None):
        """Training losses; ``gen`` draws the backbone's masks and noise,
        then the RPN sampler's keys and each stage's RoI sampler's
        (``sample_keys`` replaces the samplers' draws)."""
        c = self.cfg
        nc = c["num_classes"]
        version = c.get("angle_version", "le90")
        keys = SampleKeys(gen, sample_keys)
        x, gate_loss = self.extract_feat_train(batch["img"], gen)
        losses = {} if gate_loss is None else {"gate_loss": gate_loss}
        gt_obbs, labels, mask = (batch["gt_obbs"], batch["gt_labels"],
                                 batch["gt_mask"])
        bsz = gt_obbs.shape[0]
        dev = gt_obbs.device
        rpn_losses, rois5, s1 = hbb_rpn_rois(
            x, self.rpn_head, obb2xyxy(gt_obbs, version), labels, mask, keys)
        losses.update(rpn_losses)
        s = s1[0]["rois"].shape[0]
        l_cls, l_bbox, obbs1 = hbb2obb_stage_losses(
            x, rois5, s1, self.stage1_head, gt_obbs, labels, nc, version)
        losses["s1_loss_cls"], losses["s1_loss_bbox"] = l_cls, l_bbox

        # stage 2: rotated RoIs among stage 1's boxes
        with torch.no_grad():
            obbs1 = obbs1.detach().reshape(bsz, s, 5)
            k2 = keys(gt_obbs.shape[1] + s, bsz, dev)
            ious = candidate_gt_ious(obbs1, gt_obbs)
            every = torch.ones(s, dtype=torch.bool, device=dev)
            s2 = [sample_rois_for_training(
                (k2[0][i], k2[1][i]), obbs1[i], every, gt_obbs[i],
                labels[i], mask[i], ious[i], num=ROI_SAMPLE)
                for i in range(bsz)]
            rois2 = torch.stack([sm["rois"] for sm in s2])
        cl2, rp2 = self.stage2_head(roi_feats(x, rois2))
        cl2 = cl2.reshape(bsz, rois2.shape[1], -1).float()
        rp2 = rp2.reshape(bsz, rois2.shape[1], -1).float()
        coder2 = make_rcnn_coder(version)
        l_cls = l_reg = 0.0
        n_valid = 0
        for i in range(bsz):
            lc, lr, nv, _ = bbox_head_loss(cl2[i], rp2[i], s2[i], gt_obbs[i],
                                           labels[i], coder2, nc)
            l_cls, l_reg, n_valid = l_cls + lc, l_reg + lr, n_valid + nv
        total = torch.clamp(n_valid.float(), min=1.0)
        losses["s2_loss_cls"] = l_cls / total
        losses["s2_loss_bbox"] = l_reg / total
        return losses


RE_STAGES = (8, 16, 32, 64)      # JAX's ReResNet widths, an orientation
ORIENTATIONS = 8


class ReDet(DetectorBase):
    """``backbone`` (``ReResNet``: the config's ``stem_channels``,
    ``stage_channels``, ``stage_blocks``, JAX's defaults without them),
    ``neck`` (``ReFPN``: ``out_channels`` in all, ``num_outs``),
    ``rpn_head`` and ``roi_head``. Parameters from ``seed`` on
    ``device``."""

    def __init__(self, cfg: Dict[str, Any], device=None, seed: int = 0,
                 trainable: bool = False):
        super().__init__()
        self.cfg = c = copy.deepcopy(cfg)
        gen = torch.Generator().manual_seed(seed)
        b = c.get("backbone", {})
        stages = tuple(b.get("stage_channels", RE_STAGES))
        self.backbone = ReResNet(
            stem_channels=b.get("stem_channels", 8), stage_channels=stages,
            stage_blocks=tuple(b.get("stage_blocks", (2, 2, 2, 2))), gen=gen)
        n = c["neck"]
        ch = n["out_channels"]
        self.neck = ReFPN([s * ORIENTATIONS for s in stages], ch,
                          num_outs=n.get("num_outs", 5), gen=gen)
        self.rpn_head = OrientedRPNHead(in_channels=ch, gen=gen)
        self.roi_head = RotatedShared2FCBBoxHead(
            num_classes=c["num_classes"], in_channels=ch, gen=gen)
        self._place(c, device, trainable)

    def extract_feat(self, imgs):
        """The backbone and the neck: the (B, H, W, out_channels) levels,
        orientation fastest."""
        return self.neck(self.backbone(self._cast_in(imgs)))

    def forward(self, batch, gen: torch.Generator | None = None,
                sample_keys=None):
        """Training losses: dict(loss_rpn_cls, loss_rpn_bbox, loss_cls,
        loss_bbox); ``gen`` draws the RPN sampler's keys and the RoI
        sampler's (``sample_keys`` replaces the draws)."""
        c = self.cfg
        return oriented_rcnn_losses(
            self.extract_feat(batch["img"]), self.rpn_head, self.roi_head,
            batch, SampleKeys(gen, sample_keys), make_rpn_anchor_generator(),
            c.get("angle_version", "le90"), c["num_classes"],
            rpn_sample=RPN_SAMPLE, rcnn_sample=ROI_SAMPLE,
            rpn_nms_pre=PROPOSALS, rpn_max=PROPOSALS,
            align=lambda feats, rois: orientation_align(
                feats, rois[:, 4], ORIENTATIONS))
