"""TriSource detector.

Port of ``sm3det_tpu/models/detectors/trisource.py::TriSourceDetector``:
the shared backbone (ConvNeXt-MoE, with Domain Attention for
``ConvNeXt_DA_MultiInput`` / ``use_da``, LSKNet-MoE or VAN-MoE in
MultiInput mode, or the BabelRS ``InternViTAdapter`` built for
``cfg["img_size"]``, ``build_multi_input_backbone``), the MultitaskFPN, the
SAR GFL head and the RGB and infrared Oriented R-CNN branches (oriented
RPN, pyramid rotated RoI align, shared-2fc head).

- Inference: ``simple_test_sar/rgb/ifr``, ``simple_test_joint`` (one
  backbone pass over the three modalities, one proposal NMS, one align and
  one R-CNN NMS over rgb + infrared) and ``aug_test``. Each entry point is
  split into ``head_*`` (the network) and ``get_*``/``get_bboxes_*``
  (decode and NMS), so that a caller can feed the same network outputs to
  two devices.
- Every backbone pass hands it the images' dataset ids as JAX's does: 0
  for ``simple_test_sar``, 1 / 2 for the RGB / infrared ``simple_test``
  (and so ``aug_test``), the batch composition for ``simple_test_joint``
  and training. Only DA blocks read them.
- Training: ``forward(batch, gen)`` returns the loss dict of the JAX
  ``__call__`` (GFL losses of the SAR images, RPN and R-CNN losses of the
  RGB and infrared images, the MoE gate loss); the random draws come from
  ``gen``. With ``multi_tasks_reweight="uncertainty"`` the model holds
  the learned ``mtl_sigma`` (ones, one per ``REWEIGHT_LOSS_KEYS`` entry)
  and adds ``reweighted_total_losses`` = sum 0.5 / sigma_i^2 L_i +
  log(1 + sigma_i^2), the individual losses then reported detached. DWA
  lives in the train step (``train/train_state.py``).

The compute-dtype policy is that of ``_cast_in``: with
``compute_dtype="bfloat16"`` the images are bf16 and so are the parameters
the forward sees (convs and products in bf16, norm statistics in fp32);
head outputs are cast to fp32 before decode, NMS and the losses. An
inference model holds its parameters in the compute dtype, frozen; a
``trainable=True`` model holds fp32 masters, and the train step hands the
forward a bf16 copy (``train/train_state.py``).
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchor import AnchorGenerator
from ...core.bbox.coders import DeltaXYWHAOBBoxCoder, MidpointOffsetCoder
from ...core.bbox.samplers import SampleKeys
from ...ops.box_convert import norm_angle
from ...ops.nms import aug_multiclass_nms_rotated
from ..backbones.convnext import ConvNeXtMoE
from ..backbones.intern_vit import InternViTAdapter
from ..backbones.lsknet import LSKNetMoE
from ..backbones.van import VANMoE
from ..dense_heads.gfl_head import GFLHead, gfl_get_bboxes, gfl_loss
from ..dense_heads.oriented_rpn_head import (OrientedRPNHead,
                                             rpn_get_proposals, rpn_loss)
from ..necks.fpn import MultitaskFPN
from ..roi_heads.oriented_roi_head import (RotatedShared2FCBBoxHead,
                                           bbox_head_loss,
                                           candidate_gt_ious,
                                           extract_rotated_roi_feats,
                                           roi_head_get_bboxes,
                                           sample_rois_for_training)
from ..roi_heads.standard_roi_head import extract_hbb_roi_feats
from .base import ZOO, DetectorBase

DEFAULT_MODEL_CFG: Dict[str, Any] = dict(
    num_classes=26,
    angle_version="le90",
    backbone=dict(
        arch="tiny",
        drop_path_rate=0.1,
        moe_block_inds=((), (), (0, 2, 4, 6, 8), (0, 2)),
        num_experts=8,
        top_k=3,
        gate="cosine",
        capacity_factor=1.5,
    ),
    neck=dict(in_channels=(96, 192, 384, 768), out_channels=256,
              num_outs=5, extra_level=1, add_extra_convs="on_output"),
    sar=dict(strides=(8, 16, 32, 64, 128), reg_max=16,
             nms_pre=1000, score_thr=0.05, nms_iou=0.6, max_per_img=100),
    rgb=dict(rpn_strides=(4, 8, 16, 32, 64),
             rpn_sample=256, rcnn_sample=512,
             rpn_nms_pre=2000, rpn_max=2000, rpn_nms_iou=0.8,
             rcnn_score_thr=0.05, rcnn_nms_iou=0.1, rcnn_max=2000),
)


# the anchor generators are made once per setting: each keeps the grids it
# has made on a device, so a forward copies no anchors to the card
@functools.lru_cache(maxsize=None)
def make_sar_anchor_generator(strides=(8, 16, 32, 64, 128)):
    """GFL: single anchor per cell, octave base 8."""
    return AnchorGenerator(strides=strides, ratios=[1.0],
                           octave_base_scale=8, scales_per_octave=1)


@functools.lru_cache(maxsize=None)
def make_rpn_anchor_generator(strides=(4, 8, 16, 32, 64)):
    """Oriented RPN: scales [8] x ratios [.5, 1, 2]."""
    return AnchorGenerator(strides=strides, ratios=[0.5, 1.0, 2.0],
                           scales=[8])


def make_rpn_coder(version="le90"):
    return MidpointOffsetCoder(
        angle_range=version, target_means=(0.,) * 6,
        target_stds=(1., 1., 1., 1., 0.5, 0.5))


def make_rcnn_coder(version="le90"):
    return DeltaXYWHAOBBoxCoder(
        angle_range=version, target_means=(0.,) * 5,
        target_stds=(0.1, 0.1, 0.2, 0.2, 0.1), edge_swap=True, proj_xy=True)


# the losses the uncertainty and DWA reweighting weigh, in JAX's order
REWEIGHT_LOSS_KEYS = (
    "sar_loss_cls", "sar_loss_bbox", "sar_loss_dfl",
    "rgb_loss_rpn_cls", "rgb_loss_rpn_bbox", "rgb_loss_cls",
    "rgb_loss_bbox", "ifr_loss_rpn_cls", "ifr_loss_rpn_bbox",
    "ifr_loss_cls", "ifr_loss_bbox")
REWEIGHT_MODES = (None, "uncertainty", "dwa")
# the dataset id of each modality, as the JAX entry points pass them to the
# backbone's domain attention
DATASET_IDS = {"sar": 0, "rgb": 1, "ifr": 2}


def composition_ids(n_sar: int, n_rgb: int, n_ifr: int):
    """The dataset ids of a batch of SAR, then RGB, then infrared images:
    Python ints, the batch composition (JAX's static ``source_ratio``)."""
    return (0,) * n_sar + (1,) * n_rgb + (2,) * n_ifr


def build_multi_input_backbone(b: Dict[str, Any],
                               gen: torch.Generator | None = None,
                               img_size=None):
    """The backbone of a TriSource config's ``backbone`` dict, in
    MultiInput mode, with the JAX factory's type names and defaults.
    ``img_size`` (the config's, an int or (H, W)) fixes the InternViT
    adapter's position-embedding grid; the other backbones take any
    size."""
    btype = b.get("type", "ConvNeXt")
    if btype == "InternViTAdapter":
        # BabelRS (configs/BabelRS_configs/BabelRS_20kstep.py)
        if img_size is None:
            raise ValueError(
                "an InternViTAdapter backbone needs the image size its "
                "position embedding is built for: pass img_size (the "
                "config's) to build_detector")
        return InternViTAdapter(
            img_size, embed_dim=b.get("embed_dim", 1024),
            depth=b.get("depth", 24), num_heads=b.get("num_heads", 16),
            patch_size=b.get("patch_size", 16),
            interaction_indexes=tuple(b.get("interaction_indexes",
                                            (5, 11, 17, 23))),
            adapter_dim=b.get("adapter_dim", 256), multi_input=True,
            gen=gen)
    common = dict(
        drop_path_rate=b.get("drop_path_rate", 0.0),
        num_experts=b.get("num_experts", 2), top_k=b.get("top_k", 2),
        gate=b.get("gate", "cosine"),
        noisy_gating=b.get("noisy_gating", True),
        capacity_factor=b.get("capacity_factor", 1.5), gen=gen)
    if btype in ("ConvNeXt", "ConvNeXt_moe", "ConvNeXt_moe_MultiInput",
                 "ConvNeXt_DA_MultiInput"):
        return ConvNeXtMoE(
            arch=b.get("arch", "tiny"),
            moe_block_inds=tuple(tuple(i) for i in b.get(
                "moe_block_inds", ((), (), (), ()))),
            use_da=b.get("use_da", False),
            da_block_inds=tuple(tuple(i) for i in b.get(
                "da_block_inds", ((), (), (), ()))), **common)
    if btype in ("LSKNet", "LSKNet_moe_MultiInput", "VAN",
                 "VAN_moe_MultiInput"):
        cls = LSKNetMoE if btype.startswith("LSK") else VANMoE
        return cls(
            embed_dims=tuple(b.get("embed_dims", (32, 64, 160, 256))),
            depths=tuple(b.get("depths", (3, 3, 5, 2))),
            moe_block_inds_fc1=tuple(tuple(i) for i in b.get(
                "moe_block_inds_fc1", ((), (), (), ()))),
            moe_block_inds_fc2=tuple(tuple(i) for i in b.get(
                "moe_block_inds_fc2", ((), (), (), ()))),
            **common)
    if btype in ("SwinTransformer_moe", "Swin"):
        raise NotImplementedError(f"backbone {btype!r} is not ported: {ZOO}")
    raise ValueError(f"unknown backbone type {btype!r}")


def roi_feats(x, rois, box_dim: int = 5):
    """One pyramid RoI align of all images' RoIs (B, S, box_dim) on the
    neck's levels x -> (B * S, 7, 7, C): rotated RoIs (box_dim 5) or
    horizontal xyxy ones (box_dim 4, aligned at angle 0)."""
    bsz, s = rois.shape[:2]
    batch_idx = torch.arange(bsz, dtype=rois.dtype, device=rois.device) \
        .repeat_interleave(s)[:, None]
    flat = torch.cat([batch_idx, rois.reshape(-1, box_dim)], dim=-1)
    if box_dim == 4:
        return extract_hbb_roi_feats(x, flat)
    return extract_rotated_roi_feats(x, flat)


def oriented_rcnn_losses(x, rpn_head, roi_head, data, keys: SampleKeys,
                         rpn_gen: AnchorGenerator, version: str,
                         num_classes: int, rpn_sample: int = 256,
                         rcnn_sample: int = 512, rpn_nms_pre: int = 2000,
                         rpn_max: int = 2000, rpn_nms_iou: float = 0.8,
                         align=None):
    """The losses of one Oriented R-CNN branch on the neck's levels ``x``
    (the JAX ``__call__``'s RGB / infrared branch): the RPN loss, the
    proposals (no gradient), the RoI sampling, the align and the R-CNN
    loss. ``data``: {gt_obbs (B, G, 5), gt_labels, gt_mask}. ``keys``
    gives the RPN sampler's keys, then the RoI sampler's. ``align(feats,
    rois)`` re-aligns the pooled (B S, 7, 7, C) features of the RoIs (B S,
    5) (ReDet's orientation alignment). Returns dict(loss_rpn_cls,
    loss_rpn_bbox, loss_cls, loss_bbox)."""
    rpn_coder = make_rpn_coder(version)
    rpn_cls, rpn_reg = rpn_head(x)
    rpn_cls = [s.float() for s in rpn_cls]
    rpn_reg = [p.float() for p in rpn_reg]
    bsz = rpn_cls[0].shape[0]
    n_anchors = sum(s[0].numel() for s in rpn_cls)
    losses = rpn_loss(
        keys(n_anchors, bsz, rpn_cls[0].device), rpn_cls, rpn_reg,
        data["gt_obbs"], data["gt_mask"], rpn_gen, rpn_coder,
        version=version, num_sample=rpn_sample)
    with torch.no_grad():
        proposals, _, p_valid = rpn_get_proposals(
            [s.detach() for s in rpn_cls], [p.detach() for p in rpn_reg],
            rpn_gen, rpn_coder, img_shape=None, nms_pre=rpn_nms_pre,
            max_per_img=rpn_max, iou_thr=rpn_nms_iou)
        n_cand = data["gt_obbs"].shape[1] + proposals.shape[1]
        rkeys = keys(n_cand, bsz, proposals.device)
        ious = candidate_gt_ious(proposals, data["gt_obbs"])
        sampled = [sample_rois_for_training(
            (rkeys[0][i], rkeys[1][i]), proposals[i], p_valid[i],
            data["gt_obbs"][i], data["gt_labels"][i], data["gt_mask"][i],
            ious[i], num=rcnn_sample) for i in range(bsz)]
        rois = torch.stack([sm["rois"] for sm in sampled])
    s = rois.shape[1]
    feats = roi_feats(x, rois)
    if align is not None:
        feats = align(feats, rois.reshape(-1, 5))
    cls_logits, reg_pred = roi_head(feats)
    cls_logits = cls_logits.reshape(bsz, s, -1).float()
    reg_pred = reg_pred.reshape(bsz, s, -1).float()
    rcnn_coder = make_rcnn_coder(version)
    l_cls = l_reg = 0.0
    n_valid = 0
    for i in range(bsz):
        lc, lr, nv, _ = bbox_head_loss(
            cls_logits[i], reg_pred[i], sampled[i], data["gt_obbs"][i],
            data["gt_labels"][i], rcnn_coder, num_classes)
        l_cls, l_reg, n_valid = l_cls + lc, l_reg + lr, n_valid + nv
    total = torch.clamp(n_valid.float(), min=1.0)
    losses["loss_cls"] = l_cls / total
    losses["loss_bbox"] = l_reg / total
    return losses


class TriSourceDetector(DetectorBase):
    """SM3Det detector. ``cfg`` follows DEFAULT_MODEL_CFG.

    Parameters are made from ``seed`` with a ``torch.Generator`` and live on
    ``device``: the CUDA card by default, the host only for
    ``device="cpu"``. ``trainable=False`` (inference) casts them to the
    compute dtype and freezes them in eval mode; ``trainable=True`` keeps
    fp32 parameters that require grad, in train mode.
    """

    def __init__(self, cfg: Dict[str, Any] | None = None, device=None,
                 seed: int = 0, trainable: bool = False):
        super().__init__()
        self.cfg = c = copy.deepcopy(cfg or DEFAULT_MODEL_CFG)
        gen = torch.Generator().manual_seed(seed)
        if c.get("multi_tasks_reweight") not in REWEIGHT_MODES:
            raise ValueError(f"multi_tasks_reweight "
                             f"{c['multi_tasks_reweight']!r}: one of "
                             f"{REWEIGHT_MODES}")
        self.backbone = build_multi_input_backbone(c["backbone"], gen,
                                                   c.get("img_size"))
        n = c["neck"]
        self.neck = MultitaskFPN(
            in_channels=tuple(n["in_channels"]),
            out_channels=n["out_channels"], num_outs=n["num_outs"],
            extra_level=n.get("extra_level", 1), gen=gen)
        self.sar_bbox_head = GFLHead(
            num_classes=c["num_classes"], in_channels=n["out_channels"],
            strides=tuple(c["sar"]["strides"]),
            reg_max=c["sar"]["reg_max"], gen=gen)
        # the order of construction is the order the seed's generator is
        # drawn in
        ch = n["out_channels"]
        self.rgb_rpn_head = OrientedRPNHead(in_channels=ch, gen=gen)
        self.ifr_rpn_head = OrientedRPNHead(in_channels=ch, gen=gen)
        self.rgb_roi_head = RotatedShared2FCBBoxHead(
            num_classes=c["num_classes"], in_channels=ch, gen=gen)
        self.ifr_roi_head = RotatedShared2FCBBoxHead(
            num_classes=c["num_classes"], in_channels=ch, gen=gen)
        self._sar_gen = make_sar_anchor_generator(tuple(c["sar"]["strides"]))
        self._rpn_gen = make_rpn_anchor_generator(
            tuple(c["rgb"]["rpn_strides"]))
        if c.get("multi_tasks_reweight") == "uncertainty":
            self.mtl_sigma = nn.Parameter(torch.ones(len(REWEIGHT_LOSS_KEYS)))
        self._place(c, device, trainable)

    def extract_feat(self, imgs, dataset_id: int | None = None):
        """The backbone's levels of images of one modality; ``dataset_id``
        (0 SAR, 1 RGB, 2 infrared) reaches the DA blocks, as the JAX
        entry points pass it (None: the DA blocks are skipped)."""
        ids = None if dataset_id is None else (dataset_id,) * imgs.shape[0]
        return self.backbone(self._cast_in(imgs), ids)

    def head_sar(self, imgs):
        """Backbone, neck and GFL head; outputs in the compute dtype."""
        return self.head_sar_from_feats(self.extract_feat(imgs, 0))

    def neck_sar(self, feats):
        """Neck of the SAR branch (start_level=1, extra convs on output)."""
        return self.neck(list(feats), start_level=1,
                         add_extra_convs="on_output")

    def head_sar_from_feats(self, feats):
        """Neck and GFL head."""
        return self.sar_bbox_head(self.neck_sar(feats))

    def get_bboxes_sar(self, cls_scores, bbox_preds, img_shape=(800, 800)):
        """Decode, top-k and NMS in fp32."""
        c = self.cfg
        s = c["sar"]
        return gfl_get_bboxes(
            [x.float() for x in cls_scores], [p.float() for p in bbox_preds],
            self._sar_gen, c["num_classes"],
            img_shape, reg_max=s["reg_max"], strides=tuple(s["strides"]),
            nms_pre=s["nms_pre"], score_thr=s["score_thr"],
            iou_thr=s["nms_iou"], max_per_img=s["max_per_img"])

    @torch.no_grad()
    def simple_test_sar(self, imgs, img_shape=(800, 800)):
        """Returns per-image (dets (B, max_per_img, 5), labels, valid)."""
        cls_scores, bbox_preds = self.head_sar(imgs)
        return self.get_bboxes_sar(cls_scores, bbox_preds, img_shape)

    # ---- RGB / infrared: Oriented R-CNN ---------------------------------

    def _heads(self, subdataset: str):
        if subdataset == "rgb":
            return self.rgb_rpn_head, self.rgb_roi_head
        if subdataset == "ifr":
            return self.ifr_rpn_head, self.ifr_roi_head
        raise ValueError(subdataset)

    def neck_rcnn(self, feats):
        """Neck of the R-CNN branches (start_level=0, extra conv on the
        output): five levels, strides 4 to 64."""
        return self.neck(list(feats), start_level=0,
                         add_extra_convs="on_output")

    def head_rpn(self, x, subdataset: str):
        """RPN head of one modality on the neck's levels; outputs in the
        compute dtype."""
        return self._heads(subdataset)[0](x)

    def get_proposals(self, rpn_cls, rpn_reg, img_shape=(800, 800)):
        """Proposal decode, top-k and per-level NMS in fp32: (proposals
        (B, rpn_max, 5), scores, valid)."""
        r = self.cfg["rgb"]
        return rpn_get_proposals(
            [s.float() for s in rpn_cls], [p.float() for p in rpn_reg],
            self._rpn_gen, make_rpn_coder(self.cfg["angle_version"]),
            img_shape=img_shape, nms_pre=r["rpn_nms_pre"],
            max_per_img=r["rpn_max"], iou_thr=r["rpn_nms_iou"])

    def roi_feats(self, x, proposals):
        """One rotated RoI align of all images' proposals (B, S, 5) on the
        neck's levels x -> (B * S, 7, 7, C)."""
        return roi_feats(x, proposals)

    def get_bboxes_rcnn(self, cls_logits, reg_pred, proposals, p_valid,
                        img_shape=(800, 800), max_per_img=None):
        """R-CNN decode and multi-class rotated NMS in fp32, batched over
        images: (dets (B, rcnn_max, 6), labels, valid)."""
        c = self.cfg
        r = c["rgb"]
        return roi_head_get_bboxes(
            cls_logits.float(), reg_pred.float(), proposals, p_valid,
            make_rcnn_coder(c["angle_version"]), c["num_classes"],
            img_shape=img_shape, score_thr=r["rcnn_score_thr"],
            iou_thr=r["rcnn_nms_iou"],
            max_per_img=max_per_img or r["rcnn_max"])

    def _simple_test_rcnn(self, imgs, subdataset, img_shape,
                          max_per_img=None):
        x = self.neck_rcnn(self.extract_feat(imgs, DATASET_IDS[subdataset]))
        rpn_cls, rpn_reg = self.head_rpn(x, subdataset)
        proposals, _, p_valid = self.get_proposals(rpn_cls, rpn_reg,
                                                   img_shape)
        bsz, s = proposals.shape[:2]
        cls_logits, reg_pred = self._heads(subdataset)[1](
            self.roi_feats(x, proposals))
        return self.get_bboxes_rcnn(
            cls_logits.reshape(bsz, s, -1), reg_pred.reshape(bsz, s, -1),
            proposals, p_valid, img_shape, max_per_img)

    @torch.no_grad()
    def simple_test_rgb(self, imgs, img_shape=(800, 800)):
        """Returns per-image (dets (B, rcnn_max, 6), labels, valid)."""
        return self._simple_test_rcnn(imgs, "rgb", img_shape)

    @torch.no_grad()
    def simple_test_ifr(self, imgs, img_shape=(800, 800)):
        return self._simple_test_rcnn(imgs, "ifr", img_shape)

    def simple_test(self, imgs, subdataset: str, img_shape=(800, 800)):
        """Route on the subdataset: "sar", "rgb" or "ifr"."""
        if subdataset == "sar":
            return self.simple_test_sar(imgs, img_shape)
        if subdataset == "rgb":
            return self.simple_test_rgb(imgs, img_shape)
        if subdataset == "ifr":
            return self.simple_test_ifr(imgs, img_shape)
        raise ValueError(subdataset)

    # ---- joint inference ------------------------------------------------

    def head_joint(self, sar_imgs, rgb_imgs, ifr_imgs):
        """One backbone pass over the concatenated batch, the neck per
        branch, the GFL head and the two RPN heads. Returns ((sar_cls,
        sar_reg), x, (rpn_cls, rpn_reg)): x is the R-CNN neck's levels over
        the rgb + infrared images, the RPN outputs are concatenated over
        them in that order."""
        n_sar, n_rgb = sar_imgs.shape[0], rgb_imgs.shape[0]
        imgs = torch.cat([self._cast_in(sar_imgs), self._cast_in(rgb_imgs),
                          self._cast_in(ifr_imgs)], dim=0)
        feats = self.backbone(imgs, composition_ids(
            n_sar, n_rgb, ifr_imgs.shape[0]))
        sar_out = self.head_sar_from_feats([f[:n_sar] for f in feats])
        x = self.neck_rcnn([f[n_sar:] for f in feats])
        rgb_cls, rgb_reg = self.rgb_rpn_head([f[:n_rgb] for f in x])
        ifr_cls, ifr_reg = self.ifr_rpn_head([f[n_rgb:] for f in x])
        rpn_cls = [torch.cat([a, b], 0) for a, b in zip(rgb_cls, ifr_cls)]
        rpn_reg = [torch.cat([a, b], 0) for a, b in zip(rgb_reg, ifr_reg)]
        return sar_out, x, (rpn_cls, rpn_reg)

    def roi_logits_joint(self, roi_feats, n_rgb: int, n_ifr: int):
        """The two RoI heads on their images' RoI features ((n_rgb +
        n_ifr) * S, 7, 7, C) -> (cls_logits (B, S, C+1), reg (B, S, 5))."""
        s = roi_feats.shape[0] // (n_rgb + n_ifr)
        rgb_logits, rgb_rp = self.rgb_roi_head(roi_feats[:n_rgb * s])
        ifr_logits, ifr_rp = self.ifr_roi_head(roi_feats[n_rgb * s:])
        cls_logits = torch.cat([rgb_logits.reshape(n_rgb, s, -1),
                                ifr_logits.reshape(n_ifr, s, -1)], 0)
        reg_pred = torch.cat([rgb_rp.reshape(n_rgb, s, -1),
                              ifr_rp.reshape(n_ifr, s, -1)], 0)
        return cls_logits, reg_pred

    @torch.no_grad()
    def simple_test_joint(self, sar_imgs, rgb_imgs, ifr_imgs,
                          img_shape=(800, 800)):
        """Mixed-batch joint inference: one backbone pass over the three
        modalities; the proposal NMS, the RoI align and the R-CNN NMS each
        run once over rgb + infrared. Returns ``(sar, rgb, ifr)`` triples of
        (dets, labels, valid), equal to the per-modality
        ``simple_test_*``."""
        n_rgb, n_ifr = rgb_imgs.shape[0], ifr_imgs.shape[0]
        (sar_cls, sar_reg), x, (rpn_cls, rpn_reg) = self.head_joint(
            sar_imgs, rgb_imgs, ifr_imgs)
        sar_out = self.get_bboxes_sar(sar_cls, sar_reg, img_shape)
        proposals, _, p_valid = self.get_proposals(rpn_cls, rpn_reg,
                                                   img_shape)
        cls_logits, reg_pred = self.roi_logits_joint(
            self.roi_feats(x, proposals), n_rgb, n_ifr)
        dets, labels, valid = self.get_bboxes_rcnn(
            cls_logits, reg_pred, proposals, p_valid, img_shape)
        return (sar_out, (dets[:n_rgb], labels[:n_rgb], valid[:n_rgb]),
                (dets[n_rgb:], labels[n_rgb:], valid[n_rgb:]))

    # ---- test-time augmentation ------------------------------------------

    @torch.no_grad()
    def aug_test(self, imgs, subdataset: str, img_shape=(800, 800),
                 scales=(1.0,), flip_directions=(None, "horizontal")):
        """Test-time augmentation: every (scale, flip direction) variant
        runs ``simple_test``; its detections are mapped back to the
        original frame (mmrotate ``bbox_flip``: the centre is reflected and
        the angle becomes pi - a for rotated boxes; mmdet's for xyxy) and
        unscaled, then all variants merge through one joint class-offset
        NMS. ``flip_directions`` entries: None, "horizontal", "vertical",
        "diagonal"."""
        version = self.cfg["angle_version"]
        hgt, wid = img_shape
        imgs = self._cast_in(imgs)

        def flip_img(x, direction):
            dims = [d for d, on in ((2, ("horizontal", "diagonal")),
                                    (1, ("vertical", "diagonal")))
                    if direction in on]
            return torch.flip(x, dims) if dims else x

        def map_back(d, direction, shape_s, s):
            h, w = shape_s
            if subdataset == "sar":
                x1, y1, x2, y2, sc = d.unbind(-1)
                if direction in ("horizontal", "diagonal"):
                    x1, x2 = w - x2, w - x1
                if direction in ("vertical", "diagonal"):
                    y1, y2 = h - y2, h - y1
                return torch.stack([x1 / s, y1 / s, x2 / s, y2 / s, sc], -1)
            cx, cy, bw, bh, a, sc = d.unbind(-1)
            if direction is not None:
                # pixel-centre convention, hence the -1
                if direction in ("horizontal", "diagonal"):
                    cx = w - cx - 1
                if direction in ("vertical", "diagonal"):
                    cy = h - cy - 1
                a = norm_angle(math.pi - a, version)
            return torch.stack([cx / s, cy / s, bw / s, bh / s, a, sc], -1)

        all_d, all_l, all_v = [], [], []
        for s in scales:
            if s == 1.0:
                im_s, shape_s = imgs, (hgt, wid)
            else:
                shape_s = (int(round(hgt * s)), int(round(wid * s)))
                im_s = F.interpolate(
                    imgs.permute(0, 3, 1, 2).float(), size=shape_s,
                    mode="bilinear", align_corners=False,
                    antialias=True).permute(0, 2, 3, 1).to(imgs.dtype)
            for direction in flip_directions:
                d, lab, val = self.simple_test(
                    flip_img(im_s, direction), subdataset, shape_s)
                all_d.append(map_back(d, direction, shape_s, s))
                all_l.append(lab)
                all_v.append(val)
        return aug_multiclass_nms_rotated(
            all_d, all_l, all_v, 0.5 if subdataset == "sar" else 0.1,
            max_out=all_d[0].shape[1],
            box_dim=4 if subdataset == "sar" else 5)

    # ---- training --------------------------------------------------------

    def extract_feat_train(self, batch, gen: torch.Generator | None = None):
        """Backbone (training forward) on the concatenated SAR + RGB +
        infrared images, the neck per modality. Returns ((sar_x, rgb_x,
        ifr_x), gate_loss)."""
        imgs = [self._cast_in(batch[k]["img"]) for k in ("sar", "rgb", "ifr")]
        n_sar, n_rgb = imgs[0].shape[0], imgs[1].shape[0]
        feats, gate_loss = self.backbone.forward_train(
            torch.cat(imgs, 0), gen,
            composition_ids(n_sar, n_rgb, imgs[2].shape[0]))
        sar_x = self.neck_sar([f[:n_sar] for f in feats])
        rgb_x = self.neck_rcnn([f[n_sar:n_sar + n_rgb] for f in feats])
        ifr_x = self.neck_rcnn([f[n_sar + n_rgb:] for f in feats])
        return (sar_x, rgb_x, ifr_x), gate_loss

    def forward(self, batch, gen: torch.Generator | None = None,
                sample_keys=None):
        """Training forward: the loss dict of the JAX ``__call__``.

        ``batch``: {"sar": {img (B, H, W, 3), gt_bboxes (B, G, 4), gt_labels,
        gt_mask}, "rgb" / "ifr": {img, gt_obbs (B, G, 5), gt_labels,
        gt_mask}}, tensors on the model's device. ``gen`` draws, in order,
        the backbone's stochastic-depth masks and gate noise, then per R-CNN
        branch the RPN sampler's keys and the RoI sampler's keys.
        ``sample_keys`` (a list of (key_pos, key_neg) pairs) replaces the
        samplers' draws.
        """
        c = self.cfg
        r = c["rgb"]
        keys = SampleKeys(gen, sample_keys)
        (sar_x, rgb_x, ifr_x), gate_loss = self.extract_feat_train(batch,
                                                                  gen)
        losses: Dict[str, torch.Tensor] = {}
        if gate_loss is not None:
            losses["gate_loss"] = gate_loss

        cls_scores, bbox_preds = self.sar_bbox_head(sar_x)
        sar = batch["sar"]
        sar_losses = gfl_loss(
            [s.float() for s in cls_scores], [p.float() for p in bbox_preds],
            sar["gt_bboxes"], sar["gt_labels"], sar["gt_mask"],
            self._sar_gen, c["num_classes"], reg_max=c["sar"]["reg_max"],
            strides=tuple(c["sar"]["strides"]))
        losses.update({f"sar_{k}": v for k, v in sar_losses.items()})

        for key, feats_m in (("rgb", rgb_x), ("ifr", ifr_x)):
            rpn_head, roi_head = self._heads(key)
            b_losses = oriented_rcnn_losses(
                feats_m, rpn_head, roi_head, batch[key], keys, self._rpn_gen,
                c["angle_version"], c["num_classes"],
                rpn_sample=r["rpn_sample"], rcnn_sample=r["rcnn_sample"],
                rpn_nms_pre=r["rpn_nms_pre"], rpn_max=r["rpn_max"],
                rpn_nms_iou=r["rpn_nms_iou"])
            losses.update({f"{key}_{k}": v for k, v in b_losses.items()})

        if c.get("multi_tasks_reweight") == "uncertainty":
            sigma2 = self.mtl_sigma ** 2
            total = torch.zeros((), device=sigma2.device)
            for i, k in enumerate(REWEIGHT_LOSS_KEYS):
                li = losses.pop(k)
                total = total + 0.5 / sigma2[i] * li + torch.log1p(sigma2[i])
                losses[k] = li.detach()          # reported, not optimised
            losses["reweighted_total_losses"] = total
        return losses
