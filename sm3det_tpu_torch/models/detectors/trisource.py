"""TriSource detector, SAR inference slice.

Port of ``sm3det_tpu/models/detectors/trisource.py::TriSourceDetector``:
the shared ConvNeXt-MoE backbone, the MultitaskFPN and the SAR GFL head,
with ``simple_test_sar`` / ``simple_test(imgs, "sar")``. The compute-dtype
policy is that of ``_cast_in``: with ``compute_dtype="bfloat16"`` the
parameters and images are bf16 (convs and products in bf16, norm
statistics in fp32) and the head outputs are cast to fp32 before decode
and NMS. The RGB/IR Oriented R-CNN branches and joint inference come in a
later slice of the port.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ...core.anchor import AnchorGenerator
from ...device import resolve_device
from ..backbones.convnext import ConvNeXtMoE
from ..dense_heads.gfl_head import GFLHead, gfl_get_bboxes
from ..necks.fpn import MultitaskFPN

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

_LATER = ("the RGB/IR Oriented R-CNN branch and joint inference are the "
          "next slice of the port")


def make_sar_anchor_generator(strides=(8, 16, 32, 64, 128)):
    """GFL: single anchor per cell, octave base 8."""
    return AnchorGenerator(strides=strides, ratios=[1.0],
                           octave_base_scale=8, scales_per_octave=1)


class TriSourceDetector(nn.Module):
    """SM3Det detector, SAR slice. ``cfg`` follows DEFAULT_MODEL_CFG.

    Parameters are made from ``seed`` with a ``torch.Generator`` and live on
    ``device``: the CUDA card by default, the host only for
    ``device="cpu"``.
    """

    def __init__(self, cfg: Dict[str, Any] | None = None, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = c = copy.deepcopy(cfg or DEFAULT_MODEL_CFG)
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        b = c["backbone"]
        if b.get("type", "ConvNeXt") not in ("ConvNeXt",
                                             "ConvNeXt_moe_MultiInput"):
            raise NotImplementedError(f"backbone {b['type']!r}")
        self.backbone = ConvNeXtMoE(
            arch=b.get("arch", "tiny"),
            moe_block_inds=tuple(tuple(i) for i in b.get(
                "moe_block_inds", ((), (), (), ()))),
            num_experts=b.get("num_experts", 2), top_k=b.get("top_k", 2),
            gate=b.get("gate", "cosine"),
            noisy_gating=b.get("noisy_gating", True),
            use_da=b.get("use_da", False), gen=gen)
        n = c["neck"]
        self.neck = MultitaskFPN(
            in_channels=tuple(n["in_channels"]),
            out_channels=n["out_channels"], num_outs=n["num_outs"],
            extra_level=n.get("extra_level", 1), gen=gen)
        self.sar_bbox_head = GFLHead(
            num_classes=c["num_classes"], in_channels=n["out_channels"],
            strides=tuple(c["sar"]["strides"]),
            reg_max=c["sar"]["reg_max"], gen=gen)
        dt = c.get("compute_dtype")
        self.compute_dtype = getattr(torch, dt) if dt else torch.float32
        self.to(device=dev, dtype=self.compute_dtype)
        self.eval()
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.backbone.stem_norm.weight.device

    def _cast_in(self, imgs):
        """Images (numpy or tensor, (B, H, W, 3)) on the model's device in
        the compute dtype."""
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        return imgs.to(device=self.device, dtype=self.compute_dtype)

    def extract_feat(self, imgs):
        return self.backbone(self._cast_in(imgs))

    def head_sar(self, imgs):
        """Backbone, neck and GFL head; outputs in the compute dtype."""
        return self.head_sar_from_feats(self.extract_feat(imgs))

    def head_sar_from_feats(self, feats):
        """Neck (start_level=1, extra convs on output) and GFL head."""
        sar_x = self.neck(list(feats), start_level=1,
                          add_extra_convs="on_output")
        return self.sar_bbox_head(sar_x)

    def get_bboxes_sar(self, cls_scores, bbox_preds, img_shape=(800, 800)):
        """Decode, top-k and NMS in fp32."""
        c = self.cfg
        s = c["sar"]
        return gfl_get_bboxes(
            [x.float() for x in cls_scores], [p.float() for p in bbox_preds],
            make_sar_anchor_generator(tuple(s["strides"])), c["num_classes"],
            img_shape, reg_max=s["reg_max"], strides=tuple(s["strides"]),
            nms_pre=s["nms_pre"], score_thr=s["score_thr"],
            iou_thr=s["nms_iou"], max_per_img=s["max_per_img"])

    @torch.no_grad()
    def simple_test_sar(self, imgs, img_shape=(800, 800)):
        """Returns per-image (dets (B, max_per_img, 5), labels, valid)."""
        cls_scores, bbox_preds = self.head_sar(imgs)
        return self.get_bboxes_sar(cls_scores, bbox_preds, img_shape)

    def simple_test(self, imgs, subdataset: str, img_shape=(800, 800)):
        if subdataset == "sar":
            return self.simple_test_sar(imgs, img_shape)
        if subdataset in ("rgb", "ifr"):
            raise NotImplementedError(f"simple_test({subdataset!r}): {_LATER}")
        raise ValueError(subdataset)

    def simple_test_joint(self, sar_imgs, rgb_imgs, ifr_imgs,
                          img_shape=(800, 800)):
        raise NotImplementedError(f"simple_test_joint: {_LATER}")
