"""RoI Transformer's stage-1 head and the Gliding-Vertex head.

Port of ``sm3det_tpu/models/roi_heads/cascade_heads.py``:

- ``HBB2OBBBBoxHead`` and ``roi_trans_stage1``: horizontal RoIs pooled by
  the rotated pyramid align at angle 0 (row 7 on the card, its gather
  backward row 8), flattened over (h, w, C) as flax's ``Dense`` sees them,
  two fully connected layers of 1024, the (C+1)-way classifier and a
  5-parameter regressor whose deltas are decoded against ``hbb2obb`` of
  the RoI (also RotatedFasterRCNN's head);
- ``GVBBoxHead`` and ``gv_decode``: the same trunk with a class-agnostic
  horizontal 4-delta regressor, the four sliding fractions (``fc_fix``,
  sigmoid) and the area ratio (``fc_ratio``, sigmoid); the decode builds
  the polygon from the fractions and snaps a box whose ratio exceeds
  ``ratio_thr`` back to its horizontal box.
"""

from __future__ import annotations

import torch

from ...core.bbox.coders import DeltaXYWHAOBBoxCoder
from ...core.bbox.gv_coders import GVFixCoder
from ...ops.box_convert import hbb2obb, poly2obb
from ..layers import Dense
from .oriented_roi_head import RotatedShared2FCBBoxHead
from .standard_roi_head import Shared2FCBBoxHead, extract_hbb_roi_feats


class HBB2OBBBBoxHead(RotatedShared2FCBBoxHead):
    """The layers of the rotated shared-2fc head (``shared_fc0``,
    ``shared_fc1``, ``fc_cls`` C+1, ``fc_reg`` 5 class-agnostic deltas),
    its deltas read against ``hbb2obb`` of a horizontal RoI."""


def roi_trans_stage1(feats, rois5_hbb, head: HBB2OBBBBoxHead,
                     coder: DeltaXYWHAOBBoxCoder, version: str = "le90"):
    """Pool the horizontal RoIs (N, 5) ``(batch_idx, x1, y1, x2, y2)`` and
    decode the head's deltas against their ``hbb2obb`` priors: returns
    (cls_logits (N, C+1), oriented boxes (N, 5)), in fp32."""
    cls_logits, reg = head(extract_hbb_roi_feats(feats, rois5_hbb))
    priors = hbb2obb(rois5_hbb[:, 1:5], version)
    return cls_logits.float(), coder.decode(priors, reg.float())


class GVBBoxHead(Shared2FCBBoxHead):
    """Gliding-Vertex head: the trunk and classifier of the horizontal
    head, a class-agnostic 4-delta regressor, the fractions ``fc_fix`` (4,
    sigmoid) and the area ratio ``fc_ratio`` (1, sigmoid)."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 fc_out_channels: int = 1024, roi_feat_size: int = 7,
                 gen: torch.Generator | None = None):
        super().__init__(num_classes, in_channels, fc_out_channels,
                         roi_feat_size, reg_class_agnostic=True, gen=gen)
        self.fc_fix = Dense(fc_out_channels, 4, gen=gen)
        self.fc_ratio = Dense(fc_out_channels, 1, gen=gen)

    def forward(self, roi_feats):
        """(cls (N, C+1), hbb deltas (N, 4), fix (N, 4), ratio (N, 1))."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = torch.relu(self.shared_fc1(torch.relu(self.shared_fc0(x))))
        return (self.fc_cls(x), self.fc_reg(x),
                torch.sigmoid(self.fc_fix(x)), torch.sigmoid(self.fc_ratio(x)))


def gv_decode(hbbs, fix, ratio, version: str = "le90",
              ratio_thr: float = 0.8):
    """Oriented boxes from horizontal boxes (..., 4), fractions (..., 4)
    and ratios (..., 1): the polygon's ``poly2obb``, or ``hbb2obb`` where
    the ratio exceeds ``ratio_thr``."""
    obbs = poly2obb(GVFixCoder(version).decode(hbbs, fix), version)
    return torch.where((ratio[..., 0] > ratio_thr)[..., None],
                       hbb2obb(hbbs, version), obbs)
