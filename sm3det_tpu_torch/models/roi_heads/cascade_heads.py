"""RoI Transformer's stage-1 head.

Port of ``HBB2OBBBBoxHead`` and ``roi_trans_stage1`` of
``sm3det_tpu/models/roi_heads/cascade_heads.py``: horizontal RoIs pooled
by the rotated pyramid align at angle 0 (row 7 on the card, its gather
backward row 8), flattened over (h, w, C) as flax's ``Dense`` sees them,
two fully connected layers of 1024, the (C+1)-way classifier and a
5-parameter regressor whose deltas are decoded against ``hbb2obb`` of the
RoI.
"""

from __future__ import annotations

from ...core.bbox.coders import DeltaXYWHAOBBoxCoder
from ...ops.box_convert import hbb2obb
from .oriented_roi_head import RotatedShared2FCBBoxHead
from .standard_roi_head import extract_hbb_roi_feats


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
