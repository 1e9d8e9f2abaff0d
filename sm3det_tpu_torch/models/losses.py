"""Detection losses, weighted and masked.

Port of a subset of ``sm3det_tpu/models/losses.py``: sigmoid and softmax
cross-entropy, sigmoid focal (RetinaNet), Quality Focal and Distribution
Focal (GFL), Smooth L1, L1 and GIoU. Every loss takes an elementwise ``weight`` and an ``avg_factor``
(the reference's ``weighted_loss`` contract): without ``avg_factor`` the
mean, with it the sum divided by ``max(avg_factor, 1e-6)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reduce(loss, weight=None, avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / max(avg_factor, 1e-6)


def _bce_with_logits(logits, labels):
    """``max(x, 0) - x y + log1p(exp(-|x|))``, as the JAX losses write it."""
    return torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def sigmoid_cross_entropy(logits, labels, weight=None, avg_factor=None):
    """Binary cross-entropy with logits; ``labels`` 0/1 of the same shape."""
    return _reduce(_bce_with_logits(logits, labels), weight, avg_factor)


def softmax_cross_entropy(logits, labels, weight=None, avg_factor=None):
    """Cross-entropy with integer labels: logits (N, C), labels (N,)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return _reduce(nll, weight, avg_factor)


def sigmoid_focal_loss(logits, labels, gamma=2.0, alpha=0.25, weight=None,
                       avg_factor=None):
    """mmcv's sigmoid focal loss: logits (N, C), labels (N,) in [0, C], C
    the background (no positive class); one-vs-all per class, summed over
    the classes."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes] > 0
    p = torch.sigmoid(logits)
    pt = torch.where(onehot, p, 1 - p)
    alpha_t = torch.where(onehot, alpha, 1 - alpha)
    ce = -torch.log(torch.clamp(pt, min=1e-12))
    loss = alpha_t * (1 - pt) ** gamma * ce
    return _reduce(loss.sum(-1), weight, avg_factor)


def quality_focal_loss(logits, labels, scores, beta=2.0, weight=None,
                       avg_factor=None):
    """Quality Focal Loss (GFL): logits (N, C); labels (N,) with ``C`` for
    the background; scores (N,) the IoU targets of the positives.

    Every class of every prior regresses to 0 with weight ``p^beta``; a
    positive's own class regresses to its score with weight
    ``|score - p|^beta``.
    """
    num_classes = logits.shape[-1]
    p = torch.sigmoid(logits)
    loss = _bce_with_logits(logits, torch.zeros_like(logits)) * p.pow(beta)
    pos = labels < num_classes
    pos_label = torch.where(pos, labels, torch.zeros_like(labels))
    onehot = F.one_hot(pos_label.long(), num_classes).to(logits.dtype)
    score_t = scores[..., None] * onehot
    pos_loss = _bce_with_logits(logits, score_t) * \
        (score_t - p).abs().pow(beta)
    loss = torch.where(pos[..., None] & (onehot > 0), pos_loss, loss)
    return _reduce(loss.sum(-1), weight, avg_factor)


def distribution_focal_loss(pred, label, weight=None, avg_factor=None):
    """DFL: cross-entropy to the two integer bins bracketing each target.
    pred (N, reg_max + 1) logits; label (N,) targets in [0, reg_max]."""
    dis_left = torch.floor(label).long()
    dis_right = dis_left + 1
    weight_left = dis_right.to(pred.dtype) - label
    weight_right = label - dis_left.to(pred.dtype)
    logp = torch.log_softmax(pred, dim=-1)
    dis_right = torch.clamp(dis_right, max=pred.shape[-1] - 1)
    nll_left = -torch.gather(logp, -1, dis_left[..., None])[..., 0]
    nll_right = -torch.gather(logp, -1, dis_right[..., None])[..., 0]
    return _reduce(nll_left * weight_left + nll_right * weight_right,
                   weight, avg_factor)


def smooth_l1_loss(pred, target, beta=1.0, weight=None, avg_factor=None):
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _reduce(loss, weight, avg_factor)


def l1_loss(pred, target, weight=None, avg_factor=None):
    return _reduce((pred - target).abs(), weight, avg_factor)


def giou_loss(pred, target, eps=1e-7, weight=None, avg_factor=None):
    """GIoU loss on xyxy boxes (mmdet semantics)."""
    ap = torch.clamp(pred[..., 2] - pred[..., 0], min=0) * \
        torch.clamp(pred[..., 3] - pred[..., 1], min=0)
    at = torch.clamp(target[..., 2] - target[..., 0], min=0) * \
        torch.clamp(target[..., 3] - target[..., 1], min=0)
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = ap + at - inter + eps
    iou = inter / union
    lt_c = torch.minimum(pred[..., :2], target[..., :2])
    rb_c = torch.maximum(pred[..., 2:], target[..., 2:])
    wh_c = torch.clamp(rb_c - lt_c, min=0)
    area_c = wh_c[..., 0] * wh_c[..., 1] + eps
    giou = iou - (area_c - union) / area_c
    return _reduce(1 - giou, weight, avg_factor)
