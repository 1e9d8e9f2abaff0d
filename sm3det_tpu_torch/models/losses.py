"""Detection losses, weighted and masked.

Port of a subset of ``sm3det_tpu/models/losses.py``: sigmoid and softmax
cross-entropy, sigmoid focal (RetinaNet), Quality Focal and Distribution
Focal (GFL), Smooth L1, L1 and GIoU, and the rotated-box losses of the
refinement detectors and the retina head's ``reg_loss`` families: the
Gaussian distances (``obb2gaussian``, GWD, KLD), KFIoU and the rotated IoU
loss; CSL's smooth focal loss; the RepPoints point-set losses
(``points_gaussian``, ``poly_gaussian``, ``kld_reppoints_loss``,
``spatial_border_loss``). Every loss takes an elementwise ``weight`` and
an ``avg_factor`` (the reference's ``weighted_loss`` contract): without
``avg_factor`` the mean, with it the sum divided by ``max(avg_factor,
1e-6)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.rotated_iou import box_iou_rotated


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


def _clip(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, so that a value on a
    bound gets half the gradient, as in JAX (``torch.clamp`` gives all of
    it); e.g. the IoU loss of a box equal to its target, IoU 1."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def rotated_iou_loss(pred, target, mode="log", eps=1e-6, weight=None,
                     avg_factor=None):
    """Rotated IoU loss of aligned (..., 5) box pairs: the plain rotated IoU
    (``ops/rotated_iou.py``, sort-free clipping) and its autograd, clipped
    to [eps, 1]; ``mode`` ``"linear"`` (1 - IoU), ``"log"`` (-log IoU) or
    ``"square"`` (1 - IoU^2)."""
    ious = _clip(box_iou_rotated(pred, target, aligned=True), eps, 1.0)
    if mode == "linear":
        loss = 1 - ious
    elif mode == "log":
        loss = -torch.log(ious)
    elif mode == "square":
        loss = 1 - ious ** 2
    else:
        raise ValueError(mode)
    return _reduce(loss, weight, avg_factor)


# ---- Gaussian-distribution losses (mmrotate gaussian_dist_loss.py) ---------

def _det2(m):
    """Determinant of (..., 2, 2) matrices, ``a d - b c`` (as
    ``jnp.linalg.det`` computes a 2 x 2 one)."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def _trace2(m):
    return m[..., 0, 0] + m[..., 1, 1]


def _inv2(m):
    """Inverse of (..., 2, 2) matrices by LU, as ``jnp.linalg.inv``; a
    singular matrix gives inf / nan and raises nothing (no host sync)."""
    return torch.linalg.inv_ex(m).inverse


def obb2gaussian(obbs):
    """OBBs (..., 5) -> (mean (..., 2), covariance (..., 2, 2)):
    ``R diag(w/2, h/2)^2 R^T``, w and h clipped to [1e-7, 1e7]."""
    xy = obbs[..., :2]
    wh = _clip(obbs[..., 2:4], 1e-7, 1e7) * 0.5
    r = obbs[..., 4]
    cos_r, sin_r = torch.cos(r), torch.sin(r)
    rmat = torch.stack([torch.stack([cos_r, -sin_r], -1),
                        torch.stack([sin_r, cos_r], -1)], -2)
    s = wh[..., None] * torch.eye(2, dtype=obbs.dtype, device=obbs.device)
    sigma = rmat @ (s * s) @ rmat.transpose(-1, -2)
    return xy, sigma


def _gd_postprocess_v2(distance, fun, tau):
    """Distance -> loss: ``fun`` ``"log1p"``, ``"sqrt"`` or ``"none"``,
    then ``1 - 1 / (tau + d)`` when ``tau >= 1``."""
    if fun == "log1p":
        distance = torch.log1p(distance)
    elif fun == "sqrt":
        distance = torch.sqrt(_clip(distance, 1e-7))
    elif fun != "none":
        raise ValueError(fun)
    return 1 - 1 / (tau + distance) if tau >= 1.0 else distance


def gwd_loss(pred, target, fun="log1p", tau=1.0, alpha=1.0, normalize=True,
             weight=None, avg_factor=None):
    """Gaussian Wasserstein distance loss: the distance is
    ``sqrt(xy_dist + alpha^2 whr_dist)``, then divided by
    ``2 (det_p det_t)^(1/8)``, then post-processed."""
    mu_p, sig_p = obb2gaussian(pred)
    mu_t, sig_t = obb2gaussian(target)
    xy_dist = ((mu_p - mu_t) ** 2).sum(-1)
    whr = _trace2(sig_p) + _trace2(sig_t)
    tr_prod = _trace2(sig_p @ sig_t)
    det_sqrt = torch.sqrt(_clip(_det2(sig_p) * _det2(sig_t), 1e-7))
    whr = whr - 2 * torch.sqrt(_clip(tr_prod + 2 * det_sqrt, 1e-7))
    distance = torch.sqrt(_clip(xy_dist + alpha * alpha * whr,
                                      1e-7))
    if normalize:
        scale = 2 * _clip(torch.sqrt(_clip(torch.sqrt(
            _clip(det_sqrt, 1e-7)), 1e-7)), 1e-7)
        distance = distance / scale
    return _reduce(_gd_postprocess_v2(distance, fun, tau), weight,
                   avg_factor)


def kfiou_loss(pred, target, pred_decode, targets_decode, fun=None,
               beta=1.0 / 9.0, eps=1e-6, weight=None, avg_factor=None):
    """Kalman-filter IoU loss: Smooth L1 on the centre deltas of ``pred``
    against ``target``, plus ``1 - KFIoU`` of the decoded boxes, with the
    Kalman update's covariance ``Sp - Sp (Sp + St)^-1 Sp`` and volumes
    ``4 sqrt(det)``; ``fun`` ``"ln"`` or ``"exp"`` reshapes the IoU
    term."""
    diff = (pred[..., :2] - target[..., :2]).abs()
    xy_loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                          diff - 0.5 * beta).sum(-1)
    _, sig_p = obb2gaussian(pred_decode)
    _, sig_t = obb2gaussian(targets_decode)
    vb_p = 4 * torch.sqrt(_clip(_det2(sig_p), 0))
    vb_t = 4 * torch.sqrt(_clip(_det2(sig_t), 0))
    k = sig_p @ _inv2(sig_p + sig_t)
    sigma = sig_p - k @ sig_p
    vb = torch.nan_to_num(4 * torch.sqrt(_clip(_det2(sigma), 0)))
    kfiou = vb / (vb_p + vb_t - vb + eps)
    if fun == "ln":
        kf = -torch.log(kfiou + eps)
    elif fun == "exp":
        kf = torch.exp(1 - kfiou) - 1
    else:
        kf = 1 - kfiou
    return _reduce(_clip(xy_loss + kf, 0), weight, avg_factor)


def _kld_gauss_distance(pred, target):
    """Un-sqrted KL(pred || target) of the box Gaussians, the TARGET
    covariance inverted (gaussian_dist_loss_v1's direction)."""
    mu_p, sig_p = obb2gaussian(pred)
    mu_t, sig_t = obb2gaussian(target)
    delta = (mu_p - mu_t)[..., None]
    inv_t = _inv2(sig_t)
    term1 = (delta.transpose(-1, -2) @ inv_t @ delta)[..., 0, 0]
    term2 = _trace2(inv_t @ sig_p)
    term3 = torch.log(_clip(
        _det2(sig_t) / _clip(_det2(sig_p), 1e-7), 1e-7))
    return _clip(0.5 * (term1 + term2 + term3 - 2), 0)


def _kld_v2_distance(pred, target, alpha=1.0, sqrt=True):
    """gaussian_dist_loss's KLD distance, the PREDICTED covariance
    inverted: ``0.5 d^T Sp^-1 d / alpha^2 + 0.5 Tr(Sp^-1 St)
    + 0.5 (log|Sp| - log|St|) - 1``, square-rooted when ``sqrt``."""
    mu_p, sig_p = obb2gaussian(pred)
    mu_t, sig_t = obb2gaussian(target)
    delta = (mu_p - mu_t)[..., None]
    inv_p = _inv2(sig_p)
    xy_dist = 0.5 * (delta.transpose(-1, -2) @ inv_p @ delta)[..., 0, 0]
    whr = 0.5 * _trace2(inv_p @ sig_t)
    whr = whr + 0.5 * (torch.log(_clip(_det2(sig_p), 1e-30))
                       - torch.log(_clip(_det2(sig_t), 1e-30)))
    dist = xy_dist / (alpha * alpha) + whr - 1.0
    if sqrt:
        dist = torch.sqrt(_clip(dist, 1e-7))
    return dist


def kld_loss(pred, target, fun="log1p", tau=1.0, alpha=1.0, sqrt=True,
             weight=None, avg_factor=None):
    """Kullback-Leibler divergence loss between the box Gaussians."""
    d = _kld_v2_distance(pred, target, alpha=alpha, sqrt=sqrt)
    return _reduce(_gd_postprocess_v2(d, fun, tau), weight, avg_factor)


def smooth_focal_loss(logits, targets, gamma=2.0, alpha=0.25, weight=None,
                      avg_factor=None):
    """CSL's smooth focal loss: the focal BCE against soft targets (the
    angle coder's circular smooth labels), per element (no sum over the
    classes); ``weight`` broadcasts, e.g. an (N, 1) positive mask."""
    p = torch.sigmoid(logits)
    pt = (1 - p) * targets + p * (1 - targets)
    focal_weight = (alpha * targets + (1 - alpha) * (1 - targets)) * \
        pt ** gamma
    return _reduce(_bce_with_logits(logits, targets) * focal_weight, weight,
                   avg_factor)


# ---- RepPoints point-set losses ---------------------------------------------

def points_gaussian(pts):
    """The one-component Gaussian fit of (..., K, 2) point sets: the mean
    and the (biased) sample covariance plus 1e-4 I, so that its
    determinant stays positive."""
    mu = pts.mean(-2)
    d = pts - mu[..., None, :]
    var = d.transpose(-1, -2) @ d / pts.shape[-2]
    return mu, var + 1e-4 * torch.eye(2, dtype=pts.dtype, device=pts.device)


def poly_gaussian(polys):
    """A gt quad (..., 8) as a Gaussian (mmrotate's ``gt2gaussian``): the
    corners' mean, and the covariance ``R diag(w^2, h^2) R^T / (4 L^2)``
    (L = 3) of the edges 0-1 (w, R's direction) and 1-2 (h)."""
    big_l = 3.0
    quad = polys.reshape(polys.shape[:-1] + (4, 2))
    center = quad.mean(-2)
    edge1 = quad[..., 1, :] - quad[..., 0, :]
    edge2 = quad[..., 2, :] - quad[..., 1, :]
    w = (edge1 * edge1).sum(-1, keepdim=True)
    h = (edge2 * edge2).sum(-1, keepdim=True)
    cos_sin = edge1 / torch.sqrt(_clip(w, 1e-7))
    c, s = cos_sin[..., 0], cos_sin[..., 1]
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                      -2)
    diag = torch.diag_embed(torch.cat([w, h], -1) / (4 * big_l * big_l))
    return center, rot @ diag @ rot.transpose(-1, -2)


def kld_reppoints_loss(pred_pts, target_polys, weight=None, avg_factor=None,
                       eps=1e-6):
    """KLD RepPoints loss: KL(points' Gaussian || the gt quad's), the
    target covariance (plus eps I) inverted; ``1 - 1 / (2 + sqrt(KL))``,
    KL clipped at eps. pred_pts (..., K, 2), target_polys (..., 8)."""
    p_mu, p_var = points_gaussian(pred_pts)
    t_mu, t_var = poly_gaussian(target_polys)
    delta = (p_mu - t_mu)[..., None]
    eye = torch.eye(2, dtype=t_var.dtype, device=t_var.device)
    t_inv = _inv2(t_var + eps * eye)
    term1 = (delta.transpose(-1, -2) @ t_inv @ delta)[..., 0, 0]
    term2 = _trace2(t_inv @ p_var) + torch.log(_clip(
        _det2(t_var) / _clip(_det2(p_var), 1e-7), 1e-7))
    kld = _clip(0.5 * (term1 + term2) - 1.0, eps)
    return _reduce(1.0 - 1.0 / (2.0 + torch.sqrt(kld)), weight, avg_factor)


def _safe_norm(v):
    """The L2 norm over the last axis, with a 0 gradient at 0 (JAX's
    ``jnp.linalg.norm`` gives NaN there: 0 times the root's infinity)."""
    sq = (v * v).sum(-1)
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)


def spatial_border_loss(pts, gt_polys, weight, avg_factor=None):
    """Spatial border loss of one image: each point of a positive set
    (weight > 0) outside its gt quad costs 0.2 times its distance to the
    quad's centre; the mean over those points (1 if none).

    pts (N, K, 2); gt_polys (N, 8), aligned; weight (N,). ``avg_factor``
    is taken and unused, as in JAX (the loss is a mean already)."""
    del avg_factor
    quad = gt_polys.reshape(-1, 4, 2)
    o = quad[:, None]
    e = torch.roll(quad, -1, dims=-2)[:, None]
    p = pts[:, :, None, :]
    cr = (e[..., 0] - o[..., 0]) * (p[..., 1] - o[..., 1]) - \
        (e[..., 1] - o[..., 1]) * (p[..., 0] - o[..., 0])
    inside = (cr >= 0).all(-1) | (cr <= 0).all(-1)
    d = _safe_norm(pts - quad.mean(-2)[:, None, :])
    out = ~inside & (weight[:, None] > 0)
    n_out = torch.clamp(out.sum().float(), min=1.0)
    return (0.2 * d * out).sum() / n_out
