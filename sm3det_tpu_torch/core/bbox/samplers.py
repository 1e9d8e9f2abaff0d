"""Static-shape random positive/negative sampler.

Port of ``sm3det_tpu/core/bbox/samplers.py::random_sample`` (mmdet
``RandomSampler`` semantics): ``num`` slots, the first ``n_pos`` holding
sampled positives, then negatives, the rest masked out.

The randomness enters as tensors: two vectors of uniform keys in [0, 1),
one for the positives' order and one for the negatives'. A caller draws
them with :func:`draw_sample_keys` from an explicit ``torch.Generator``; a
test can hand in the very draws ``jax.random.uniform`` made for the JAX
function. Candidates are ordered by key with a stable sort, so equal keys
keep the lower index first, as ``lax.top_k`` does.
"""

from __future__ import annotations

import torch


def draw_sample_keys(n: int, gen: torch.Generator | None = None,
                     batch=(), device=None):
    """(key_pos, key_neg): uniform keys of shape ``batch + (n,)``, drawn on
    ``gen``'s device and moved to ``device``."""
    gdev = gen.device if gen is not None else None
    keys = torch.rand((2,) + tuple(batch) + (n,), generator=gen, device=gdev)
    keys = keys.to(device) if device is not None else keys
    return keys[0], keys[1]


class SampleKeys:
    """The sampler keys of one forward, in the order it asks for them:
    drawn from ``gen`` (:func:`draw_sample_keys`), or, when ``given`` is a
    sequence of (key_pos, key_neg) pairs, taken from it in turn (a test
    hands in the JAX function's draws this way)."""

    def __init__(self, gen: torch.Generator | None = None, given=None):
        self.gen = gen
        self.given = None if given is None else list(given)

    def __call__(self, n: int, batch: int, device):
        """(key_pos, key_neg), each (batch, n), on ``device``."""
        if self.given is None:
            return draw_sample_keys(n, self.gen, (batch,), device)
        if not self.given:
            raise ValueError("SampleKeys: the given keys are used up")
        kp, kn = self.given.pop(0)
        if tuple(kp.shape) != (batch, n) or tuple(kn.shape) != (batch, n):
            raise ValueError(f"SampleKeys: given keys {tuple(kp.shape)}, "
                             f"the sampler draws {(batch, n)}")
        return kp.to(device), kn.to(device)


def random_sample(key_pos, key_neg, assigned_gt_inds, num: int,
                  pos_fraction: float):
    """Sample ``num`` priors with at most ``num * pos_fraction`` positives.

    key_pos, key_neg: (..., P) uniform keys; assigned_gt_inds: (..., P) in
    the mmdet encoding (0 negative, > 0 positive). Leading dimensions are
    images. Returns dict(inds (..., num) int64, pos_mask, neg_mask).
    """
    p = assigned_gt_inds.shape[-1]
    is_pos = assigned_gt_inds > 0
    is_neg = assigned_gt_inds == 0
    k = min(num, p)
    pos_order = torch.sort(key_pos + torch.where(is_pos, 0.0, 10.0), dim=-1,
                           stable=True).indices[..., :k]
    neg_order = torch.sort(key_neg + torch.where(is_neg, 0.0, 10.0), dim=-1,
                           stable=True).indices[..., :k]
    n_pos = torch.clamp(is_pos.sum(-1, keepdim=True),
                        max=int(num * pos_fraction))
    n_neg = torch.minimum(is_neg.sum(-1, keepdim=True), num - n_pos)
    slots = torch.arange(num, device=assigned_gt_inds.device)
    pos_take = torch.gather(pos_order, -1, torch.clamp(
        slots, max=k - 1).expand(pos_order.shape[:-1] + (num,)))
    neg_take = torch.gather(neg_order, -1,
                            torch.clamp(slots - n_pos, 0, k - 1))
    inds = torch.where(slots < n_pos, pos_take, neg_take)
    return {"inds": inds, "pos_mask": slots < n_pos,
            "neg_mask": (slots >= n_pos) & (slots < n_pos + n_neg)}
