"""The NMS's packed suppression bits and greedy keep, port against JAX, on
the CPU.

``hbb_nms_mask_ref`` and ``rotated_nms_mask_ref`` (the plain versions of
the IoU kernels' mask mode) unpacked must equal the strict upper triangle
of ``iou > thr`` from the JAX package's ``bbox_overlaps`` and
``box_iou_rotated_chunked`` (with the group mask), and ``nms_keep_ref``
must equal the JAX ``greedy_keep``. The tolerance is none: both sides are
bit masks, compared exactly. The inputs, made from a numpy seed, hold
ties, exact duplicates, zero-size boxes and, for the groups, an inert
tail. A rotated box of no size against a real one has no defined IoU
(both packages give rounding noise, up to 1e6, and not the same): those
pairs are left out of the rotated comparison, and such boxes are
ineligible (as padding is) where the keeps are compared. Last, each NMS
function of the port is shown to go through the mask and the keep on the
CPU, and to equal the JAX function's output.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.ops.rotated_iou import box_iou_rotated_chunked
from sm3det_tpu_torch.ops import nms as tnms
from sm3det_tpu_torch.ops.cuda import hbb_iou_kernel as hik
from sm3det_tpu_torch.ops.cuda import nms_keep_kernel as nkk
from sm3det_tpu_torch.ops.cuda import rotated_iou_kernel as rik
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)

# the package re-exports the function nms under the module's name
jnms = importlib.import_module("sm3det_tpu.ops.nms")

SIZES = [1, 31, 32, 33, 300]
BATCHES = [1, 3]
HBB_THR, ROT_THR = 0.5, 0.1      # the GFL's 0.6 and the RPN's 0.8 alike


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hbb(rng, n):
    """xyxy boxes in clusters, with exact duplicates and zero-size boxes."""
    ctr = rng.uniform(0, 200, (max(n // 8, 1), 2))[rng.randint(
        0, max(n // 8, 1), n)] + rng.normal(0, 12, (n, 2))
    wh = rng.uniform(4, 60, (n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    boxes[1::7] = boxes[0::7][:len(boxes[1::7])]
    boxes[5::11, 2:] = boxes[5::11, :2]              # no size
    return boxes.astype(np.float32)


def _obb(rng, n, empty=True):
    ctr = rng.uniform(0, 200, (max(n // 8, 1), 2))[rng.randint(
        0, max(n // 8, 1), n)] + rng.normal(0, 12, (n, 2))
    boxes = np.concatenate([ctr, rng.uniform(4, 60, (n, 2)),
                            rng.uniform(-1.55, 1.55, (n, 1))], -1)
    boxes[1::7] = boxes[0::7][:len(boxes[1::7])]
    if empty:
        boxes[5::11, 2:4] = 0.0                      # no size
    return boxes.astype(np.float32)


def _real(boxes):
    """Boxes of some size; for xyxy boxes every box counts."""
    if boxes.shape[-1] == 4:
        return np.ones(boxes.shape[:-1], bool)
    return boxes[..., 2] * boxes[..., 3] > 0


def _defined(boxes):
    """Pairs whose IoU is defined: not one box of no size and one real."""
    real = _real(boxes)
    return real[..., :, None] == real[..., None, :]


def _groups(rng, n):
    """Ascending groups of 4 classes, the last eighth inert."""
    g = np.sort(rng.randint(0, 4, n)).astype(np.int32)
    g[n - n // 8:] = rik.INERT_GROUP
    return g


# the JAX references, jitted: one compile a box count, shared by the cases
_jax_hbb_iou = jax.jit(lambda x: jnms.bbox_overlaps(x, x))
_jax_rotated_iou = jax.jit(lambda x: box_iou_rotated_chunked(x, x))


@pytest.fixture(scope="module")
def cases():
    """Per (kind, n, b): the boxes (and groups), the port's plain mask and
    the strict upper triangle of JAX's ``iou > thr``, computed once."""
    out = {}

    def get(kind, n, b):
        key = (kind, n, b)
        if key in out:
            return out[key]
        rng = np.random.RandomState(n * 10 + b)
        if kind == "hbb":
            boxes = np.stack([_hbb(rng, n) for _ in range(b)])
            groups = None
            mask = hik.hbb_nms_mask_ref(_t(boxes), HBB_THR)
            ious = [np.asarray(_jax_hbb_iou(x)) for x in boxes]
            thr = HBB_THR
        else:
            boxes = np.stack([_obb(rng, n) for _ in range(b)])
            groups = np.stack([_groups(rng, n) for _ in range(b)]) \
                if kind == "banded" else None
            mask = rik.rotated_nms_mask_ref(
                _t(boxes), ROT_THR, None if groups is None else _t(groups))
            ious = [np.asarray(_jax_rotated_iou(x)) for x in boxes]
            if groups is not None:
                ious = [iou * (g[:, None] == g[None, :])
                        for iou, g in zip(ious, groups)]
            thr = ROT_THR
        want = np.stack([np.triu(iou > np.float32(thr), 1) for iou in ious])
        if groups is not None:      # inert pairs are never read: 0 here
            want &= (groups < rik.INERT_GROUP)[:, :, None]
        out[key] = (boxes, groups, mask, want)
        return out[key]

    return get


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["hbb", "rotated", "banded"])
def test_nms_mask_ref_matches_jax(cases, kind, n, b):
    boxes, groups, mask, want = cases(kind, n, b)
    assert mask.dtype == torch.int32 and mask.shape == (b, n, -(-n // 32))
    defined = _defined(boxes)
    if kind == "hbb":
        assert defined.all()
    np.testing.assert_array_equal(
        nkk.unpack_bits(mask, n).numpy() & defined, want & defined)
    # one image alone: the same words
    one = hik.hbb_nms_mask_ref(_t(boxes[-1]), HBB_THR) if kind == "hbb" \
        else rik.rotated_nms_mask_ref(
            _t(boxes[-1]), ROT_THR,
            None if groups is None else _t(groups[-1]))
    assert torch.equal(one, mask[-1])
    if n == 300:
        assert want.sum() > 3 * b            # duplicates and real overlaps


@pytest.mark.parametrize("kind", ["hbb", "rotated", "banded"])
def test_nms_keep_ref_on_real_masks_matches_jax(cases, kind):
    boxes, groups, mask, want = cases(kind, 300, 3)
    rng = np.random.RandomState(4)
    elig = (rng.rand(3, 300) < 0.9) & _real(boxes)
    if groups is not None:
        elig &= groups < rik.INERT_GROUP
    keep = nkk.nms_keep_ref(mask, _t(elig))
    for i in range(3):
        ref = jnms.greedy_keep(jnp.asarray(want[i]), jnp.asarray(elig[i]))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(ref))
    assert 0 < int(keep.sum()) < int(elig.sum())


@pytest.mark.parametrize("density", [0.01, 0.3])
@pytest.mark.parametrize("n", [1, 33, 300, 700])     # 700: blocked greedy
def test_nms_keep_ref_on_random_masks_matches_jax(density, n):
    """Random bits everywhere, the lower triangle too (never read)."""
    rng = np.random.RandomState(int(density * 100) + n)
    sup = rng.rand(2, n, n) < density
    elig = rng.rand(2, n) < 0.9
    words = nkk.pack_bits(_t(sup))
    assert torch.equal(nkk.unpack_bits(words, n), _t(sup))
    keep = nkk.nms_keep_ref(words, _t(elig))
    for i in range(2):
        ref = jnms.greedy_keep(jnp.asarray(sup[i]), jnp.asarray(elig[i]))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(ref))
    assert torch.equal(nkk.nms_keep(words[1], _t(elig[1])), keep[1])


def test_pack_bits_sign_bit():
    bits = torch.zeros(2, 64, dtype=torch.bool)
    bits[0, 31] = bits[0, 32] = bits[1, 0] = True
    words = nkk.pack_bits(bits)
    assert words.tolist() == [[-(1 << 31), 1], [1, 0]]
    assert torch.equal(nkk.unpack_bits(words, 64), bits)
    assert torch.equal(nkk.unpack_bits(nkk.pack_bits(bits[:, :40]), 40),
                       bits[:, :40])


def test_nms_keep_refuses_a_mask_of_another_shape():
    with pytest.raises(ValueError, match="does not fit"):
        nkk.nms_keep(torch.zeros(3, 2, dtype=torch.int32),
                     torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="does not fit"):
        nkk.nms_keep(torch.zeros(3, 1, dtype=torch.int64),
                     torch.ones(3, dtype=torch.bool))


# ---- each NMS function goes through the mask and the keep ------------------

def _route_calls(monkeypatch):
    """Count the calls of the mask and keep functions the NMS module holds."""
    calls = {"mask": 0, "keep": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for attr in ("hbb_nms_mask", "rotated_nms_mask"):
        monkeypatch.setattr(tnms, attr, counted("mask", getattr(tnms, attr)))
    monkeypatch.setattr(tnms, "nms_keep", counted("keep", tnms.nms_keep))
    return calls


def _equal(got, ref, box_tol):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), r, atol=box_tol, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), r)


def _route_case(name, rng):
    """(port call, JAX call, coordinate tolerance) of one NMS function on
    inputs with ties and duplicates."""
    n = 160
    hbb, obb = _hbb(rng, n), _obb(rng, n, empty=False)
    scores = rng.uniform(0.05, 1, n).astype(np.float32)
    scores[10:14] = scores[10]
    cls = rng.randint(0, 5, n).astype(np.int32)
    multi = rng.rand(n, 6).astype(np.float32)
    J = jnp.asarray
    if name == "nms":
        return (lambda: tnms.nms(_t(hbb), _t(scores), 0.5, 80, 0.1),
                lambda: jnms.nms(J(hbb), J(scores), 0.5, 80, score_thr=0.1), 1e-5)
    if name == "batched_nms":
        return (lambda: tnms.batched_nms(_t(hbb), _t(scores), _t(cls), 0.5,
                                         80),
                lambda: jnms.batched_nms(J(hbb), J(scores), J(cls), 0.5, 80), 1e-5)
    if name == "multiclass_nms":
        return (lambda: tnms.multiclass_nms(_t(hbb), _t(multi), 0.3, 0.5, 60,
                                            pre_nms=300),
                lambda: jnms.multiclass_nms(J(hbb), J(multi), 0.3, 0.5, 60,
                                            pre_nms=300), 1e-5)
    if name == "nms_rotated":
        return (lambda: tnms.nms_rotated(_t(obb), _t(scores), 0.1, 80, 0.1),
                lambda: jnms.nms_rotated(J(obb), J(scores), 0.1, 80,
                                         score_thr=0.1), 1e-5)
    if name == "nms_rotated_grouped":
        shifted = obb.copy()
        shifted[:, 0] += cls * 1000.0
        return (lambda: tnms.nms_rotated(_t(shifted), _t(scores), 0.1, 80,
                                         0.1, groups=_t(cls)),
                lambda: jnms.nms_rotated(J(shifted), J(scores), 0.1, 80,
                                         score_thr=0.1, groups=J(cls)), 1e-3)
    if name == "multiclass_nms_rotated":
        return (lambda: tnms.multiclass_nms_rotated(_t(obb), _t(multi), 0.3,
                                                    0.1, 60, pre_nms=300),
                lambda: jnms.multiclass_nms_rotated(J(obb), J(multi), 0.3, 0.1, 60,
                                                    pre_nms=300), 1e-5)
    box_dim = 5 if name == "aug_multiclass_nms_rotated" else 4
    base = obb if box_dim == 5 else hbb
    dets = [np.concatenate([base + k * rng.normal(0, 0.5, base.shape)
                            .astype(np.float32), scores[:, None]], -1)
            for k in range(2)]
    valid = [rng.rand(n) < 0.9 for _ in range(2)]
    labels = [cls, cls[::-1].copy()]
    return (lambda: tnms.aug_multiclass_nms_rotated(
                [_t(d) for d in dets], [_t(x) for x in labels],
                [_t(v) for v in valid], 0.1, 100, box_dim=box_dim),
            lambda: jnms.aug_multiclass_nms_rotated(
                [J(d) for d in dets], [J(x) for x in labels],
                [J(v) for v in valid], 0.1, 100, box_dim=box_dim), 1e-5)


@pytest.mark.parametrize("name", [
    "nms", "batched_nms", "multiclass_nms", "nms_rotated",
    "nms_rotated_grouped", "multiclass_nms_rotated",
    "aug_multiclass_nms_rotated", "aug_multiclass_nms_horizontal"])
def test_nms_functions_go_through_mask_and_keep(monkeypatch, name):
    port, ref, box_tol = _route_case(name, np.random.RandomState(12))
    calls = _route_calls(monkeypatch)
    got = port()
    assert calls == {"mask": 1, "keep": 1}
    want = jax.jit(ref)()
    assert int(got[2].sum()) > 0
    _equal(got, want, box_tol)
