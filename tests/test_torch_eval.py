"""The port's evaluation against the JAX package's, on the CPU: VOC mAP
(rotated and horizontal, ignore gts, scale ranges), the tp/fp pass on
identical IoU matrices, the COCO protocol, and the DOTA patch merge and
Task1 submission.

The IoUs of the two packages agree to float rounding, not bit for bit
(JAX's eval may take its native C++ IoU), and a tp/fp decision at an IoU
within rounding of a threshold is a discrete function of that noise. So
the detections here are drawn until no IoU lies within 1e-4 of a
threshold (0.5:0.05:0.95 for the mAP, 0.1 for the merge), no detection's
two best IoUs are within 1e-4, and no area within 1e-4 (relative) of a
scale-range edge; then per-class AP and mAP agree within 1e-6.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

from sm3det_tpu.core.evaluation import coco_eval as jax_coco
from sm3det_tpu.core.evaluation import eval_map as jax_map
from sm3det_tpu.core.patch import split_merge as jax_sm
from sm3det_tpu_torch.core.evaluation import coco_eval as port_coco
from sm3det_tpu_torch.core.evaluation import eval_map as port_map
from sm3det_tpu_torch.core.patch import split_merge as port_sm
from sm3det_tpu_torch.ops.cuda.hbb_iou_kernel import hbb_iou_ref
from sm3det_tpu_torch.ops.cuda.rotated_iou_kernel import rotated_iou_ref

THRS = np.round(0.5 + 0.05 * np.arange(10), 2)
SCALES = [(0, 24), (24, 48), (48, 1000)]
EDGES = np.array([24.0 ** 2, 48.0 ** 2])
NC = 4


def _iou(a, b, box_dim):
    ta, tb = torch.from_numpy(a[:, :box_dim]), torch.from_numpy(b)
    f = rotated_iou_ref if box_dim == 5 else hbb_iou_ref
    return f(ta, tb).numpy()


def _area(b, box_dim):
    return b[:, 2] * b[:, 3] if box_dim == 5 else \
        (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


def _safe(ious, thrs, margin=1e-4, top2=True):
    """No IoU within margin of a threshold; with ``top2``, the two best of
    a row apart."""
    if ious.size == 0:
        return True
    if np.abs(ious[..., None] - np.asarray(thrs)).min() <= margin:
        return False
    if top2 and ious.shape[1] > 1:
        top = np.sort(ious, 1)[:, -2:]
        if ((top[:, 1] - top[:, 0] <= margin) & (top[:, 1] > 0)).any():
            return False
    return True


def _far_from_edges(areas):
    return len(areas) == 0 or \
        (np.abs(areas[:, None] / EDGES - 1) > 1e-4).all()


def _obb(rng, n, span=200.0):
    return np.stack([rng.uniform(20, span, n), rng.uniform(20, span, n),
                     rng.uniform(10, 60, n), rng.uniform(6, 30, n),
                     rng.uniform(-1.5, 1.5, n)], -1).astype(np.float32)


def _hbb(rng, n, span=200.0):
    xy = rng.uniform(10, span, (n, 2))
    wh = rng.uniform(8, 60, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _make_case(box_dim, seed, n_img=6, with_ignore=True):
    """Per image: gts and ignore gts of NC classes, detections near them
    (jittered) and a few stray ones, each class's drawn until safe."""
    rng = np.random.RandomState(seed)
    draw = _obb if box_dim == 5 else _hbb
    det_results, annotations = [], []
    for i in range(n_img):
        while True:
            k = rng.randint(2, 9)
            gts = draw(rng, k)
            if _far_from_edges(_area(gts, box_dim)):
                break
        labels = rng.randint(0, NC, k).astype(np.int64)
        if i == 1:                      # an image without gts
            gts, labels = gts[:0], labels[:0]
        ann = dict(bboxes=gts, labels=labels)
        ign = np.zeros((0, box_dim), np.float32)
        if with_ignore and i % 2 == 0:
            while True:
                ign = draw(rng, 2)
                if _far_from_edges(_area(ign, box_dim)):
                    break
            ann["bboxes_ignore"] = ign
            ann["labels_ignore"] = rng.randint(0, NC, 2).astype(np.int64)
        per_class = []
        for c in range(NC):
            both = np.concatenate([gts[labels == c], ign[
                ann.get("labels_ignore", np.zeros(0, int)) == c]])
            for _ in range(1000):
                src = both[rng.randint(0, len(both), rng.randint(0, 4))] \
                    if len(both) else np.zeros((0, box_dim), np.float32)
                jit = rng.normal(0, 2.5, src.shape).astype(np.float32)
                if box_dim == 5:
                    jit[:, 4] *= 0.04
                stray = draw(rng, rng.randint(0, 3))
                d = np.concatenate([src + jit, stray]).astype(np.float32)
                if box_dim == 4:
                    d[:, 2:] = np.maximum(d[:, 2:], d[:, :2] + 2)
                if _far_from_edges(_area(d, box_dim)) and (
                        not len(both) or _safe(_iou(d, both, box_dim),
                                               THRS)):
                    break
            else:
                raise AssertionError("no safe draw")
            scores = rng.uniform(0.05, 1.0, (len(d), 1)).astype(np.float32)
            per_class.append(np.concatenate([d, scores], 1))
        if i == 3:                      # an image without detections
            per_class = [p[:0] for p in per_class]
        det_results.append(per_class)
        annotations.append(ann)
    return det_results, annotations


def _assert_same_map(got, ref):
    for k in ("mAP50", "mAP75", "mAP"):
        assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])
    assert got["per_class_ap50"].keys() == ref["per_class_ap50"].keys()
    for c, v in ref["per_class_ap50"].items():
        assert abs(got["per_class_ap50"][c] - v) <= 1e-6
    for k, v in ref.get("per_scale_ap50", {}).items():
        assert abs(got["per_scale_ap50"][k] - v) <= 1e-6


@pytest.mark.parametrize("box_dim", [5, 4])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scales", [None, SCALES])
def test_eval_rbbox_map_matches_jax(box_dim, seed, scales):
    dets, anns = _make_case(box_dim, seed)
    ref = jax_map.eval_rbbox_map(dets, anns, box_dim=box_dim,
                                 scale_ranges=scales, logger=None)
    got = port_map.eval_rbbox_map(dets, anns, box_dim=box_dim,
                                  scale_ranges=scales, logger=None,
                                  device="cpu")
    assert ref["mAP50"] > 0.1             # the case really matches
    _assert_same_map(got, ref)


def test_eval_rbbox_map_without_ignore_and_chunked(monkeypatch):
    """Images packed one a chunk give the result of one chunk."""
    dets, anns = _make_case(5, 3, with_ignore=False)
    ref = jax_map.eval_rbbox_map(dets, anns, logger=None)
    whole = port_map.eval_rbbox_map(dets, anns, logger=None, device="cpu")
    monkeypatch.setitem(port_map.MAX_PAIRS, "cpu", 1)
    one_each = port_map.eval_rbbox_map(dets, anns, logger=None,
                                       device="cpu")
    _assert_same_map(whole, ref)
    assert one_each == whole


def test_pairwise_ious_blocks_equal_the_plain_iou():
    dets, anns = _make_case(5, 4)
    gts = [[a["bboxes"][a["labels"] == c] for c in range(NC)] for a in anns]
    ious = port_map.pairwise_ious(dets, gts, 5, "cpu")
    n_blocks = 0
    for i in range(len(dets)):
        for c in range(NC):
            d, g = dets[i][c], gts[i][c]
            if len(d) and len(g):
                n_blocks += 1
                np.testing.assert_array_equal(ious[(i, c)], _iou(d, g, 5))
            else:
                assert (i, c) not in ious
    assert len(ious) == n_blocks > 0


@pytest.mark.parametrize("ranges", [None, [(None, None), (0, 900),
                                           (900, 1e6)]])
@pytest.mark.parametrize("box_dim", [5, 4])
def test_tpfp_on_identical_ious(ranges, box_dim):
    rng = np.random.RandomState(5)
    draw = _obb if box_dim == 5 else _hbb
    for trial in range(20):
        det = np.concatenate([draw(rng, 12), rng.rand(12, 1)], 1) \
            .astype(np.float32)
        gts, ign = draw(rng, 5), draw(rng, trial % 3)
        ious = rng.rand(12, 5 + len(ign)).astype(np.float32)
        ious[rng.rand(*ious.shape) < 0.3] = 0.0
        for thr in (0.5, 0.75):
            tp_j, fp_j = jax_map._tpfp(det, gts, ign, ious, thr, ranges,
                                       box_dim)
            tp_p, fp_p = port_map._tpfp(det, gts, ign, ious, thr, ranges,
                                        box_dim)
            np.testing.assert_array_equal(tp_p, tp_j)
            np.testing.assert_array_equal(fp_p, fp_j)


@pytest.mark.parametrize("mode", ["area", "11points"])
def test_average_precision_matches_jax(mode):
    rng = np.random.RandomState(0)
    rec = np.sort(rng.rand(30))
    prec = rng.rand(30)
    assert port_map.average_precision(rec, prec, mode) == \
        jax_map.average_precision(rec, prec, mode)


def _coco_case(seed):
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for i in range(5):
        k = rng.randint(1, 8)
        gts = _hbb(rng, k, span=300)
        labels = rng.randint(0, NC, k)
        ann = dict(bboxes=gts, labels=labels,
                   areas=_area(gts, 4).astype(np.float64) *
                   rng.uniform(0.5, 1.5, k))
        if i % 2:
            ann["bboxes_crowd"] = _hbb(rng, 1, span=300)
            ann["labels_crowd"] = rng.randint(0, NC, 1)
            ann["areas_crowd"] = np.array([500.0])
        per_class = []
        for c in range(NC):
            src = gts[labels == c]
            d = np.concatenate([src + rng.normal(0, 3, src.shape),
                                _hbb(rng, rng.randint(0, 3), span=300)])
            d[:, 2:] = np.maximum(d[:, 2:], d[:, :2] + 2)
            per_class.append(np.concatenate(
                [d, rng.rand(len(d), 1)], 1).astype(np.float32))
        dets.append(per_class)
        anns.append(ann)
    return dets, anns


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("classwise", [False, True])
def test_coco_eval_bbox_matches_jax(seed, classwise):
    dets, anns = _coco_case(seed)
    names = [f"c{i}" for i in range(NC)]
    ref = jax_coco.coco_eval_bbox(dets, anns, classwise=classwise,
                                  class_names=names, logger=None)
    got = port_coco.coco_eval_bbox(dets, anns, classwise=classwise,
                                   class_names=names, logger=None)
    assert got.keys() == ref.keys()
    assert ref["bbox_mAP_50"] > 0
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-6, k
        elif isinstance(v, dict):
            for kk, vv in v.items():
                assert got[k][kk] == vv or (np.isnan(vv) and
                                            np.isnan(got[k][kk]))
        else:
            assert got[k] == v


# ---- the DOTA patch merge and submission -----------------------------------

PATCH_IDS = ["P0001__1.0__0___0", "P0001__1.0__512___0",
             "P0001__1.0__0___512", "P0002__0.5__0___0",
             "P0002__0.5__824___0", "P0003"]


def _patch_results(seed):
    """Detections of overlapping patches; the translated boxes of
    neighbouring patches overlap each other, never with an IoU within
    1e-4 of the merge's 0.1."""
    rng = np.random.RandomState(seed)
    metas = [port_sm.parse_patch_id(p) for p in PATCH_IDS]
    while True:
        res = []
        for p in PATCH_IDS:
            per_class = []
            for c in range(NC):
                k = rng.randint(0, 6)
                d = _obb(rng, k, span=150)
                per_class.append(np.concatenate(
                    [d, rng.rand(k, 1)], 1).astype(np.float32))
            res.append(per_class)
        ok = True
        for c in range(NC):
            by_base = {}
            for (base, sc, x0, y0), r in zip(metas, res):
                d = r[c].copy()
                d[:, :4] /= sc
                d[:, 0] += x0
                d[:, 1] += y0
                by_base.setdefault(base, []).append(d)
            for ds in by_base.values():
                cat = np.concatenate(ds)
                io = _iou(cat, cat[:, :5], 5)
                np.fill_diagonal(io, 0.0)
                ok &= _safe(io, [0.1], top2=False)
        if ok:
            return res


def test_parse_patch_id_matches_jax():
    names = PATCH_IDS + ["P0706__1024__0___0", "P2805__1.5__1648___824",
                         "my__img__1.0__10___20", "P0001__1.0__0__0",
                         "plain_name", "P0001__x__0___0"]
    for n in names:
        assert port_sm.parse_patch_id(n) == jax_sm.parse_patch_id(n)
    assert port_sm.parse_patch_id("P0001__1.0__0___600") == \
        ("P0001", 1.0, 0.0, 600.0)


def test_merge_and_submission_match_jax(tmp_path):
    res = _patch_results(0)
    ref = jax_sm.merge_det_by_patch_ids(PATCH_IDS, res, NC)
    got = port_sm.merge_det_by_patch_ids(PATCH_IDS, res, NC, device="cpu")
    assert got.keys() == ref.keys() == {"P0001", "P0002", "P0003"}
    n_kept = 0
    for base in ref:
        for c in range(NC):
            np.testing.assert_array_equal(got[base][c],
                                          np.asarray(ref[base][c]))
            n_kept += len(ref[base][c])
    n_in = sum(len(r[c]) for r in res for c in range(NC))
    assert 0 < n_kept < n_in             # the merge suppressed some
    names = [f"cls-{c}" for c in range(NC)]
    zj = jax_sm.write_dota_submission(ref, names, str(tmp_path / "jax"))
    zp = port_sm.write_dota_submission(got, names, str(tmp_path / "port"))
    with zipfile.ZipFile(zj) as a, zipfile.ZipFile(zp) as b:
        assert sorted(a.namelist()) == sorted(b.namelist()) == sorted(
            f"Task1_{n}.txt" for n in names)
        for n in a.namelist():
            assert a.read(n) == b.read(n)
    assert os.path.getsize(tmp_path / "port" / "Task1_cls-0.txt") > 0


def test_merge_patch_results_matches_jax():
    rng = np.random.RandomState(3)
    res = _patch_results(2)
    dets = [np.concatenate(r) for r in res]
    labels = [np.concatenate([np.full(len(x), c) for c, x in enumerate(r)])
              for r in res]
    offsets = [(float(rng.randint(0, 500)), float(rng.randint(0, 500)),
                float(rng.choice([1.0, 0.5]))) for _ in res]
    for max_per_img in (2000, 3):
        ref = jax_sm.merge_patch_results(dets, labels, offsets, NC,
                                         max_per_img=max_per_img)
        got = port_sm.merge_patch_results(dets, labels, offsets, NC,
                                          max_per_img=max_per_img,
                                          device="cpu")
        for c in range(NC):
            np.testing.assert_allclose(got[c], np.asarray(ref[c]),
                                       rtol=0, atol=0)


def test_multiscale_windows_match_jax():
    a = jax_sm.get_multiscale_patch([1024, 512], [824, 412], [1.0, 0.5])
    b = port_sm.get_multiscale_patch([1024, 512], [824, 412], [1.0, 0.5])
    assert a == b
    assert port_sm.slide_window(2500, 1700, *b) == \
        jax_sm.slide_window(2500, 1700, *a)
