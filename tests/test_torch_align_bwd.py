"""Row 8 (the pyramid RoI align's feature gradient) and the R-CNN
assigner's batched IoU, on the CPU.

The port's plain backward ``roi_align_rotated_pyramid_bwd_ref`` (what the
CUDA kernels are held against on the card) against the JAX package's Pallas
backward ``roi_align_rotated_pyramid_fused_bwd`` in interpret mode; the
plain version of the CUDA backward's tile rule (``touched_boxes_ref``: a RoI
is summed into the tiles its box of touched pixels meets); and the batched
assigner IoU (one launch for the R-CNN branch's images) against the
per-image one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.ops.pallas.roi_align_kernel import (
    compute_patch_size, roi_align_rotated_pyramid_fused_bwd, route_levels
    as jax_route_levels)
from sm3det_tpu_torch.models.roi_heads.oriented_roi_head import (
    candidate_gt_ious, sample_rois_for_training)
from sm3det_tpu_torch.ops.cuda import roi_align_kernel as rak
from sm3det_tpu_torch.ops.cuda.rotated_iou_kernel import rotated_iou
from sm3det_tpu_torch.ops.roi_align_rotated import route_levels
from torch_jax_refs import one_torch_thread  # noqa: F401

STRIDES = (4, 8, 16, 32)
SIZE = 256


def _rois(rng, bsz, n):
    """RoIs on all four levels, rotated, one long and thin (200 x 6 px),
    one on the border, one larger than the image (the coarsest level)."""
    rois = np.stack([rng.randint(0, bsz, n), rng.uniform(30, 220, n),
                     rng.uniform(30, 220, n), rng.uniform(16, 140, n),
                     rng.uniform(8, 140, n), rng.uniform(-1.5, 1.5, n)],
                    -1).astype(np.float32)
    rois[0, 1:] = [128.0, 120.0, 200.0, 6.0, 0.4]         # long and thin
    rois[1, 1:] = [2.0, 250.0, 40.0, 30.0, -0.7]          # on the border
    rois[2, 1:] = [130.0, 110.0, 470.0, 460.0, 0.2]       # level 3
    return rois


def test_align_bwd_ref_matches_pallas_interpret():
    """2 images, C = 32, 50 RoIs over 4 levels, on the TPU kernel's
    extent-clamped levels (the port's routing is the exact rule, which the
    clamp only moves coarser; the forward's test does the same). fp32:
    1e-4 of the gradient's scale, the JAX package's own tolerance for its
    kernel (its bilinear weights go through a matrix product)."""
    rng = np.random.RandomState(8)
    bsz, c, n = 2, 32, 50
    feats = [np.zeros((bsz, SIZE // s, SIZE // s, c), np.float32)
             for s in STRIDES]
    rois = _rois(rng, bsz, n)
    g = rng.randn(n, 7, 7, c).astype(np.float32)
    patch = compute_patch_size([f.shape[1] for f in feats],
                               [f.shape[2] for f in feats])
    lvls = np.array(jax_route_levels(jnp.asarray(rois), patch, STRIDES,
                                     56, 4))
    assert set(lvls.tolist()) == {0, 1, 2, 3}
    ref = roi_align_rotated_pyramid_fused_bwd(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(g),
        7, STRIDES, interpret=True)
    got = rak.roi_align_rotated_pyramid_bwd_ref(
        torch.from_numpy(g), torch.from_numpy(rois), torch.from_numpy(lvls),
        [f.shape for f in feats], torch.float32, STRIDES)
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-4 * scale


@pytest.mark.parametrize("case", ["random", "one_centre"])
def test_touched_boxes_hold_each_rois_gradient(case):
    """The CUDA backward sums RoI n into an output tile only where n's box
    of touched pixels meets the tile, so that box must hold every pixel of
    n's own gradient. With g = 1 every touched pixel gets a positive
    gradient: the box equals the bounding box of the RoI's gradient, and is
    (-1, -1, -1, -1) for a RoI outside its level (and for none else)."""
    rng = np.random.RandomState(3)
    bsz, c, n = 2, 2, 40
    rois = _rois(rng, bsz, n)
    if case == "one_centre":
        rois[:, 0] = 0
        rois[:, 1:3] = 120.0
    rois[5, 1:3] = -900.0                                   # outside
    rois[6, 3:5] = 0.0                                      # no size
    rois_t = torch.from_numpy(rois)
    lvls = route_levels(rois_t)
    shapes = [(bsz, SIZE // s, SIZE // s, c) for s in STRIDES]
    boxes = rak.touched_boxes_ref(rois_t, lvls, shapes)
    assert boxes.shape == (n, 4)
    for i in range(n):
        grads = rak.roi_align_rotated_pyramid_bwd_ref(
            torch.ones(1, 7, 7, c), rois_t[i:i + 1], lvls[i:i + 1], shapes,
            torch.float32)
        lvl, b = int(lvls[i]), int(rois[i, 0])
        for k, gk in enumerate(grads):
            if k != lvl:
                assert float(gk.abs().max()) == 0.0
        on = torch.nonzero(grads[lvl][b].abs().sum(-1) > 0)
        if not on.numel():
            assert boxes[i].tolist() == [-1, -1, -1, -1], i
            continue
        want = [int(on[:, 0].min()), int(on[:, 0].max()),
                int(on[:, 1].min()), int(on[:, 1].max())]
        assert boxes[i].tolist() == want, i
    assert boxes[5].tolist() == [-1, -1, -1, -1]
    assert (boxes[[i for i in range(n) if i != 5], 0] >= 0).all()
    # the long, thin RoI alone spans many of its level's 8 x 8 tiles
    y0, y1, x0, x1 = (int(v) // rak.BWD_TILE for v in boxes[0])
    assert int(lvls[0]) == 0 and (y1 - y0 + 1) * (x1 - x0 + 1) >= 8


def test_batched_assigner_ious_match_per_image():
    """The train step computes the R-CNN assigner's IoU for all images of a
    branch in one call (``candidate_gt_ious``) and hands each image its
    slice to ``sample_rois_for_training``: the same IoU, bit for bit, as
    one ``rotated_iou`` call an image (the train step's earlier way), and
    so the same sampled RoIs, masks and gt indices."""
    rng = np.random.RandomState(4)
    bsz, n_gt, n_prop = 2, 5, 300

    def obbs(n):
        return np.stack([rng.uniform(20, 230, (bsz, n)),
                         rng.uniform(20, 230, (bsz, n)),
                         rng.uniform(8, 60, (bsz, n)),
                         rng.uniform(8, 60, (bsz, n)),
                         rng.uniform(-1.5, 1.5, (bsz, n))], -1)

    gts = torch.from_numpy(obbs(n_gt).astype(np.float32))
    props = torch.from_numpy(obbs(n_prop).astype(np.float32))
    props[:, :60] = gts[:, rng.randint(0, n_gt, 60)] + \
        torch.from_numpy(rng.randn(bsz, 60, 5).astype(np.float32)) * 3
    gt_mask = torch.ones(bsz, n_gt, dtype=torch.bool)
    gt_mask[1, -1] = False
    p_valid = torch.from_numpy(rng.rand(bsz, n_prop) > 0.1)
    labels = torch.from_numpy(rng.randint(0, 5, (bsz, n_gt)))
    keys = torch.from_numpy(rng.rand(2, bsz, n_gt + n_prop)
                            .astype(np.float32))
    ious = candidate_gt_ious(props, gts)
    assert ious.shape == (bsz, n_gt + n_prop, n_gt)
    n_pos = 0
    for i in range(bsz):
        args = ((keys[0, i], keys[1, i]), props[i], p_valid[i], gts[i],
                labels[i], gt_mask[i])
        own = rotated_iou(torch.cat([gts[i], props[i]]), gts[i])
        assert torch.equal(own, ious[i])
        one = sample_rois_for_training(*args, own, num=64)
        batched = sample_rois_for_training(*args, ious[i], num=64)
        assert one.keys() == batched.keys()
        for k in one:
            assert torch.equal(one[k], batched[k]), k
        n_pos += int(one["pos_mask"].sum())
    assert n_pos > 0
