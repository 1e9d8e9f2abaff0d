"""The port's pyramid rotated RoI align against the JAX package, on the CPU.

The plain version (``roi_align_rotated_pyramid`` with ``route_levels``, which
the CUDA kernel's wrapper takes for CPU tensors) against the JAX package's
exact path ``extract_rotated_roi_feats`` and against its Pallas kernel in
interpret mode. fp32, features of order 1: 1e-5 absolute, the rounding of
the sample coordinates times the features' slope. (The JAX exact path folds
the batch and level offsets into the row coordinate before it takes the
bilinear weight, which costs it a few 1e-6 on later images; the port
samples each level in its own frame.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.roi_heads.oriented_roi_head import \
    extract_rotated_roi_feats as jax_extract
from sm3det_tpu.ops.pallas.roi_align_kernel import (
    compute_patch_size, roi_align_rotated_pyramid_fused, route_levels
    as jax_route_levels)
from sm3det_tpu_torch.models.roi_heads.oriented_roi_head import \
    extract_rotated_roi_feats
from sm3det_tpu_torch.ops.cuda import roi_align_kernel as rak
from sm3det_tpu_torch.ops.roi_align_rotated import (
    roi_align_rotated_pyramid, route_levels)
from torch_jax_refs import one_torch_thread  # noqa: F401

STRIDES = (4, 8, 16, 32)
SIZE = 256


def _pyramid(rng, bsz, c, extra_level=True):
    strides = STRIDES + ((64,) if extra_level else ())
    return [rng.rand(bsz, SIZE // s, SIZE // s, c).astype(np.float32)
            for s in strides]


def _rois(rng, bsz, n):
    """RoIs on every level, rotated, some over the border, some of no
    size."""
    side = 8 * 2 ** rng.uniform(0, 5.5, n)                    # 8 .. 360 px
    aspect = 2 ** rng.uniform(-1.5, 1.5, n)
    rois = np.stack([rng.randint(0, bsz, n),
                     rng.uniform(-20, SIZE + 20, n),
                     rng.uniform(-20, SIZE + 20, n),
                     side * aspect, side / aspect,
                     rng.uniform(-1.55, 1.55, n)], -1).astype(np.float32)
    rois[::13, 1:] = 0.0                                      # padding
    return rois


def test_route_levels_matches_jax_rule():
    rng = np.random.RandomState(0)
    rois = _rois(rng, 2, 400)
    rois[:4, 3:5] = [[56, 56], [112, 112], [224, 224], [448, 448]]
    got = route_levels(torch.from_numpy(rois)).numpy()
    scale = np.sqrt(np.maximum(rois[:, 3] * rois[:, 4], 1e-6))
    want = np.clip(np.floor(np.log2(scale / 56 + 1e-6)), 0, 3)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    assert set(got.tolist()) == {0, 1, 2, 3}
    assert got[::13].max() == 0                # zero-size RoIs: level 0


@pytest.mark.parametrize("bsz", [1, 3])
def test_pyramid_align_matches_jax_exact_path(bsz):
    rng = np.random.RandomState(bsz)
    feats = _pyramid(rng, bsz, 16)
    rois = _rois(rng, bsz, 150)
    ref = np.asarray(jax_extract([jnp.asarray(f) for f in feats[:4]],
                                 jnp.asarray(rois)))
    got = extract_rotated_roi_feats(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois))
    assert got.shape == ref.shape == (150, 7, 7, 16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    # a zero-size RoI reads feat[b, 0, 0] of level 0 in every bin
    b0 = int(rois[0, 0])
    np.testing.assert_allclose(
        got[0].numpy(), np.broadcast_to(feats[0][b0, 0, 0], (7, 7, 16)),
        atol=1e-6)
    # a RoI far outside the image is all zeros
    far = rois[:1].copy()
    far[0, 1:] = [-900.0, -900.0, 40.0, 20.0, 0.3]
    out = extract_rotated_roi_feats([torch.from_numpy(f) for f in feats],
                                    torch.from_numpy(far))
    assert float(out.abs().max()) == 0.0


def test_pyramid_align_constant_map_and_chunks():
    rng = np.random.RandomState(5)
    feats = [torch.full((2, SIZE // s, SIZE // s, 8), 3.0) for s in STRIDES]
    rois = np.stack([rng.randint(0, 2, 40), rng.uniform(60, 190, 40),
                     rng.uniform(60, 190, 40), rng.uniform(10, 100, 40),
                     rng.uniform(10, 100, 40), rng.uniform(-1.5, 1.5, 40)],
                    -1).astype(np.float32)
    rois = torch.from_numpy(rois)
    lvls = route_levels(rois)
    out = roi_align_rotated_pyramid(feats, rois, lvls, 7)
    np.testing.assert_allclose(out.numpy(), 3.0, atol=1e-5)   # inside: const
    rnd = [torch.from_numpy(f) for f in _pyramid(rng, 2, 8, False)]
    whole = roi_align_rotated_pyramid(rnd, rois, lvls, 7)
    chunked = roi_align_rotated_pyramid(rnd, rois, lvls, 7, roi_chunk=7)
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())
    half = roi_align_rotated_pyramid([f.bfloat16() for f in rnd], rois, lvls,
                                     7)
    assert half.dtype == torch.bfloat16
    ref = roi_align_rotated_pyramid([f.bfloat16().float() for f in rnd],
                                    rois, lvls, 7)
    # one rounding to bf16 at the end: half a step of 2^-8 relative
    np.testing.assert_allclose(half.float().numpy(), ref.numpy(),
                               rtol=2.0 ** -8, atol=0)


def test_pyramid_align_matches_pallas_interpret():
    """The sampling against the TPU kernel's, both on the TPU kernel's
    extent-clamped levels (the way the JAX package's own test holds its
    kernel against its exact path); the port's own routing is the exact
    rule, which the clamp only ever moves to a coarser level."""
    rng = np.random.RandomState(0)
    bsz, c, n = 2, 64, 64
    feats = _pyramid(rng, bsz, c, extra_level=False)
    rois = np.stack([rng.randint(0, bsz, n), rng.uniform(30, 220, n),
                     rng.uniform(30, 220, n), rng.uniform(16, 140, n),
                     rng.uniform(8, 140, n), rng.uniform(-1.5, 1.5, n)],
                    -1).astype(np.float32)
    jf = [jnp.asarray(f) for f in feats]
    patch = compute_patch_size([f.shape[1] for f in feats],
                               [f.shape[2] for f in feats])
    clamped = np.asarray(jax_route_levels(jnp.asarray(rois), patch, STRIDES,
                                          56, 4))
    ours = route_levels(torch.from_numpy(rois)).numpy()
    assert (ours <= clamped).all() and (ours == clamped).any()
    fused = np.asarray(roi_align_rotated_pyramid_fused(
        jf, jnp.asarray(rois), 7, interpret=True))
    tf = [torch.from_numpy(f) for f in feats]
    got = roi_align_rotated_pyramid(tf, torch.from_numpy(rois),
                                    torch.from_numpy(clamped), 7).numpy()
    rel = np.abs(got - fused).max() / np.abs(fused).max()
    assert rel < 1e-4, rel                 # the JAX test's own tolerance
    same = ours == clamped                 # where the clamp is idle
    via_wrapper = rak.roi_align_rotated_pyramid_fused(
        tf, torch.from_numpy(rois)).numpy()
    np.testing.assert_array_equal(via_wrapper[same], got[same])


def test_align_wrapper_rejects_what_the_kernel_does_not_take():
    feats = [torch.zeros(1, 8, 8, 4, device="meta")]
    rois = torch.zeros(3, 6, device="meta")
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        rak.roi_align_rotated_pyramid_fused(feats, rois,
                                            featmap_strides=(4,))
