#!/usr/bin/env python3
"""Rows 5 and 6's mask mode with and without the band, timed on one CUDA
card: the shipped ``rotated_nms_mask`` (``sm3det_tpu_torch/ops/cuda/csrc/
rotated_iou.cu``: pairs apart by a margin decided +0, every other pair
clipped by the exact pair function) against the same source built with
``-DSM3DET_ROTATED_IOU_BAND=1``, which decides ``iou > thr`` without IEEE
division where a bound on the exact pair function's rounding allows (the
argument is in the source) and clips only the rest.

Run from the root of the repository on a machine with a card:

    python3 tools/profiling/torch_rotated_iou_band.py [--rounds 4]
        [--iters 20] [--seed 0]

The variant is built with the library's nvcc flags into
``ops/cuda/_build/variants/`` and called through its own C entry. Inputs:
clustered rotated boxes as ``chip_smoke.py`` phase 3 draws them (the
``aug_test`` merge's (1, 4000) at thr 0.1 over 24 clusters, and denser
ones over 2 and 4 clusters), the R-CNN's banded (8, 2000) with 26 sorted
classes and an inert tail, with no class offset and at 4000 px a class,
and the joint forward's own R-CNN NMS input ([8 SAR : 4 RGB : 4
infrared] random 800^2 images through the full-width bf16
``TriSourceDetector``, random weights from ``--seed``, recorded as the NMS
receives it). Both builds are held bit for bit against the plain version
on the pairs whose IoU is defined (a box of no size against a real one is
not); then they are timed with CUDA events, ``--iters`` launches a
round, ``--rounds`` rounds, the order reversed every other round: the
median ms a launch. It exits non-zero if a bit differs. It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def log(*a):
    print(*a, flush=True)


def build_band():
    """The band build of rotated_iou.cu: its sm3det_rotated_nms_mask."""
    from sm3det_tpu_torch.ops.cuda import build
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "rotated_iou_band.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-DSM3DET_ROTATED_IOU_BAND=1",
           "-I", str(build.CSRC), "-shared", "-o", str(so),
           str(build.CSRC / "rotated_iou.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    (out / "rotated_iou_band.log").write_text(p.stdout + p.stderr)
    if p.returncode:
        raise RuntimeError(f"nvcc failed on the band build:\n{p.stderr}")
    fn = ctypes.CDLL(str(so)).sm3det_rotated_nms_mask
    fn.argtypes = build._SIGNATURES["sm3det_rotated_nms_mask"]
    fn.restype = ctypes.c_int
    return fn


def clustered(torch, gen, bsz, n, k, dev):
    """chip_smoke.py's rotated_boxes over k cluster centres."""
    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev)
    centres = u(bsz, k, 2) * 700 + 50
    pick = torch.randint(0, k, (bsz, n), generator=gen, device=dev)
    ctr = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) \
        + torch.randn(bsz, n, 2, generator=gen, device=dev) * 25
    side = 8 * 2 ** (u(bsz, n) * 4.5)
    asp = 2 ** ((u(bsz, n) - .5) * 4)
    boxes = torch.stack([ctr[..., 0], ctr[..., 1], side * asp, side / asp,
                         (u(bsz, n) - 0.5) * 3.14], -1)
    boxes[:, 1::9] = boxes[:, 0::9][:, :boxes[:, 1::9].shape[1]]
    boxes[:, -5:] = 0.0
    return boxes


def joint_rcnn_input(torch, seed):
    """The boxes, threshold and groups the joint forward's R-CNN NMS gets
    (the model as tools/profiling/torch_sar_profile.py --path joint
    builds it)."""
    from sm3det_tpu_torch.models.detectors.trisource import (
        DEFAULT_MODEL_CFG, TriSourceDetector)
    from sm3det_tpu_torch.ops import nms as nms_mod
    model = TriSourceDetector(dict(DEFAULT_MODEL_CFG,
                                   compute_dtype="bfloat16"), seed=seed)
    model.sar_bbox_head.gfl_cls.bias.fill_(0.0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    imgs, rgb, ifr = (torch.rand(b, 800, 800, 3, generator=gen,
                                 device="cuda") for b in (8, 4, 4))
    with torch.no_grad():
        _, x, rpn = model.head_joint(imgs, rgb, ifr)
        props, _, _ = model.get_proposals(*rpn, (800, 800))
        rf = model.roi_feats(x, props)
        for head, part in ((model.rgb_roi_head, rf[:rf.shape[0] // 2]),
                           (model.ifr_roi_head, rf[rf.shape[0] // 2:])):
            logits, _ = head(part)
            head.fc_cls.weight.mul_(3.0 / logits.float().std().item())
    seen, mask_fn = [], nms_mod.rotated_nms_mask

    def recording(*a, **kw):
        seen.append((a, kw))
        return mask_fn(*a, **kw)
    nms_mod.rotated_nms_mask = recording
    try:
        model.simple_test_joint(imgs, rgb, ifr, img_shape=(800, 800))
    finally:
        nms_mod.rotated_nms_mask = mask_fn
    a, kw = seen[-1]
    groups = a[2] if len(a) > 2 else kw.get("groups")
    return a[0].float().contiguous(), a[1], \
        groups.to(torch.int32).contiguous()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from chip_smoke import nvidia_smi_line
    from sm3det_tpu_torch.ops.cuda import build
    from sm3det_tpu_torch.ops.cuda import nms_keep_kernel as nkk
    from sm3det_tpu_torch.ops.cuda import rotated_iou_kernel as rik

    t0 = time.perf_counter()
    fns = {"shipped": build.load_library().sm3det_rotated_nms_mask,
           "band": build_band()}
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
        f"{nvidia_smi_line()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def launch(name, boxes, thr, groups):
        bsz, n = boxes.shape[:2]
        out = torch.empty((bsz, n, -(-n // 32)), device=dev,
                          dtype=torch.int32)
        rc = fns[name](boxes.data_ptr(), build.ptr(groups), out.data_ptr(),
                       bsz, n, thr, build.stream_ptr(dev))
        build.check(rc, f"rotated_nms_mask ({name})")
        return out

    def banded(bsz, offset):
        boxes = clustered(torch, gen, bsz, 2000, 24, dev)
        groups = torch.sort(torch.randint(0, 26, (bsz, 2000), generator=gen,
                                          device=dev), dim=-1).values.int()
        boxes[..., :2] += (groups * offset)[..., None]
        groups[:, -250:] = rik.INERT_GROUP
        return boxes, 0.1, groups

    cases = {
        "aug_test merge (1, 4000), 24 clusters, thr 0.1":
            (clustered(torch, gen, 1, 4000, 24, dev), 0.1, None),
        "dense (1, 4000), 2 clusters, thr 0.1":
            (clustered(torch, gen, 1, 4000, 2, dev), 0.1, None),
        "dense (8, 2000), 4 clusters, thr 0.5":
            (clustered(torch, gen, 8, 2000, 4, dev), 0.5, None),
        "R-CNN banded (8, 2000), no class offset": banded(8, 0.0),
        "R-CNN banded (2, 2000), class offset 4000": banded(2, 4000.0),
        "joint forward's R-CNN input (8, 2000)":
            joint_rcnn_input(torch, args.seed),
    }
    bad = []
    for what, (boxes, thr, groups) in cases.items():
        n = boxes.shape[1]
        ref = torch.cat([rik.rotated_nms_mask_ref(
            boxes[i:i + 1], thr, None if groups is None else groups[i:i + 1])
            for i in range(boxes.shape[0])])
        real = boxes[..., 2] * boxes[..., 3] > 0
        ok = real[..., :, None] == real[..., None, :]
        want = nkk.unpack_bits(ref, n) & ok
        same = {k: torch.equal(nkk.unpack_bits(launch(k, boxes, thr, groups),
                                               n) & ok, want) for k in fns}
        times = {k: [] for k in fns}
        order = list(fns)
        for r in range(args.rounds):
            for k in (order if r % 2 == 0 else order[::-1]):
                launch(k, boxes, thr, groups)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                s.record()
                for _ in range(args.iters):
                    launch(k, boxes, thr, groups)
                e.record()
                torch.cuda.synchronize()
                times[k].append(s.elapsed_time(e) / args.iters)
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"[band] {what}: shipped {med['shipped']:.4f} ms, band "
            f"{med['band']:.4f} ms a launch (median of {args.rounds} rounds "
            f"of {args.iters}); {int(want.sum())} bits set; bit-equal to "
            f"the plain version: shipped {same['shipped']}, band "
            f"{same['band']}")
        bad += [f"{k} on {what}" for k, v in same.items() if not v]
    if bad:
        sys.exit(f"bits differ from the plain version: {bad}")
    log("[band] every bit equal to the plain version")


if __name__ == "__main__":
    main()
