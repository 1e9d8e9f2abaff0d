#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: requires a CUDA card; prints its name and power limit;
2. build: compiles the CUDA kernels from ``sm3det_tpu_torch/ops/cuda/csrc``
   and prints the nvcc time and each kernel's registers and shared memory;
3. kernels: holds every kernel against its plain PyTorch version on the
   card, at the main path's shapes (8 images of 800^2; 2000 proposals an
   image), in fp32 and bf16, and times kernel, plain version and, where
   there is one, a PyTorch library call;
4. end to end: (a) one 800^2 image in fp32 on the card against the same
   model on the host, stage by stage, for the SAR branch and for the RGB
   Oriented R-CNN branch; (b) the full-width 8 x 800^2 bf16
   ``simple_test(imgs, "sar")``; (c) the full-width joint forward
   ``simple_test_joint`` over [8 SAR : 4 RGB : 4 infrared] images of 800^2
   in bf16, with the launch counts of every kernel, images/s, peak memory
   and the stage times, and a one-image ``aug_test("rgb")`` that runs the
   un-banded rotated IoU kernel;
5. training: (a) one fp32 forward + backward of the full-width train step
   over [1 SAR : 1 RGB : 1 infrared] images of 512^2 on the card against
   the same model on the host, with the same host-made draws and the same
   proposals: every loss within 1e-3 relative, the gradient norm of each
   top-level subtree within 1e-2; (b) the full-width flagship train step
   (``DEFAULT_MODEL_CFG``, [4:2:2] x 800^2, bf16 policy, DLA switching on
   after two warmup steps, AdamW), warmed up, then 10 timed steps: images/s
   (median and quartiles), peak memory, every loss and the launches of
   every kernel in one step;
6. evaluation entry point: the flagship built from
   ``configs/sm3det_convnext_t.py`` through the port's config, registry
   and ``build_detector`` (bf16, random weights from seed 0), saved with
   ``save_params``; then ``sm3det_tpu_torch.tools.test``'s ``main``
   in-process on synthetic 1024^2 images (resized to 800^2), batch 8:
   (a) SAR COCO ``bbox`` over 32 images, RGB mAP over 32, SAR mAP over 16
   (images/s, the host pipeline's images/s alone, host syncs a batch in
   the loop, peak memory, metrics, launches); (b) ``eval_rbbox_map`` on
   the card (rows 5 and 4 in matrix mode) against the host's plain
   version on those detections: every AP bit-equal, and the gts given
   back as detections mAP 1.0; (c) ``--format-only`` on 8 patch-named
   images of two base images: the zip, and the card's merge equal to the
   host's; (d) ``inference_detector_by_patches`` of a 2048^2 image;
7. train entry point: ``sm3det_tpu_torch.tools.train``'s ``main``
   in-process: (a) ``configs/sm3det_convnext_t.py --synthetic-data`` at
   full width in bf16, [2:1:1] x 800^2, 30 iterations with a checkpoint at
   20 and an eval pass at 30 (train images/s after 2 warm iterations, the
   host pipeline's images/s alone, the loop's wait for batches, peak
   memory, the checkpoint's size and seconds, the launches of every
   kernel of the path; the host pipeline's stages timed one by one in
   one thread), then ``--resume-from iter_20``: the loaded state
   equal to the file bit for bit, and 5 more iterations with finite
   losses and the host synchronisations counted by part (the loop's own
   at most one a log line); (b) ``configs/convergence_synth.py`` in bf16
   for 300 iterations, each eval's mAP50 per modality beside the JAX
   package's bf16 and fp32 records: finite losses, the last window's
   total loss below the first's, the final SAR mAP50 at least 0.5;
8. LSKNet-MoE / VAN-MoE and the loss reweighting: (a) the detector of
   ``configs/local_configs/SM3Det_lsk_t.py`` at full width in fp32, one
   800^2 image on the card against the host, stage by stage (features,
   both necks, GFL and RPN heads) within 1e-3 of scale, with the linear
   experts' capacity dispatch keeping the same routes; (b) the bf16 joint
   forwards of ``SM3Det_lsk_t.py`` and ``SM3Det_van_t.py`` over [8 : 4 :
   4] x 800^2: images/s, device busy time, peak memory, 0 host syncs, the
   launches of every kernel, the stage times and the backbone's time by
   module kind; one forward of ``SM3Det_lsk_b.py``; (c) ``tools.test`` on
   LSK-T, SAR and RGB mAP over 16 synthetic images; (d) ``tools.train``
   on LSK-T, bf16, [2:1:1] x 800^2, 20 iterations with a checkpoint at 10
   and a resume equal to it bit for bit;
   ``main_uncertainty_convnext_t_orcnn_gfl.py`` 10 iterations
   (``reweighted_total_losses`` logged, ``mtl_sigma`` moved) and again
   with DWA (weights 1 at step 1 and not after, the carry in
   ``iter_10.pth``);
9. the TriSource head-combination variants and the zoo's single-dataset
   detectors: (a) H1-R1, H2-R1 and H2-R2 (``SM3Det_convnext_t_
   {s2anet_gfl, s2anet_frcnn, orcnn_frcnn}.py`` through
   ``build_detector``), one fp32 forward + backward at [1:1:1] x 512^2 on
   the card against the host with the same draws and proposals: every
   loss within 1e-3 relative, each top-level subtree's gradient norm
   within 1e-2; (b) ``tools.train`` on the H2-R2 config, bf16, [2:1:1] x
   800^2, ``evaluation=None``, DLA on after two iterations: 12 iterations
   with a checkpoint at 6 and a resume equal to it bit for bit, then 6
   iterations of H1-R1 (the retina assigner): images/s, peak memory,
   host syncs by part, the losses, the launches a step; (c)
   ``simple_test`` of ``OrientedRCNN``, ``GFL`` and ``RotatedRetinaNet``
   (``dota_convnext_t_orcnn.py``, ``sardet50k_convnext_t_gfl.py``) at 8 x
   800^2 bf16: images/s, peak memory, host syncs, launches; then
   ``OrientedRCNN`` at one 800^2 image in fp32, card against host, stage
   by stage;
10. the refinement and cascade detectors: (a) ``R3Det``, ``S2ANet``
   (``refine_reg_loss`` smooth_l1 and kfiou) and ``RoITransformer``
   (``dota_convnext_t_{s2anet,roitrans}.py``, full width) in fp32 at 2 x
   256^2, one forward + backward on the card against the host with the
   same parameters, batch and sampler keys: every loss within 1e-3
   relative, each subtree's gradient norm within 1e-2; (b)
   ``S2ANet.simple_test`` and ``R3Det.simple_test`` at 8 x 800^2 bf16:
   images/s, device busy time, 0 host syncs, peak memory, the launches,
   and ``rotated_feature_align`` alone at level 0 beside its bytes;
   (c) bf16 AdamW train steps of ``S2ANet`` and ``RoITransformer``
   through the library API at 2 x 800^2: images/s, syncs a step, peak
   memory, finite losses, the launches a step;
11. the Domain-Attention baseline
   (``configs/local_configs/main_DA_convnext_t_orcnn_gfl.py``) and the
   backbone / neck / NMS leftovers: (a) fp32 at 2 images a modality x
   256^2, card against host: the features, necks, GFL / RPN outputs and
   R-CNN logits of each ``simple_test`` and of the joint forward within
   1e-3 of scale, one train forward's losses within 1e-3 relative and
   subtree gradient norms within 1e-2; (b) the joint [8:4:4] x 800^2 bf16
   forward: images/s, device busy time, 0 host syncs, and launches by
   kernel equal to the config's own (``DA_JOINT_LAUNCHES``), the FFN
   kernel of the DA blocks alone against its plain version; (c)
   ``tools.train`` bf16 [2:1:1] x 800^2, 6 iterations, DLA on after 2;
   (d) ``tools.test`` rgb and sar over 16 synthetic images; (e) the
   flagship with ``gate="linear"`` (row 3 launched), ``soft_nms`` and the
   GRN block on the card against their plain versions. The phase must
   take at most 120 s;
12. the BabelRS configuration (``configs/BabelRS_configs/
   BabelRS_20kstep.py``: the InternViT-300M ViT-Adapter at full width
   under the TriSource heads): (a) fp32, TF32 off, 2 images a modality x
   256^2 on a model built for that grid, card against host: the
   backbone's 4 levels, both necks, GFL / RPN outputs and R-CNN logits
   within 1e-3 of scale, one train forward's losses within 1e-3 relative
   and the gradient norms of the ViT, adapter, SPM, neck and heads within
   1e-2; (b) the joint [8:4:4] x 800^2 bf16 forward: launches exactly
   ``BABELRS_JOINT_LAUNCHES`` (rows 4 mask, 6, 7 and the keep scan; none
   of rows 1, 2, 3, 9), 0 host syncs, images/s, device busy time, peak
   memory, and the device time of the ViT's attention and MLPs, the
   adapter's deformable sampling (beside its bound), the SPM and the
   neck + heads; (d) ``tools.test`` rgb over 16 synthetic images; (c)
   ``tools.train`` bf16 [1:1:1] x 800^2 with the config's layer decay
   (each parameter's scale read back from the optimizer), then EMA,
   ``accumulate=2`` and the cosine policy with a checkpoint
   mid-accumulation and a resume equal to it bit for bit. The phase must
   take at most 180 s, the whole script 1200 s.

Phase 3 also holds the variants' new shapes: row 4's mask mode and the
keep scan at the H2 SAR RPN's 4507 candidates an image, row 5's matrix
mode at the retina assigner's 120087 anchors x 512 and x 256 gts (bit for
bit), and rows 7 and 8 on axis-aligned RoIs with integer edges.

Phase 3 holds the NMS's kernels (the IoU kernels' mask mode, which packs
the decisions ``iou > thr`` into 32-bit words, and the greedy keep scan)
bit for bit against their plain versions at the main path's shapes, and
4c again on the joint forward's own NMS inputs, beside the matrix modes on
the same inputs; 4c and 5b count the host synchronisations of one joint
forward and one train step (``torch.cuda.set_sync_debug_mode("warn")``).
Phase 3 also holds rows 9, 2 and 10 against their plain versions at
ConvNeXt-L's and -XL's widest stages (C = 1536, 2048), row 7 on the joint
forward's own proposals in 4c, and logs an estimate of what row 7 reads
of the levels (the taps one by one against the staged footprints, from
the plain geometry). It also holds the
training kernels against their plain versions:
the pyramid RoI align's feature gradient (``roi_align_rotated_bwd.cu``, two
launches bit-equal, on random, one-centre and long, thin RoIs) and
the trainable dw7x7 + LN (``fused_dwconv_ln_train``: the forward kernel and
the five gradients of the ``dwconv_ln_bwd.cu`` kernels, against autograd of
the plain formulation and against the closed-form plain backward, and two
backward runs for bit-equal gradients), and row 9 at the LSKNet / VAN
widths (C = 32-512, 8 images of 800^2), counting the elements that differ
from its plain version.

It imports nothing of JAX. The second line from the end is the per-kernel
JSON record, the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, SXM
IMG = 800
N_IMGS = 8
JOINT = (8, 4, 4)          # SAR, RGB, infrared images of the joint forward
N_PROPOSALS = 2000         # rpn_max = rcnn pre_nms of DEFAULT_MODEL_CFG
# fp32 operations of one rotated-IoU pair: 32 edge-against-edge clips of
# ~17 operations (3 of them divisions) and 8 clipped-edge cross products
ROT_IOU_FLOPS = 650
# a distance test of two circumscribed circles (dx, dy, the squares and
# sums, a comparison)
CIRCLE_TEST_FLOPS = 8
# the H2 SAR RPN's NMS candidates at 800^2: min(1000, level) of 5 levels
H2_RPN_N = 4 * 1000 + 13 * 13 * 3
# stage geometry of ConvNeXt-T at 800^2: (H = W, C, dense blocks, MoE
# blocks, LayerNorms: stem, downsample into the next stage, output)
STAGES = [(200, 96, 3, 0, 3), (100, 192, 3, 0, 2), (50, 384, 4, 5, 2),
          (25, 768, 1, 2, 1)]
# the LSKNet-MoE / VAN-MoE archs of the SM3Det_{lsk,van}_{t,s,b} configs:
# (stage widths, depths); S has B's widths. A forward's LayerNorms at a
# stage: the patch embed's, two a block and the output's
LSK_ARCHS = {"t": ((32, 64, 160, 256), (3, 3, 5, 2)),
             "b": ((64, 128, 320, 512), (3, 3, 12, 3))}
TRAIN = (4, 2, 2)          # SAR, RGB, infrared images of the train step
TRAIN_GTS = 16             # gts an image, as bench.py --train
TRAIN_STEPS = 10
DLA_WARMUP = 2             # DLA switches on after two steps
HOST_IMG = 512             # card-against-host train check, [1:1:1]


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        "nvidia-smi unavailable"


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Mean CUDA-event time of ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def device_ms(torch, fn, iters=10, warmup=2, tries=3):
    """Mean device time of ``iters`` calls: the summed durations of the
    CUDA kernels ``torch.profiler`` records, without the host's gaps
    between them (at the small shapes the host's launches, not the
    kernels, set the CUDA-event time of a forward + backward). The
    profiler now and then records no CUDA event at all: such a trace is
    taken again, up to ``tries`` times, and then the time is None (not
    measured), never 0."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
        if us:
            return sum(us) / 1e3 / iters
        log("[time]   torch.profiler recorded no CUDA event; tracing again")
    return None


def ms_str(v):
    """A time for the log; None is a device time the profiler missed."""
    return "not measured" if v is None else f"{v:.4f} ms"


def timed_forwards(torch, fn, n=10):
    """Each call timed on its own (host clock, ended by a synchronize): the
    host's clock varies more than the device's, so the median and the
    quartiles are reported."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    q1, med, q3 = statistics.quantiles(walls, n=4)
    return walls, q1, med, q3


def spread_class_scores(head, roi_feats):
    """Random weights leave the 27-way softmax near 1/27, under
    rcnn_score_thr, and the NMS would see no candidate: scale fc_cls so
    that the logits' spread is 3."""
    logits, _ = head(roi_feats)
    head.fc_cls.weight.mul_(3.0 / logits.float().std().item())


def host_syncs(torch, fn):
    """Run ``fn`` once under ``torch.cuda.set_sync_debug_mode("warn")`` and
    count the synchronising calls by site: the innermost frame of the port
    (``sm3det_tpu_torch/...:line (function)``), else the warning's own."""
    import traceback
    import warnings
    sites = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        site = f"{filename}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if "sm3det_tpu_torch" in fr.filename:
                rel = fr.filename[fr.filename.index("sm3det_tpu_torch"):]
                site = f"{rel}:{fr.lineno} ({fr.name})"
                break
        sites[site] = sites.get(site, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def bound_ms(nbytes, work):
    """Least time for ``nbytes`` of traffic and ``work``, a list of
    (flops, dtype name of the unit that runs them)."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    tf = sum(f / PEAK_FLOPS[dt] for f, dt in work) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(got, ref):
    d = (got.float() - ref.float()).abs().max().item()
    return d, ref.float().abs().max().item()


class KernelRecord:
    """Per-forward totals of one kernel: times and bounds summed over the
    shapes phase 3 runs it at (for the backbone's kernels the 8-image SAR
    forward's; for the others the joint forward's), weighted by its
    launches there."""

    def __init__(self, name, source, replaces, library, sources=None):
        self.name, self.source, self.replaces = name, source, replaces
        self.sources = sources or [source]
        self.library = library
        self.ms = self.plain_ms = self.bound = 0.0
        self.library_ms = 0.0 if library else None
        self.device = None      # (kernel, library) device ms, where taken
        self.err = 0.0
        self.bound_kind = {}
        self.extra = {}         # further per-forward sums, e.g. ffn_ms

    def add_extra(self, n, **values):
        """Add ``n`` times each value; a None (not measured) makes the sum
        None: it is left unknown rather than counted as 0."""
        for k, v in values.items():
            old = self.extra.get(k, 0.0)
            self.extra[k] = None if v is None or old is None else old + n * v

    def add(self, n, ms, plain_ms, bound, kind, lib_ms):
        self.ms += n * ms
        self.plain_ms += n * plain_ms
        self.bound += n * bound
        self.bound_kind[kind] = self.bound_kind.get(kind, 0) + n * bound
        if self.library_ms is not None:
            self.library_ms += n * lib_ms

    def add_device(self, n, ms, lib_ms):
        k, lib = self.device or (0.0, 0.0)
        self.device = tuple(None if a is None or v is None else a + n * v
                            for a, v in ((k, ms), (lib, lib_ms)))

    def json(self, launches):
        rec = {"name": self.name, "route": "cuda", "source": self.source,
               "sources": self.sources,
               "replaces": self.replaces, "launches": launches,
               "max_abs_err": self.err, "ms": self.ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound,
               "bound_by": max(self.bound_kind, key=self.bound_kind.get),
               "library_ms": self.library_ms, "library": self.library}
        if self.device is not None:
            rec["device_ms"], rec["library_device_ms"] = self.device
        rec.update(self.extra)
        return rec


def align_read_model(torch, sample_taps, feats, rois, lvls,
                     strides=(4, 8, 16, 32), out=7, sn=2, stage=32 * 1024):
    """An estimate, not a measurement, of what row 7's kernel reads of the
    levels: the taps from the plain geometry (``sample_taps``) and the
    kernel's rule (a RoI whose footprint, all C channels, fits the 32 KB
    stage is read once, pixel by pixel; any other reads its 16 taps a bin
    from device memory, each counted, though L1 may serve repeats).
    Returns the staged footprint pixels, those taps, the RoIs staged and
    not, and the median footprint of a RoI in pixels."""
    ch, isz = feats[0].shape[-1], feats[0].element_size()
    cap = stage // (ch * isz) if ch * isz % 16 == 0 else 0
    tot = {"pixels": 0, "taps": 0, "staged": 0, "unstaged": 0}
    every = []
    for lvl, st in enumerate(strides):
        r = rois[lvls == lvl].float()
        n = r.shape[0]
        if n == 0:
            continue
        hgt, wid = feats[lvl].shape[1], feats[lvl].shape[2]
        y0, x0, y1, x1 = sample_taps(r, hgt, wid, out, 1.0 / st, sn)[:4]
        # each tap row's span of columns, row by row of the level
        slot = (torch.arange(n, device=r.device) * hgt).view(n, 1, 1, 1, 1)
        slot = torch.stack([slot + y0, slot + y1]).reshape(-1)
        xlo = torch.full((n * hgt,), wid, device=r.device,
                         dtype=torch.long).scatter_reduce(
            0, slot, torch.stack([x0, x0]).reshape(-1), "amin")
        xhi = torch.full_like(xlo, -1).scatter_reduce(
            0, slot, torch.stack([x1, x1]).reshape(-1), "amax")
        pix = (xhi - xlo + 1).clamp(min=0).view(n, hgt).sum(1)
        every.append(pix)
        staged = pix <= cap
        tot["pixels"] += int(pix[staged].sum())
        tot["taps"] += int((~staged).sum()) * out * out * sn * sn * 4
        tot["staged"] += int(staged.sum())
        tot["unstaged"] += int((~staged).sum())
    tot["median_pixels"] = float(torch.cat(every).float().median())
    return tot


def equal_rectangles(torch, obb_corners, a, b, what, scores=None):
    """Card boxes ``a`` against host boxes ``b`` (..., 5): fieldwise within
    1e-4 of the image size, or the same rectangle in its other description
    (a tie of w and h swaps them and turns the angle by 90 degrees; a tie
    at the le90 wrap turns it by 180): the corners agree up to a cyclic
    shift, within 1e-4 of the box's coordinates. With ``scores`` (card,
    host), boxes whose scores are within 1e-6 may also have changed
    places: the two devices' sigmoid differs in the last bit, and the merge
    orders by score. Logs the comparison as ``what``."""
    a, b = a.reshape(-1, 5).cpu(), b.reshape(-1, 5).cpu()
    far = (a - b).abs().amax(-1) > 1e-4 * IMG
    n_far = int(far.sum())
    ok, worst = True, 0.0
    if n_far:
        ca, cb = obb_corners(a[far]), obb_corners(b[far])
        lim = 1e-4 * torch.clamp(ca.abs().amax((1, 2)), min=IMG)
        if scores is None:
            dist = torch.stack([
                (ca - torch.roll(cb, k, dims=1)).abs().amax((1, 2))
                for k in range(4)]).amin(0) / lim
        else:
            sa, sb = (t.reshape(-1).cpu()[far] for t in scores)
            dist = torch.stack([
                (ca[:, None] - torch.roll(cb, k, dims=1)[None]).abs()
                .amax((2, 3)) for k in range(4)]).amin(0) / lim[:, None]
            dist = dist + 1e9 * ((sa[:, None] - sb[None]).abs() > 1e-6)
            dist = torch.maximum(dist.amin(1), dist.amin(0))
        ok, worst = bool((dist <= 1).all()), dist.max().item()
        if not ok:
            log(f"[e2e fp32] {what}: differing boxes (card, host): "
                f"{a[far][dist > 1][:4].tolist()} "
                f"{b[far][dist > 1][:4].tolist()}")
    log(f"[e2e fp32] {what}: {a.shape[0] - n_far} boxes equal "
        f"fieldwise (1e-4 x {IMG}), {n_far} equal as rectangles"
        f"{' or swapped at tied scores' if scores else ''} only (worst "
        f"corner distance {worst:.2f} of its limit) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def make_train_batch(rng, comp, img, g):
    """A train batch of numpy arrays as ``bench.py --train`` makes it: SAR
    xyxy gts, RGB / infrared OBB gts, ``g`` of each an image."""
    import numpy as np

    def mk(n, obb):
        out = {"img": rng.rand(n, img, img, 3).astype(np.float32),
               "gt_labels": rng.randint(0, 26, (n, g)).astype(np.int32),
               "gt_mask": np.ones((n, g), bool)}
        if obb:
            out["gt_obbs"] = np.stack([
                rng.uniform(25, img - 25, (n, g)),
                rng.uniform(25, img - 25, (n, g)),
                rng.uniform(10, 60, (n, g)), rng.uniform(6, 30, (n, g)),
                rng.uniform(-1.2, 1.2, (n, g))], -1).astype(np.float32)
        else:
            cx, cy = rng.uniform(20, img - 20, (2, n, g))
            w, h = rng.uniform(8, 60, (2, n, g))
            out["gt_bboxes"] = np.stack(
                [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                -1).astype(np.float32)
        return out

    return {"sar": mk(comp[0], False), "rgb": mk(comp[1], True),
            "ifr": mk(comp[2], True)}


def subtree_norms(torch, names, grads):
    """Gradient norm of each top-level subtree (backbone, neck, heads)."""
    sq = {}
    for n, g in zip(names, grads):
        top = n.split(".")[0]
        sq[top] = sq.get(top, 0.0) + float(g.double().pow(2).sum())
    return {k: v ** 0.5 for k, v in sq.items()}


EVAL_CFG = "configs/sm3det_convnext_t.py"
EVAL_IMG = 1024            # synthetic eval images, resized to img_size 800
EVAL_WORK = "work_dirs/chip_smoke"   # gitignored; removed at the end


def syncs_in_loop(torch, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its
    result, synchronisations in all, those made inside ``stream_eval`` (the
    loop and the forwards it runs))."""
    import traceback
    import warnings
    counts = {"all": 0, "loop": 0}

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        counts["all"] += 1
        if any(fr.name == "stream_eval" and fr.filename.endswith(
                "eval_loop.py") for fr in traceback.extract_stack()):
            counts["loop"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, counts["all"], counts["loop"]


class PatchNamed:
    """A dataset whose image ids are DOTA patch names."""

    def __init__(self, ds, names):
        self.ds, self.names = ds, names
        self.CLASSES = ds.CLASSES

    def __len__(self):
        return len(self.names)

    def get_raw(self, idx):
        return dict(self.ds.get_raw(idx), img_id=self.names[idx])


def phase6(torch, dev, smi, build):
    """6. The eval entry point (``sm3det_tpu_torch.tools.test``) on the
    card; returns (failures, record for the JSON line)."""
    import os
    import shutil

    import numpy as np

    from sm3det_tpu_torch.apis.inference import \
        inference_detector_by_patches
    from sm3det_tpu_torch.core.evaluation import eval_map as em
    from sm3det_tpu_torch.core.patch.split_merge import \
        merge_det_by_patch_ids
    from sm3det_tpu_torch.data.datasets import SyntheticDetDataset
    from sm3det_tpu_torch.models.builder import build_detector
    from sm3det_tpu_torch.ops.cuda import hbb_iou_kernel as hik
    from sm3det_tpu_torch.ops.cuda import rotated_iou_kernel as rik
    from sm3det_tpu_torch.tools import test as cli
    from sm3det_tpu_torch.train.checkpoint import load_params, save_params
    from sm3det_tpu_torch.utils.config import Config

    failures, rec = [], {}
    t_phase = time.perf_counter()
    cfg = Config.fromfile(EVAL_CFG)
    nc = cfg.num_classes
    os.makedirs(EVAL_WORK, exist_ok=True)
    ckpt = os.path.join(EVAL_WORK, "flagship_bf16.pth")

    # (a) the flagship from the config, bf16, random weights from seed 0;
    # the GFL prior bias at 0 and fc_cls scaled so that there are
    # detections (as 4b and 4c); saved, then reloaded by the CLI
    t0 = time.perf_counter()
    model = build_detector(cfg.model, device=dev, compute_dtype="bfloat16",
                           seed=0)
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():
        model.sar_bbox_head.gfl_cls.bias.fill_(0.0)
        imgs = torch.rand(2, 800, 800, 3, generator=gen, device=dev)
        x = model.neck_rcnn(model.extract_feat(imgs))
        props, _, _ = model.get_proposals(*model.head_rpn(x, "rgb"))
        logits, _ = model.rgb_roi_head(model.roi_feats(x, props))
        model.rgb_roi_head.fc_cls.weight.mul_(
            3.0 / logits.float().std().item())
    save_params(ckpt, model)
    del model, imgs, x, props, logits
    torch.cuda.empty_cache()
    log(f"[eval] flagship from {EVAL_CFG} (bf16, seed 0) built and saved "
        f"in {time.perf_counter() - t0:.1f} s ({os.path.getsize(ckpt) / 2**20:.0f}"
        f" MiB)")

    launches, loaded = {}, [None]

    def run(sub, n, extra=(), ds=None):
        ds = ds or SyntheticDetDataset(
            n=n, img_size=EVAL_IMG, num_classes=nc,
            box_type="hbb" if sub == "sar" else "obb", seed=7)
        argv = [EVAL_CFG, ckpt, "--subdataset", sub, "--num-images", str(n),
                "--batch-size", "8"] + list(extra)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        out, n_sync, n_loop = syncs_in_loop(
            torch, lambda: cli.main(argv, dataset=ds, model=loaded[0]))
        torch.cuda.synchronize()
        got = dict(build.LAUNCHES)
        loaded[0] = out["model"]
        st = out["stats"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per_batch = n_loop / max(st["batches"], 1)
        n_det = sum(len(d) for img in out["det_results"] for d in img)
        log(f"[eval] {' '.join(argv[2:])}: {out['img_per_s']:.2f} images/s "
            f"(host clock, after warm-up; {n} x {EVAL_IMG}^2 -> "
            f"{cfg.img_size}^2); host pipeline alone "
            f"{st['host_images_per_s']:.2f} images/s; waited "
            f"{st['queue_wait_s']:.3f} s for the host, "
            f"{st['event_wait_s']:.3f} s on {st['event_waits']} events; host "
            f"syncs {n_loop} in the loop ({per_batch:.2f} a batch of "
            f"{st['batches']}), {n_sync} in all; peak memory {peak:.2f} GiB; "
            f"{n_det} detections; card {smi}")
        log(f"[eval]   launches: {got}")
        log(f"[eval]   metrics: {out['metrics']}")
        key = sub + ("_format" if "--format-only" in extra else
                     "_mAP" if extra else "")
        rec[key] = dict(
            images=n, images_per_s=out["img_per_s"],
            host_images_per_s=st["host_images_per_s"],
            queue_wait_s=st["queue_wait_s"],
            event_wait_s=st["event_wait_s"], batches=st["batches"],
            loop_syncs=n_loop, loop_syncs_per_batch=per_batch,
            all_syncs=n_sync, peak_gib=peak, detections=n_det,
            metrics={k: v for k, v in (out["metrics"] or {}).items()
                     if isinstance(v, (int, float, str))})
        if n_det == 0:
            failures.append(f"eval {key}: no detections")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return out, got

    t0 = time.perf_counter()
    sar, got = run("sar", 32)
    m = sar["metrics"]
    if not (0.0 <= m["bbox_mAP"] <= 1.0 and m["bbox_mAP_copypaste"]):
        failures.append("eval sar: bbox metrics")
    for k in ("fused_convnext_block", "dwconv_ln", "moe_ffn_grouped",
              "fused_layernorm", "hbb_nms_mask", "nms_keep"):
        if got[k] <= 0:
            failures.append(f"eval sar launches {k}={got[k]}")
    rgb, got = run("rgb", 32)
    rec["rotated_iou_banded_launches"] = got["rotated_iou_banded"]
    for k in ("fused_convnext_block", "dwconv_ln", "moe_ffn_grouped",
              "fused_layernorm", "hbb_nms_mask", "rotated_nms_mask_banded",
              "nms_keep", "roi_align_rotated", "rotated_iou_banded"):
        if got[k] <= 0:
            failures.append(f"eval rgb launches {k}={got[k]}")
    if got["rotated_iou"] or got["hbb_iou"]:
        failures.append(f"eval rgb: unexpected matrix launches {got}")
    if not np.isfinite(rgb["metrics"]["mAP"]):
        failures.append("eval rgb: mAP not finite")
    sar_map, got = run("sar", 16, ("--cfg-options", "evaluation.metric=mAP"))
    rec["hbb_iou_launches"] = got["hbb_iou"]
    if got["hbb_iou"] <= 0:
        failures.append(f"eval sar mAP launches hbb_iou={got['hbb_iou']}")
    model = loaded[0]
    log(f"[eval] (a) four CLI runs: {time.perf_counter() - t0:.1f} s")

    # (b) the card's eval against the host's on identical inputs
    calls = [0]
    real_chunk = em._chunk_ious

    def counting(*a, **kw):
        calls[0] += 1
        return real_chunk(*a, **kw)
    em._chunk_ious = counting
    try:
        for name, src, box_dim, kernel in (
                ("rgb", rgb, 5, "rotated_iou_banded"),
                ("sar mAP", sar_map, 4, "hbb_iou")):
            dets, anns = src["det_results"], src["annotations"]
            res = {}
            for where in ("cuda", "cpu"):
                calls[0] = 0
                build.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[where] = em.eval_rbbox_map(dets, anns, box_dim=box_dim,
                                               logger=None, device=where)
                torch.cuda.synchronize()
                res[where + "_s"] = time.perf_counter() - t0
                res[where + "_calls"] = calls[0]
                res[where + "_launches"] = build.LAUNCHES[kernel]
            same = res["cuda"] == res["cpu"]
            n_pairs = sum(len(d) * int(np.sum(a["labels"] == c))
                          for img, a in zip(dets, anns)
                          for c, d in enumerate(img))
            log(f"[eval] (b) {name} eval_rbbox_map, {len(dets)} images, "
                f"{n_pairs} same-class det x gt pairs: card "
                f"{res['cuda_s'] * 1e3:.1f} ms ({res['cuda_calls']} IoU "
                f"call(s), {res['cuda_launches']} {kernel} launch(es)); host "
                f"{res['cpu_s'] * 1e3:.1f} ms ({res['cpu_calls']} IoU calls "
                f"of the plain version); every AP bit-equal {same}: card "
                f"mAP {res['cuda']['mAP']!r}, host {res['cpu']['mAP']!r}")
            rec[f"eval_{kernel}"] = dict(
                images=len(dets), pairs=n_pairs,
                card_ms=res["cuda_s"] * 1e3, host_ms=res["cpu_s"] * 1e3,
                card_launches=res["cuda_launches"],
                card_calls=res["cuda_calls"], host_calls=res["cpu_calls"],
                equal=same)
            if not same or res["cuda_launches"] != res["cuda_calls"]:
                failures.append(f"eval card against host: {name}")
            # the kernel alone at this eval's shape: its one chunk, padded
            gts = [[a["bboxes"][a["labels"] == c] for c in range(nc)]
                   for a in anns]
            items = next(em.chunks(dets, gts, em.MAX_PAIRS["cuda"]))
            arrs = em.pack_chunk(items, box_dim)
            d, g, dg, gg = (torch.from_numpy(v).to(dev) for v in arrs[:4])
            same_g = (dg[:, :, None] == gg[:, None, :]) & \
                (dg[:, :, None] < rik.INERT_GROUP)
            if box_dim == 5:
                def kfn():
                    return rik.rotated_iou(d, g, groups1=dg, groups2=gg)

                def pfn():
                    return rik.rotated_iou_ref(d, g, groups1=dg, groups2=gg)
                work = int(same_g.sum()) * ROT_IOU_FLOPS
                nbytes = 4 * (d.numel() + g.numel() + dg.numel() +
                              gg.numel() + same_g.numel())
                k_out, p_out = kfn(), pfn()
                exact = torch.equal(k_out[same_g], p_out[same_g])
            else:
                def kfn():
                    return hik.hbb_iou(d, g)

                def pfn():
                    return hik.hbb_iou_ref(d, g)
                work = same_g.numel() * 12
                nbytes = 4 * (d.numel() + g.numel() + same_g.numel())
                exact = torch.equal(kfn()[same_g], pfn()[same_g])
            k_ms = cuda_ms(torch, kfn, iters=10)
            p_ms = cuda_ms(torch, pfn, iters=3, warmup=1)
            b_ms, b_by = bound_ms(nbytes, [(work, "float32")])
            log(f"[eval] (b) {kernel} alone on the chunk {tuple(d.shape)} x "
                f"{tuple(g.shape)}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                f"ms (CUDA events), bound {b_ms:.4f} ms ({b_by}); the "
                f"defined pairs bit-equal {exact}")
            rec[f"eval_{kernel}"].update(
                shape=[list(d.shape), list(g.shape)], kernel_ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                kernel_equal=exact)
            if not exact:
                failures.append(f"eval {kernel} against its plain version")
            # the gts given back as detections (score 1): mAP 1
            gt_dets = [[np.concatenate(
                [a["bboxes"][a["labels"] == c],
                 np.ones((int(np.sum(a["labels"] == c)), 1), np.float32)],
                1) for c in range(nc)] for a in anns]
            perfect = em.eval_rbbox_map(gt_dets, anns, box_dim=box_dim,
                                        logger=None, device=dev)
            log(f"[eval] (b) {name}: the gts as detections give mAP "
                f"{perfect['mAP']!r}")
            if perfect["mAP"] != 1.0:
                failures.append(f"eval {name}: gts as detections")
    finally:
        em._chunk_ious = real_chunk

    # (c) --format-only on rgb: 8 patches of two base images, merged on
    # the card, against the host's plain merge of the same detections. The
    # R-CNN keeps 300 detections an image here (the model's cfg, as the
    # --cfg-options would set it on a model the tool builds), so that the
    # host's plain mask (a dense N^2 IoU) takes seconds, not minutes
    names = [f"P000{b}__1.0__{x}___{y}" for b in (1, 2)
             for x in (0, 824) for y in (0, 824)]
    ds = PatchNamed(SyntheticDetDataset(n=8, img_size=EVAL_IMG,
                                        num_classes=nc, seed=8), names)
    sub_dir = os.path.join(EVAL_WORK, "submission")
    rcnn_max = model.cfg["rgb"]["rcnn_max"]
    model.cfg["rgb"]["rcnn_max"] = 300
    fmt, got = run("rgb", 8, ("--format-only", "--submission-dir", sub_dir,
                              "--cfg-options", "model.rgb.rcnn_max=300"),
                   ds=ds)
    model.cfg["rgb"]["rcnn_max"] = rcnn_max
    zip_ok = os.path.exists(os.path.join(sub_dir, "submission.zip"))
    t0 = time.perf_counter()
    host = merge_det_by_patch_ids(fmt["img_ids"], fmt["det_results"], nc,
                                  device="cpu")
    host_s = time.perf_counter() - t0
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = merge_det_by_patch_ids(fmt["img_ids"], fmt["det_results"], nc,
                                  device=dev)
    card_s = time.perf_counter() - t0
    merge_launches = dict(build.LAUNCHES)
    same = card.keys() == host.keys() == fmt["merged"].keys() and all(
        np.array_equal(card[b][c], host[b][c]) and
        np.array_equal(fmt["merged"][b][c], host[b][c])
        for b in host for c in range(nc))
    n_in = sum(len(d) for img in fmt["det_results"] for d in img)
    n_out = sum(len(d) for b in host for d in host[b])
    log(f"[eval] (c) --format-only: zip written {zip_ok}; {n_in} patch "
        f"detections merged into {n_out} in {len(host)} images; card "
        f"{card_s * 1e3:.1f} ms ({merge_launches['rotated_nms_mask_banded']} "
        f"banded mask, {merge_launches['nms_keep']} keep launches), host "
        f"{host_s * 1e3:.1f} ms; card merge equals the host's {same}")
    rec["merge"] = dict(detections_in=n_in, detections_out=n_out,
                        card_ms=card_s * 1e3, host_ms=host_s * 1e3,
                        equal=same)
    if not (zip_ok and same and n_out > 0):
        failures.append("eval --format-only merge")

    # (d) a 2048^2 image by patches of 1024 (step 824): 9 windows, batches
    # of 4
    load_params(ckpt, model)          # the saved weights, read back
    rng = np.random.RandomState(9)
    big = (rng.rand(2048, 2048, 3) * 255).astype(np.uint8)
    n_patches = [0]

    def infer(batch):
        n_patches[0] += batch.shape[0]
        return model.simple_test_rgb(torch.from_numpy(batch).to(dev),
                                     img_shape=(1024, 1024))
    infer(np.zeros((4, 1024, 1024, 3), np.float32))       # warm-up
    n_patches[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged = inference_detector_by_patches(infer, big, nc, batch_size=4,
                                           device=dev)
    torch.cuda.synchronize()
    patch_s = time.perf_counter() - t0
    n_big = sum(len(d) for d in merged)
    log(f"[eval] (d) inference_detector_by_patches, 2048^2: 9 windows of "
        f"1024^2 (step 824) in {n_patches[0]} batch slots of 4, "
        f"{patch_s * 1e3:.1f} ms, {n_big} merged detections")
    rec["by_patches"] = dict(windows=9, slots=n_patches[0],
                             ms=patch_s * 1e3, detections=n_big)
    if n_big == 0 or not all(np.isfinite(d).all() for d in merged):
        failures.append("eval by patches")
    del model, loaded[0]
    shutil.rmtree(EVAL_WORK, ignore_errors=True)
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[eval] phase 6 wall time {rec['phase_s']:.1f} s")
    return failures, rec, launches


TRAIN_CFG = "configs/sm3det_convnext_t.py"
TRAIN_WORK = "work_dirs/chip_smoke_train"   # gitignored; removed at the end
TRAIN_ITERS = 30
TRAIN_WARM = 2             # iterations left out of the timed window
CONV_CFG = "configs/convergence_synth.py"
# 300 of the config's 600 iterations, to leave phase 9 room in the time
# limit; tools/profiling/torch_convergence.py runs 600 and 1500
CONV_ITERS = 300
CONV_SAR_GATE = 0.5        # the final SAR mAP50 must reach this
# the JAX package's convergence records for CONV_CFG (600 iterations on a
# TPU, held-out draws; PARITY.md): the bf16 run and the fp32 run
CONV_RECORDS = (("bf16", "docs/evidence/convergence_bf16_eval.txt"),
                ("fp32", "docs/evidence/convergence_synth_eval.txt"))
# the kernels each run of the train entry point must launch
TRAIN_KERNELS = ("hbb_nms_mask", "nms_keep", "rotated_iou",
                 "roi_align_rotated", "roi_align_rotated_bwd",
                 "fused_dwconv_ln_train", "fused_dwconv_ln_train_bwd")
EVAL_HOOK_KERNELS = ("fused_convnext_block", "dwconv_ln", "moe_ffn_grouped",
                     "fused_layernorm", "rotated_nms_mask_banded",
                     "rotated_iou_banded")


def syncs_by_part(torch, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its
    result, synchronisations by the part of the train entry point that
    made them: ``step`` (inside ``train_step``), ``checkpoint``, ``eval``
    (the eval hooks), ``loop`` (``run_training`` itself: the batch's copy,
    the metrics' fetch) and ``other`` (set-up and loading, other threads);
    the step's by site, as ``host_syncs`` names them)."""
    import traceback
    import warnings
    parts = dict(step=0, checkpoint=0, eval=0, loop=0, other=0)
    step_sites = {}

    def part(stack):
        names = [(fr.name, fr.filename) for fr in stack]
        if any(n == "train_step" for n, _ in names):
            return "step"
        if any(n == "save_train_state" for n, _ in names):
            return "checkpoint"
        if any(n == "run" and f.endswith("train.py") for n, f in names):
            return "eval"
        if any(n == "run_training" for n, _ in names):
            return "loop"
        return "other"

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        where = part(stack)
        parts[where] += 1
        if where == "step":
            fr = next((f for f in reversed(stack)
                       if "sm3det_tpu_torch" in f.filename), None)
            site = f"{filename}:{lineno}" if fr is None else (
                f"{fr.filename[fr.filename.index('sm3det_tpu_torch'):]}:"
                f"{fr.lineno} ({fr.name})")
            step_sites[site] = step_sites.get(site, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, parts, step_sites


def checkpoint_equal(torch, ck, s):
    """Whether the train state ``s`` a resumed run loaded equals the
    ``iter_N.pth`` file ``ck`` bit for bit: the parameters, Adam's moments,
    the step counts, the DLA multipliers and EMA, the generator, and the
    parameters' EMA and the gradient accumulators where the file has
    them."""
    from sm3det_tpu_torch.train.checkpoint import TRAIN_FORMAT
    saved = torch.load(ck, map_location="cpu", weights_only=True)
    names = list(s.params)
    same = saved["format"] == TRAIN_FORMAT and saved["names"] == names
    pairs = [("params", s.params.values()), ("mu", s.opt.mu),
             ("nu", s.opt.nu)]
    for key, ts in (("ema", s.ema), ("accum", s.opt.accum)):
        if (saved.get(key) is None) != (ts is None):
            return False
        if ts is not None:
            pairs.append((key, ts))
    same = same and saved.get("accum_count", 0) == s.opt.accum_count
    for key, ts in pairs:
        same = same and all(torch.equal(saved[key][n], t.cpu())
                            for n, t in zip(names, ts))
    return same and (saved["count"], saved["step"], saved["mults"]) == (
        s.opt.count, s.opt.step, s.opt.mults) and \
        torch.equal(saved["dla"]["ema"], s.opt.dla.ema.cpu()) and \
        torch.equal(saved["gen_state"], s.gen.get_state())


def read_records():
    """{name: {iteration: (sar, rgb, ifr) mAP50}} of CONV_RECORDS."""
    import re
    out = {}
    for name, path in CONV_RECORDS:
        rec = {}
        with open(path) as f:
            for line in f:
                m = re.match(r"eval\[(\w+)\] @ (\d+): \{'mAP50': ([0-9.e-]+)",
                             line)
                if m:
                    rec.setdefault(int(m.group(2)), {})[m.group(1)] = \
                        float(m.group(3))
        out[name] = {it: tuple(v.get(k) for k in ("sar", "rgb", "ifr"))
                     for it, v in rec.items()}
    return out


def host_stage_ms(cfg_path, n=12):
    """The train pipeline's host stages, one thread, over the first ``n``
    samples of each modality of the synthetic datasets the train tool
    builds for ``cfg_path``: {modality: {stage: ms an image}, with
    ``rotated`` (the images rotated) and ``rotate_ms_each``}."""
    import numpy as np

    from sm3det_tpu_torch.data import transforms as T
    from sm3det_tpu_torch.data.loader import PipelineCfg
    from sm3det_tpu_torch.tools import train as tool
    from sm3det_tpu_torch.utils.config import Config

    cfg = Config.fromfile(cfg_path)
    out = {}
    for key, ds in zip(("sar", "rgb", "ifr"),
                       tool.build_datasets(cfg, synthetic=True)):
        p = PipelineCfg.from_config(cfg.data[key], img_size=cfg.img_size,
                                    version=cfg.angle_version)
        ms = dict(read=0.0, resize=0.0, flip=0.0, rotate=0.0,
                  normalize_pad=0.0)
        rotated = 0
        for i in range(n):
            rng = np.random.RandomState(i)
            t0 = time.perf_counter()
            raw = ds.get_raw(i)
            t1 = time.perf_counter()
            img, obbs, hbbs, _ = T.resize(raw["img"], (p.img_size,) * 2,
                                          raw.get("obbs"), raw.get("hbbs"))
            t2 = time.perf_counter()
            img, obbs, hbbs, _ = T.random_flip(
                rng, img, obbs, hbbs, prob=p.flip_prob, version=p.version,
                direction=p.flip_directions)
            t3 = time.perf_counter()
            if p.rotate_ratio > 0 and obbs is not None:
                before = img
                img, _, _ = T.poly_random_rotate(
                    rng, img, obbs, raw["labels"],
                    rotate_ratio=p.rotate_ratio,
                    angles_range=p.angles_range,
                    rect_classes=p.rect_classes, version=p.version)
                rotated += img is not before
            t4 = time.perf_counter()
            T.pad_to(T.normalize(img, p.mean, p.std), (p.img_size,) * 2)
            t5 = time.perf_counter()
            for k, a, b in (("read", t0, t1), ("resize", t1, t2),
                            ("flip", t2, t3), ("rotate", t3, t4),
                            ("normalize_pad", t4, t5)):
                ms[k] += (b - a) * 1e3
        rec = {k: v / n for k, v in ms.items()}
        rec["rotated"] = rotated
        rec["rotate_ms_each"] = ms["rotate"] / rotated if rotated else None
        out[key] = rec
    return out


def phase7(torch, dev, smi, build):
    """7. The train entry point (``sm3det_tpu_torch.tools.train``) on the
    card: (a) the flagship from its config, full width, bf16, 30
    iterations with a checkpoint, an eval pass and a resume; (b) the
    convergence config for CONV_ITERS iterations against the JAX
    package's records. Returns (failures, record, launches)."""
    import os
    import shutil

    import numpy as np

    from sm3det_tpu_torch.tools import train as tool
    from sm3det_tpu_torch.utils.config import Config

    failures, rec = [], {}
    t_phase = time.perf_counter()
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    wd = os.path.join(TRAIN_WORK, "flagship")
    common = [TRAIN_CFG, "--synthetic-data", "--work-dir", wd,
              "--cfg-options", "model.compute_dtype=bfloat16",
              "checkpoint_interval=20", "evaluation.interval=30",
              "evaluation.num_images=16"]

    # (a) 30 iterations of [2:1:1] x 800^2: the window after TRAIN_WARM
    # iterations up to the checkpoint at 20 is timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    out = tool.main(common[:4] + ["--max-iters", str(TRAIN_ITERS)]
                    + common[4:] + ["log_interval=10"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st, ls = out["stats"], out["loader_stats"]
    n_img = sum(Config.fromfile(TRAIN_CFG).source_ratio)
    ends = st["iter_end_s"]
    # iterations TRAIN_WARM + 1 .. 20: from the end of iteration
    # TRAIN_WARM to that of iteration 20, before its checkpoint
    win = (TRAIN_WARM - 1, 19)
    ips = (win[1] - win[0]) * n_img / (ends[win[1]] - ends[win[0]])
    host_ips = ls["batches"] * n_img / ls["host_busy_s"]
    _, ck_bytes, ck_s = st["checkpoints"][0]
    losses = st["log_lines"][-1]
    log(f"[train entry] {TRAIN_CFG} --synthetic-data bf16, [2:1:1] x 800^2, "
        f"{TRAIN_ITERS} iterations in {wall:.1f} s: {ips:.2f} images/s over "
        f"iterations {win[0] + 2}-{win[1] + 1} (host clock); host pipeline "
        f"alone {host_ips:.2f} images/s ({ls['batches']} batches in "
        f"{ls['host_busy_s']:.2f} s of producer time); the loop waited "
        f"{st['data_wait_s']:.3f} s for batches in all "
        f"({st['data_wait_s'] / st['iters'] * 1e3:.2f} ms an iteration); "
        f"peak memory {peak:.2f} GiB; checkpoint {ck_bytes / 2 ** 20:.1f} "
        f"MiB in {ck_s:.2f} s; card {smi}")
    log(f"[train entry]   iteration wall times (ms): " + " ".join(
        f"{(b - a) * 1e3:.1f}" for a, b in zip(ends, ends[1:])))
    log(f"[train entry]   last log line: {losses}")
    log(f"[train entry]   launches: {launches}")
    for it, name, res, secs in st["evals"]:
        log(f"[train entry]   eval[{name}] @ {it} in {secs:.2f} s: "
            f"{ {k: v for k, v in res.items() if np.isscalar(v)} }")
    rec["flagship"] = dict(
        iterations=TRAIN_ITERS, images_per_s=ips, host_images_per_s=host_ips,
        data_wait_s=st["data_wait_s"], peak_gib=peak,
        checkpoint_mib=ck_bytes / 2 ** 20, checkpoint_s=ck_s, wall_s=wall,
        last_losses=losses)
    if not all(np.isfinite(v) for x in st["log_lines"] for v in x.values()):
        failures.append("train entry: a logged value is not finite")
    if len(st["evals"]) != 3:
        failures.append(f"train entry: {len(st['evals'])} evals, expected 3")
    for k in TRAIN_KERNELS + EVAL_HOOK_KERNELS:
        if launches.get(k, 0) <= 0:
            failures.append(f"train entry launches {k}={launches.get(k)}")
    del out
    torch.cuda.empty_cache()

    # the host pipeline's stages, one thread (what the producer's 4
    # threads share with the training thread)
    stages = host_stage_ms(TRAIN_CFG)
    for key, r in stages.items():
        log(f"[train entry] host stages, {key}, one thread, ms an image: "
            + ", ".join(f"{k} {v:.1f}" for k, v in r.items()
                        if k not in ("rotated", "rotate_ms_each"))
            + f"; {r['rotated']} of 12 rotated"
            + (f", {r['rotate_ms_each']:.1f} ms each" if r["rotated"]
               else ""))
    rec["host_stage_ms"] = stages

    # the CLI's resume loads what was saved, bit for bit
    ck = os.path.join(wd, "iter_20.pth")
    t0 = time.perf_counter()
    back = tool.main(common[:4] + ["--resume-from", ck, "--max-iters", "20"]
                     + common[4:])
    load_s = time.perf_counter() - t0
    same = checkpoint_equal(torch, ck, back["state"])
    log(f"[train entry] --resume-from iter_20: start {back['start_iter']}, "
        f"the loaded state equal to the file bit for bit: {same} (the run, "
        f"build and load included, {load_s:.1f} s)")
    if not (same and back["start_iter"] == 20):
        failures.append("train entry: the resumed state differs from "
                        "iter_20.pth")
    del back
    torch.cuda.empty_cache()

    # ... and trains on from it: 5 iterations, synchronisations by part
    build.reset_launches()
    res, parts, step_sites = syncs_by_part(torch, lambda: tool.main(
        common[:4] + ["--resume-from", ck, "--max-iters", "25"]
        + common[4:] + ["log_interval=5"]))
    st = res["stats"]
    per_step = parts["step"] / max(st["iters"], 1)
    log(f"[train entry] resumed 21-25: losses {st['log_lines'][-1]}; host "
        f"syncs in {st['iters']} iterations: {parts} ({per_step:.1f} a step "
        f"inside the step, the bare step 43 in 5b; the loop's own "
        f"{parts['loop']} for {len(st['log_lines'])} log fetch(es); "
        f"'other' is set-up: the build and the load's copies to the card)")
    log(f"[train entry]   the step's syncs by site: {step_sites}")
    rec["resume"] = dict(equal=same, syncs=parts, step_sync_sites=step_sites,
                         log_line=st["log_lines"][-1])
    if not all(np.isfinite(v) for v in st["log_lines"][-1].values()):
        failures.append("train entry: resumed losses not finite")
    if parts["loop"] > len(st["log_lines"]):
        failures.append(f"train entry: the loop synchronised {parts['loop']}"
                        f" times in {st['iters']} iterations")
    for k in TRAIN_KERNELS:
        if build.LAUNCHES.get(k, 0) <= 0:
            failures.append(f"resumed run launches {k}=0")
    del res
    shutil.rmtree(wd, ignore_errors=True)
    torch.cuda.empty_cache()
    rec["flagship"]["phase_s"] = time.perf_counter() - t_phase
    log(f"[train entry] 7a wall time {rec['flagship']['phase_s']:.1f} s")

    # (b) convergence: CONV_CFG in bf16, SAR scored by VOC mAP as in the
    # records
    t0 = time.perf_counter()
    build.reset_launches()
    conv = tool.main([CONV_CFG, "--work-dir",
                      os.path.join(TRAIN_WORK, "convergence"),
                      "--max-iters", str(CONV_ITERS), "--cfg-options",
                      "model.compute_dtype=bfloat16",
                      "evaluation.metric=mAP"])
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    st = conv["stats"]
    ends = st["iter_end_s"]
    records = read_records()
    got = {}
    for it, name, res, _ in st["evals"]:
        got.setdefault(it, {})[name] = float(res["mAP50"])
    table = []
    for it in sorted(got):
        row = tuple(got[it].get(k) for k in ("sar", "rgb", "ifr"))
        table.append((it, row))
        refs = "; ".join(
            f"{name} record " + " / ".join(f"{v:.3f}" for v in r[it])
            for name, r in records.items() if it in r)
        log(f"[convergence] @ {it}: mAP50 sar / rgb / ifr "
            + " / ".join(f"{v:.3f}" for v in row) + f" ({refs})")
    first, last = st["log_lines"][0], st["log_lines"][-1]
    log(f"[convergence] {CONV_CFG} bf16, {CONV_ITERS} iterations in "
        f"{conv_s:.1f} s (median iteration "
        f"{statistics.median(np.diff(ends)) * 1e3:.1f} ms, evals and the "
        f"checkpoint included in the wall time); loss {first['loss']} at "
        f"{first['iter']} -> {last['loss']} at {last['iter']}; launches "
        f"{dict(build.LAUNCHES)}; card {smi}")
    rec["convergence"] = dict(iterations=CONV_ITERS, seconds=conv_s,
                              map50=table, first_loss=first["loss"],
                              last_loss=last["loss"])
    if not all(np.isfinite(v) for x in st["log_lines"] for v in x.values()):
        failures.append("convergence: a logged value is not finite")
    if not last["loss"] < first["loss"]:
        failures.append(f"convergence: loss {first['loss']} -> "
                        f"{last['loss']}")
    final = table[-1][1][0] if table and table[-1][0] == CONV_ITERS \
        else None
    if final is None or not final >= CONV_SAR_GATE:
        failures.append(f"convergence: final SAR mAP50 {final} < "
                        f"{CONV_SAR_GATE}")
    del conv
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[train entry] phase 7 wall time {rec['phase_s']:.1f} s")
    return failures, rec, launches



LSK_T_CFG = "configs/local_configs/SM3Det_lsk_t.py"
VAN_T_CFG = "configs/local_configs/SM3Det_van_t.py"
LSK_B_CFG = "configs/local_configs/SM3Det_lsk_b.py"
UNC_CFG = "configs/local_configs/main_uncertainty_convnext_t_orcnn_gfl.py"
LSK_WORK = "work_dirs/chip_smoke_lsk"   # gitignored; removed at the end
LSK_TRAIN_ITERS = 20
REWEIGHT_ITERS = 10
# the kernels of the LSK / VAN joint forward, and of their train step
LSK_KERNELS = ("fused_layernorm", "hbb_nms_mask", "nms_keep",
               "rotated_nms_mask_banded", "roi_align_rotated")
LSK_TRAIN_KERNELS = ("hbb_nms_mask", "nms_keep", "rotated_iou",
                     "roi_align_rotated", "roi_align_rotated_bwd")


def backbone_kind(name, module):
    """The kind of a leaf module of an LSKNet / VAN backbone whose time
    phase 8 sums, or None."""
    from sm3det_tpu_torch.models.backbones.convnext import LayerNormOpt
    from sm3det_tpu_torch.models.layers import Conv2d
    from sm3det_tpu_torch.models.moe import MoELayer
    if isinstance(module, LayerNormOpt):
        return "norms"
    if isinstance(module, MoELayer):
        return "MoE"
    if not isinstance(module, Conv2d):
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "conv_spatial":
        return "conv 7x7 dilation-3 depthwise"
    if leaf == "conv0":
        return "conv 5x5 depthwise"
    if leaf == "dwconv":
        return "conv 3x3 depthwise"
    if leaf == "conv_squeeze":
        return "conv 7x7 squeeze"
    if leaf.startswith(("stem", "patch_embed")):
        return "conv patch embeds"
    return "conv 1x1"


def kind_ms(torch, root, fn, iters=3):
    """Mean CUDA-event time of each kind of ``root``'s leaf modules
    (``backbone_kind``) in one call of ``fn``, and of the whole call:
    (total ms, {kind: ms})."""
    events, handles = [], []
    for name, m in root.named_modules():
        kind = backbone_kind(name, m)
        if kind is None:
            continue

        def pre(mod, args, kind=kind):
            events.append([kind, torch.cuda.Event(enable_timing=True), None])
            events[-1][1].record()

        def post(mod, args, out):
            events[-1][2] = torch.cuda.Event(enable_timing=True)
            events[-1][2].record()
        handles += [m.register_forward_pre_hook(pre),
                    m.register_forward_hook(post)]
    try:
        fn()
        torch.cuda.synchronize()
        events.clear()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {}
    for kind, a, b in events:
        out[kind] = out.get(kind, 0.0) + a.elapsed_time(b) / iters
    return s.elapsed_time(e) / iters, out


def phase8(torch, dev, smi, build):
    """8. The LSKNet-MoE and VAN-MoE TriSource configurations and the loss
    reweighting on the card: (a) ``SM3Det_lsk_t.py``'s detector at full
    width, fp32, one 800^2 image, card against host stage by stage; (b)
    the bf16 joint forwards of ``SM3Det_lsk_t.py`` and ``SM3Det_van_t.py``
    over [8 : 4 : 4] x 800^2, and one of ``SM3Det_lsk_b.py``; (c)
    ``tools.test`` on LSK-T, SAR and RGB mAP; (d) ``tools.train`` on LSK-T
    (checkpoint, resume), and the uncertainty and DWA reweighting. Returns
    (failures, record, launches of the LSK-T joint forward)."""
    import os
    import shutil

    import numpy as np
    import torch.nn.functional as F

    from sm3det_tpu_torch.models import moe as moe_mod
    from sm3det_tpu_torch.models.builder import build_detector
    from sm3det_tpu_torch.tools import test as test_cli
    from sm3det_tpu_torch.tools import train as train_cli
    from sm3det_tpu_torch.train import train_state as ts_mod
    from sm3det_tpu_torch.utils.config import Config

    failures, rec = [], {}
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False     # as main: fp32 is fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(8)
    tol = 1e-3      # fp32 summation order through the blocks and the head

    # (a) fp32, card against host, the MoE's capacity dispatch recorded
    t0 = time.perf_counter()
    cfg_t = Config.fromfile(LSK_T_CFG)
    model = build_detector(cfg_t.model, device=dev, compute_dtype="float32",
                           seed=0)
    host = build_detector(cfg_t.model, device="cpu", compute_dtype="float32",
                          seed=0)
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    dispatch = moe_mod.capacity_dispatch
    keeps = {"card": [], "host": []}

    def stages_of(m, img, where):
        def recording(*a, **kw):
            out = dispatch(*a, **kw)
            keeps[where].append(out[3].cpu())
            return out
        moe_mod.capacity_dispatch = recording
        try:
            with torch.no_grad():
                feats = m.extract_feat(img)
                sar_x = m.neck_sar(feats)
                cls, reg = m.sar_bbox_head(sar_x)
                x = m.neck_rcnn(feats)
                rpn_cls, rpn_reg = m.head_rpn(x, "rgb")
        finally:
            moe_mod.capacity_dispatch = dispatch
        return dict(features=feats, sar_neck=sar_x, gfl_cls=cls,
                    gfl_reg=reg, rcnn_neck=x, rpn_cls=rpn_cls,
                    rpn_reg=rpn_reg)

    img = torch.rand(1, IMG, IMG, 3, generator=gen, device=dev)
    got = stages_of(model, img, "card")
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    ref = stages_of(host, img.cpu(), "host")
    t_host = time.perf_counter() - t_host
    worst = 0.0
    for name in got:
        for lvl, (a, b) in enumerate(zip(got[name], ref[name])):
            err, scale = max_err(a.cpu(), b)
            ok = bool(torch.isfinite(a).all()) and a.shape == b.shape and \
                err <= tol * max(scale, 1.0)
            worst = max(worst, err / max(scale, 1.0))
            log(f"[lsk fp32] {name}[{lvl}] {tuple(a.shape)}: max abs err "
                f"{err:.3e} (max |ref| {scale:.3e}) tol {tol} x scale "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"lsk fp32 {name}[{lvl}]")
    same_keep = len(keeps["card"]) == len(keeps["host"]) > 0 and all(
        torch.equal(a, b) for a, b in zip(keeps["card"], keeps["host"]))
    drops = [int((~k).sum()) for k in keeps["card"]]
    log(f"[lsk fp32] {LSK_T_CFG}, one {IMG}^2 image: {len(keeps['card'])} "
        f"MoE layers, the capacity dispatch's keep equal card/host "
        f"{same_keep}, routes dropped {drops}; worst error {worst:.3e} of "
        f"scale; host forward {t_host:.1f} s; "
        f"{'ok' if same_keep else 'FAIL'}")
    if not same_keep:
        failures.append("lsk fp32: capacity keep differs card/host")
    rec["fp32"] = dict(worst_rel_err=worst, keep_equal=same_keep,
                       dropped=drops, seconds=time.perf_counter() - t0)
    del model, host, got, ref, img
    torch.cuda.empty_cache()

    # (b) bf16 joint forwards at full width
    def joint_case(path, timed=True):
        cfg = Config.fromfile(path)
        m = build_detector(cfg.model, device=dev, compute_dtype="bfloat16",
                           seed=0)
        n_sar, n_rgb, n_ifr = JOINT
        imgs = [torch.rand(n, IMG, IMG, 3, generator=gen, device=dev)
                for n in JOINT]
        with torch.no_grad():
            m.sar_bbox_head.gfl_cls.bias.fill_(0.0)
            _, x, rpn = m.head_joint(*imgs)
            props, _, _ = m.get_proposals(*rpn)
            rf = m.roi_feats(x, props)
            spread_class_scores(m.rgb_roi_head, rf[:n_rgb * N_PROPOSALS])
            spread_class_scores(m.ifr_roi_head, rf[n_rgb * N_PROPOSALS:])
        del x, rpn, props, rf

        def joint():
            return m.simple_test_joint(*imgs)

        for _ in range(2):
            joint()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        outs = joint()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        name = os.path.basename(path)[:-3]
        r = dict(peak_gib=peak, launches=launches)
        ok = True
        for sub, (d, lab, val), n in zip(("sar", "rgb", "ifr"), outs,
                                         JOINT):
            fin = bool(torch.isfinite(d).all())
            ok = ok and fin and d.shape[0] == n and int(val.sum()) > 0
            log(f"[lsk joint] {name} {sub}: dets {tuple(d.shape)}, "
                f"{int(val.sum())} valid, finite {fin}")
        if not ok:
            failures.append(f"{name} joint outputs")
        for k in LSK_KERNELS:
            if launches[k] <= 0:
                failures.append(f"{name} joint launches {k}={launches[k]}")
        log(f"[lsk joint] {name}: launches in one forward {launches}; peak "
            f"memory {peak:.2f} GiB")
        if not timed:
            return m, imgs, r
        walls, q1, med, q3 = timed_forwards(torch, joint)
        busy = device_ms(torch, joint, iters=3, warmup=0)
        syncs = host_syncs(torch, joint)
        n_syncs = sum(syncs.values())
        if n_syncs:
            failures.append(f"{name} joint: {n_syncs} host syncs {syncs}")
        with torch.no_grad():
            cat = torch.cat([m._cast_in(i) for i in imgs], 0)
            feats = m.backbone(cat)
            f_sar = [f[:n_sar] for f in feats]
            f_rc = [f[n_sar:] for f in feats]
            sar_x, x = m.neck_sar(f_sar), m.neck_rcnn(f_rc)
            s_cls, s_reg = m.sar_bbox_head(sar_x)
            (_, _), _, rpn = m.head_joint(*imgs)
            props, _, pval = m.get_proposals(*rpn)
            rf = m.roi_feats(x, props)
            logits, deltas = m.roi_logits_joint(rf, n_rgb, n_ifr)
            bb_ms, kinds = kind_ms(torch, m.backbone,
                                   lambda: m.backbone(cat))
            st = {
                "backbone": bb_ms,
                "necks": cuda_ms(torch, lambda: (m.neck_sar(f_sar),
                                                 m.neck_rcnn(f_rc)), iters=3),
                "GFL and RPN heads": cuda_ms(torch, lambda: (
                    m.sar_bbox_head(sar_x),
                    m.rgb_rpn_head([f[:n_rgb] for f in x]),
                    m.ifr_rpn_head([f[n_rgb:] for f in x])), iters=3),
                "SAR decode + NMS": cuda_ms(
                    torch, lambda: m.get_bboxes_sar(s_cls, s_reg), iters=3),
                "proposal decode + NMS": cuda_ms(
                    torch, lambda: m.get_proposals(*rpn), iters=3),
                "RoI align": cuda_ms(torch, lambda: m.roi_feats(x, props),
                                     iters=3),
                "RoI heads": cuda_ms(torch, lambda: m.roi_logits_joint(
                    rf, n_rgb, n_ifr), iters=3),
                "R-CNN decode + NMS": cuda_ms(
                    torch, lambda: m.get_bboxes_rcnn(logits, deltas, props,
                                                     pval), iters=3)}
        kinds["other backbone ops"] = bb_ms - sum(kinds.values())
        n_img = sum(JOINT)
        log(f"[lsk joint] {name} [{n_sar}:{n_rgb}:{n_ifr}] x {IMG}^2 bf16: "
            f"median {med * 1e3:.2f} ms (quartiles {q1 * 1e3:.2f}-"
            f"{q3 * 1e3:.2f}), {n_img / med:.2f} images/s (host clock); "
            f"device busy {ms_str(busy)} a forward (torch.profiler); "
            f"{n_syncs} host syncs a forward; card {smi}")
        log(f"[lsk joint] {name} wall times (ms): "
            f"{' '.join(f'{w * 1e3:.2f}' for w in walls)}")
        log(f"[lsk joint] {name} stages (CUDA events, mean of 3, ms): "
            + "; ".join(f"{k} {v:.2f}" for k, v in st.items()))
        log(f"[lsk joint] {name} backbone by module kind (CUDA events around "
            f"each module call, mean of 3, ms): " + "; ".join(
                f"{k} {v:.2f}" for k, v in sorted(kinds.items())))
        r.update(images_per_s=n_img / med, ms=med * 1e3, q1_ms=q1 * 1e3,
                 q3_ms=q3 * 1e3, device_busy_ms=busy, host_syncs=n_syncs,
                 stage_ms=st, backbone_kind_ms=kinds)
        del feats, f_sar, f_rc, sar_x, x, rpn, props, rf, logits, deltas
        return m, imgs, r

    t0 = time.perf_counter()
    lsk_model, _, rec["lsk_t_joint"] = joint_case(LSK_T_CFG)
    lsk_launches = rec["lsk_t_joint"]["launches"]
    # the dilated 7x7 depthwise (cuDNN) at stage 0 of the joint batch: as
    # the port runs it (the channels-last view), on an NCHW copy, and with
    # cuDNN's autotuner on; against its bytes / fp32 operations bound
    conv = lsk_model.backbone.stage0_block0.attn.spatial_gating_unit \
        .conv_spatial
    xs = torch.randn(sum(JOINT), IMG // 4, IMG // 4, conv.weight.shape[0],
                     generator=gen, device=dev).to(torch.bfloat16)
    xn = xs.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        t_cl = cuda_ms(torch, lambda: conv(xs))
        t_nchw = cuda_ms(torch, lambda: F.conv2d(
            xn, conv.weight, conv.bias, 1, 9, 3, conv.groups))
        was = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            t_tuned = cuda_ms(torch, lambda: conv(xs))
        finally:
            torch.backends.cudnn.benchmark = was
    b, k = bound_ms(4 * xs.numel(), [(2 * 49 * xs.numel(), "float32")])
    log(f"[lsk joint] conv_spatial (7x7, dilation 3, depthwise) "
        f"{tuple(xs.shape)} bf16: channels-last {t_cl:.4f} ms, NCHW "
        f"{t_nchw:.4f} ms, channels-last with cudnn.benchmark "
        f"{t_tuned:.4f} ms; bound {b:.4f} ms ({k}); card {smi}")
    rec["conv_spatial_stage0"] = dict(
        shape=list(xs.shape), channels_last_ms=t_cl, nchw_ms=t_nchw,
        benchmark_ms=t_tuned, bound_ms=b, bound_by=k)
    del xs, xn, conv
    m, imgs, rec["van_t_joint"] = joint_case(VAN_T_CFG)
    del m, imgs
    torch.cuda.empty_cache()
    m, imgs, rec["lsk_b_joint"] = joint_case(LSK_B_CFG, timed=False)
    del m, imgs
    torch.cuda.empty_cache()
    log(f"[lsk joint] (b) {time.perf_counter() - t0:.1f} s")

    # (c) the eval entry point on LSK-T, the model of (b)
    t0 = time.perf_counter()
    for sub in ("sar", "rgb"):
        build.reset_launches()
        out = test_cli.main([LSK_T_CFG, "--subdataset", sub,
                             "--synthetic-data", "--num-images", "16",
                             "--batch-size", "8", "--cfg-options",
                             "evaluation.metric=mAP"], model=lsk_model)
        n_det = sum(len(d) for img in out["det_results"] for d in img)
        m_ap = out["metrics"]["mAP"]
        log(f"[lsk eval] tools.test {LSK_T_CFG} --subdataset {sub} "
            f"--synthetic-data, 16 images: mAP {m_ap:.4f}, {n_det} "
            f"detections, {out['img_per_s']:.2f} images/s; launches "
            f"{dict(build.LAUNCHES)}")
        rec[f"eval_{sub}"] = dict(mAP=m_ap, detections=n_det,
                                  images_per_s=out["img_per_s"])
        if not (0.0 <= m_ap <= 1.0) or n_det == 0:
            failures.append(f"lsk eval {sub}: mAP {m_ap}, {n_det} dets")
    del lsk_model, out
    torch.cuda.empty_cache()
    log(f"[lsk eval] (c) {time.perf_counter() - t0:.1f} s")

    # (d) the train entry point
    shutil.rmtree(LSK_WORK, ignore_errors=True)

    def train_run(path, wd, iters, extra=(), argv_extra=()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        out, parts, sites = syncs_by_part(torch, lambda: train_cli.main(
            [path, "--synthetic-data", "--work-dir", wd, "--max-iters",
             str(iters)] + list(argv_extra) + [
                "--cfg-options", "model.compute_dtype=bfloat16",
                f"checkpoint_interval={iters}", "log_interval=5"]
            + list(extra)))
        wall = time.perf_counter() - t0
        st = out["stats"]
        ends = st["iter_end_s"]
        n_img = sum(Config.fromfile(path).source_ratio)
        iter_ms = float(np.median(np.diff(ends[1:]))) * 1e3 \
            if len(ends) > 2 else None
        ips = n_img / iter_ms * 1e3 if iter_ms else None
        r = dict(iterations=st["iters"], median_iteration_ms=iter_ms,
                 images_per_s=ips,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 syncs=parts, syncs_per_step=parts["step"] / max(
                     st["iters"], 1), step_sync_sites=sites,
                 last_log=st["log_lines"][-1] if st["log_lines"] else None,
                 launches=dict(build.LAUNCHES), wall_s=wall)
        log(f"[lsk train] {os.path.basename(path)} {' '.join(extra)} "
            f"{' '.join(argv_extra)}: {st['iters']} iterations in "
            f"{wall:.1f} s; median iteration "
            + ("n/a" if iter_ms is None else
               f"{iter_ms:.1f} ms, {ips:.2f} images/s")
            + f" (host clock); peak {r['peak_gib']:.2f} GiB; syncs by part "
            f"{parts} ({r['syncs_per_step']:.1f} a step); card {smi}")
        log(f"[lsk train]   the step's syncs by site: {sites}")
        log(f"[lsk train]   last log line: {r['last_log']}")
        if st["log_lines"] and not all(np.isfinite(v) for x in
                                       st["log_lines"] for v in x.values()):
            failures.append(f"{path}: a logged value is not finite")
        return out, r

    t0 = time.perf_counter()
    wd = os.path.join(LSK_WORK, "lsk_t")
    half = LSK_TRAIN_ITERS // 2
    out, rec["train_lsk_t"] = train_run(LSK_T_CFG, wd, LSK_TRAIN_ITERS,
                                        (f"checkpoint_interval={half}",))
    for k in LSK_TRAIN_KERNELS:
        if rec["train_lsk_t"]["launches"][k] <= 0:
            failures.append(f"lsk train launches {k}=0")
    del out
    ck = os.path.join(wd, f"iter_{half}.pth")
    back = train_cli.main([LSK_T_CFG, "--synthetic-data", "--work-dir", wd,
                           "--resume-from", ck, "--max-iters", str(half),
                           "--cfg-options", "model.compute_dtype=bfloat16"])
    same = checkpoint_equal(torch, ck, back["state"])
    log(f"[lsk train] --resume-from iter_{half}: start "
        f"{back['start_iter']}, the loaded state equal to the file bit for "
        f"bit: {same}")
    if not (same and back["start_iter"] == half):
        failures.append(f"lsk train: the resumed state differs from "
                        f"iter_{half}.pth")
    del back
    out, rec["train_lsk_t_resumed"] = train_run(
        LSK_T_CFG, wd, half + 2, ("log_interval=2",), ("--resume-from", ck))
    if not rec["train_lsk_t_resumed"]["last_log"]:
        failures.append("lsk train: no log line after the resume")
    rec["train_lsk_t"]["resume_equal"] = same
    del out
    torch.cuda.empty_cache()

    # uncertainty: reweighted_total_losses logged, mtl_sigma trained
    out, r = train_run(UNC_CFG, os.path.join(LSK_WORK, "uncertainty"),
                       REWEIGHT_ITERS)
    sigma = out["state"].params["mtl_sigma"].detach().float().cpu()
    moved = float((sigma - 1).abs().max())
    logged = "reweighted_total_losses" in (r["last_log"] or {})
    log(f"[lsk train] uncertainty: reweighted_total_losses logged {logged}; "
        f"mtl_sigma moved by up to {moved:.3e}: {sigma.tolist()}")
    r.update(mtl_sigma=sigma.tolist(), sigma_moved=moved)
    rec["train_uncertainty"] = r
    if not (logged and moved > 0):
        failures.append("uncertainty: not logged or mtl_sigma did not move")
    del out
    torch.cuda.empty_cache()

    # DWA: the weights each step applied, recorded on the card
    weights = []
    real = ts_mod.dwa_weights

    def recording(cur, prev):
        w = real(cur, prev)
        weights.append(w.detach())
        return w
    ts_mod.dwa_weights = recording
    try:
        wd = os.path.join(LSK_WORK, "dwa")
        out, r = train_run(UNC_CFG, wd, REWEIGHT_ITERS,
                           ("model.multi_tasks_reweight=dwa",))
    finally:
        ts_mod.dwa_weights = real
    w = torch.stack(weights).float().cpu()
    saved = torch.load(os.path.join(wd, f"iter_{REWEIGHT_ITERS}.pth"),
                       map_location="cpu", weights_only=True)
    carry = out["state"].prev_losses.cpu()
    first_ones = torch.equal(w[0], torch.ones_like(w[0]))
    later = [float((x - 1).abs().max()) for x in w[1:]]
    carried = saved["prev_losses"] is not None and \
        torch.equal(saved["prev_losses"], carry) and bool((carry > 0).any())
    log(f"[lsk train] dwa: weights 1 at step 1 {first_ones}; largest "
        f"|w - 1| at steps 2..{len(w)}: "
        + " ".join(f"{v:.3e}" for v in later)
        + f"; the carry in iter_{REWEIGHT_ITERS}.pth equal to the state's "
        f"{carried}: {carry.tolist()}")
    r.update(first_weights_one=first_ones, max_weight_dev=later,
             carry=carry.tolist(), carry_in_checkpoint=carried)
    rec["train_dwa"] = r
    if not (first_ones and later and all(v > 0 for v in later) and carried):
        failures.append("dwa: weights or carry")
    del out, saved
    shutil.rmtree(LSK_WORK, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[lsk train] (d) {time.perf_counter() - t0:.1f} s")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[lsk] phase 8 wall time {rec['phase_s']:.1f} s")
    return failures, rec, lsk_launches


VARIANT_CFGS = tuple(
    (tag, f"configs/local_configs/SM3Det_convnext_t_{name}.py")
    for tag, name in (("H1-R1", "s2anet_gfl"), ("H2-R1", "s2anet_frcnn"),
                      ("H2-R2", "orcnn_frcnn")))
VARIANT_WORK = "work_dirs/chip_smoke_variant"   # gitignored; removed
VARIANT_ITERS = 12          # H2-R2 through the train entry point
VARIANT_H1_ITERS = 6        # H1-R1: the retina assigner
ZOO_DOTA_CFG = "configs/local_configs/dota_convnext_t_orcnn.py"
ZOO_SAR_CFG = "configs/local_configs/sardet50k_convnext_t_gfl.py"
# the kernels each run must launch: the H2-R2 / H1-R1 train steps and
# the zoo's forwards (no MoE block in the zoo's ConvNeXt configs)
VARIANT_KERNELS = {
    "H2-R2": ("hbb_nms_mask", "nms_keep", "rotated_iou", "roi_align_rotated",
              "roi_align_rotated_bwd", "fused_dwconv_ln_train",
              "fused_dwconv_ln_train_bwd"),
    "H1-R1": ("rotated_iou", "fused_dwconv_ln_train",
              "fused_dwconv_ln_train_bwd")}
ZOO_KERNELS = {
    "OrientedRCNN": ("fused_convnext_block", "fused_layernorm",
                     "hbb_nms_mask", "nms_keep", "roi_align_rotated",
                     "rotated_nms_mask_banded"),
    "GFL": ("fused_convnext_block", "fused_layernorm", "hbb_nms_mask",
            "nms_keep"),
    "RotatedRetinaNet": ("fused_convnext_block", "fused_layernorm",
                         "rotated_nms_mask_banded", "nms_keep")}


def phase9(torch, dev, smi, build):
    """9. The TriSource head-combination variants and the zoo's
    single-dataset detectors on the card: (a) the H1-R1, H2-R1 and H2-R2
    configs through ``build_detector``, one fp32 forward + backward at
    [1:1:1] x 512^2 on the card against the host, with the same draws and
    proposals: every loss within 1e-3 relative, each top-level subtree's
    gradient norm within 1e-2; (b) ``tools.train`` on the H2-R2 config at
    full width in bf16, [2:1:1] x 800^2, DLA on after two iterations, with a
    checkpoint and a resume equal to it bit for bit, then H1-R1; (c)
    ``simple_test`` of ``OrientedRCNN``, ``GFL`` and ``RotatedRetinaNet`` at
    8 x 800^2 bf16, and ``OrientedRCNN`` at one 800^2 image in fp32, card
    against host, stage by stage. Returns (failures, record, launches of
    one H2-R2 train step)."""
    import copy
    import os
    import shutil

    import numpy as np

    from sm3det_tpu_torch.models.builder import build_detector
    from sm3det_tpu_torch.models.detectors import hbb_detectors as hbb_mod
    from sm3det_tpu_torch.models.detectors import trisource as tri_mod
    from sm3det_tpu_torch.models.detectors.trisource import roi_feats
    from sm3det_tpu_torch.ops import nms as nms_mod
    from sm3det_tpu_torch.ops.cuda import rotated_iou_kernel as rik
    from sm3det_tpu_torch.ops.rotated_iou import obb_corners
    from sm3det_tpu_torch.tools import train as train_cli
    from sm3det_tpu_torch.train.train_state import batch_to, trainable_params
    from sm3det_tpu_torch.utils.config import Config

    failures, rec = [], {}
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False     # as main: fp32 is fp32
    torch.backends.cuda.matmul.allow_tf32 = False

    # (a) card against host, one fp32 forward + backward a combination
    tbatch = make_train_batch(np.random.RandomState(9), (1, 1, 1), HOST_IMG,
                              TRAIN_GTS)
    real = {"tri": tri_mod.rpn_get_proposals,
            "hbb": hbb_mod.hbb_rpn_get_proposals}
    rec["card_host"] = {}
    for name, path in VARIANT_CFGS:
        t0 = time.perf_counter()
        card = build_detector(Config.fromfile(path).model, device=dev,
                              compute_dtype="float32", seed=0,
                              trainable=True)
        host = copy.deepcopy(card).to("cpu")
        # the proposal NMS is a discrete function of float noise: the
        # host samples its RoIs from the card's proposals
        recorded, replayed = {"tri": [], "hbb": []}, {"tri": 0, "hbb": 0}

        def record(key):
            def fn(*a, **kw):
                out = real[key](*a, **kw)
                recorded[key].append(out)
                return out
            return fn

        def replay(key):
            def fn(*a, **kw):
                out = recorded[key][replayed[key]]
                replayed[key] += 1
                return tuple(t.cpu() for t in out)
            return fn

        runs = {}
        for side, m, dv, patch in (("card", card, dev, record),
                                   ("host", host, torch.device("cpu"),
                                    replay)):
            tri_mod.rpn_get_proposals = patch("tri")
            hbb_mod.hbb_rpn_get_proposals = patch("hbb")
            try:
                params = trainable_params(m)
                losses = m(batch_to(tbatch, dv),
                           gen=torch.Generator().manual_seed(5))
                grads = torch.autograd.grad(
                    sum(losses.values()), list(params.values()),
                    allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params.values(), grads)]
            finally:
                tri_mod.rpn_get_proposals = real["tri"]
                hbb_mod.hbb_rpn_get_proposals = real["hbb"]
            runs[side] = ({k: float(v.detach()) for k, v in losses.items()},
                          subtree_norms(torch, list(params), grads))
            del losses, grads
        (ld, nd), (lh, nh) = runs["card"], runs["host"]
        bad = [k for k in lh if not (np.isfinite(ld[k]) and abs(
            ld[k] - lh[k]) <= 1e-3 * abs(lh[k]) + 1e-7)]
        bad += [f"|grad {k}|" for k in nh if not (np.isfinite(nd[k]) and abs(
            nd[k] - nh[k]) <= 1e-2 * nh[k])]
        worst_l = max(abs(ld[k] - lh[k]) / max(abs(lh[k]), 1e-12)
                      for k in lh)
        worst_g = max(abs(nd[k] - nh[k]) / max(nh[k], 1e-12) for k in nh)
        rec["card_host"][name] = dict(card_losses=ld, host_losses=lh,
                                      worst_loss_rel=worst_l,
                                      worst_grad_norm_rel=worst_g)
        log(f"[variant fp32] {name} ({os.path.basename(path)}), [1:1:1] x "
            f"{HOST_IMG}^2, card against host with the card's proposals "
            f"({len(recorded['tri'])} oriented, {len(recorded['hbb'])} "
            f"horizontal): {len(lh)} losses, worst {worst_l:.2e} relative "
            f"(tol 1e-3); {len(nh)} subtree gradient norms, worst "
            f"{worst_g:.2e} (tol 1e-2); {time.perf_counter() - t0:.1f} s "
            f"{'ok' if not bad else 'FAIL ' + str(bad)}")
        for k in sorted(lh):
            log(f"[variant fp32]   {k}: card {ld[k]:.6e} host {lh[k]:.6e}")
        failures += [f"variant {name} card/host {k}" for k in bad]
        del card, host, recorded
        torch.cuda.empty_cache()

    # (b) the train entry point
    shutil.rmtree(VARIANT_WORK, ignore_errors=True)

    def train_run(tag, path, wd, iters, extra=(), argv_extra=()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        out, parts, sites = syncs_by_part(torch, lambda: train_cli.main(
            [path, "--synthetic-data", "--work-dir", wd, "--max-iters",
             str(iters)] + list(argv_extra) + [
                "--cfg-options", "evaluation=None",
                "model.compute_dtype=bfloat16", "lr_config.warmup_iters=2",
                "log_interval=2"] + list(extra)))
        wall = time.perf_counter() - t0
        st = out["stats"]
        done = st["iters"]
        steps = np.diff(st["iter_end_s"][2:]) * 1e3   # after 2 warm-up
        n_img = sum(Config.fromfile(path).source_ratio)
        q = (statistics.quantiles(steps, n=4) if len(steps) > 1
             else [float("nan")] * 3)
        r = dict(iterations=done, median_iteration_ms=q[1],
                 iteration_ms_quartiles=[q[0], q[2]],
                 images_per_s=n_img / q[1] * 1e3,
                 images_per_s_quartiles=[n_img / q[2] * 1e3,
                                         n_img / q[0] * 1e3],
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 syncs=parts, syncs_per_step=parts["step"] / max(done, 1),
                 step_sync_sites=sites,
                 last_log=st["log_lines"][-1] if st["log_lines"] else None,
                 launches_per_step={k: v / max(done, 1) for k, v in
                                    build.LAUNCHES.items() if v},
                 mults=dict(out["state"].opt.mults), wall_s=wall)
        log(f"[variant train] {tag} ({os.path.basename(path)}): {done} "
            f"iterations in {wall:.1f} s; median iteration {q[1]:.1f} ms "
            f"(quartiles {q[0]:.1f} / {q[2]:.1f}), "
            f"{r['images_per_s']:.2f} images/s (quartiles "
            f"{r['images_per_s_quartiles'][0]:.2f} / "
            f"{r['images_per_s_quartiles'][1]:.2f}, host clock); peak "
            f"{r['peak_gib']:.2f} GiB; syncs by part {parts} "
            f"({r['syncs_per_step']:.1f} a step); card {smi}")
        log(f"[variant train]   the step's syncs by site: {sites}")
        log(f"[variant train]   launches a step: {r['launches_per_step']}")
        log(f"[variant train]   DLA multipliers at the end: {r['mults']}")
        log(f"[variant train]   last log line: {r['last_log']}")
        if not st["log_lines"] or not all(
                np.isfinite(v) for x in st["log_lines"] for v in x.values()):
            failures.append(f"variant train {tag}: a logged value is not "
                            f"finite")
        for k in VARIANT_KERNELS[tag]:
            if build.LAUNCHES.get(k, 0) <= 0:
                failures.append(f"variant train {tag}: launches {k}=0")
        return out, r

    h2r2 = dict(VARIANT_CFGS)["H2-R2"]
    wd = os.path.join(VARIANT_WORK, "h2r2")
    half = VARIANT_ITERS // 2
    out, rec["train_h2r2"] = train_run(
        "H2-R2", h2r2, wd, VARIANT_ITERS, (f"checkpoint_interval={half}",))
    mults = rec["train_h2r2"]["mults"]
    if not mults or all(abs(m - 1.0) < 1e-6 for m in mults.values()):
        failures.append("variant train: DLA did not switch on")
    del out
    ck = os.path.join(wd, f"iter_{half}.pth")
    back = train_cli.main([h2r2, "--synthetic-data", "--work-dir", wd,
                           "--resume-from", ck, "--max-iters", str(half),
                           "--cfg-options", "evaluation=None",
                           "model.compute_dtype=bfloat16",
                           "lr_config.warmup_iters=2"])
    same = checkpoint_equal(torch, ck, back["state"])
    rec["resume_equal"] = same
    log(f"[variant train] H2-R2 --resume-from iter_{half}: start "
        f"{back['start_iter']}, the loaded state equal to the file bit for "
        f"bit: {same}")
    if not (same and back["start_iter"] == half):
        failures.append(f"variant train: the resumed state differs from "
                        f"iter_{half}.pth")
    del back
    torch.cuda.empty_cache()
    out, rec["train_h1r1"] = train_run(
        "H1-R1", dict(VARIANT_CFGS)["H1-R1"], os.path.join(
            VARIANT_WORK, "h1r1"), VARIANT_H1_ITERS,
        (f"checkpoint_interval={VARIANT_H1_ITERS + 1}",))
    del out
    shutil.rmtree(VARIANT_WORK, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) the zoo's forwards, 8 x 800^2 bf16
    gen = torch.Generator(device="cuda").manual_seed(9)
    imgs = torch.rand(N_IMGS, IMG, IMG, 3, generator=gen, device=dev)
    shape = (IMG, IMG)
    rec["zoo"] = {}
    for name, path, mtype in (("OrientedRCNN", ZOO_DOTA_CFG, None),
                              ("GFL", ZOO_SAR_CFG, None),
                              ("RotatedRetinaNet", ZOO_DOTA_CFG,
                               "RotatedRetinaNet")):
        mc = Config.fromfile(path).model.to_dict()
        if mtype:
            mc["type"] = mtype
        model = build_detector(mc, device=dev, compute_dtype="bfloat16",
                               seed=0)
        # real detections: class scores off the 0.01 prior
        with torch.no_grad():
            if name == "GFL":
                model.bbox_head.gfl_cls.bias.fill_(0.0)
            elif name == "RotatedRetinaNet":
                model.bbox_head.retina_cls.bias.fill_(0.0)
            else:
                x = model.extract_feat(imgs[:1])
                p, _, _ = model.get_proposals(*model.rpn_head(x), shape)
                spread_class_scores(model.roi_head, roi_feats(x, p))

        def fwd():
            return model.simple_test(imgs, shape)
        out = fwd()
        torch.cuda.synchronize()
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out = fwd()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        sites = host_syncs(torch, fwd)
        _, q1, med, q3 = timed_forwards(torch, fwd, n=6)
        dets, labels, valid = out
        n_valid = int(valid.sum())
        ok = bool(torch.isfinite(dets).all()) and n_valid > 0 and all(
            launches.get(k, 0) > 0 for k in ZOO_KERNELS[name])
        rec["zoo"][name] = dict(
            images_per_s=N_IMGS / med, ms=med * 1e3,
            ms_quartiles=[q1 * 1e3, q3 * 1e3], peak_gib=peak,
            host_syncs=sum(sites.values()), sync_sites=sites,
            launches={k: v for k, v in launches.items() if v},
            valid=n_valid, dets_shape=list(dets.shape))
        log(f"[zoo] {name} ({os.path.basename(path)}) simple_test 8 x "
            f"{IMG}^2 bf16: median {med * 1e3:.2f} ms (quartiles "
            f"{q1 * 1e3:.2f} / {q3 * 1e3:.2f}), {N_IMGS / med:.2f} images/s "
            f"(host clock); peak {peak:.2f} GiB; host syncs {sites}; "
            f"dets {tuple(dets.shape)}, {n_valid} valid; launches "
            f"{rec['zoo'][name]['launches']}; card {smi} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"zoo {name} forward")
        del model, out, dets, labels, valid
        torch.cuda.empty_cache()

    # OrientedRCNN, one 800^2 image, fp32: card against host, stage by
    # stage; each stage from the card's inputs to it
    e2e_tol = 1e-3
    model = build_detector(Config.fromfile(ZOO_DOTA_CFG).model, device=dev,
                           compute_dtype="float32", seed=0)
    host = copy.deepcopy(model).to("cpu")
    img = imgs[:1]
    zoo_fail = []

    def stage(what, a, b):
        err, scale = max_err(a.cpu(), b.cpu())
        ok = bool(torch.isfinite(a.float()).all()) and a.shape == b.shape \
            and err <= e2e_tol * max(scale, 1.0)
        log(f"[zoo fp32] OrientedRCNN {what} {tuple(a.shape)}: max abs err "
            f"{err:.3e} (max |ref| {scale:.3e}) tol {e2e_tol} x scale "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            zoo_fail.append(what)

    with torch.no_grad():
        f_d = model.backbone(model._cast_in(img))
        f_h = host.backbone(img.cpu())
        for lvl, (a, b) in enumerate(zip(f_d, f_h)):
            stage(f"features[{lvl}]", a, b)
        x_d = model._neck(f_d)
        x_h = host._neck([t.cpu() for t in f_d])
        rpn_d = model.rpn_head(x_d)
        rpn_h = host.rpn_head([t.cpu() for t in x_d])
        for lvl in range(len(x_d)):
            stage(f"neck[{lvl}]", x_d[lvl], x_h[lvl])
            stage(f"rpn_cls[{lvl}]", rpn_d[0][lvl], rpn_h[0][lvl])
            stage(f"rpn_reg[{lvl}]", rpn_d[1][lvl], rpn_h[1][lvl])
        prop_d, psc_d, pval_d = model.get_proposals(*rpn_d, shape)
        prop_h, psc_h, pval_h = host.get_proposals(
            [t.cpu() for t in rpn_d[0]], [t.cpu() for t in rpn_d[1]], shape)
        ok = torch.equal(pval_d.cpu(), pval_h) and \
            (psc_d.cpu() - psc_h).abs().max().item() <= 1e-6 and \
            equal_rectangles(torch, obb_corners, prop_d, prop_h,
                             "OrientedRCNN proposals", (psc_d, psc_h))
        if not ok or int(pval_h.sum()) == 0:
            zoo_fail.append("proposals")
        rf_d = roi_feats(x_d, prop_d)
        rf_h = roi_feats([t.cpu() for t in x_d], prop_d.cpu())
        bin_err = (rf_d.cpu() - rf_h).abs().amax(-1)
        n_bad = int((bin_err > e2e_tol * max(rf_h.abs().max().item(),
                                             1.0)).sum())
        log(f"[zoo fp32] OrientedRCNN roi_feats {tuple(rf_d.shape)}: "
            f"{n_bad} of {bin_err.numel()} bins beyond {e2e_tol} x scale "
            f"(allowed 8: border samples) {'ok' if n_bad <= 8 else 'FAIL'}")
        if n_bad > 8:
            zoo_fail.append("roi_feats")
        spread_class_scores(model.roi_head, rf_d)
        host.roi_head.load_state_dict(
            {k: v.cpu() for k, v in model.roi_head.state_dict().items()})
        lg_d, dl_d = model.roi_head(rf_d)
        lg_h, dl_h = host.roi_head(rf_d.cpu())
        stage("cls_logits", lg_d, lg_h)
        stage("bbox_deltas", dl_d, dl_h)
        args = (lg_d[None], dl_d[None], prop_d, pval_d)
        det_d = model.get_bboxes(*args, shape)
        det_h = host.get_bboxes(*[t.cpu() for t in args], shape)
        n_valid = int(det_h[2].sum())
        if torch.equal(det_d[2].cpu(), det_h[2]) and \
                torch.equal(det_d[1].cpu(), det_h[1]):
            sc_err = (det_d[0][..., 5].cpu() - det_h[0][..., 5]).abs() \
                .max().item()
            ok = n_valid > 0 and sc_err <= 1e-4 and equal_rectangles(
                torch, obb_corners, det_d[0][..., :5], det_h[0][..., :5],
                "OrientedRCNN detections")
            log(f"[zoo fp32] OrientedRCNN detections from the same logits: "
                f"{n_valid} valid, labels/valid equal, max score err "
                f"{sc_err:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}")
        else:
            # a candidate pair within rounding of the IoU threshold decides
            # either way between the devices (sinf/cosf): the mask kernel
            # must then agree with its plain version on the card
            kernel_mask = nms_mod.rotated_nms_mask
            nms_mod.rotated_nms_mask = rik.rotated_nms_mask_ref
            try:
                det_p = model.get_bboxes(*args, shape)
            finally:
                nms_mod.rotated_nms_mask = kernel_mask
            ok = n_valid > 0 and all(torch.equal(a, b)
                                     for a, b in zip(det_d, det_p))
            log(f"[zoo fp32] OrientedRCNN detections: card and host differ "
                f"({int(det_d[2].sum())} against {n_valid} valid) at an IoU "
                f"near-tie; the card's mask kernel against the plain mask "
                f"on the card: equal {ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            zoo_fail.append("detections")
    rec["zoo_card_host_ok"] = not zoo_fail
    failures += [f"zoo OrientedRCNN card/host {k}" for k in zoo_fail]
    del model, host, imgs
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[variant] phase 9 wall time {rec['phase_s']:.1f} s")
    step = {k: round(v) for k, v in
            rec["train_h2r2"]["launches_per_step"].items()}
    return failures, rec, step


REFINE_CFG = "configs/local_configs/dota_convnext_t_s2anet.py"
ROITRANS_CFG = "configs/local_configs/dota_convnext_t_roitrans.py"
REFINE_HOST = (2, 256)      # 10a: images, size
REFINE_TRAIN = (2, 800)     # 10c: images, size
REFINE_GTS = 16
REFINE_TIMED = 4            # 10c: steps timed, after 4 others
# the kernels each run must launch: the refinement detectors' forward and
# the train steps (no MoE block in these configs)
REFINE_KERNELS = ("fused_convnext_block", "fused_layernorm",
                  "rotated_nms_mask_banded", "nms_keep")
REFINE_TRAIN_KERNELS = {
    "S2ANet": ("rotated_iou", "fused_dwconv_ln_train",
               "fused_dwconv_ln_train_bwd"),
    "RoITransformer": ("hbb_nms_mask", "nms_keep", "rotated_iou",
                       "roi_align_rotated", "roi_align_rotated_bwd",
                       "fused_dwconv_ln_train", "fused_dwconv_ln_train_bwd")}


def refine_batch(np, rng, n, img, g):
    """One modality's train batch of oriented gts, numpy."""
    return {"img": rng.rand(n, img, img, 3).astype(np.float32),
            "gt_obbs": np.stack([
                rng.uniform(25, img - 25, (n, g)),
                rng.uniform(25, img - 25, (n, g)),
                rng.uniform(10, 60, (n, g)), rng.uniform(6, 30, (n, g)),
                rng.uniform(-1.2, 1.2, (n, g))], -1).astype(np.float32),
            "gt_labels": rng.randint(0, 26, (n, g)).astype(np.int32),
            "gt_mask": np.ones((n, g), bool)}


def phase10(torch, dev, smi, build):
    """10. The zoo's refinement and cascade detectors on the card: (a)
    ``R3Det``, ``S2ANet`` (``refine_reg_loss`` smooth_l1 and kfiou) and
    ``RoITransformer`` at full width, fp32, 2 x 256^2: one forward +
    backward on the card against the host with the same parameters, batch
    and sampler keys (the host's RPN proposals replayed from the card's):
    every loss within 1e-3 relative, each top-level subtree's gradient norm
    within 1e-2; (b) ``S2ANet.simple_test`` and ``R3Det.simple_test`` at
    the widths of ``dota_convnext_t_s2anet.py``, 8 x 800^2 bf16:
    images/s, device busy time, host syncs (0 required), peak memory, the
    launches a forward, and ``rotated_feature_align`` alone at level 0;
    (c) bf16 AdamW train steps of ``S2ANet`` and ``RoITransformer``
    through the library API, 2 x 800^2: images/s, syncs a step, peak
    memory, finite losses, the launches a step. Returns (failures, record,
    launches of one RoITransformer train step)."""
    import copy
    import os

    import numpy as np

    from sm3det_tpu_torch.models.builder import build_detector
    from sm3det_tpu_torch.models.detectors import redet_roitrans as rt_mod
    from sm3det_tpu_torch.ops.geometry_extras import rotated_feature_align
    from sm3det_tpu_torch.train.optim import make_optimizer
    from sm3det_tpu_torch.train.train_state import (
        batch_to, build_train_step, init_train_state, trainable_params)
    from sm3det_tpu_torch.utils.config import Config

    failures, rec = [], {}
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False     # as main: fp32 is fp32
    torch.backends.cuda.matmul.allow_tf32 = False

    def model_cfg(path, mtype=None, **extra):
        mc = Config.fromfile(path).model.to_dict()
        if mtype:
            mc["type"] = mtype
        mc.update(extra)
        return mc

    # (a) card against host, fp32
    n_img, size = REFINE_HOST
    hbatch = refine_batch(np, np.random.RandomState(10), n_img, size,
                          REFINE_GTS)
    real = rt_mod.hbb_rpn_get_proposals
    rec["card_host"] = {}
    for tag, mc in (
            ("R3Det", model_cfg(REFINE_CFG, "R3Det")),
            ("S2ANet smooth_l1", model_cfg(REFINE_CFG)),
            ("S2ANet kfiou", model_cfg(REFINE_CFG,
                                       refine_reg_loss="kfiou")),
            ("RoITransformer", model_cfg(ROITRANS_CFG))):
        t0 = time.perf_counter()
        card = build_detector(mc, device=dev, compute_dtype="float32",
                              seed=0, trainable=True)
        host = copy.deepcopy(card).to("cpu")
        # the proposal NMS is a discrete function of float noise: the
        # host takes the card's proposals
        recorded, replayed = [], [0]

        def record(*a, **kw):
            out = real(*a, **kw)
            recorded.append(out)
            return out

        def replay(*a, **kw):
            replayed[0] += 1
            return tuple(t.cpu() for t in recorded[replayed[0] - 1])

        runs = {}
        for side, m, dv, patch in (("card", card, dev, record),
                                   ("host", host, torch.device("cpu"),
                                    replay)):
            rt_mod.hbb_rpn_get_proposals = patch
            try:
                params = trainable_params(m)
                losses = m(batch_to({"d": hbatch}, dv)["d"],
                           gen=torch.Generator().manual_seed(5))
                grads = torch.autograd.grad(
                    sum(losses.values()), list(params.values()),
                    allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params.values(), grads)]
            finally:
                rt_mod.hbb_rpn_get_proposals = real
            runs[side] = ({k: float(v.detach()) for k, v in losses.items()},
                          subtree_norms(torch, list(params), grads))
            del losses, grads
        (ld, nd), (lh, nh) = runs["card"], runs["host"]
        bad = [k for k in lh if not (np.isfinite(ld[k]) and abs(
            ld[k] - lh[k]) <= 1e-3 * abs(lh[k]) + 1e-7)]
        bad += [f"|grad {k}|" for k in nh if not (np.isfinite(nd[k]) and abs(
            nd[k] - nh[k]) <= 1e-2 * nh[k])]
        worst_l = max(abs(ld[k] - lh[k]) / max(abs(lh[k]), 1e-12)
                      for k in lh)
        worst_g = max(abs(nd[k] - nh[k]) / max(nh[k], 1e-12) for k in nh)
        rec["card_host"][tag] = dict(card_losses=ld, host_losses=lh,
                                     card_norms=nd, host_norms=nh,
                                     worst_loss_rel=worst_l,
                                     worst_grad_norm_rel=worst_g)
        log(f"[refine fp32] {tag}, {n_img} x {size}^2, card against host"
            f"{' with the card proposals' if recorded else ''}: {len(lh)} "
            f"losses, worst {worst_l:.2e} relative (tol 1e-3); {len(nh)} "
            f"subtree gradient norms, worst {worst_g:.2e} (tol 1e-2); "
            f"{time.perf_counter() - t0:.1f} s "
            f"{'ok' if not bad else 'FAIL ' + str(bad)}")
        for k in sorted(lh):
            log(f"[refine fp32]   {k}: card {ld[k]:.6e} host {lh[k]:.6e}")
        failures += [f"refine {tag} card/host {k}" for k in bad]
        del card, host, recorded
        torch.cuda.empty_cache()

    # (b) the refinement detectors' simple_test, 8 x 800^2 bf16
    gen = torch.Generator(device="cuda").manual_seed(10)
    imgs = torch.rand(N_IMGS, IMG, IMG, 3, generator=gen, device=dev)
    rec["simple_test"] = {}
    for name in ("S2ANet", "R3Det"):
        model = build_detector(model_cfg(REFINE_CFG, name), device=dev,
                               compute_dtype="bfloat16", seed=0)

        def fwd():
            return model.simple_test(imgs, (IMG, IMG))
        out = fwd()
        torch.cuda.synchronize()
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out = fwd()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        sites = host_syncs(torch, fwd)
        busy = device_ms(torch, fwd, iters=3, warmup=0)
        _, q1, med, q3 = timed_forwards(torch, fwd, n=6)
        dets, labels, valid = out
        n_valid = int(valid.sum())
        n_syncs = sum(sites.values())
        ok = bool(torch.isfinite(dets).all()) and n_valid > 0 and \
            n_syncs == 0 and all(launches.get(k, 0) > 0
                                 for k in REFINE_KERNELS)
        rec["simple_test"][name] = dict(
            images_per_s=N_IMGS / med,
            images_per_s_quartiles=[N_IMGS / q3, N_IMGS / q1],
            ms=med * 1e3, ms_quartiles=[q1 * 1e3, q3 * 1e3],
            device_busy_ms=busy, peak_gib=peak, host_syncs=n_syncs,
            sync_sites=sites,
            launches={k: v for k, v in launches.items() if v},
            valid=n_valid, dets_shape=list(dets.shape))
        log(f"[refine] {name} ({os.path.basename(REFINE_CFG)}) simple_test "
            f"8 x {IMG}^2 bf16: median {med * 1e3:.2f} ms (quartiles "
            f"{q1 * 1e3:.2f} / {q3 * 1e3:.2f}), {N_IMGS / med:.2f} "
            f"images/s (host clock); device busy {ms_str(busy)} a forward "
            f"(torch.profiler); peak {peak:.2f} GiB; host syncs {n_syncs} "
            f"{sites}; dets {tuple(dets.shape)}, {n_valid} valid; launches "
            f"{rec['simple_test'][name]['launches']}; card {smi} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"refine {name} forward")
        del model, out, dets, labels, valid
        torch.cuda.empty_cache()

    # rotated_feature_align alone at level 0, (8, 100, 100, 256) bf16
    feats = (torch.randn(N_IMGS, IMG // 8, IMG // 8, 256, generator=gen,
                         device=dev)).to(torch.bfloat16)
    boxes = torch.cat([torch.rand(N_IMGS, IMG // 8, IMG // 8, 2,
                                  generator=gen, device=dev) * IMG,
                       8 + torch.rand(N_IMGS, IMG // 8, IMG // 8, 2,
                                      generator=gen, device=dev) * 120,
                       torch.rand(N_IMGS, IMG // 8, IMG // 8, 1,
                                  generator=gen, device=dev) - 0.5], -1)

    def rfa():
        return rotated_feature_align(feats, boxes, points=5,
                                     spatial_scale=1.0 / 8)
    rfa_ms = cuda_ms(torch, rfa)
    rfa_dev = device_ms(torch, rfa)
    nbytes = 2 * feats.numel() * feats.element_size() + \
        boxes.numel() * boxes.element_size()
    rfa_bound = nbytes / H100_BYTES_PER_S * 1e3
    rec["rotated_feature_align"] = dict(
        shape=list(feats.shape), ms=rfa_ms, device_ms=rfa_dev,
        bytes=nbytes, bytes_bound_ms=rfa_bound)
    log(f"[refine] rotated_feature_align (plain PyTorch) at level 0 "
        f"{tuple(feats.shape)} bf16, 5 points: {rfa_ms:.4f} ms, device "
        f"{ms_str(rfa_dev)}; reads and writes {nbytes / 1e6:.1f} MB "
        f"(features once, boxes once, output once): bound "
        f"{rfa_bound:.4f} ms (bytes); card {smi}")
    del feats, boxes, imgs
    torch.cuda.empty_cache()

    # (c) train steps through the library API, 2 x 800^2 bf16
    n_img, size = REFINE_TRAIN
    rec["train"] = {}
    step_launches = {}
    for name, path in (("S2ANet", REFINE_CFG),
                       ("RoITransformer", ROITRANS_CFG)):
        model = build_detector(model_cfg(path), device=dev,
                               compute_dtype="bfloat16", seed=0,
                               trainable=True)
        init_fn, update_fn, _ = make_optimizer(
            list(trainable_params(model)), warmup_iters=2)
        state = init_train_state(model, init_fn)
        step = build_train_step(model, update_fn)
        tb = batch_to({"d": refine_batch(np, np.random.RandomState(11),
                                         n_img, size, REFINE_GTS)},
                      dev)["d"]
        holder = {"state": state}

        def one_step():
            holder["state"], m = step(holder["state"], tb)
            return m
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            one_step()
        torch.cuda.synchronize()
        build.reset_launches()
        metrics = one_step()
        torch.cuda.synchronize()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        sites = host_syncs(torch, one_step)
        _, q1, med, q3 = timed_forwards(torch, one_step, n=REFINE_TIMED)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        metrics = {k: float(v) for k, v in one_step().items()}
        n_syncs = sum(sites.values())
        ok = all(np.isfinite(v) for v in metrics.values()) and all(
            launches.get(k, 0) > 0 for k in REFINE_TRAIN_KERNELS[name])
        rec["train"][name] = dict(
            images_per_s=n_img / med,
            images_per_s_quartiles=[n_img / q3, n_img / q1],
            step_ms=med * 1e3, step_ms_quartiles=[q1 * 1e3, q3 * 1e3],
            syncs_per_step=n_syncs, sync_sites=sites, peak_gib=peak,
            losses=metrics, launches_per_step=launches)
        log(f"[refine train] {name} ({os.path.basename(path)}), {n_img} x "
            f"{size}^2 bf16, AdamW: median step {med * 1e3:.1f} ms "
            f"(quartiles {q1 * 1e3:.1f} / {q3 * 1e3:.1f}), "
            f"{n_img / med:.2f} images/s (host clock); {n_syncs} syncs a "
            f"step {sites}; peak {peak:.2f} GiB; card {smi} "
            f"{'ok' if ok else 'FAIL'}")
        log(f"[refine train]   launches a step: {launches}")
        log("[refine train]   losses: " + ", ".join(
            f"{k} {v:.5f}" for k, v in metrics.items()))
        if not ok:
            failures.append(f"refine train {name}")
        step_launches[name] = launches
        del model, state, step, holder, tb
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[refine] phase 10 wall time {rec['phase_s']:.1f} s")
    return failures, rec, step_launches


DA_CFG = "configs/local_configs/main_DA_convnext_t_orcnn_gfl.py"
DA_HOST = (2, 256)          # 11a: images a modality, size
DA_WORK = "work_dirs/chip_smoke_da"     # gitignored; removed at the end
DA_TRAIN_ITERS = 6
# the DA config's joint forward: 11 dense blocks through row 1 (each one
# dwconv_ln launch as well), 7 DA blocks through row 2 and the FFN kernel,
# the stem, 3 downsample and 4 output LayerNorms, the flagship's NMS and
# align launches
DA_JOINT_LAUNCHES = {
    "fused_convnext_block": 11, "dwconv_ln": 18, "convnext_ffn": 7,
    "moe_ffn_grouped": 0, "fused_layernorm": 8, "hbb_iou": 0,
    "rotated_iou": 0, "rotated_iou_banded": 0, "roi_align_rotated": 1,
    "roi_align_rotated_bwd": 0, "fused_dwconv_ln_train": 0,
    "fused_dwconv_ln_train_bwd": 0, "hbb_nms_mask": 2,
    "rotated_nms_mask": 0, "rotated_nms_mask_banded": 1, "nms_keep": 3}
DA_TRAIN_KERNELS = ("hbb_nms_mask", "nms_keep", "rotated_iou",
                    "roi_align_rotated", "roi_align_rotated_bwd",
                    "fused_dwconv_ln_train", "fused_dwconv_ln_train_bwd")
# the DA blocks of ConvNeXt-T at 800^2: (H = W, C, blocks)
DA_FFN_SHAPES = ((50, 384, 5), (25, 768, 2))
DA_PHASE_LIMIT_S = 120
SCRIPT_LIMIT_S = 1200      # the whole script, kernel builds included, must end within this


def phase11(torch, dev, smi, build):
    """11. The Domain-Attention baseline (``main_DA_convnext_t_orcnn_gfl``:
    ConvNeXt-T without MoE blocks, DA in stage-2 blocks 0/2/4/6/8 and
    stage-3 blocks 0/2) and the leftovers on the card: (a) fp32, 2 images a
    modality x 256^2, card against host: the features, necks, GFL and RPN
    outputs and R-CNN logits of each ``simple_test`` and of the joint
    forward within 1e-3 of scale (the host's RoIs the card's proposals);
    one train forward's losses within 1e-3 relative and each top-level
    subtree's gradient norm within 1e-2 (the host's proposals the card's);
    (b) the joint [8:4:4] x 800^2 bf16 forward at full width: images/s
    (median and quartiles of 10), device busy time, host syncs (0), and the
    launches by kernel, which must equal ``DA_JOINT_LAUNCHES``; the FFN
    kernel alone at the DA blocks' shapes against its plain version;
    (c) ``tools.train`` on the DA config, bf16, [2:1:1] x 800^2,
    ``DA_TRAIN_ITERS`` iterations, DLA on after 2: images/s, syncs a step
    by part, the launches a step; (d) ``tools.test`` on it, RGB and SAR
    mAP over 16 synthetic images; (e) the flagship with ``gate="linear"``
    in the bf16 joint forward (row 3 launched 7 times), ``soft_nms`` on the
    card against the host (the selections bit for bit) and the GRN block
    on the card against its plain path. Returns (failures, record, the
    launches of (b)'s forward)."""
    import copy
    import os
    import shutil

    import numpy as np

    from sm3det_tpu_torch.models.backbones.convnext import ConvNeXtBlock
    from sm3det_tpu_torch.models.builder import build_detector
    from sm3det_tpu_torch.models.detectors import trisource as tri_mod
    from sm3det_tpu_torch.models.detectors.trisource import (
        DEFAULT_MODEL_CFG, TriSourceDetector)
    from sm3det_tpu_torch.models.layers import gelu
    from sm3det_tpu_torch.ops import nms as nms_mod
    from sm3det_tpu_torch.ops.cuda import convnext_block_kernel as cbk
    from sm3det_tpu_torch.ops.cuda.hbb_iou_kernel import hbb_iou
    from sm3det_tpu_torch.ops.cuda.moe_groupgemm_kernel import ffn_ref
    from sm3det_tpu_torch.tools import test as test_cli
    from sm3det_tpu_torch.tools import train as train_cli
    from sm3det_tpu_torch.train.train_state import (batch_to,
                                                    trainable_params)
    from sm3det_tpu_torch.utils.config import Config

    failures, rec = [], {}
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False     # as main: fp32 is fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = Config.fromfile(DA_CFG).model.to_dict()
    gen = torch.Generator(device="cuda").manual_seed(11)
    cpu = torch.device("cpu")

    def close(tag, a, b, tol=1e-3):
        """a on the card, b on the host: within tol of b's scale."""
        err, scale = max_err(a.cpu(), b)
        ok = bool(torch.isfinite(a.float()).all()) and a.shape == b.shape \
            and err <= tol * max(scale, 1.0)
        rec["card_host"][tag] = dict(err=err, scale=scale)
        if not ok:
            failures.append(f"DA card/host {tag}")
            log(f"[da fp32]   {tag} {tuple(a.shape)}: max abs err {err:.3e} "
                f"(max |ref| {scale:.3e}) FAIL")
        return err / max(scale, 1.0)

    # (a) card against host, fp32
    t0 = time.perf_counter()
    n_img, size = DA_HOST
    card = build_detector(mc, device=dev, compute_dtype="float32", seed=0)
    host = copy.deepcopy(card).to(cpu)
    imgs = {k: torch.rand(n_img, size, size, 3, generator=gen, device=dev)
            for k in ("sar", "rgb", "ifr")}
    rec["card_host"] = {}
    worst = 0.0
    with torch.no_grad():
        for sub, d in (("sar", 0), ("rgb", 1), ("ifr", 2)):
            ic, ih = imgs[sub], imgs[sub].cpu()
            fd, fh = card.extract_feat(ic, d), host.extract_feat(ih, d)
            outs = [(f"{sub} features {i}", a, b)
                    for i, (a, b) in enumerate(zip(fd, fh))]
            if sub == "sar":
                hd = card.sar_bbox_head(card.neck_sar(fd))
                hh = host.sar_bbox_head(host.neck_sar(fh))
                outs += [(f"sar gfl {j} {i}", a, b) for j in range(2)
                         for i, (a, b) in enumerate(zip(hd[j], hh[j]))]
            else:
                xd, xh = card.neck_rcnn(fd), host.neck_rcnn(fh)
                rd, rh = card.head_rpn(xd, sub), host.head_rpn(xh, sub)
                outs += [(f"{sub} rpn {j} {i}", a, b) for j in range(2)
                         for i, (a, b) in enumerate(zip(rd[j], rh[j]))]
                props = card.get_proposals(*rd, (size, size))[0]
                head_d, head_h = card._heads(sub)[1], host._heads(sub)[1]
                ld = head_d(card.roi_feats(xd, props))
                lh = head_h(host.roi_feats(xh, props.cpu()))
                outs += [(f"{sub} rcnn logits", ld[0], lh[0]),
                         (f"{sub} rcnn deltas", ld[1], lh[1])]
            for tag, a, b in outs:
                worst = max(worst, close(tag, a, b))
        args = [imgs[k] for k in ("sar", "rgb", "ifr")]
        jd = card.head_joint(*args)
        jh = host.head_joint(*[a.cpu() for a in args])
        outs = [(f"joint sar {j} {i}", a, b) for j in range(2)
                for i, (a, b) in enumerate(zip(jd[0][j], jh[0][j]))]
        outs += [(f"joint neck {i}", a, b) for i, (a, b) in
                 enumerate(zip(jd[1], jh[1]))]
        outs += [(f"joint rpn {j} {i}", a, b) for j in range(2)
                 for i, (a, b) in enumerate(zip(jd[2][j], jh[2][j]))]
        props = card.get_proposals(*jd[2], (size, size))[0]
        ld = card.roi_logits_joint(card.roi_feats(jd[1], props), n_img,
                                   n_img)
        lh = host.roi_logits_joint(host.roi_feats(jh[1], props.cpu()), n_img,
                                   n_img)
        outs += [("joint rcnn logits", ld[0], lh[0]),
                 ("joint rcnn deltas", ld[1], lh[1])]
        for tag, a, b in outs:
            worst = max(worst, close(tag, a, b))
    rec["card_host_worst"] = worst
    log(f"[da fp32] {DA_CFG}, {n_img} x {size}^2 a modality, card against "
        f"host: {len(rec['card_host'])} outputs (features, necks, GFL and "
        f"RPN heads, R-CNN logits on the card's proposals; the three "
        f"simple_test and the joint forward), worst {worst:.2e} of scale "
        f"(tol 1e-3); {time.perf_counter() - t0:.1f} s")
    del card, host, imgs, fd, fh, jd, jh, props, ld, lh

    t0 = time.perf_counter()
    card = build_detector(mc, device=dev, compute_dtype="float32", seed=0,
                          trainable=True)
    host = copy.deepcopy(card).to(cpu)
    tbatch = make_train_batch(np.random.RandomState(12), (n_img,) * 3, size,
                              TRAIN_GTS)
    real = tri_mod.rpn_get_proposals
    recorded, replayed = [], [0]

    def record(*a, **kw):
        out = real(*a, **kw)
        recorded.append(out)
        return out

    def replay(*a, **kw):
        replayed[0] += 1
        return tuple(t.cpu() for t in recorded[replayed[0] - 1])

    runs = {}
    for side, m, dv, patch in (("card", card, dev, record),
                               ("host", host, cpu, replay)):
        tri_mod.rpn_get_proposals = patch
        try:
            params = trainable_params(m)
            losses = m(batch_to(tbatch, dv),
                       gen=torch.Generator().manual_seed(5))
            grads = torch.autograd.grad(sum(losses.values()),
                                        list(params.values()))
        finally:
            tri_mod.rpn_get_proposals = real
        runs[side] = ({k: float(v.detach()) for k, v in losses.items()},
                      subtree_norms(torch, list(params), grads))
        del losses, grads
    (ld, nd), (lh, nh) = runs["card"], runs["host"]
    bad = [k for k in lh if not (np.isfinite(ld[k]) and abs(
        ld[k] - lh[k]) <= 1e-3 * abs(lh[k]) + 1e-7)]
    bad += [f"|grad {k}|" for k in nh if not (np.isfinite(nd[k]) and abs(
        nd[k] - nh[k]) <= 1e-2 * nh[k])]
    worst_l = max(abs(ld[k] - lh[k]) / max(abs(lh[k]), 1e-12) for k in lh)
    worst_g = max(abs(nd[k] - nh[k]) / max(nh[k], 1e-12) for k in nh)
    rec["train_card_host"] = dict(card_losses=ld, host_losses=lh,
                                  card_norms=nd, host_norms=nh,
                                  worst_loss_rel=worst_l,
                                  worst_grad_norm_rel=worst_g)
    log(f"[da fp32] train forward + backward, [{n_img}:{n_img}:{n_img}] x "
        f"{size}^2, card against host (the host's RoIs from the card's "
        f"proposals): {len(lh)} losses {sorted(lh)}, worst {worst_l:.2e} "
        f"relative (tol 1e-3); {len(nh)} subtree gradient norms, worst "
        f"{worst_g:.2e} (tol 1e-2); {time.perf_counter() - t0:.1f} s "
        f"{'ok' if not bad else 'FAIL ' + str(bad)}")
    if "gate_loss" in lh:
        bad.append("a gate loss without MoE blocks")
    failures += [f"DA train card/host {k}" for k in bad]
    del card, host, recorded
    torch.cuda.empty_cache()

    # (b) the joint forward, full width, bf16
    t0 = time.perf_counter()
    model = build_detector(mc, device=dev, compute_dtype="bfloat16", seed=0)
    n_sar, n_rgb, n_ifr = JOINT
    sar_i, rgb_i, ifr_i = (torch.rand(n, IMG, IMG, 3, generator=gen,
                                      device=dev) for n in JOINT)
    with torch.no_grad():
        model.sar_bbox_head.gfl_cls.bias.fill_(0.0)
        _, x, rpn = model.head_joint(sar_i, rgb_i, ifr_i)
        props, _, _ = model.get_proposals(*rpn)
        rf = model.roi_feats(x, props)
        spread_class_scores(model.rgb_roi_head, rf[:n_rgb * N_PROPOSALS])
        spread_class_scores(model.ifr_roi_head, rf[n_rgb * N_PROPOSALS:])
    del x, rpn, props, rf

    def joint():
        return model.simple_test_joint(sar_i, rgb_i, ifr_i)

    for _ in range(2):
        joint()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    sar_o, rgb_o, ifr_o = joint()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    off = {k: (v, DA_JOINT_LAUNCHES[k]) for k, v in launches.items()
           if v != DA_JOINT_LAUNCHES[k]}
    if off:
        failures.append(f"DA joint launches (got, expected): {off}")
    valid = [int(o[2].sum()) for o in (sar_o, rgb_o, ifr_o)]
    if not all(v > 0 for v in valid) or not all(
            bool(torch.isfinite(o[0]).all()) for o in (sar_o, rgb_o, ifr_o)):
        failures.append(f"DA joint outputs: valid {valid}")
    sites = host_syncs(torch, joint)
    busy = device_ms(torch, joint, iters=3, warmup=0)
    walls, q1, med, q3 = timed_forwards(torch, joint)
    n_syncs = sum(sites.values())
    if n_syncs:
        failures.append(f"DA joint host syncs {sites}")
    n_joint = sum(JOINT)
    rec["joint"] = dict(
        images_per_s=n_joint / med,
        images_per_s_quartiles=[n_joint / q3, n_joint / q1],
        ms=med * 1e3, ms_quartiles=[q1 * 1e3, q3 * 1e3],
        device_busy_ms=busy, peak_gib=peak, host_syncs=n_syncs,
        launches={k: v for k, v in launches.items() if v}, valid=valid)
    log(f"[da joint] {DA_CFG} [{n_sar}:{n_rgb}:{n_ifr}] x {IMG}^2 bf16: "
        f"median {med * 1e3:.2f} ms (quartiles {q1 * 1e3:.2f} / "
        f"{q3 * 1e3:.2f}), {n_joint / med:.2f} images/s (host clock); "
        f"device busy {ms_str(busy)} a forward (torch.profiler); peak "
        f"{peak:.2f} GiB; host syncs {n_syncs} {sites}; valid {valid}; "
        f"card {smi}")
    log(f"[da joint]   launches in one forward: {rec['joint']['launches']} "
        f"(expected {DA_JOINT_LAUNCHES}) {'ok' if not off else 'FAIL'}")
    log(f"[da joint]   forward wall times (ms): "
        f"{' '.join(f'{w * 1e3:.2f}' for w in walls)}")
    del sar_o, rgb_o, ifr_o

    # the FFN kernel of the DA blocks alone, against its plain version and
    # the library's matrix products, at the 8-image shapes
    rec["convnext_ffn"] = []
    for hw, c, n_blocks in DA_FFN_SHAPES:
        xt = torch.randn(N_IMGS * hw * hw, c, generator=gen,
                         device=dev).to(torch.bfloat16)
        w1 = (torch.randn(c, 4 * c, generator=gen, device=dev)
              * c ** -0.5).to(torch.bfloat16)
        w2 = (torch.randn(4 * c, c, generator=gen, device=dev)
              * (4 * c) ** -0.5).to(torch.bfloat16)
        b1 = (torch.randn(4 * c, generator=gen, device=dev) * 0.1) \
            .to(torch.bfloat16)
        b2 = (torch.randn(c, generator=gen, device=dev) * 0.1) \
            .to(torch.bfloat16)
        with torch.no_grad():
            got = cbk.convnext_ffn(xt, w1, b1, w2, b2)
            ref = ffn_ref(xt, w1, b1, w2, b2)
        err, scale = max_err(got, ref)
        ok = err <= 2.0 ** -6 * max(scale, 1.0)
        ms = cuda_ms(torch, lambda: cbk.convnext_ffn(xt, w1, b1, w2, b2))
        plain = cuda_ms(torch, lambda: ffn_ref(xt, w1, b1, w2, b2))
        lib = cuda_ms(torch, lambda: torch.nn.functional.linear(
            gelu(torch.nn.functional.linear(xt, w1.t(), b1)), w2.t(), b2))
        m_tok = xt.shape[0]
        b_ms, kind = bound_ms(
            2 * (2 * m_tok * c + 2 * c * 4 * c + 5 * c),
            [(4 * m_tok * c * 4 * c, "bfloat16")])
        rec["convnext_ffn"].append(dict(
            shape=[m_tok, c], blocks=n_blocks, ms=ms, plain_ms=plain,
            library_ms=lib, bound_ms=b_ms, bound_by=kind, max_abs_err=err,
            scale=scale))
        log(f"[da ffn] convnext_ffn ({m_tok}, {c}) bf16, hidden {4 * c}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library (F.linear + "
            f"gelu + F.linear) {lib:.4f} ms, bound {b_ms:.4f} ms ({kind}); "
            f"max abs err {err:.3e} of {scale:.3e} "
            f"{'ok' if ok else 'FAIL'}; card {smi}")
        if not ok:
            failures.append(f"convnext_ffn C={c}: {err} of {scale}")
    log(f"[da] (a) + (b) {time.perf_counter() - t0:.1f} s")

    # (d) the eval entry point on the model of (b)
    t0 = time.perf_counter()
    rec["eval"] = {}
    for sub in ("rgb", "sar"):
        build.reset_launches()
        out = test_cli.main([DA_CFG, "--subdataset", sub,
                             "--synthetic-data", "--num-images", "16",
                             "--batch-size", "8", "--cfg-options",
                             "evaluation.metric=mAP"], model=model)
        n_det = sum(len(d) for img in out["det_results"] for d in img)
        m_ap = out["metrics"]["mAP"]
        ffn = build.LAUNCHES["convnext_ffn"]
        rec["eval"][sub] = dict(mAP=m_ap, detections=n_det,
                                images_per_s=out["img_per_s"],
                                convnext_ffn_launches=ffn)
        log(f"[da eval] tools.test {DA_CFG} --subdataset {sub} "
            f"--synthetic-data, 16 images: mAP {m_ap:.4f}, {n_det} "
            f"detections, {out['img_per_s']:.2f} images/s; launches "
            f"{ {k: v for k, v in build.LAUNCHES.items() if v} }")
        # 7 DA blocks a forward: the tool's warm-up batch and 2 of 8
        if not (0.0 <= m_ap <= 1.0) or n_det == 0 or ffn != 7 * 3:
            failures.append(f"DA eval {sub}: mAP {m_ap}, {n_det} dets, "
                            f"convnext_ffn {ffn} (7 a forward, 3 "
                            f"forwards)")
    del model, out
    torch.cuda.empty_cache()
    log(f"[da eval] (d) {time.perf_counter() - t0:.1f} s")

    # (c) the train entry point
    t0 = time.perf_counter()
    shutil.rmtree(DA_WORK, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    out, parts, sites = syncs_by_part(torch, lambda: train_cli.main(
        [DA_CFG, "--synthetic-data", "--work-dir", DA_WORK, "--max-iters",
         str(DA_TRAIN_ITERS), "--cfg-options", "evaluation=None",
         "model.compute_dtype=bfloat16", "lr_config.warmup_iters=2",
         "log_interval=2"]))
    st = out["stats"]
    done = st["iters"]
    steps = np.diff(st["iter_end_s"][2:]) * 1e3
    n_img = sum(Config.fromfile(DA_CFG).source_ratio)
    q = statistics.quantiles(steps, n=4)
    launched = {k: v / max(done, 1) for k, v in build.LAUNCHES.items() if v}
    mults = dict(out["state"].opt.mults)
    rec["train"] = dict(
        iterations=done, median_iteration_ms=q[1],
        iteration_ms_quartiles=[q[0], q[2]], images_per_s=n_img / q[1] * 1e3,
        images_per_s_quartiles=[n_img / q[2] * 1e3, n_img / q[0] * 1e3],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, syncs=parts,
        syncs_per_step=parts["step"] / max(done, 1), step_sync_sites=sites,
        launches_per_step=launched, mults=mults,
        last_log=st["log_lines"][-1] if st["log_lines"] else None)
    log(f"[da train] tools.train {DA_CFG} --synthetic-data, bf16 "
        f"[2:1:1] x {IMG}^2: {done} iterations; median iteration "
        f"{q[1]:.1f} ms (quartiles {q[0]:.1f} / {q[2]:.1f}), "
        f"{rec['train']['images_per_s']:.2f} images/s (host clock); peak "
        f"{rec['train']['peak_gib']:.2f} GiB; syncs by part {parts} "
        f"({rec['train']['syncs_per_step']:.1f} a step) {sites}; card {smi}")
    log(f"[da train]   launches a step: {launched}")
    log(f"[da train]   DLA multipliers at the end: {mults}")
    log(f"[da train]   last log line: {rec['train']['last_log']}")
    if done != DA_TRAIN_ITERS or not st["log_lines"] or not all(
            np.isfinite(v) for x in st["log_lines"] for v in x.values()):
        failures.append("DA train: iterations or a logged value")
    if any("gate_loss" in x for x in st["log_lines"]):
        failures.append("DA train logged a gate loss")
    if not mults or all(abs(m - 1.0) < 1e-6 for m in mults.values()):
        failures.append(f"DA train: DLA multipliers {mults}")
    for k in DA_TRAIN_KERNELS:
        if launched.get(k, 0) <= 0:
            failures.append(f"DA train launches {k}=0")
    shutil.rmtree(DA_WORK, ignore_errors=True)
    del out
    torch.cuda.empty_cache()
    log(f"[da train] (c) {time.perf_counter() - t0:.1f} s")

    # (e) the linear gate, soft_nms and the GRN block
    t0 = time.perf_counter()
    cfg = copy.deepcopy(DEFAULT_MODEL_CFG)
    cfg["backbone"]["gate"] = "linear"
    cfg["compute_dtype"] = "bfloat16"
    model = TriSourceDetector(cfg, device=dev, seed=0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("ffn.w_gate"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev)
                        * 0.05)

    def lin():
        return model.simple_test_joint(sar_i, rgb_i, ifr_i)
    lin()
    torch.cuda.synchronize()
    build.reset_launches()
    outs = lin()
    torch.cuda.synchronize()
    lin_launches = {k: v for k, v in build.LAUNCHES.items() if v}
    _, q1, med, q3 = timed_forwards(torch, lin, n=5)
    ok = lin_launches.get("moe_ffn_grouped") == 7 and all(
        bool(torch.isfinite(o[0]).all()) for o in outs)
    rec["linear_gate_joint"] = dict(
        launches=lin_launches, ms=med * 1e3, ms_quartiles=[q1 * 1e3,
                                                           q3 * 1e3],
        images_per_s=n_joint / med)
    log(f"[da linear gate] the flagship with gate='linear' (w_gate ~ "
        f"N(0, 0.05)), joint [{n_sar}:{n_rgb}:{n_ifr}] x {IMG}^2 bf16: "
        f"median {med * 1e3:.2f} ms (quartiles {q1 * 1e3:.2f} / "
        f"{q3 * 1e3:.2f}), {n_joint / med:.2f} images/s; launches "
        f"{lin_launches} {'ok' if ok else 'FAIL'}; card {smi}")
    if not ok:
        failures.append(f"linear gate joint: launches {lin_launches}")
    del model, outs, sar_i, rgb_i, ifr_i
    torch.cuda.empty_cache()

    n_box = N_PROPOSALS
    xy = torch.rand(n_box, 2, generator=gen, device=dev) * 700
    boxes = torch.cat([xy, xy + 10 + torch.rand(
        n_box, 2, generator=gen, device=dev) * 90], -1)
    scores = torch.rand(n_box, generator=gen, device=dev)
    rec["soft_nms"] = {}
    for method in ("linear", "gaussian", "naive"):
        ref = nms_mod.soft_nms(boxes.cpu(), scores.cpu(), 0.3, 100,
                               method=method)
        build.reset_launches()
        got = nms_mod.soft_nms(boxes, scores, 0.3, 100, method=method)
        torch.cuda.synchronize()
        n_iou = build.LAUNCHES["hbb_iou"]
        same = torch.equal(got[1].cpu(), ref[1]) and torch.equal(
            got[2].cpu(), ref[2])
        err = float((got[0].cpu() - ref[0]).abs().max())
        ms = cuda_ms(torch, lambda: nms_mod.soft_nms(boxes, scores, 0.3, 100,
                                                     method=method), iters=3)
        iou_ms = cuda_ms(torch, lambda: hbb_iou(boxes, boxes))
        rec["soft_nms"][method] = dict(selections_equal=same, dets_err=err,
                                       ms=ms, hbb_iou_launches=n_iou,
                                       iou_matrix_ms=iou_ms)
        log(f"[da soft_nms] {method}, {n_box} boxes, 100 selections: card "
            f"against host selections equal {same}, dets max abs err "
            f"{err:.2e}; {ms:.3f} ms on the card (of it the IoU matrix, row "
            f"4's matrix mode, {iou_ms:.4f} ms, {n_iou} launch); card {smi}")
        if not (same and n_iou == 1 and err <= 1e-5):
            failures.append(f"soft_nms {method}")

    g = torch.Generator().manual_seed(13)
    blk = ConvNeXtBlock(384, use_grn=True, gen=g)
    with torch.no_grad():
        blk.grn.gamma.uniform_(0.3, 0.8, generator=g)
        blk.grn.beta.uniform_(-0.1, 0.1, generator=g)
    blk = blk.eval().requires_grad_(False).to(dev, torch.bfloat16)
    xb = torch.randn(N_IMGS, 50, 50, 384, generator=gen,
                     device=dev).to(torch.bfloat16)
    with torch.no_grad():
        build.reset_launches()
        got = blk(xb)
        torch.cuda.synchronize()
        n_dw = build.LAUNCHES["dwconv_ln"]
        dw, ln = blk.dwconv, blk.norm
        ref = xb + blk._mlp(cbk.dwconv_ln_ref(xb, dw.weight, dw.bias,
                                              ln.weight, ln.bias))
    err, scale = max_err(got, ref)
    ok = n_dw == 1 and err <= 2.0 ** -6 * max(scale, 1.0)
    rec["grn_block"] = dict(shape=list(xb.shape), max_abs_err=err,
                            scale=scale, dwconv_ln_launches=n_dw)
    log(f"[da grn] GRN block {tuple(xb.shape)} bf16 on the card (row 2, "
        f"then matrix products and GRN) against its plain path: max abs "
        f"err {err:.3e} of {scale:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"GRN block: {err} of {scale}, {n_dw} launches")
    log(f"[da] (e) {time.perf_counter() - t0:.1f} s")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[da] phase 11 wall time {rec['phase_s']:.1f} s (limit "
        f"{DA_PHASE_LIMIT_S} s)")
    if rec["phase_s"] > DA_PHASE_LIMIT_S:
        failures.append(f"phase 11 took {rec['phase_s']:.1f} s")
    return failures, rec, launches


BABELRS_CFG = "configs/BabelRS_configs/BabelRS_20kstep.py"
BABELRS_HOST = (2, 256)     # 12a: images a modality, size (the model's grid)
BABELRS_WORK = "work_dirs/chip_smoke_babelrs"   # gitignored; removed
BABELRS_TRAIN_ITERS = 6
# the BabelRS joint forward [8:4:4] x 800^2: the ViT and its adapter run no
# kernel of the port (SDPA, F.layer_norm, matrix products, the deformable
# gather), the heads the flagship's
BABELRS_JOINT_LAUNCHES = dict(DA_JOINT_LAUNCHES, fused_convnext_block=0,
                              dwconv_ln=0, convnext_ffn=0, fused_layernorm=0)
BABELRS_TRAIN_KERNELS = ("hbb_nms_mask", "nms_keep", "rotated_iou",
                         "roi_align_rotated", "roi_align_rotated_bwd")
BABELRS_PHASE_LIMIT_S = 180


def vit_part(name):
    """The part of the BabelRS detector a parameter belongs to: the ViT
    (blocks, patch embed, position embedding), the adapter (the deformable
    attention modules and the projections), the SPM, the neck, the
    heads."""
    top, _, rest = name.partition(".")
    if top != "backbone":
        return "neck" if top == "neck" else "heads"
    mod = rest.split(".")[0]
    if mod == "spm":
        return "spm"
    if mod.startswith(("block", "stem", "pos_embed")):
        return "vit"
    return "adapter"


def phase12(torch, dev, smi, build):
    """12. The BabelRS configuration (``configs/BabelRS_configs/
    BabelRS_20kstep.py``: the InternViT-300M ViT-Adapter, embed 1024, depth
    24, 16 heads, adapter 256, under the TriSource heads, 26 classes) on
    the card, the deformable offsets drawn away from their zero init:
    (a) fp32, TF32 off, 2 images a modality x 256^2 on a model built for
    that grid, card against host: the backbone's 4 levels, both necks, the
    GFL and RPN outputs and the R-CNN logits on the card's proposals within
    1e-3 of scale; one train forward's losses within 1e-3 relative and the
    gradient norms of the ViT, the adapter, the SPM, the neck and the heads
    within 1e-2 (the host's proposals the card's); (b) the joint [8:4:4] x
    800^2 bf16 forward: launches exactly ``BABELRS_JOINT_LAUNCHES``, 0 host
    syncs, device busy time, images/s, peak memory, and the device time of
    the ViT's attention (SDPA alone and the branch), its MLPs, the
    adapter's deformable sampling (beside its bound), the SPM and the
    neck + heads; (d) ``tools.test`` rgb over 16 synthetic images on that
    model; (c) ``tools.train`` bf16 [1:1:1] x 800^2, ``BABELRS_TRAIN_ITERS``
    iterations with the config's layer decay (each parameter's scale read
    back from the optimizer: block i ``0.95^(23 - i)``, the stems
    ``0.95^24``, the heads 1), then 3 iterations with EMA, ``accumulate=2``
    and the cosine policy, a checkpoint mid-accumulation and a resume
    equal to it bit for bit. Returns (failures, record, the launches of
    (b)'s forward)."""
    import copy
    import math
    import shutil

    import numpy as np
    import torch.nn.functional as F

    from sm3det_tpu_torch.models.backbones.intern_vit import _grid
    from sm3det_tpu_torch.models.builder import build_detector
    from sm3det_tpu_torch.models.detectors import trisource as tri_mod
    from sm3det_tpu_torch.models.detectors.trisource import composition_ids
    from sm3det_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from sm3det_tpu_torch.tools import test as test_cli
    from sm3det_tpu_torch.tools import train as train_cli
    from sm3det_tpu_torch.train.train_state import (batch_to,
                                                    trainable_params)
    from sm3det_tpu_torch.utils.config import Config

    failures, rec = [], {"card_host": {}}
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False     # as main: fp32 is fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = Config.fromfile(BABELRS_CFG).model.to_dict()
    gen = torch.Generator(device="cuda").manual_seed(12)
    cpu = torch.device("cpu")

    def offsets_off_zero(model, std):
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("sampling_offsets.weight"):
                    p.copy_(torch.randn(p.shape, generator=gen,
                                        device=dev).to(p.dtype) * std)

    def close(tag, a, b, tol=1e-3):
        err, scale = max_err(a.cpu(), b)
        ok = bool(torch.isfinite(a.float()).all()) and a.shape == b.shape \
            and err <= tol * max(scale, 1.0)
        rec["card_host"][tag] = dict(err=err, scale=scale)
        if not ok:
            failures.append(f"BabelRS card/host {tag}")
            log(f"[babelrs fp32]   {tag} {tuple(a.shape)}: max abs err "
                f"{err:.3e} (max |ref| {scale:.3e}) FAIL")
        return err / max(scale, 1.0)

    # (a) card against host, fp32: one trainable model serves both checks
    t0 = time.perf_counter()
    n_img, size = BABELRS_HOST
    card = build_detector(mc, device=dev, compute_dtype="float32", seed=0,
                          trainable=True, img_size=size)
    offsets_off_zero(card, 0.02)
    host = copy.deepcopy(card).to(cpu)
    imgs = [torch.rand(n_img, size, size, 3, generator=gen, device=dev)
            for _ in range(3)]
    ids = composition_ids(n_img, n_img, n_img)
    worst = 0.0
    with torch.no_grad():
        outs = []
        sides = []
        for m, dv in ((card, dev), (host, cpu)):
            x = torch.cat([i.to(dv) for i in imgs])
            feats = m.backbone(x, ids)
            xs = m.neck_sar([f[:n_img] for f in feats])
            gfl = m.sar_bbox_head(xs)
            xr = m.neck_rcnn([f[n_img:] for f in feats])
            rpn = [m.rgb_rpn_head([f[:n_img] for f in xr]),
                   m.ifr_rpn_head([f[n_img:] for f in xr])]
            sides.append((feats, xs, gfl, xr, rpn))
        (fd, xsd, gd, xrd, rd), (fh, xsh, gh, xrh, rh) = sides
        outs += [(f"backbone level {i}", a, b) for i, (a, b) in
                 enumerate(zip(fd, fh))]
        outs += [(f"sar neck {i}", a, b) for i, (a, b) in
                 enumerate(zip(xsd, xsh))]
        outs += [(f"rcnn neck {i}", a, b) for i, (a, b) in
                 enumerate(zip(xrd, xrh))]
        outs += [(f"gfl {j} {i}", a, b) for j in range(2)
                 for i, (a, b) in enumerate(zip(gd[j], gh[j]))]
        for k, name in enumerate(("rgb", "ifr")):
            outs += [(f"{name} rpn {j} {i}", a, b) for j in range(2)
                     for i, (a, b) in enumerate(zip(rd[k][j], rh[k][j]))]
        rpn_cls = [torch.cat([a, b], 0) for a, b in zip(rd[0][0],
                                                        rd[1][0])]
        rpn_reg = [torch.cat([a, b], 0) for a, b in zip(rd[0][1],
                                                        rd[1][1])]
        props = card.get_proposals(rpn_cls, rpn_reg, (size, size))[0]
        ld = card.roi_logits_joint(card.roi_feats(xrd, props), n_img, n_img)
        lh = host.roi_logits_joint(host.roi_feats(xrh, props.cpu()), n_img,
                                   n_img)
        outs += [("rcnn logits", ld[0], lh[0]),
                 ("rcnn deltas", ld[1], lh[1])]
        for tag, a, b in outs:
            worst = max(worst, close(tag, a, b))
    rec["card_host_worst"] = worst
    log(f"[babelrs fp32] {BABELRS_CFG} at full width (embed 1024, depth "
        f"24, adapter 256), {n_img} x {size}^2 a modality, card against "
        f"host: {len(rec['card_host'])} outputs (the backbone's 4 levels, "
        f"both necks, GFL and RPN heads, R-CNN logits on the card's "
        f"proposals), worst {worst:.2e} of scale (tol 1e-3); "
        f"{time.perf_counter() - t0:.1f} s")
    del sides, outs, fd, fh, xsd, xsh, xrd, xrh, gd, gh, rd, rh, ld, lh

    t0 = time.perf_counter()
    tbatch = make_train_batch(np.random.RandomState(12), (n_img,) * 3, size,
                              TRAIN_GTS)
    real = tri_mod.rpn_get_proposals
    recorded, replayed = [], [0]

    def record(*a, **kw):
        out = real(*a, **kw)
        recorded.append(out)
        return out

    def replay(*a, **kw):
        replayed[0] += 1
        return tuple(t.cpu() for t in recorded[replayed[0] - 1])

    runs = {}
    for side, m, dv, patch in (("card", card, dev, record),
                               ("host", host, cpu, replay)):
        tri_mod.rpn_get_proposals = patch
        try:
            params = trainable_params(m)
            losses = m(batch_to(tbatch, dv),
                       gen=torch.Generator().manual_seed(5))
            grads = torch.autograd.grad(sum(losses.values()),
                                        list(params.values()),
                                        allow_unused=True)
        finally:
            tri_mod.rpn_get_proposals = real
        sq = {}
        for n, g in zip(params, grads):
            if g is not None:
                part = vit_part(n)
                sq[part] = sq.get(part, 0.0) + float(g.double().pow(2).sum())
        runs[side] = ({k: float(v.detach()) for k, v in losses.items()},
                      {k: v ** 0.5 for k, v in sq.items()})
        del losses, grads
    (ld, nd), (lh, nh) = runs["card"], runs["host"]
    bad = [k for k in lh if not (np.isfinite(ld[k]) and abs(
        ld[k] - lh[k]) <= 1e-3 * abs(lh[k]) + 1e-7)]
    bad += [f"|grad {k}|" for k in nh if not (np.isfinite(nd[k]) and abs(
        nd[k] - nh[k]) <= 1e-2 * nh[k])]
    if set(nh) != {"vit", "adapter", "spm", "neck", "heads"} or \
            "gate_loss" in lh:
        bad.append(f"parts {sorted(nh)}, losses {sorted(lh)}")
    worst_l = max(abs(ld[k] - lh[k]) / max(abs(lh[k]), 1e-12) for k in lh)
    worst_g = max(abs(nd[k] - nh[k]) / max(nh[k], 1e-12) for k in nh)
    rec["train_card_host"] = dict(card_losses=ld, host_losses=lh,
                                  card_norms=nd, host_norms=nh,
                                  worst_loss_rel=worst_l,
                                  worst_grad_norm_rel=worst_g)
    log(f"[babelrs fp32] train forward + backward, [{n_img}:{n_img}:"
        f"{n_img}] x {size}^2, card against host (the host's RoIs from the "
        f"card's proposals): {len(lh)} losses, worst {worst_l:.2e} "
        f"relative (tol 1e-3); gradient norms of {sorted(nh)}, worst "
        f"{worst_g:.2e} (tol 1e-2); {time.perf_counter() - t0:.1f} s "
        f"{'ok' if not bad else 'FAIL ' + str(bad)}")
    log(f"[babelrs fp32]   gradient norms card {nd} host {nh}")
    failures += [f"BabelRS train card/host {k}" for k in bad]
    del card, host, recorded, imgs
    torch.cuda.empty_cache()

    # (b) the joint forward, full width, bf16
    t0 = time.perf_counter()
    model = build_detector(mc, device=dev, compute_dtype="bfloat16", seed=0,
                           img_size=IMG)
    offsets_off_zero(model, 0.02)
    n_sar, n_rgb, n_ifr = JOINT
    sar_i, rgb_i, ifr_i = (torch.rand(n, IMG, IMG, 3, generator=gen,
                                      device=dev) for n in JOINT)
    with torch.no_grad():
        model.sar_bbox_head.gfl_cls.bias.fill_(0.0)
        _, x, rpn = model.head_joint(sar_i, rgb_i, ifr_i)
        props, _, _ = model.get_proposals(*rpn)
        rf = model.roi_feats(x, props)
        spread_class_scores(model.rgb_roi_head, rf[:n_rgb * N_PROPOSALS])
        spread_class_scores(model.ifr_roi_head, rf[n_rgb * N_PROPOSALS:])
    del x, rpn, props, rf

    def joint():
        return model.simple_test_joint(sar_i, rgb_i, ifr_i)

    for _ in range(2):
        joint()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    sar_o, rgb_o, ifr_o = joint()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    off = {k: (v, BABELRS_JOINT_LAUNCHES[k]) for k, v in launches.items()
           if v != BABELRS_JOINT_LAUNCHES[k]}
    if off:
        failures.append(f"BabelRS joint launches (got, expected): {off}")
    valid = [int(o[2].sum()) for o in (sar_o, rgb_o, ifr_o)]
    if not all(v > 0 for v in valid) or not all(
            bool(torch.isfinite(o[0]).all()) for o in (sar_o, rgb_o, ifr_o)):
        failures.append(f"BabelRS joint outputs: valid {valid}")
    sites = host_syncs(torch, joint)
    busy = device_ms(torch, joint, iters=3, warmup=0)
    walls, q1, med, q3 = timed_forwards(torch, joint)
    n_syncs = sum(sites.values())
    if n_syncs:
        failures.append(f"BabelRS joint host syncs {sites}")
    n_joint = sum(JOINT)
    rec["joint"] = dict(
        images_per_s=n_joint / med,
        images_per_s_quartiles=[n_joint / q3, n_joint / q1],
        ms=med * 1e3, ms_quartiles=[q1 * 1e3, q3 * 1e3],
        device_busy_ms=busy, peak_gib=peak, host_syncs=n_syncs,
        launches={k: v for k, v in launches.items() if v}, valid=valid)
    log(f"[babelrs joint] {BABELRS_CFG} [{n_sar}:{n_rgb}:{n_ifr}] x "
        f"{IMG}^2 bf16: median {med * 1e3:.2f} ms (quartiles "
        f"{q1 * 1e3:.2f} / {q3 * 1e3:.2f}), {n_joint / med:.2f} images/s "
        f"(host clock); device busy {ms_str(busy)} a forward "
        f"(torch.profiler); peak {peak:.2f} GiB; host syncs {n_syncs} "
        f"{sites}; valid {valid}; card {smi}")
    log(f"[babelrs joint]   launches in one forward: "
        f"{rec['joint']['launches']} (expected "
        f"{ {k: v for k, v in BABELRS_JOINT_LAUNCHES.items() if v} }) "
        f"{'ok' if not off else 'FAIL'}")
    log(f"[babelrs joint]   forward wall times (ms): "
        f"{' '.join(f'{w * 1e3:.2f}' for w in walls)}")
    del sar_o, rgb_o, ifr_o

    # the parts of the forward alone, at its shapes (16 images): the
    # CUDA-event time of one call (these are device-bound calls of
    # milliseconds), times the calls a forward; beside it the summed kernel
    # durations under torch.profiler, which can miss events
    bb = model.backbone
    depth, n_inter = bb.depth, len(bb.interaction_indexes)
    parts = {}

    def timed(fn, iters=5, **extra):
        return dict(ms_a_call=cuda_ms(torch, fn, iters=iters),
                    device_ms_a_call=device_ms(torch, fn, iters=iters),
                    **extra)
    with torch.no_grad():
        xi = torch.cat([sar_i, rgb_i, ifr_i]).to(torch.bfloat16)
        tokens, h, w = bb.stem_tokens(xi)
        blk = bb.block0
        nh, hd = blk.num_heads, blk.dim // blk.num_heads
        qkv = blk.qkv(blk.norm1(tokens)).reshape(n_joint, h * w, 3, nh, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        n_tok = h * w
        flops = 4.0 * n_joint * nh * n_tok * n_tok * hd
        b_ms, kind = bound_ms(4 * q.numel() * q.element_size(),
                              [(flops, "bfloat16")])
        parts["vit_sdpa"] = timed(
            lambda: F.scaled_dot_product_attention(q, k, v), calls=depth,
            bound_ms_a_call=b_ms, bound_by=kind)
        parts["vit_attention_branch"] = timed(
            lambda: blk.attention(tokens, (h, w)), calls=depth)
        mlp_flops = 2.0 * n_joint * n_tok * 8 * blk.dim * blk.dim
        b_ms, kind = bound_ms(0, [(mlp_flops, "bfloat16")])
        parts["vit_mlp"] = timed(lambda: blk.mlp(tokens), calls=depth,
                                 bound_ms_a_call=b_ms, bound_by=kind)
        parts["spm"] = timed(lambda: bb.spm(xi), calls=1)
        c1, c2, c3, c4 = bb.spm(xi)
        shapes = [tuple(c.shape[1:3]) for c in (c2, c3, c4)]
        spatial = torch.cat([c.reshape(n_joint, -1, bb.adapter_dim)
                             for c in (c2, c3, c4)], dim=1)
        vit_ref = _grid(h, w, dev)[None].expand(n_joint, -1, -1)
        spa_ref = torch.cat([_grid(hh, ww, dev) for hh, ww in shapes],
                            0)[None].expand(n_joint, -1, -1)
        q_tok = bb.vit_proj(tokens)
        for name, mod, args in (
                ("extract", bb.extract0, (spatial, spa_ref, q_tok,
                                          [(h, w)])),
                ("inject", bb.inject0, (q_tok, vit_ref, spatial, shapes))):
            vs, loc, att = mod.sampling(*args)
            lv = args[3]
            n_out = loc.shape[0] * loc.shape[1] * mod.dim
            nbytes = (vs.numel() * vs.element_size()
                      + loc.numel() * loc.element_size()
                      + att.numel() * att.element_size()
                      + n_out * vs.element_size())
            # a point: 4 taps of hd multiply-adds, the weight's
            # multiply-add, ~30 operations of coordinates
            n_pts = att.numel()
            b_ms, kind = bound_ms(nbytes, [(n_pts * (10 * (mod.dim //
                                                           mod.num_heads)
                                                     + 30), "float32")])
            parts[f"deform_{name}"] = timed(
                lambda: ms_deform_attn(vs, lv, loc, att), calls=n_inter,
                bound_ms_a_call=b_ms, bound_by=kind, queries=loc.shape[1],
                levels=lv, value_tokens=vs.shape[1])
        parts["backbone"] = timed(lambda: bb(xi), iters=3, calls=1)
        feats = bb(xi)

        def neck_heads():
            model.head_sar_from_feats([f[:n_sar] for f in feats])
            xr = model.neck_rcnn([f[n_sar:] for f in feats])
            model.rgb_rpn_head([f[:n_rgb] for f in xr])
            model.ifr_rpn_head([f[n_rgb:] for f in xr])
        parts["neck_heads"] = timed(neck_heads, calls=1)
    for name, p in parts.items():
        t = p["ms_a_call"]
        p["ms_a_forward"] = t * p["calls"]
        extra = "" if "bound_ms_a_call" not in p else (
            f", bound {p['bound_ms_a_call']:.4f} ms a call "
            f"({p['bound_by']})")
        log(f"[babelrs parts] {name}: {t:.4f} ms a call (CUDA events; "
            f"kernel durations under torch.profiler "
            f"{ms_str(p['device_ms_a_call'])}) x {p['calls']} = "
            f"{p['ms_a_forward']:.4f} ms a joint forward{extra}")
    rec["parts"] = parts
    del tokens, qkv, q, k, v, c1, c2, c3, c4, spatial, q_tok, feats, xi
    torch.cuda.empty_cache()
    log(f"[babelrs] (b) {time.perf_counter() - t0:.1f} s")

    # (d) the eval entry point on the model of (b)
    t0 = time.perf_counter()
    build.reset_launches()
    out = test_cli.main([BABELRS_CFG, "--subdataset", "rgb",
                         "--synthetic-data", "--num-images", "16",
                         "--batch-size", "8"], model=model)
    n_det = sum(len(d) for img in out["det_results"] for d in img)
    m_ap = out["metrics"]["mAP"]
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    rec["eval"] = dict(mAP=m_ap, detections=n_det,
                       images_per_s=out["img_per_s"], launches=launched)
    log(f"[babelrs eval] tools.test {BABELRS_CFG} --subdataset rgb "
        f"--synthetic-data, 16 images: mAP {m_ap:.4f}, {n_det} detections, "
        f"{out['img_per_s']:.2f} images/s; launches {launched}; card {smi}")
    if not (0.0 <= m_ap <= 1.0) or n_det == 0 or \
            launched.get("roi_align_rotated", 0) == 0 or any(
                launched.get(k, 0) for k in ("fused_convnext_block",
                                             "dwconv_ln", "convnext_ffn",
                                             "fused_layernorm")):
        failures.append(f"BabelRS eval: mAP {m_ap}, {n_det} dets, "
                        f"launches {launched}")
    del model, out, sar_i, rgb_i, ifr_i
    torch.cuda.empty_cache()
    log(f"[babelrs eval] (d) {time.perf_counter() - t0:.1f} s")

    # (c) the train entry point: layer decay, then EMA + accumulation
    t0 = time.perf_counter()
    shutil.rmtree(BABELRS_WORK, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    common = ["evaluation=None", "model.compute_dtype=bfloat16"]
    out, sync_parts, sites = syncs_by_part(torch, lambda: train_cli.main(
        [BABELRS_CFG, "--synthetic-data", "--work-dir",
         f"{BABELRS_WORK}/ld", "--max-iters", str(BABELRS_TRAIN_ITERS),
         "--cfg-options", *common, "lr_config.warmup_iters=2",
         "log_interval=2"]))
    st = out["stats"]
    done = st["iters"]
    steps = np.diff(st["iter_end_s"][2:]) * 1e3
    n_img = sum(Config.fromfile(BABELRS_CFG).source_ratio)
    q = statistics.quantiles(steps, n=4)
    launched = {k: v / max(done, 1) for k, v in build.LAUNCHES.items() if v}
    sc = out["lr_scales"]
    want = {f"backbone.block{i}.qkv.weight": 0.95 ** (23 - i)
            for i in range(24)}
    want.update({"backbone.spm.stem1.weight": 0.95 ** 24,
                 "backbone.spm.stem2.weight": 0.95 ** 24,
                 "backbone.stem_single.weight": 0.95 ** 24,
                 "backbone.pos_embed": 0.95 ** 24,
                 "backbone.spm.gn1.weight": 1.0,
                 "backbone.inject3.value_proj.weight": 1.0,
                 "sar_bbox_head.gfl_cls.weight": 1.0,
                 "rgb_roi_head.fc_cls.weight": 1.0})
    off_sc = {k: (sc.get(k), v) for k, v in want.items()
              if sc.get(k) is None or not math.isclose(sc[k], v,
                                                       rel_tol=1e-12)}
    rec["train"] = dict(
        iterations=done, median_iteration_ms=q[1],
        iteration_ms_quartiles=[q[0], q[2]], images_per_s=n_img / q[1] * 1e3,
        images_per_s_quartiles=[n_img / q[2] * 1e3, n_img / q[0] * 1e3],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        syncs=sync_parts, syncs_per_step=sync_parts["step"] / max(done, 1),
        step_sync_sites=sites, launches_per_step=launched,
        lr_scales_checked=len(want), lr_scales_off=off_sc,
        last_log=st["log_lines"][-1] if st["log_lines"] else None)
    log(f"[babelrs train] tools.train {BABELRS_CFG} --synthetic-data, bf16 "
        f"[1:1:1] x {IMG}^2, layer decay 0.95 over 24: {done} iterations; "
        f"median iteration {q[1]:.1f} ms (quartiles {q[0]:.1f} / "
        f"{q[2]:.1f}), {rec['train']['images_per_s']:.2f} images/s (host "
        f"clock); peak {rec['train']['peak_gib']:.2f} GiB; syncs by part "
        f"{sync_parts} ({rec['train']['syncs_per_step']:.1f} a step) "
        f"{sites}; card {smi}")
    log(f"[babelrs train]   launches a step: {launched}")
    log(f"[babelrs train]   layer-decay scales read back from the "
        f"optimizer: block i 0.95^(23-i) for i < 24, the stems 0.95^24, "
        f"the SPM's norms, the adapter and the heads 1: "
        f"{'ok' if not off_sc else 'FAIL ' + str(off_sc)}")
    log(f"[babelrs train]   last log line: {rec['train']['last_log']}")
    if done != BABELRS_TRAIN_ITERS or not st["log_lines"] or not all(
            np.isfinite(v) for x in st["log_lines"] for v in x.values()):
        failures.append("BabelRS train: iterations or a logged value")
    if off_sc:
        failures.append(f"BabelRS layer-decay scales {off_sc}")
    for k in BABELRS_TRAIN_KERNELS:
        if launched.get(k, 0) <= 0:
            failures.append(f"BabelRS train launches {k}=0")
    del out

    wd = f"{BABELRS_WORK}/ema"
    extra = ["ema_decay=0.9998", "optimizer.accumulate=2",
             "lr_config.policy=cosine", "checkpoint_interval=3",
             "log_interval=1"]
    out = train_cli.main([BABELRS_CFG, "--synthetic-data", "--work-dir", wd,
                          "--max-iters", "3", "--cfg-options", *common,
                          *extra])
    s1 = out["state"]
    ema_moved = any(bool((e - p).abs().max() > 0)
                    for e, p in zip(s1.ema, s1.params.values()))
    counts = (s1.opt.step, s1.opt.count, s1.opt.accum_count)
    del out, s1
    torch.cuda.empty_cache()
    ck = f"{wd}/iter_3.pth"
    again = train_cli.main([BABELRS_CFG, "--synthetic-data", "--work-dir",
                            wd, "--resume-from", ck, "--max-iters", "3",
                            "--cfg-options", *common, *extra])
    same = checkpoint_equal(torch, ck, again["state"])
    ok = same and ema_moved and counts == (3, 1, 1) and \
        again["start_iter"] == 3 and again["stats"]["iters"] == 0
    rec["ema_accumulate_resume"] = dict(
        step_count_accum=counts, ema_moved=ema_moved, resume_equal=same)
    log(f"[babelrs train] ema_decay=0.9998 optimizer.accumulate=2 "
        f"lr_config.policy=cosine: 3 iterations (step, Adam count, "
        f"accumulated {counts}), EMA moved {ema_moved}; resumed from "
        f"iter_3 (mid-accumulation): the loaded state, EMA and "
        f"accumulators included, equal to the file bit for bit {same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"BabelRS EMA / accumulation resume: {counts}, "
                        f"moved {ema_moved}, equal {same}")
    shutil.rmtree(BABELRS_WORK, ignore_errors=True)
    del again
    torch.cuda.empty_cache()
    log(f"[babelrs train] (c) {time.perf_counter() - t0:.1f} s")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[babelrs] phase 12 wall time {rec['phase_s']:.1f} s (limit "
        f"{BABELRS_PHASE_LIMIT_S} s)")
    if rec["phase_s"] > BABELRS_PHASE_LIMIT_S:
        failures.append(f"phase 12 took {rec['phase_s']:.1f} s")
    return failures, rec, launches


def main():
    t_main = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from sm3det_tpu_torch.ops.cuda import build
    except ImportError as exc:
        fail(f"the port is not importable ({exc}); run from the repo root")
    import torch.nn.functional as F

    import numpy as np

    from sm3det_tpu_torch.models.detectors import trisource as tri_mod
    from sm3det_tpu_torch.models.detectors.trisource import (
        DEFAULT_MODEL_CFG, TriSourceDetector)
    from sm3det_tpu_torch.train.dla import make_dla_config
    from sm3det_tpu_torch.train.optim import make_optimizer
    from sm3det_tpu_torch.train.train_state import (
        batch_to, build_train_step, init_train_state, trainable_params)
    from sm3det_tpu_torch.models.moe import MoELayer, group_aligned_dispatch
    from sm3det_tpu_torch.models.moe import stable_topk
    from sm3det_tpu_torch.ops.cuda import convnext_block_kernel as cbk
    from sm3det_tpu_torch.ops.cuda import hbb_iou_kernel as hik
    from sm3det_tpu_torch.ops.cuda import moe_groupgemm_kernel as mgk
    from sm3det_tpu_torch.ops.cuda import nms_keep_kernel as nkk
    from sm3det_tpu_torch.ops.cuda import roi_align_kernel as rak
    from sm3det_tpu_torch.ops.cuda import rotated_iou_kernel as rik
    from sm3det_tpu_torch.ops import nms as nms_mod
    from sm3det_tpu_torch.ops.roi_align_rotated import (
        roi_align_rotated_pyramid, route_levels, sample_taps)
    from sm3det_tpu_torch.ops.rotated_iou import obb_corners

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {kind}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    log(f"[build] nvcc, link and load {time.perf_counter() - t0:.1f} s")
    nvlog = build.BUILD_DIR / "nvcc.log"
    if nvlog.exists():
        for line in nvlog.read_text().splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                log("[build]   " + line.strip())

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale) \
            .to(dtype)

    recs = {
        "dwconv_ln": KernelRecord(
            "dwconv_ln", "sm3det_tpu_torch/ops/cuda/csrc/dwconv_ln.cu",
            "sm3det_tpu/ops/pallas/convnext_block_kernel.py:322",
            "F.conv2d(groups=C) + F.layer_norm",
            sources=["sm3det_tpu_torch/ops/cuda/csrc/dwconv_ln.cu",
                     "sm3det_tpu_torch/ops/cuda/csrc/dwconv_core.cuh"]),
        "fused_convnext_block": KernelRecord(
            "fused_convnext_block",
            "sm3det_tpu_torch/ops/cuda/csrc/ffn_wgmma.cu",
            "sm3det_tpu/ops/pallas/convnext_block_kernel.py:313",
            "F.conv2d(groups=C) + F.layer_norm + F.linear + F.gelu + "
            "F.linear + residual",
            sources=["sm3det_tpu_torch/ops/cuda/csrc/dwconv_ln.cu",
                     "sm3det_tpu_torch/ops/cuda/csrc/dwconv_core.cuh",
                     "sm3det_tpu_torch/ops/cuda/csrc/ffn_wgmma.cu",
                     "sm3det_tpu_torch/ops/cuda/csrc/wgmma_sm90.cuh"]),
        "moe_ffn_grouped": KernelRecord(
            "moe_ffn_grouped",
            "sm3det_tpu_torch/ops/cuda/csrc/ffn_wgmma.cu",
            "sm3det_tpu/ops/pallas/moe_groupgemm_kernel.py:42",
            "torch._grouped_mm + F.gelu + torch._grouped_mm"
            if hasattr(torch, "_grouped_mm") else None,
            sources=["sm3det_tpu_torch/ops/cuda/csrc/ffn_wgmma.cu",
                     "sm3det_tpu_torch/ops/cuda/csrc/wgmma_sm90.cuh"]),
        "hbb_iou": KernelRecord(
            "hbb_iou", "sm3det_tpu_torch/ops/cuda/csrc/hbb_iou.cu",
            "sm3det_tpu/ops/pallas/hbb_iou_kernel.py:29", None),
        "fused_layernorm": KernelRecord(
            "fused_layernorm", "sm3det_tpu_torch/ops/cuda/csrc/layernorm.cu",
            "sm3det_tpu/ops/pallas/convnext_block_kernel.py:66",
            "F.layer_norm"),
        "rotated_iou": KernelRecord(
            "rotated_iou", "sm3det_tpu_torch/ops/cuda/csrc/rotated_iou.cu",
            "sm3det_tpu/ops/pallas/rotated_iou_kernel.py:102", None),
        "rotated_iou_banded": KernelRecord(
            "rotated_iou_banded",
            "sm3det_tpu_torch/ops/cuda/csrc/rotated_iou.cu",
            "sm3det_tpu/ops/pallas/rotated_iou_kernel.py:118", None),
        "hbb_nms_mask": KernelRecord(
            "hbb_nms_mask", "sm3det_tpu_torch/ops/cuda/csrc/hbb_iou.cu",
            "sm3det_tpu/ops/pallas/hbb_iou_kernel.py:29", None),
        "rotated_nms_mask": KernelRecord(
            "rotated_nms_mask",
            "sm3det_tpu_torch/ops/cuda/csrc/rotated_iou.cu",
            "sm3det_tpu/ops/pallas/rotated_iou_kernel.py:102", None),
        "rotated_nms_mask_banded": KernelRecord(
            "rotated_nms_mask_banded",
            "sm3det_tpu_torch/ops/cuda/csrc/rotated_iou.cu",
            "sm3det_tpu/ops/pallas/rotated_iou_kernel.py:118", None),
        "nms_keep": KernelRecord(
            "nms_keep", "sm3det_tpu_torch/ops/cuda/csrc/nms_keep.cu",
            "sm3det_tpu/ops/nms.py:135 (jnp greedy_keep; no Pallas kernel)",
            None),
        "roi_align_rotated": KernelRecord(
            "roi_align_rotated",
            "sm3det_tpu_torch/ops/cuda/csrc/roi_align_rotated.cu",
            "sm3det_tpu/ops/pallas/roi_align_kernel.py:189", None),
        "roi_align_rotated_bwd": KernelRecord(
            "roi_align_rotated_bwd",
            "sm3det_tpu_torch/ops/cuda/csrc/roi_align_rotated_bwd.cu",
            "sm3det_tpu/ops/pallas/roi_align_kernel.py:562", None),
        "fused_dwconv_ln_train": KernelRecord(
            "fused_dwconv_ln_train",
            "sm3det_tpu_torch/ops/cuda/csrc/dwconv_ln.cu",
            "sm3det_tpu/ops/pallas/convnext_block_kernel.py:345",
            "F.conv2d(groups=C) + F.layer_norm, forward and backward",
            sources=["sm3det_tpu_torch/ops/cuda/csrc/dwconv_ln.cu",
                     "sm3det_tpu_torch/ops/cuda/csrc/dwconv_ln_bwd.cu",
                     "sm3det_tpu_torch/ops/cuda/csrc/dwconv_core.cuh",
                     "sm3det_tpu_torch/ops/cuda/convnext_block_kernel.py"]),
        # the dense block's FFN alone, for the Domain-Attention blocks (JAX
        # computes that FFN with XLA products, convnext.py:218-221, beside
        # its fused_dwconv_ln); timed in phase 11
        "convnext_ffn": KernelRecord(
            "convnext_ffn", "sm3det_tpu_torch/ops/cuda/csrc/ffn_wgmma.cu",
            "sm3det_tpu/ops/pallas/convnext_block_kernel.py:313 (its FFN "
            "half)", "F.linear + F.gelu + F.linear",
            sources=["sm3det_tpu_torch/ops/cuda/csrc/ffn_wgmma.cu",
                     "sm3det_tpu_torch/ops/cuda/csrc/wgmma_sm90.cuh",
                     "sm3det_tpu_torch/ops/cuda/csrc/grouped_ffn.cu"]),
    }
    failures = []

    def check(name, dtype, shape, got, ref, rel_tol, main_path=None):
        """main_path: whether the bf16 SAR forward runs this case (its error
        goes into the JSON record); default: the bf16 cases."""
        err, scale = max_err(got, ref)
        tol = rel_tol * max(scale, 1.0)
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol
        rel = err / max(scale, 1e-30)
        log(f"[kernel] {name:22s} {str(dtype)[6:]:9s} {shape}: max abs err "
            f"{err:.3e} (max |ref| {scale:.3e}, rel {rel:.2e}), tol "
            f"{tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {dtype} {shape}")
        if main_path or (main_path is None and dtype == torch.bfloat16):
            recs[name].err = max(recs[name].err, err)

    # tolerances: fp32 differ only by summation order (1e-4 of the output
    # scale); bf16 outputs may differ by a rounding step of bf16 (2^-8
    # relative) where fp32 sums land on either side, plus one rounding of
    # the bf16 hidden activation: 2^-6 of the output scale
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}

    def moe_library_ms(x_slots, tile_e, w1, b1, w2, b2):
        """The yardstick of row 3: ``torch._grouped_mm`` + GELU +
        ``torch._grouped_mm`` over the same slot layout (each expert's
        rows one group), where the card's torch has it; the port never
        calls it. None, with the reason in the record, where it has not or
        refuses these operands."""
        rec = recs["moe_ffn_grouped"]
        if rec.library is None:
            return None
        tile = x_slots.shape[0] // tile_e.shape[0]
        ends = torch.cumsum(torch.bincount(tile_e, minlength=w1.shape[0])
                            * tile, 0).to(torch.int32)
        slot_e = tile_e.repeat_interleave(tile)
        b1s, b2s = b1[slot_e], b2[slot_e]

        def chain():
            hdn = torch._grouped_mm(x_slots, w1, offs=ends) + b1s
            return torch._grouped_mm(F.gelu(hdn, approximate="tanh"), w2,
                                     offs=ends) + b2s
        try:
            chain()
        except (RuntimeError, TypeError) as exc:
            log(f"[time]   torch._grouped_mm refused the slot layout: {exc}")
            rec.library, rec.library_ms = f"none ({exc})"[:200], None
            return None
        return cuda_ms(torch, chain)

    if recs["moe_ffn_grouped"].library is None:
        log("[time]   this torch has no torch._grouped_mm: row 3 has no "
            "library yardstick")

    # ---- 3. kernels against their plain versions -------------------------
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        isz = torch.tensor([], dtype=dtype).element_size()
        for hw, c, n_dense, n_moe, n_ln in STAGES:
            shape = (N_IMGS, hw, hw, c)
            x = rnd(*shape, dtype=dtype)
            dwk = rnd(c, 1, 7, 7, scale=0.15).to(dtype)
            dwb, lnb = rnd(c, scale=0.1).to(dtype), rnd(c, scale=0.1).to(dtype)
            lns = (1 + rnd(c, scale=0.1)).to(dtype)
            got = cbk.fused_dwconv_ln(x, dwk, dwb, lns, lnb)
            ref = cbk.dwconv_ln_ref(x, dwk, dwb, lns, lnb)
            check("dwconv_ln", dtype, shape, got, ref, tol[dtype])
            n_pix = N_IMGS * hw * hw
            if dtype == torch.bfloat16:
                xl = x.permute(0, 3, 1, 2)

                def lib_dwln():
                    y = F.conv2d(xl, dwk, dwb, padding=3, groups=c)
                    return F.layer_norm(y.permute(0, 2, 3, 1), (c,), lns, lnb,
                                        1e-6)
                ms = cuda_ms(torch, lambda: cbk.fused_dwconv_ln(
                    x, dwk, dwb, lns, lnb))
                pms = cuda_ms(torch, lambda: cbk.dwconv_ln_ref(
                    x, dwk, dwb, lns, lnb))
                lms = cuda_ms(torch, lib_dwln)
                # 49 fp32 FMAs a value and ~8 flops of LN, off the tensor
                # cores
                b, k = bound_ms(2 * n_pix * c * isz + 52 * c * 4,
                                [(n_pix * c * (98 + 8), "float32")])
                recs["dwconv_ln"].add(n_dense + n_moe, ms, pms, b, k, lms)
                log(f"[time]   dwconv_ln {shape}: kernel {ms:.4f} ms, plain "
                    f"{pms:.4f} ms, library {lms:.4f} ms, bound {b:.4f} ms "
                    f"({k})")

            xo = x * 3 + 1            # LayerNorm input off zero mean
            got = cbk.fused_layernorm(xo, lns, lnb)
            ref = cbk.layernorm_math(xo, lns, lnb)
            check("fused_layernorm", dtype, shape, got, ref, tol[dtype])
            if dtype == torch.bfloat16:
                ms = cuda_ms(torch, lambda: cbk.fused_layernorm(xo, lns, lnb))
                pms = cuda_ms(torch, lambda: cbk.layernorm_math(xo, lns, lnb))
                lms = cuda_ms(torch, lambda: F.layer_norm(xo, (c,), lns, lnb,
                                                          1e-6))
                b, k = bound_ms(2 * n_pix * c * isz + 2 * c * isz,
                                [(n_pix * c * 8, "float32")])
                # device time alone: at the small stages the wrapper's host
                # time sets the CUDA-event time
                dev_ms = device_ms(torch, lambda: cbk.fused_layernorm(
                    xo, lns, lnb))
                dev_lms = device_ms(torch, lambda: F.layer_norm(
                    xo, (c,), lns, lnb, 1e-6))
                recs["fused_layernorm"].add(n_ln, ms, pms, b, k, lms)
                recs["fused_layernorm"].add_device(n_ln, dev_ms, dev_lms)
                log(f"[time]   fused_layernorm {shape}: kernel {ms:.4f} ms, "
                    f"plain {pms:.4f} ms, library {lms:.4f} ms, bound "
                    f"{b:.4f} ms ({k}); device time only: kernel "
                    f"{ms_str(dev_ms)}, library {ms_str(dev_lms)}")

            hid = 4 * c
            w1 = rnd(c, hid, scale=c ** -0.5).to(dtype)
            w2 = rnd(hid, c, scale=hid ** -0.5).to(dtype)
            b1, b2 = rnd(hid, scale=0.1).to(dtype), rnd(c, scale=0.1).to(dtype)
            gamma = (0.5 + torch.rand(c, generator=gen, device=dev)).to(dtype)
            args = (x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma)
            got = cbk.fused_convnext_block(*args)
            ref = cbk.convnext_block_ref(*args)
            check("fused_convnext_block", dtype, shape, got, ref, tol[dtype])
            if dtype == torch.bfloat16:
                xl = x.permute(0, 3, 1, 2)
                w1t, w2t = w1.t().contiguous(), w2.t().contiguous()

                def lib_block():
                    y = F.conv2d(xl, dwk, dwb, padding=3, groups=c)
                    y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), lns, lnb,
                                     1e-6)
                    y = F.linear(F.gelu(F.linear(y, w1t, b1),
                                        approximate="tanh"), w2t, b2)
                    return torch.addcmul(x, y, gamma)
                ms = cuda_ms(torch, lambda: cbk.fused_convnext_block(*args))
                pms = cuda_ms(torch, lambda: cbk.convnext_block_ref(*args))
                lms = cuda_ms(torch, lib_block)
                b, k = bound_ms(2 * n_pix * c * isz + 2 * c * hid * isz,
                                [(n_pix * c * 106, "float32"),
                                 (4 * n_pix * c * hid, dname)])
                recs["fused_convnext_block"].add(n_dense, ms, pms, b, k, lms)
                log(f"[time]   fused_convnext_block {shape}: kernel {ms:.4f} "
                    f"ms, plain {pms:.4f} ms, library {lms:.4f} ms, bound "
                    f"{b:.4f} ms ({k})")
                # the FFN half alone: the fused launch on dwconv_ln's output
                xn = cbk.fused_dwconv_ln(x, dwk, dwb, lns, lnb).reshape(-1, c)
                x2 = x.reshape(-1, c)
                w1e, w2e = w1[None], w2[None]

                def ffn_half():
                    return mgk.ffn_fused(xn, w1e, b1, w2e, b2, shortcut=x2,
                                         gamma=gamma)

                def ffn_half_plain():
                    hdn = mgk.ffn_ref(xn, w1, b1, w2, torch.zeros_like(b2))
                    return (x2.float() + gamma.float() * (
                        hdn.float() + b2.float())).to(dtype)

                def ffn_half_lib():
                    return torch.addcmul(x2, F.linear(F.gelu(
                        F.linear(xn, w1t, b1), approximate="tanh"), w2t, b2),
                        gamma)
                fms = cuda_ms(torch, ffn_half)
                flms = cuda_ms(torch, ffn_half_lib)
                fb, fk = bound_ms(3 * n_pix * c * isz + 2 * c * hid * isz,
                                  [(4 * n_pix * c * hid, dname)])
                recs["fused_convnext_block"].add_extra(
                    n_dense, ffn_ms=fms, ffn_library_ms=flms, ffn_bound_ms=fb)
                # ffn_ref rounds the FFN before the residual (one more
                # bf16 step than the kernel): within the 2^-6 tolerance
                check("fused_convnext_block", dtype, (shape, "ffn half"),
                      ffn_half(), ffn_half_plain(), tol[dtype])
                log(f"[time]   fused_convnext_block FFN half {shape}: kernel "
                    f"{fms:.4f} ms, library {flms:.4f} ms (F.linear + "
                    f"F.gelu + F.linear + torch.addcmul), bound {fb:.4f} ms "
                    f"({fk})")
                del xn, x2

            if not n_moe:
                continue
            cfg = DEFAULT_MODEL_CFG["backbone"]
            e, topk = cfg["num_experts"], cfg["top_k"]
            moe = MoELayer(c, hid, num_experts=e, top_k=topk,
                           gen=torch.Generator().manual_seed(c)) \
                .to(device=dev, dtype=dtype)
            tokens = rnd(n_pix, c, dtype=dtype)
            with torch.no_grad():
                _, top_idx = stable_topk(moe.w_gate(tokens), topk)
            src, tile_e, tile, _ = group_aligned_dispatch(top_idx, e, c)
            x_slots = tokens[src]
            ex = moe.experts
            margs = (x_slots, tile_e, ex.w1.detach(), ex.b1.detach(),
                     ex.w2.detach(), ex.b2.detach())
            got = mgk.moe_ffn_grouped(*margs)
            ref = mgk.moe_ffn_grouped_ref(*margs)
            sshape = (tuple(x_slots.shape), f"tile {tile}", f"E {e}")
            check("moe_ffn_grouped", dtype, sshape, got, ref, tol[dtype])
            if dtype == torch.bfloat16:
                s = x_slots.shape[0]
                ms = cuda_ms(torch, lambda: mgk.moe_ffn_grouped(*margs))
                pms = cuda_ms(torch, lambda: mgk.moe_ffn_grouped_ref(*margs))
                b, k = bound_ms(2 * s * c * isz + e * 2 * c * hid * isz,
                                [(4 * n_pix * topk * c * hid, dname)])
                lms = moe_library_ms(*margs)
                recs["moe_ffn_grouped"].add(n_moe, ms, pms, b, k, lms or 0.0)
                log(f"[time]   moe_ffn_grouped {sshape}: kernel {ms:.4f} ms, "
                    f"plain {pms:.4f} ms, library "
                    f"{'n/a' if lms is None else f'{lms:.4f} ms'} "
                    f"({recs['moe_ffn_grouped'].library}), bound {b:.4f} ms "
                    f"({k}); {s} slots for {n_pix * topk} routes")

    # row 9 at the LSKNet / VAN widths, 8 images of 800^2: held against its
    # plain version (and whether bit for bit), timed in bf16 against
    # F.layer_norm, weighted by a forward's LayerNorms at each stage
    ln_rec, lsk_cases = recs["fused_layernorm"], []
    for arch, (dims, depths) in LSK_ARCHS.items():
        sums = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                              "device_ms", "library_device_ms"), 0.0)
        for hw, c, depth in zip((200, 100, 50, 25), dims, depths):
            shape = (N_IMGS, hw, hw, c)
            n_ln = 2 + 2 * depth
            for dtype in (torch.float32, torch.bfloat16):
                isz = torch.tensor([], dtype=dtype).element_size()
                xo = (rnd(*shape) * 3 + 1).to(dtype)
                lns = (1 + rnd(c, scale=0.1)).to(dtype)
                lnb = rnd(c, scale=0.1).to(dtype)
                got = cbk.fused_layernorm(xo, lns, lnb)
                ref = cbk.layernorm_math(xo, lns, lnb)
                check("fused_layernorm", dtype, (f"lsk-{arch}",) + shape, got,
                      ref, tol[dtype], main_path=False)
                n_diff = int((got != ref).sum())
                err, _ = max_err(got, ref)
                lsk_cases.append(dict(arch=arch, shape=list(shape),
                                      dtype=str(dtype)[6:], max_abs_err=err,
                                      elements_differing=n_diff))
                log(f"[kernel]   fused_layernorm lsk-{arch} {shape} "
                    f"{str(dtype)[6:]}: {n_diff} of {got.numel()} elements "
                    f"differ from the plain version (bit-equal "
                    f"{n_diff == 0})")
                if dtype != torch.bfloat16:
                    continue
                n_pix = N_IMGS * hw * hw
                ms = cuda_ms(torch, lambda: cbk.fused_layernorm(xo, lns, lnb))
                pms = cuda_ms(torch, lambda: cbk.layernorm_math(xo, lns, lnb))
                lms = cuda_ms(torch, lambda: F.layer_norm(xo, (c,), lns, lnb,
                                                          1e-6))
                b, k = bound_ms(2 * n_pix * c * isz + 2 * c * isz,
                                [(n_pix * c * 8, "float32")])
                dev_ms = device_ms(torch, lambda: cbk.fused_layernorm(
                    xo, lns, lnb))
                dev_lms = device_ms(torch, lambda: F.layer_norm(
                    xo, (c,), lns, lnb, 1e-6))
                for key, v in (("ms", ms), ("plain_ms", pms),
                               ("library_ms", lms), ("bound_ms", b),
                               ("device_ms", dev_ms),
                               ("library_device_ms", dev_lms)):
                    sums[key] = None if v is None or sums[key] is None \
                        else sums[key] + n_ln * v
                log(f"[time]   fused_layernorm lsk-{arch} {shape}: kernel "
                    f"{ms:.4f} ms, plain {pms:.4f} ms, library {lms:.4f} ms, "
                    f"bound {b:.4f} ms ({k}); device time only: kernel "
                    f"{ms_str(dev_ms)}, library {ms_str(dev_lms)}; {n_ln} a "
                    f"forward")
            del xo, got, ref
        ln_rec.extra.update({f"lsk_{arch}_{k}": v for k, v in sums.items()})
        log(f"[time]   fused_layernorm, the LSKNet-{arch.upper()} forward's "
            f"LayerNorms over 8 images: " + ", ".join(
                f"{k} {ms_str(v)}" for k, v in sums.items()))
    ln_rec.extra["lsk_widths"] = lsk_cases

    nb = 2000
    xy = torch.rand(N_IMGS, nb, 2, generator=gen, device=dev) * 760
    wh = 4 + torch.rand(N_IMGS, nb, 2, generator=gen, device=dev) * 120
    boxes = torch.cat([xy, xy + wh], -1)
    for triu in (False, True):
        got = hik.hbb_iou(boxes, boxes, triu=triu)
        ref = hik.hbb_iou_ref(boxes, boxes, triu=triu)
        check("hbb_iou", torch.float32, (N_IMGS, nb, nb, f"triu={triu}"),
              got, ref, 1e-6, main_path=True)
    ms = cuda_ms(torch, lambda: hik.hbb_iou(boxes, boxes, triu=True))
    pms = cuda_ms(torch, lambda: hik.hbb_iou_ref(boxes, boxes, triu=True))
    b, k = bound_ms(N_IMGS * (2 * nb * 16 + nb * nb * 4),
                    [(N_IMGS * nb * nb * 12, "float32")])
    recs["hbb_iou"].add(1, ms, pms, b, k, 0.0)
    log(f"[time]   hbb_iou ({N_IMGS}, {nb}, {nb}) triu: kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms, bound {b:.4f} ms ({k})")
    # the RPN's proposal NMS of the joint forward: 8 images x 5 levels
    rb = (JOINT[1] + JOINT[2]) * 5
    xy = torch.rand(rb, nb, 2, generator=gen, device=dev) * 760
    wh = 4 + torch.rand(rb, nb, 2, generator=gen, device=dev) * 120
    rboxes = torch.cat([xy, xy + wh], -1)
    check("hbb_iou", torch.float32, (rb, nb, nb, "triu=True"),
          hik.hbb_iou(rboxes, rboxes, triu=True),
          hik.hbb_iou_ref(rboxes, rboxes, triu=True), 1e-6, main_path=True)
    ms = cuda_ms(torch, lambda: hik.hbb_iou(rboxes, rboxes, triu=True),
                 iters=5)
    pms = cuda_ms(torch, lambda: hik.hbb_iou_ref(rboxes, rboxes, triu=True),
                  iters=2, warmup=1)
    b, k = bound_ms(rb * (2 * nb * 16 + nb * nb * 4),
                    [(rb * nb * nb * 12, "float32")])
    recs["hbb_iou"].add(1, ms, pms, b, k, 0.0)
    log(f"[time]   hbb_iou ({rb}, {nb}, {nb}) triu: kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms, bound {b:.4f} ms ({k})")
    del rboxes

    # ---- rotated IoU: plain + triu, and group-banded + triu --------------
    def rotated_boxes(bsz, n):
        """Boxes that really overlap: clustered centres, mixed aspect
        ratios and angles, exact duplicates, a few of no size."""
        centres = torch.rand(bsz, 24, 2, generator=gen, device=dev) * 700 + 50
        pick = torch.randint(0, 24, (bsz, n), generator=gen, device=dev)
        ctr = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2)) \
            + torch.randn(bsz, n, 2, generator=gen, device=dev) * 25
        side = 8 * 2 ** (torch.rand(bsz, n, generator=gen, device=dev) * 4.5)
        asp = 2 ** ((torch.rand(bsz, n, generator=gen, device=dev) - .5) * 4)
        ang = (torch.rand(bsz, n, generator=gen, device=dev) - 0.5) * 3.14
        boxes = torch.stack([ctr[..., 0], ctr[..., 1], side * asp,
                             side / asp, ang], -1)
        boxes[:, 1::9] = boxes[:, 0::9][:, :boxes[:, 1::9].shape[1]]
        boxes[:, -5:] = 0.0
        return boxes

    def defined_pairs(boxes):
        """A box of no size against a real one is rounding noise over a
        union near 0 (finite; no caller reads it): left out."""
        real = (boxes[..., 2] * boxes[..., 3]) > 0
        return real[..., :, None] == real[..., None, :]

    iou_tol = 1e-5      # absolute, on an IoU in [0, 1]
    # the third case shifts each class by the multi-class NMS's offset
    # (coordinates to 1e5 px, where fp32 steps by 0.01 px): the kernel must
    # still equal the plain version, and cross-class pairs must be 0
    cases = (("rotated_iou", rotated_boxes(1, 2 * N_PROPOSALS)[0], None, 0),
             ("rotated_iou_banded", rotated_boxes(N_IMGS, N_PROPOSALS), 26,
              0),
             ("rotated_iou_banded", rotated_boxes(2, N_PROPOSALS), 26, 4000))
    for name, boxes, n_cls, class_offset in cases:
        n = boxes.shape[-2]
        groups = None
        mask = defined_pairs(boxes)
        if n_cls:
            groups = torch.sort(torch.randint(
                0, n_cls, boxes.shape[:-1], generator=gen, device=dev),
                dim=-1).values.int()
            boxes[..., :2] += (groups * class_offset)[..., None]
            cross = groups[..., :, None] != groups[..., None, :]
            groups[..., -n // 8:] = rik.INERT_GROUP
            mask &= (groups[..., :, None] == groups[..., None, :]) & \
                (groups[..., :, None] < rik.INERT_GROUP)
        kw = dict(triu=True, groups1=groups, groups2=groups)
        got = rik.rotated_iou(boxes, boxes, **kw)
        ref = rik.rotated_iou_ref(boxes, boxes, **kw)
        torch.cuda.synchronize()
        need = rik.tile_need(n, n, True, groups, groups, device=dev)
        skipped = ~need.repeat_interleave(rik.TILE, -2) \
            .repeat_interleave(rik.TILE, -1)[..., :n, :n]
        diff = (got - ref).abs() * mask
        err = diff.max().item()
        exact = int((diff == 0).sum()) == diff.numel()
        zeros_ok = float((got.abs() * skipped).max()) == 0.0
        if class_offset:
            zeros_ok = zeros_ok and float((got.abs() * cross).max()) == 0.0
        ok = bool(torch.isfinite(got).all()) and err <= iou_tol and zeros_ok
        pairs = int(need.sum()) * rik.TILE ** 2
        log(f"[kernel] {name:22s} float32   {tuple(boxes.shape)} triu"
            f"{', class offset ' + str(class_offset) if class_offset else ''}"
            f": max "
            f"abs err {err:.3e} on {int(mask.sum())} defined pairs (bit-"
            f"equal: {exact}), {int((ref * mask > 0.1).sum())} pairs over "
            f"IoU 0.1, skipped tiles exactly zero: {zeros_ok}, computed "
            f"pairs {pairs} of {got.numel()}; tol {iou_tol} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        recs[name].err = max(recs[name].err, err)
        del ref, diff, skipped, mask
        # the plain triu matrix at 4000 boxes runs on no path any more (the
        # aug_test merge takes the mask mode): a check only
        if class_offset or name == "rotated_iou":
            continue
        ms = cuda_ms(torch, lambda: rik.rotated_iou(boxes, boxes, **kw),
                     iters=5)
        pms = cuda_ms(torch, lambda: rik.rotated_iou_ref(boxes, boxes, **kw),
                      iters=2, warmup=1)
        b, k = bound_ms(2 * boxes.numel() * 4 + got.numel() * 4,
                        [(pairs * ROT_IOU_FLOPS, "float32")])
        recs[name].add(1, ms, pms, b, k, 0.0)
        log(f"[time]   {name} {tuple(boxes.shape)} triu: kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, bound {b:.4f} ms ({k})")
        del got

    # the plain matrix mode where a path runs it: the train step's R-CNN
    # assigner, one launch an R-CNN branch for its images (TRAIN[1] = 2
    # RGB images: their gts and proposals against their gts), bit for bit
    # on the defined pairs
    n_assign = 2                            # the RGB and infrared branches
    cands = rotated_boxes(TRAIN[1], TRAIN_GTS + N_PROPOSALS)
    gts = cands[:, :TRAIN_GTS]
    got = rik.rotated_iou(cands, gts)
    ref = rik.rotated_iou_ref(cands, gts)
    mask = defined_pairs(cands)[:, :, :TRAIN_GTS]
    diff = (got - ref).abs() * mask
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and err == 0.0
    log(f"[kernel] rotated_iou            float32   {tuple(cands.shape)} x "
        f"{tuple(gts.shape)} (the R-CNN assigner, one launch a branch): max "
        f"abs err {err:.3e} on {int(mask.sum())} defined pairs, "
        f"{int((ref * mask > 0.5).sum())} pairs over IoU 0.5; bit-equal "
        f"required {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("rotated_iou assigner")
    recs["rotated_iou"].err = max(recs["rotated_iou"].err, err)
    ms = cuda_ms(torch, lambda: rik.rotated_iou(cands, gts), iters=5)
    dev_ms = device_ms(torch, lambda: rik.rotated_iou(cands, gts), iters=5)
    pms = cuda_ms(torch, lambda: rik.rotated_iou_ref(cands, gts), iters=2,
                  warmup=1)
    b, k = bound_ms((cands.numel() + gts.numel() + got.numel()) * 4,
                    [(got.numel() * ROT_IOU_FLOPS, "float32")])
    recs["rotated_iou"].add(n_assign, ms, pms, b, k, 0.0)
    recs["rotated_iou"].add_extra(n_assign, device_ms=dev_ms)
    log(f"[time]   rotated_iou {tuple(cands.shape)} x {tuple(gts.shape)} "
        f"(the assigner, {n_assign} a train step): kernel {ms:.4f} ms, "
        f"device {ms_str(dev_ms)}, plain {pms:.4f} ms, bound {b:.4f} ms "
        f"({k})")
    del cands, gts, got, ref, diff, mask

    # ---- the NMS: suppression bits (mask mode) and the keep scan ----------
    def nms_mask_case(name, what, boxes, thr, groups=None, matrix=False):
        """A mask kernel against its plain version on ``boxes`` (bit for bit
        on the pairs whose IoU is defined), timed beside its bound and, with
        ``matrix``, the matrix mode on the same input. The bound counts the
        pairs these boxes need decided: j > i, and one group below the
        inert group where there are groups. Returns the kernel's words and
        the times."""
        bsz, n = boxes.shape[:2]
        if name == "hbb_nms_mask":
            def run():
                return hik.hbb_nms_mask(boxes, thr)

            def plain():
                return hik.hbb_nms_mask_ref(boxes, thr)

            def mat():
                return hik.hbb_iou(boxes, boxes, triu=True)
            ok, flops = None, 12
        else:
            def run():
                return rik.rotated_nms_mask(boxes, thr, groups)

            def plain():        # an image at a time: the plain IoU's memory
                return torch.cat([rik.rotated_nms_mask_ref(
                    boxes[i:i + 1], thr,
                    None if groups is None else groups[i:i + 1])
                    for i in range(bsz)])

            def mat():
                return rik.rotated_iou(boxes, boxes, triu=True,
                                       groups1=groups, groups2=groups)
            ok, flops = defined_pairs(boxes), ROT_IOU_FLOPS
        got, ref = run(), plain()
        a, r = nkk.unpack_bits(got, n), nkk.unpack_bits(ref, n)
        if ok is not None:
            a, r = a & ok, r & ok
        same = torch.equal(a, r)
        up = torch.triu(torch.ones(n, n, dtype=torch.bool, device=dev), 1)
        if groups is None:
            pairs = bsz * n * (n - 1) // 2
        else:
            g = groups.long()
            pairs = int((up & (g[:, :, None] == g[:, None, :])
                         & (g[:, :, None] < rik.INERT_GROUP)).sum())
        log(f"[kernel] {name:22s} bits      {what} {tuple(boxes.shape)}, thr "
            f"{thr}: bit-equal to the plain version {same} on "
            f"{'all' if ok is None else int(ok.sum())} pairs, "
            f"{int(r.sum())} bits set, {pairs} pairs to decide "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"{name} {what}")
        del a, r, ref, up
        t = {"ms": cuda_ms(torch, run, iters=5),
             "device_ms": device_ms(torch, run, iters=5),
             "plain_ms": cuda_ms(torch, plain, iters=2, warmup=1)}
        t["bound"], t["kind"] = bound_ms(
            boxes.numel() * 4 + got.numel() * 4
            + (0 if groups is None else groups.numel() * 4),
            [(pairs * flops, "float32")])
        line = (f"[time]   {name} {what} {tuple(boxes.shape)}: kernel "
                f"{t['ms']:.4f} ms, device {ms_str(t['device_ms'])}, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound']:.4f} ms "
                f"({t['kind']})")
        if matrix:
            t["matrix_ms"] = cuda_ms(torch, mat, iters=5)
            t["matrix_device_ms"] = device_ms(torch, mat, iters=5)
            line += (f"; the matrix mode on the same input {t['matrix_ms']:.4f}"
                     f" ms, device {ms_str(t['matrix_device_ms'])}")
        log(line)
        return got, t

    def nms_keep_case(what, mask, elig):
        """The keep scan against its plain version (exact, and two runs
        bit-equal), timed beside its bound: the words the scan needs read
        once (row i's words from its diagonal word i // 32 rightwards, as
        the kernel stages them), eligible in, keep out; the ORs of the kept
        rows' words as operations."""
        def run():
            return nkk.nms_keep(mask, elig)
        got, again = run(), run()
        ref = nkk.nms_keep_ref(mask, elig)
        same = torch.equal(got, ref) and torch.equal(got, again)
        n = elig.shape[-1]
        kept = torch.nonzero(got)[:, 1]
        ors = int((mask.shape[-1] - 1 - kept // 32).sum())
        log(f"[kernel] nms_keep               bool      {what} "
            f"{tuple(mask.shape)}: equal to the plain version and across two "
            f"runs {same}; {int(got.sum())} kept of {int(elig.sum())} "
            f"eligible {'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"nms_keep {what}")
        t = {"ms": cuda_ms(torch, run, iters=5),
             "device_ms": device_ms(torch, run, iters=5),
             "plain_ms": cuda_ms(torch, lambda: nkk.nms_keep_ref(mask, elig),
                                 iters=2, warmup=1)}
        # row i needs words i // 32 .. W - 1: sum_i (W - i // 32) an image
        w = mask.shape[-1]
        words = sum(min(32, n - 32 * c) * (w - c) for c in range(w))
        bsz = elig.numel() // max(n, 1)
        # word ORs counted at the fp32 rate (integer operations, same units)
        t["bound"], t["kind"] = bound_ms(bsz * words * 4 + 2 * elig.numel(),
                                         [(ors, "float32")])
        log(f"[time]   nms_keep {what} {tuple(mask.shape)} (n {n}): kernel "
            f"{t['ms']:.4f} ms, device {ms_str(t['device_ms'])}, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound']:.4f} ms "
            f"({t['kind']})")
        return t

    def record_main(name, t, n):
        """Add a case at the main path's shapes, ``n`` launches of it a
        joint forward, to the record's totals."""
        recs[name].add(n, t["ms"], t["plain_ms"], t["bound"], t["kind"], 0.0)
        recs[name].add_extra(n, device_ms=t["device_ms"])

    def some_hbb(bsz, n):
        xy = torch.rand(bsz, n, 2, generator=gen, device=dev) * 760
        wh = 4 + torch.rand(bsz, n, 2, generator=gen, device=dev) * 120
        return torch.cat([xy, xy + wh], -1)

    # SAR (the GFL NMS, 8 images, thr 0.6) and RPN (8 images x 5 levels,
    # thr 0.8) masks, and their keeps
    for what, bsz, thr, elig_p in (("SAR", N_IMGS, 0.6, 0.9),
                                   ("RPN", rb, 0.8, 1.0)):
        hb = some_hbb(bsz, nb)
        words, t = nms_mask_case("hbb_nms_mask", what, hb, thr)
        record_main("hbb_nms_mask", t, 1)
        elig = torch.rand(bsz, nb, generator=gen, device=dev) < elig_p
        record_main("nms_keep", nms_keep_case(what, words, elig), 1)
        del hb, words
    # the aug_test merge (2 x 2000, not banded); the R-CNN's multiclass NMS
    # (26 sorted classes, an inert tail), also at the class offsets
    ab = rotated_boxes(1, 2 * N_PROPOSALS)
    words, t = nms_mask_case("rotated_nms_mask", "aug_test merge", ab, 0.1)
    record_main("rotated_nms_mask", t, 1)
    for class_offset, bsz in ((0, N_IMGS), (4000, 2)):
        rcb = rotated_boxes(bsz, N_PROPOSALS)
        groups = torch.sort(torch.randint(
            0, 26, (bsz, N_PROPOSALS), generator=gen, device=dev),
            dim=-1).values.int()
        rcb[..., :2] += (groups * class_offset)[..., None]
        groups[:, -N_PROPOSALS // 8:] = rik.INERT_GROUP
        what = f"R-CNN, class offset {class_offset}"
        if class_offset:
            got = rik.rotated_nms_mask(rcb, 0.1, groups)
            ref = torch.cat([rik.rotated_nms_mask_ref(
                rcb[i:i + 1], 0.1, groups[i:i + 1]) for i in range(bsz)])
            ok = defined_pairs(rcb)
            same = torch.equal(nkk.unpack_bits(got, N_PROPOSALS) & ok,
                               nkk.unpack_bits(ref, N_PROPOSALS) & ok)
            log(f"[kernel] rotated_nms_mask_banded bits      {what} "
                f"{tuple(rcb.shape)}: bit-equal to the plain version {same} "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                failures.append(f"rotated_nms_mask_banded {what}")
            continue
        words, t = nms_mask_case("rotated_nms_mask_banded", what, rcb, 0.1,
                                 groups)
        record_main("rotated_nms_mask_banded", t, 1)
        elig = groups < rik.INERT_GROUP
        record_main("nms_keep", nms_keep_case("R-CNN", words, elig), 1)
    del ab, rcb, words, elig

    # ---- the shapes of the TriSource variants and the zoo (phase 9) -------
    # row 4's mask mode and the keep scan at the H2 SAR RPN's candidates,
    # min(1000, level) of its five levels at 800^2: 4507 an image, the
    # H2-R2 train step's 2 SAR images, thr 0.7
    hb = some_hbb(2, H2_RPN_N)
    words, t = nms_mask_case("hbb_nms_mask", "H2 SAR RPN", hb, 0.7)
    recs["hbb_nms_mask"].extra["h2_sar_rpn"] = dict(shape=[2, H2_RPN_N], **t)
    elig = torch.rand(2, H2_RPN_N, generator=gen, device=dev) < 0.95
    recs["nms_keep"].extra["h2_sar_rpn"] = dict(
        shape=[2, H2_RPN_N], **nms_keep_case("H2 SAR RPN", words, elig))
    del hb, words, elig
    # row 5's matrix mode at the rotated RetinaNet assigner: 120087 anchors
    # of an 800^2 image against 512 (DOTA) or 256 (infrared) gts, one launch
    # a branch; bit for bit on the defined pairs. The work this data needs:
    # the pair function for pairs whose circumscribed circles meet, one
    # distance test (CIRCLE_TEST_FLOPS) for the rest
    from sm3det_tpu_torch.models.dense_heads.rotated_retina_head import \
        make_retina_anchor_generator
    anchors = torch.cat(make_retina_anchor_generator().grid_anchors(
        [(-(-IMG // st),) * 2 for st in (8, 16, 32, 64, 128)],
        device=dev))[None]
    for n_gt in (512, 256):
        gts = rotated_boxes(1, n_gt)
        got = rik.rotated_iou(anchors, gts)
        ref = rik.rotated_iou_ref(anchors, gts)
        real_a = (anchors[..., 2] * anchors[..., 3]) > 0
        real_g = (gts[..., 2] * gts[..., 3]) > 0
        ok_pairs = real_a[..., :, None] == real_g[..., None, :]
        err = ((got - ref).abs() * ok_pairs).max().item()
        ok = bool(torch.isfinite(got).all()) and err == 0.0
        reach = torch.cdist(anchors[0, :, :2], gts[0, :, :2]) <= (
            anchors[0, :, None, 2:4].norm(dim=-1) / 2
            + gts[0, None, :, 2:4].norm(dim=-1) / 2)
        near = int(reach.sum())
        del reach
        pairs = got.numel()
        log(f"[kernel] rotated_iou            float32   {tuple(anchors.shape)}"
            f" x {tuple(gts.shape)} (the retina assigner): max abs err "
            f"{err:.3e} on {int(ok_pairs.sum())} defined pairs, "
            f"{int((ref * ok_pairs > 0.5).sum())} pairs over IoU 0.5, "
            f"{near} pairs within reach; bit-equal required "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"rotated_iou retina assigner {n_gt}")
        del ref, ok_pairs
        ms = cuda_ms(torch, lambda: rik.rotated_iou(anchors, gts), iters=3)
        dev_ms = device_ms(torch, lambda: rik.rotated_iou(anchors, gts),
                           iters=3)
        pms = cuda_ms(torch, lambda: rik.rotated_iou_ref(anchors, gts),
                      iters=1, warmup=0)
        b, k = bound_ms(
            (anchors.numel() + gts.numel() + pairs) * 4,
            [(near * ROT_IOU_FLOPS + (pairs - near) * CIRCLE_TEST_FLOPS,
              "float32")])
        recs["rotated_iou"].extra[f"retina_assigner_{n_gt}"] = dict(
            shape=[list(anchors.shape), list(gts.shape)], ms=ms,
            device_ms=dev_ms, plain_ms=pms, bound=b, kind=k,
            pairs_within_reach=near)
        log(f"[time]   rotated_iou {tuple(anchors.shape)} x "
            f"{tuple(gts.shape)} (the retina assigner, 1 a branch): kernel "
            f"{ms:.4f} ms, device {ms_str(dev_ms)}, plain {pms:.4f} ms, "
            f"bound {b:.4f} ms ({k})")
        del got, gts
    del anchors

    # ---- pyramid rotated RoI align at the joint forward's shapes ----------
    n_rois = (JOINT[1] + JOINT[2]) * N_PROPOSALS

    def some_rois(bsz, n):
        """RoIs over all four levels, rotated, some across the border, some
        far outside, some of no size (padded proposals)."""
        def u(*shape):
            return torch.rand(*shape, generator=gen, device=dev)
        side = 8 * 2 ** (u(n) * 6.5)
        asp = 2 ** ((u(n) - 0.5) * 3)
        rois = torch.stack([
            torch.randint(0, bsz, (n,), generator=gen, device=dev).float(),
            (u(n) * 1.2 - 0.1) * IMG, (u(n) * 1.2 - 0.1) * IMG, side * asp,
            side / asp, (u(n) - 0.5) * 3.14], -1)
        rois[::11, 1:] = 0.0
        rois[5::50, 1:3] = -3.0 * IMG
        return rois

    def align_reads(what, feats, rr):
        """Log, beside row 7's bytes bound, what it reads of the levels:
        modelled from the plain geometry (``align_read_model``), not
        measured (no counter of L2 reads on the card)."""
        ch, isz = feats[0].shape[-1], feats[0].element_size()
        lv = route_levels(rr.float())
        modelled_tap_bytes = rr.shape[0] * 49 * 16 * ch * isz
        m = align_read_model(torch, sample_taps, feats, rr, lv)
        staged_footprint_pixels = m["pixels"]
        est = (staged_footprint_pixels + m["taps"]) * ch * isz
        log(f"[time]   roi_align_rotated {what} RoIs, modelled reads of the "
            f"levels (plain geometry and the kernel's staging rule, not "
            f"measured): the taps one by one {modelled_tap_bytes / 1e9:.3f} "
            f"GB; this kernel {staged_footprint_pixels} staged footprint "
            f"pixels ({m['staged']} RoIs) + {m['taps']} taps read from "
            f"device memory ({m['unstaged']} RoIs) = {est / 1e9:.3f} GB "
            f"({est / modelled_tap_bytes:.3f}); a RoI's footprint: median "
            f"{m['median_pixels']:.0f} pixels against 784 taps")

    rois = some_rois(N_IMGS, n_rois)
    lvls = route_levels(rois)
    log(f"[kernel] roi_align_rotated: {n_rois} RoIs, per level "
        f"{torch.bincount(lvls, minlength=4).tolist()}")
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.tensor([], dtype=dtype).element_size()
        feats = [rnd(N_IMGS, IMG // st, IMG // st, 256, dtype=dtype)
                 for st in (4, 8, 16, 32, 64)]
        got = rak.roi_align_rotated_pyramid_fused(feats, rois)
        ref = roi_align_rotated_pyramid(feats, rois, lvls, 7)
        check("roi_align_rotated", dtype, (n_rois, 7, 7, 256), got, ref,
              tol[dtype], main_path=dtype == torch.bfloat16)
        if float(got[5::50].abs().max()) != 0.0:
            failures.append("roi_align_rotated: RoIs outside are not zero")
        del ref
        if dtype == torch.bfloat16:
            ms = cuda_ms(torch, lambda: rak.roi_align_rotated_pyramid_fused(
                feats, rois), iters=5)
            pms = cuda_ms(torch, lambda: roi_align_rotated_pyramid(
                feats, rois, lvls, 7), iters=2, warmup=1)
            b, k = bound_ms(
                sum(f.numel() for f in feats[:4]) * isz + rois.numel() * 4
                + got.numel() * isz,
                [(n_rois * 49 * 16 * 256 * 2, "float32")])
            dev_ms = device_ms(
                torch, lambda: rak.roi_align_rotated_pyramid_fused(
                    feats, rois), iters=5)
            recs["roi_align_rotated"].add(1, ms, pms, b, k, 0.0)
            recs["roi_align_rotated"].extra["device_ms"] = dev_ms
            log(f"[time]   roi_align_rotated ({n_rois}, 7, 7, 256) bf16: "
                f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b:.4f} ms "
                f"({k}); device time only (the kernel and route_levels' "
                f"ops) {ms_str(dev_ms)}")
            align_reads("synthetic", feats, rois)
        del got, feats
    # ---- the train step's kernels ----------------------------------------
    # row 8: the align's feature gradient at the train step's shapes (2
    # images of a modality, 4 levels, 2 x rcnn_sample = 1024 RoIs), the
    # adversarial case of every RoI on one centre (every RoI meets the same
    # tiles, which sum them one after another) and long, thin RoIs (routed
    # by area to fine levels, where they cross many tiles); two launches
    # must give the same bits
    n_train_rois = 2 * DEFAULT_MODEL_CFG["rgb"]["rcnn_sample"]
    rois_t = some_rois(2, n_train_rois)
    crowd = rois_t.clone()
    crowd[:, 0] = 0.0
    crowd[:, 1:3] = 400.0
    crowd[:, 3:5] = 24 + torch.rand(n_train_rois, 2, generator=gen,
                                    device=dev) * 36
    thin = rois_t.clone()
    thin[:, 3] = IMG * (0.2 + 0.6 * torch.rand(n_train_rois, generator=gen,
                                               device=dev))
    thin[:, 4] = thin[:, 3] / (4 + 36 * torch.rand(
        n_train_rois, generator=gen, device=dev))
    # the H2 SAR branch's RoIs: axis-aligned with integer edges (angle 0),
    # where bilinear taps land on pixel edges
    from sm3det_tpu_torch.models.roi_heads.standard_roi_head import \
        hbb_to_roi5
    ixy = torch.randint(-20, IMG - 16, (n_train_rois, 2), generator=gen,
                        device=dev).float()
    iwh = torch.randint(1, 400, (n_train_rois, 2), generator=gen,
                        device=dev).float()
    level0 = torch.cat([rois_t[:, :1], hbb_to_roi5(torch.cat(
        [ixy, ixy + iwh], -1))], -1)
    strides4 = (4, 8, 16, 32)
    shapes4 = [(2, IMG // st, IMG // st, 256) for st in strides4]
    for dtype in (torch.float32, torch.bfloat16):
        feats4 = [rnd(*sh, dtype=dtype) for sh in shapes4]
        got = rak.roi_align_rotated_pyramid_fused(feats4, level0)
        ref = roi_align_rotated_pyramid(feats4, level0, route_levels(level0),
                                        7)
        check("roi_align_rotated", dtype,
              ("angle 0, integer edges", tuple(got.shape)), got, ref,
              tol[dtype], main_path=False)
        if not torch.equal(got, rak.roi_align_rotated_pyramid_fused(
                feats4, level0)):
            failures.append(f"roi_align_rotated {dtype} angle 0: two "
                            f"launches differ")
        del feats4, got, ref
    bwd_steps = 2                      # one align backward per R-CNN branch
    extra_key = {"all on one centre": "crowded_ms",
                 "long and thin": "long_thin_ms",
                 "angle 0, integer edges": "angle0_integer_ms"}
    for case, rr in (("random", rois_t), ("all on one centre", crowd),
                     ("long and thin", thin),
                     ("angle 0, integer edges", level0)):
        lv = route_levels(rr)
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.tensor([], dtype=dtype).element_size()
            g_out = rnd(n_train_rois, 7, 7, 256, dtype=dtype)

            def bwd():
                return rak.roi_align_rotated_pyramid_bwd(
                    g_out, rr, lv, shapes4, dtype, strides4)
            got, again = bwd(), bwd()
            ref = rak.roi_align_rotated_pyramid_bwd_ref(g_out, rr, lv,
                                                         shapes4, dtype,
                                                         strides4)
            # fp32: another summation order (1e-4 of the scale); bf16:
            # both round the fp32 sum once (2^-6, as the other bf16 rows)
            for lvl, (a, b) in enumerate(zip(got, ref)):
                check("roi_align_rotated_bwd", dtype,
                      (case, f"level {lvl}", tuple(a.shape)), a, b,
                      tol[dtype], main_path=dtype == torch.bfloat16)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"[kernel] roi_align_rotated_bwd {str(dtype)[6:]} {case}: "
                f"two launches bit-equal {same} {'ok' if same else 'FAIL'}")
            if not same:
                failures.append(f"roi_align_rotated_bwd {dtype} {case} not "
                                f"deterministic")
            del ref, got, again
            if dtype != torch.bfloat16:
                continue
            ms = cuda_ms(torch, bwd, iters=5)
            if case != "random":
                recs["roi_align_rotated_bwd"].extra[extra_key[case]] = ms
                log(f"[time]   roi_align_rotated_bwd ({n_train_rois}, 7, 7, "
                    f"256) bf16, {case}: kernel {ms:.4f} ms")
                continue
            pms = cuda_ms(torch, lambda: rak.roi_align_rotated_pyramid_bwd_ref(
                g_out, rr, lv, shapes4, dtype, strides4), iters=2, warmup=1)
            dev_ms = device_ms(torch, bwd, iters=5)
            grad_bytes = sum(a * b * c * d for a, b, c, d in shapes4) * isz
            b, k = bound_ms(g_out.numel() * isz + rr.numel() * 4 + grad_bytes,
                            [(n_train_rois * 49 * 16 * 256 * 2, "float32")])
            recs["roi_align_rotated_bwd"].add(bwd_steps, ms, pms, b, k, 0.0)
            recs["roi_align_rotated_bwd"].add_extra(bwd_steps,
                                                    device_ms=dev_ms)
            log(f"[time]   roi_align_rotated_bwd ({n_train_rois}, 7, 7, 256)"
                f" bf16 -> 4 levels of 2 images: kernel {ms:.4f} ms (both "
                f"launches and the wrapper), device {ms_str(dev_ms)}, plain "
                f"{pms:.4f} ms, bound {b:.4f} ms ({k})")
    del g_out

    # row 10: the trainable dw7x7 + LN, forward and the five gradients,
    # against the plain fp32 formulation's autograd and the closed-form
    # plain backward, at the train step's backbone shapes ([4:2:2] = 8
    # images of 800^2); the backward twice, for bit-equal gradients
    n_tr = sum(TRAIN)
    grad_names = ("dx", "ddwk", "ddwb", "dlns", "dlnb")
    for hw, c, n_dense, n_moe, _ in STAGES:
        for dtype in ((torch.float32, torch.bfloat16) if hw == 25
                      else (torch.bfloat16,)):
            isz = torch.tensor([], dtype=dtype).element_size()
            shape = (n_tr, hw, hw, c)
            ins = [rnd(*shape, dtype=dtype),
                   rnd(c, 1, 7, 7, scale=0.15).to(dtype),
                   rnd(c, scale=0.1).to(dtype),
                   (1 + rnd(c, scale=0.1)).to(dtype),
                   rnd(c, scale=0.1).to(dtype)]
            ins = [t.requires_grad_(True) for t in ins]
            g_out = rnd(*shape, dtype=dtype)

            def kernel_fb():
                out = cbk.fused_dwconv_ln_train(*ins)
                return (out,) + torch.autograd.grad(out, ins, g_out)

            def plain_fb():
                out = cbk.dwconv_ln_ref(*ins)
                return (out,) + torch.autograd.grad(out, ins, g_out)

            got, ref = kernel_fb(), plain_fb()
            again = kernel_fb()
            closed = cbk.dwconv_ln_bwd_ref(*[t.detach() for t in ins], g_out)
            for what, a, b in zip(("out",) + grad_names, got, ref):
                check("fused_dwconv_ln_train", dtype, (shape, what), a, b,
                      tol[dtype])
            for what, a, b in zip(grad_names, got[1:], closed):
                check("fused_dwconv_ln_train", dtype,
                      (shape, what, "closed form"), a, b, tol[dtype])
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"[kernel] fused_dwconv_ln_train {str(dtype)[6:]} {shape}: "
                f"two backward runs bit-equal {same} "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                failures.append(f"fused_dwconv_ln_train {dtype} {shape} "
                                f"not deterministic")
            del got, ref, again, closed
            if dtype != torch.bfloat16:
                continue
            xl = ins[0].permute(0, 3, 1, 2)

            def library_fb():
                y = torch.nn.functional.conv2d(xl, ins[1], ins[2], padding=3,
                                               groups=c)
                out = F.layer_norm(y.permute(0, 2, 3, 1), (c,), ins[3],
                                   ins[4], 1e-6)
                return torch.autograd.grad(out, ins, g_out)

            saved = [t.detach() for t in ins]
            ms = cuda_ms(torch, kernel_fb)
            fwd_ms = cuda_ms(torch, lambda: cbk.fused_dwconv_ln(*saved))
            bwd_ms = cuda_ms(torch, lambda: cbk._dwconv_ln_bwd_launch(
                *saved, g_out, 1e-6))
            pms = cuda_ms(torch, plain_fb, iters=5)
            lms = cuda_ms(torch, library_fb)
            dev_ms = device_ms(torch, kernel_fb)
            dev_lms = device_ms(torch, library_fb)
            n_pix = n_tr * hw * hw
            # each input and output once: x, g in; out, dx out (+ weights);
            # forward 106 fp32 operations a value, backward two 7x7 passes
            # and the LN's (~220)
            b, k = bound_ms(4 * n_pix * c * isz + 2 * 52 * c * 4,
                            [(n_pix * c * 326, "float32")])
            recs["fused_dwconv_ln_train"].add(n_dense + n_moe, ms, pms, b, k,
                                              lms)
            recs["fused_dwconv_ln_train"].add_device(n_dense + n_moe, dev_ms,
                                                     dev_lms)
            log(f"[time]   fused_dwconv_ln_train {shape} bf16 forward + "
                f"backward: {ms:.4f} ms (forward kernel {fwd_ms:.4f}, "
                f"backward kernels {bwd_ms:.4f}), plain {pms:.4f} ms, "
                f"library {lms:.4f} ms, bound {b:.4f} ms ({k}); device "
                f"time only: kernels {ms_str(dev_ms)}, library "
                f"{ms_str(dev_lms)}")
            del ins, g_out, saved

    # ConvNeXt-L's and -XL's widest stages (C = 1536, 2048; off the main
    # path): rows 9, 2 and 10 (forward and the five gradients, the
    # backward twice for bit-equal gradients)
    for c in (1536, 2048):
        for dtype in (torch.float32, torch.bfloat16):
            shape = (2, 12, 12, c)
            ins = [rnd(*shape, dtype=dtype),
                   rnd(c, 1, 7, 7, scale=0.15).to(dtype),
                   rnd(c, scale=0.1).to(dtype),
                   (1 + rnd(c, scale=0.1)).to(dtype),
                   rnd(c, scale=0.1).to(dtype)]
            xo = ins[0] * 3 + 1
            check("fused_layernorm", dtype, shape,
                  cbk.fused_layernorm(xo, ins[3], ins[4]),
                  cbk.layernorm_math(xo, ins[3], ins[4]), tol[dtype],
                  main_path=False)
            check("dwconv_ln", dtype, shape, cbk.fused_dwconv_ln(*ins),
                  cbk.dwconv_ln_ref(*ins), tol[dtype], main_path=False)
            ins = [t.requires_grad_(True) for t in ins]
            g_out = rnd(*shape, dtype=dtype)
            out = cbk.fused_dwconv_ln_train(*ins)
            got = (out,) + torch.autograd.grad(out, ins, g_out)
            again = torch.autograd.grad(cbk.fused_dwconv_ln_train(*ins), ins,
                                        g_out)
            closed = cbk.dwconv_ln_bwd_ref(*[t.detach() for t in ins],
                                           g_out)
            check("fused_dwconv_ln_train", dtype, (shape, "out"), got[0],
                  cbk.dwconv_ln_ref(*[t.detach() for t in ins]), tol[dtype],
                  main_path=False)
            for what, a, b in zip(grad_names, got[1:], closed):
                check("fused_dwconv_ln_train", dtype, (shape, what), a, b,
                      tol[dtype], main_path=False)
            if not all(torch.equal(a, b) for a, b in zip(got[1:], again)):
                failures.append(f"fused_dwconv_ln_train {dtype} {shape} not "
                                f"deterministic")
            del ins, g_out, out, got, again, closed

    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")

    # ---- 4a. fp32, one image: card against host --------------------------
    cfg32 = json.loads(json.dumps(DEFAULT_MODEL_CFG))
    model = TriSourceDetector(cfg32, device="cuda", seed=0)
    # real detections: lift the prior-probability bias so scores clear
    # score_thr and the NMS compares real candidates
    model.sar_bbox_head.gfl_cls.bias.fill_(0.0)
    host = TriSourceDetector(cfg32, device="cpu", seed=0)
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    img = torch.rand(1, IMG, IMG, 3, generator=gen, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        feats_d = model.extract_feat(img)
        cls_d, reg_d = model.head_sar_from_feats(feats_d)
        feats_h = host.extract_feat(img.cpu())
        cls_h, reg_h = host.head_sar_from_feats(feats_h)
    log(f"[e2e fp32] card and host forward {time.perf_counter() - t0:.1f} s")
    e2e_tol = 1e-3      # fp32 summation order through 18 blocks and the head
    for name, ds, hs in (("features", feats_d, feats_h),
                         ("cls_scores", cls_d, cls_h),
                         ("bbox_preds", reg_d, reg_h)):
        for lvl, (a, b) in enumerate(zip(ds, hs)):
            err, scale = max_err(a.cpu(), b)
            ok = bool(torch.isfinite(a).all()) and a.shape == b.shape and \
                err <= e2e_tol * max(scale, 1.0)
            log(f"[e2e fp32] {name}[{lvl}] {tuple(a.shape)}: max abs err "
                f"{err:.3e} (max |ref| {scale:.3e}) tol {e2e_tol} x scale "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"e2e {name}[{lvl}]")
    shape = (IMG, IMG)
    dets_d = model.get_bboxes_sar(cls_d, reg_d, shape)
    dets_h = host.get_bboxes_sar([x.cpu() for x in cls_d],
                                 [x.cpu() for x in reg_d], shape)
    same_valid = torch.equal(dets_d[2].cpu(), dets_h[2]) and \
        torch.equal(dets_d[1].cpu(), dets_h[1])
    box_err = (dets_d[0].cpu() - dets_h[0]).abs().max().item()
    n_valid = int(dets_h[2].sum())
    ok = same_valid and box_err <= 1e-4 and n_valid > 0
    log(f"[e2e fp32] detections from the same head outputs: {n_valid} valid, "
        f"labels/valid equal {same_valid}, max box/score err {box_err:.3e} "
        f"(tol 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("e2e detections")
    del cls_d, reg_d, cls_h, reg_h

    # ---- 4a, RGB branch: the same image through the Oriented R-CNN -------
    def stage(name, a, b):
        err, scale = max_err(a.cpu(), b.cpu())
        ok = bool(torch.isfinite(a.float()).all()) and a.shape == b.shape \
            and err <= e2e_tol * max(scale, 1.0)
        log(f"[e2e fp32] rgb {name} {tuple(a.shape)}: max abs err {err:.3e} "
            f"(max |ref| {scale:.3e}) tol {e2e_tol} x scale "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"e2e rgb {name}")

    def same_rectangles(a, b, what, scores=None):
        return equal_rectangles(torch, obb_corners, a, b, f"rgb {what}",
                                scores)

    with torch.no_grad():
        x_d = model.neck_rcnn(feats_d)
        x_h = host.neck_rcnn(feats_h)
        rpn_d = model.head_rpn(x_d, "rgb")
        rpn_h = host.head_rpn(x_h, "rgb")
        for lvl in range(5):
            stage(f"neck[{lvl}]", x_d[lvl], x_h[lvl])
            stage(f"rpn_cls[{lvl}]", rpn_d[0][lvl], rpn_h[0][lvl])
            stage(f"rpn_reg[{lvl}]", rpn_d[1][lvl], rpn_h[1][lvl])
        # proposals from the same RPN outputs
        prop_d, psc_d, pval_d = model.get_proposals(*rpn_d, shape)
        prop_h, psc_h, pval_h = host.get_proposals(
            [t.cpu() for t in rpn_d[0]], [t.cpu() for t in rpn_d[1]], shape)
        ok = torch.equal(pval_d.cpu(), pval_h) and \
            (psc_d.cpu() - psc_h).abs().max().item() <= 1e-6 and \
            same_rectangles(prop_d, prop_h, "proposals", (psc_d, psc_h))
        log(f"[e2e fp32] rgb proposals from the same RPN outputs: "
            f"{int(pval_h.sum())} valid of {pval_h.numel()}, valid equal "
            f"{torch.equal(pval_d.cpu(), pval_h)} {'ok' if ok else 'FAIL'}")
        if not ok or int(pval_h.sum()) == 0:
            failures.append("e2e rgb proposals")
        # RoI features from the same proposals: the kernel against the
        # host's plain version. The two devices' sinf/cosf differ in the
        # last bit, so a sample within rounding of a level's border may be
        # inside on one and outside on the other: a few bins may differ
        rf_d = model.roi_feats(x_d, prop_d)
        rf_h = host.roi_feats([t.cpu() for t in x_d], prop_d.cpu())
        bin_err = (rf_d.cpu() - rf_h).abs().amax(-1)
        scale = rf_h.abs().max().item()
        n_bad = int((bin_err > e2e_tol * max(scale, 1.0)).sum())
        ok = bool(torch.isfinite(rf_d).all()) and n_bad <= 8
        log(f"[e2e fp32] rgb roi_feats {tuple(rf_d.shape)}: {n_bad} of "
            f"{bin_err.numel()} bins beyond {e2e_tol} x scale (allowed 8: "
            f"border samples), median bin err {bin_err.median().item():.3e}"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("e2e rgb roi_feats")
        spread_class_scores(model.rgb_roi_head, rf_d)
        host.rgb_roi_head.load_state_dict(
            {k: v.cpu() for k, v in model.rgb_roi_head.state_dict().items()})
        logit_d, delta_d = model.rgb_roi_head(rf_d)
        logit_h, delta_h = host.rgb_roi_head(rf_d.cpu())
        stage("cls_logits", logit_d, logit_h)
        stage("bbox_deltas", delta_d, delta_h)
        # detections from the same logits
        args = (logit_d[None], delta_d[None], prop_d, pval_d)
        det_d = model.get_bboxes_rcnn(*args, shape)
        det_h = host.get_bboxes_rcnn(*[t.cpu() for t in args], shape)
        same_valid = torch.equal(det_d[2].cpu(), det_h[2]) and \
            torch.equal(det_d[1].cpu(), det_h[1])
        n_valid = int(det_h[2].sum())
        if same_valid:
            sc_err = (det_d[0][..., 5].cpu() - det_h[0][..., 5]).abs() \
                .max().item()
            ok = n_valid > 0 and sc_err <= 1e-4 and same_rectangles(
                det_d[0][..., :5], det_h[0][..., :5], "detections")
            log(f"[e2e fp32] rgb detections from the same logits: {n_valid} "
                f"valid, {len(set(det_h[1][det_h[2]].tolist()))} classes, "
                f"labels/valid equal True, max score err {sc_err:.3e} (tol "
                f"1e-4) {'ok' if ok else 'FAIL'}")
        else:
            # the NMS compares IoU > 0.1 and the host's IoU differs from
            # the card's in the last bits (sinf/cosf): a candidate pair
            # within 1e-5 of the threshold may decide either way. Then the
            # mask kernel must still agree with its plain version run on
            # the card, where both see the same sinf/cosf: the NMS's mask
            # function is swapped for the plain one, whose route launches
            # no mask kernel
            kernel_mask = nms_mod.rotated_nms_mask
            nms_mod.rotated_nms_mask = rik.rotated_nms_mask_ref
            build.reset_launches()
            try:
                det_p = model.get_bboxes_rcnn(*args, shape)
            finally:
                nms_mod.rotated_nms_mask = kernel_mask
            torch.cuda.synchronize()
            plain_route = dict(build.LAUNCHES)
            ok = n_valid > 0 and all(
                torch.equal(a, b) for a, b in zip(det_d, det_p)) and \
                plain_route["rotated_nms_mask_banded"] == 0 and \
                plain_route["nms_keep"] == 1
            log(f"[e2e fp32] rgb detections from the same logits: card and "
                f"host differ ({int(det_d[2].sum())} against {n_valid} "
                f"valid): a near-tie at the IoU threshold between the "
                f"devices; the mask kernel against the plain mask on the "
                f"card (that run's launches: rotated_nms_mask_banded "
                f"{plain_route['rotated_nms_mask_banded']}, nms_keep "
                f"{plain_route['nms_keep']}): equal {ok} "
                f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("e2e rgb detections")
    del model, host, feats_d, feats_h, x_d, x_h, rpn_d, rpn_h, rf_d, rf_h
    if failures:
        fail(f"end-to-end checks failed: {failures}")

    # ---- 4b. full width, 8 x 800^2, bf16 ---------------------------------
    cfg16 = json.loads(json.dumps(DEFAULT_MODEL_CFG))
    cfg16["compute_dtype"] = "bfloat16"
    model = TriSourceDetector(cfg16, seed=0)          # on the card
    model.sar_bbox_head.gfl_cls.bias.fill_(0.0)
    imgs = torch.rand(N_IMGS, IMG, IMG, 3, generator=gen, device=dev)
    for _ in range(2):
        model.simple_test(imgs, "sar")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    dets, labels, valid = model.simple_test(imgs, "sar")
    torch.cuda.synchronize()
    sar_launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[e2e bf16] sar: launches in one forward: {sar_launches}")
    want = {"fused_convnext_block": 11, "dwconv_ln": 18, "convnext_ffn": 0,
            "moe_ffn_grouped": 7, "fused_layernorm": 8, "hbb_iou": 0,
            "rotated_iou": 0, "rotated_iou_banded": 0,
            "roi_align_rotated": 0, "roi_align_rotated_bwd": 0,
            "fused_dwconv_ln_train": 0, "fused_dwconv_ln_train_bwd": 0,
            "hbb_nms_mask": 1, "rotated_nms_mask": 0,
            "rotated_nms_mask_banded": 0, "nms_keep": 1}
    for k, v in sar_launches.items():
        if v != want[k]:
            failures.append(f"sar launches {k}={v}")
    ok_out = dets.shape == (N_IMGS, 100, 5) and \
        bool(torch.isfinite(dets).all()) and int(valid.sum()) > 0
    log(f"[e2e bf16] sar: dets {tuple(dets.shape)}, {int(valid.sum())} "
        f"valid, finite {bool(torch.isfinite(dets).all())}")
    if not ok_out:
        failures.append("bf16 sar outputs")

    walls, q1, dt, q3 = timed_forwards(
        torch, lambda: model.simple_test(imgs, "sar"))
    head_ms = cuda_ms(torch, lambda: model.head_sar(imgs), iters=3)
    cls_o, reg_o = model.head_sar(imgs)
    post_ms = cuda_ms(torch, lambda: model.get_bboxes_sar(cls_o, reg_o),
                      iters=3)
    sar_ips = N_IMGS / dt
    log(f"[e2e bf16] sar: forward wall times (ms): "
        f"{' '.join(f'{w * 1e3:.2f}' for w in walls)}")
    log(f"[e2e bf16] sar: {N_IMGS} x {IMG}^2: median {dt * 1e3:.2f} ms per "
        f"batch (quartiles {q1 * 1e3:.2f}-{q3 * 1e3:.2f}), {sar_ips:.2f} "
        f"images/s, peak memory {peak_gib:.2f} GiB; backbone+neck+head "
        f"{head_ms:.2f} ms, decode+NMS {post_ms:.2f} ms (CUDA events); card "
        f"{smi}")
    del cls_o, reg_o, dets, labels, valid
    if failures:
        fail(f"full-width SAR run failed: {failures}")

    # ---- 4c. full width, joint [8 : 4 : 4] x 800^2, bf16 -------------------
    n_sar, n_rgb, n_ifr = JOINT
    n_joint = sum(JOINT)
    sar_i = imgs[:n_sar]
    rgb_i = torch.rand(n_rgb, IMG, IMG, 3, generator=gen, device=dev)
    ifr_i = torch.rand(n_ifr, IMG, IMG, 3, generator=gen, device=dev)
    with torch.no_grad():
        _, x, rpn = model.head_joint(sar_i, rgb_i, ifr_i)
        props, _, _ = model.get_proposals(*rpn)
        rf = model.roi_feats(x, props)
        spread_class_scores(model.rgb_roi_head, rf[:n_rgb * N_PROPOSALS])
        spread_class_scores(model.ifr_roi_head, rf[n_rgb * N_PROPOSALS:])
    del x, rpn, props, rf

    def joint():
        return model.simple_test_joint(sar_i, rgb_i, ifr_i)

    for _ in range(2):
        joint()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    sar_o, rgb_o, ifr_o = joint()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    joint_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[joint bf16] launches in one forward: {launches}")
    # hbb_nms_mask: the SAR NMS, and the RPN NMS of 8 images x 5 levels in
    # one; rotated_nms_mask_banded: the R-CNN NMS; a keep scan each
    want = {"fused_convnext_block": 11, "dwconv_ln": 18, "convnext_ffn": 0,
            "moe_ffn_grouped": 7, "fused_layernorm": 8, "hbb_iou": 0,
            "rotated_iou": 0, "rotated_iou_banded": 0,
            "roi_align_rotated": 1, "roi_align_rotated_bwd": 0,
            "fused_dwconv_ln_train": 0, "fused_dwconv_ln_train_bwd": 0,
            "hbb_nms_mask": 2, "rotated_nms_mask": 0,
            "rotated_nms_mask_banded": 1, "nms_keep": 3}
    for k, v in launches.items():
        if v != want[k]:
            log(f"[joint bf16] launches of {k}: {v}, expected {want[k]}")
        if want[k] and v <= 0:
            failures.append(f"joint launches {k}={v}")
    ok_out = sar_o[0].shape == (n_sar, 100, 5)
    for name, (d, lab, val), n in (("sar", sar_o, n_sar), ("rgb", rgb_o, n_rgb),
                                   ("ifr", ifr_o, n_ifr)):
        fin = bool(torch.isfinite(d).all())
        log(f"[joint bf16] {name}: dets {tuple(d.shape)}, {int(val.sum())} "
            f"valid, {len(set(lab[val].tolist()))} classes, finite {fin}")
        ok_out = ok_out and fin and int(val.sum()) > 0 and d.shape[0] == n
        if name != "sar":
            ok_out = ok_out and d.shape == (n, N_PROPOSALS, 6)
    if not ok_out:
        failures.append("bf16 joint outputs")

    walls, q1, joint_dt, q3 = timed_forwards(torch, joint)
    joint_ips = n_joint / joint_dt
    with torch.no_grad():
        (s_cls, s_reg), x, rpn = model.head_joint(sar_i, rgb_i, ifr_i)
        props, _, pval = model.get_proposals(*rpn)
        rf = model.roi_feats(x, props)
        logits, deltas = model.roi_logits_joint(rf, n_rgb, n_ifr)
        stages = {
            "backbone + necks + GFL and RPN heads": cuda_ms(
                torch, lambda: model.head_joint(sar_i, rgb_i, ifr_i),
                iters=3),
            "SAR decode + NMS": cuda_ms(
                torch, lambda: model.get_bboxes_sar(s_cls, s_reg), iters=3),
            "proposal decode + NMS": cuda_ms(
                torch, lambda: model.get_proposals(*rpn), iters=3),
            "RoI align": cuda_ms(
                torch, lambda: model.roi_feats(x, props), iters=3),
            "RoI heads": cuda_ms(
                torch, lambda: model.roi_logits_joint(rf, n_rgb, n_ifr),
                iters=3),
            "R-CNN decode + NMS": cuda_ms(
                torch, lambda: model.get_bboxes_rcnn(logits, deltas, props,
                                                     pval), iters=3),
        }
    log(f"[joint bf16] forward wall times (ms): "
        f"{' '.join(f'{w * 1e3:.2f}' for w in walls)}")
    log(f"[joint bf16] [{n_sar}:{n_rgb}:{n_ifr}] x {IMG}^2: median "
        f"{joint_dt * 1e3:.2f} ms per batch (quartiles {q1 * 1e3:.2f}-"
        f"{q3 * 1e3:.2f}), {joint_ips:.2f} images/s, peak memory "
        f"{joint_peak_gib:.2f} GiB; card {smi}")
    log("[joint bf16] stages (CUDA events, mean of 3, ms): " + "; ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    # row 7 on the RoIs the joint forward's RPN produced
    n_img = props.shape[0]
    rois_j = torch.cat([torch.arange(n_img, device=dev, dtype=props.dtype)
                        .repeat_interleave(props.shape[1])[:, None],
                        props.reshape(-1, 5)], -1)
    lv_j = route_levels(rois_j.float())
    log(f"[joint bf16] roi_align_rotated on the joint forward's "
        f"{rois_j.shape[0]} proposals: per level "
        f"{torch.bincount(lv_j, minlength=4).tolist()}")
    with torch.no_grad():
        got = rak.roi_align_rotated_pyramid_fused(x, rois_j)
        ref = roi_align_rotated_pyramid(x, rois_j, lv_j, 7)
        check("roi_align_rotated", got.dtype,
              ("joint proposals", tuple(got.shape)), got, ref,
              tol[got.dtype])
        ms = cuda_ms(torch, lambda: rak.roi_align_rotated_pyramid_fused(
            x, rois_j), iters=5)
        pms = cuda_ms(torch, lambda: roi_align_rotated_pyramid(
            x, rois_j, lv_j, 7), iters=2, warmup=1)
        again = rak.roi_align_rotated_pyramid_fused(x, rois_j)
    same = torch.equal(got, again)
    if not same:
        failures.append("roi_align_rotated: runs differ")
    recs["roi_align_rotated"].extra.update(proposals_ms=ms,
                                           proposals_plain_ms=pms)
    log(f"[time]   roi_align_rotated joint proposals {tuple(got.shape)}: "
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms; two runs bit-equal "
        f"{same}")
    align_reads("proposals", x, rois_j)
    del x, rpn, props, rf, logits, deltas, s_cls, s_reg, got, ref, again

    # the NMS kernels on the joint forward's own inputs: one forward with
    # the NMS's mask and keep functions recording what they are given
    nms_fns = {k: getattr(nms_mod, k)
               for k in ("hbb_nms_mask", "rotated_nms_mask", "nms_keep")}
    seen = []

    def recording(k):
        def fn(*a, **kw):
            seen.append((k, a, kw))
            return nms_fns[k](*a, **kw)
        return fn
    for k in nms_fns:
        setattr(nms_mod, k, recording(k))
    try:
        joint()
    finally:
        for k, fn in nms_fns.items():
            setattr(nms_mod, k, fn)
    stage_of = ["SAR", "RPN", "R-CNN"]
    masks = [c for c in seen if c[0] != "nms_keep"]
    keeps = [c for c in seen if c[0] == "nms_keep"]
    log(f"[joint bf16] the NMS's inputs recorded from one forward: "
        f"{[(k, tuple(a[0].shape)) for k, a, _ in seen]}")
    if len(masks) != 3 or len(keeps) != 3:
        failures.append(f"joint NMS calls {[k for k, _, _ in seen]}")
    for what, (k, a, kw), (_, ka, _) in zip(stage_of, masks, keeps):
        boxes, thr = a[0], a[1]
        groups = a[2] if len(a) > 2 else kw.get("groups")
        name = k + ("_banded" if groups is not None else "")
        _, t = nms_mask_case(name, f"joint forward's {what} input", boxes,
                             thr, groups, matrix=True)
        recs[name].add_extra(1, joint_input_ms=t["ms"],
                             joint_input_device_ms=t["device_ms"],
                             joint_input_plain_ms=t["plain_ms"],
                             joint_input_bound_ms=t["bound"])
        matrix = "rotated_iou_banded" if groups is not None else "hbb_iou"
        recs[matrix].add_extra(1, joint_input_ms=t["matrix_ms"],
                               joint_input_device_ms=t["matrix_device_ms"])
        tk = nms_keep_case(f"joint forward's {what} input", *ka)
        recs["nms_keep"].add_extra(1, joint_input_ms=tk["ms"],
                                   joint_input_device_ms=tk["device_ms"],
                                   joint_input_plain_ms=tk["plain_ms"],
                                   joint_input_bound_ms=tk["bound"])
    del seen, masks, keeps
    joint_syncs = host_syncs(torch, joint)
    log(f"[joint bf16] host synchronisations in one forward "
        f"(set_sync_debug_mode('warn')): {sum(joint_syncs.values())}; "
        f"by site: {joint_syncs}")

    # test-time augmentation on one RGB image: the merge of the two
    # variants' detections runs the un-banded rotated mask kernel
    model.aug_test(rgb_i[:1], "rgb")
    torch.cuda.synchronize()
    build.reset_launches()
    a_dets, a_labels, a_valid = model.aug_test(rgb_i[:1], "rgb")
    torch.cuda.synchronize()
    aug_launches = dict(build.LAUNCHES)
    ok = a_dets.shape == (1, N_PROPOSALS, 6) and \
        bool(torch.isfinite(a_dets).all()) and int(a_valid.sum()) > 0 and \
        aug_launches["rotated_nms_mask"] >= 1
    log(f"[aug bf16] aug_test('rgb'), 1 image, 2 flips: dets "
        f"{tuple(a_dets.shape)}, {int(a_valid.sum())} valid; launches "
        f"{aug_launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("aug_test")
    launches["rotated_nms_mask"] = aug_launches["rotated_nms_mask"]
    if failures:
        fail(f"full-width joint run failed: {failures}")

    # ---- 5a. the train step, fp32, card against host ---------------------
    del model, imgs, sar_i, rgb_i, ifr_i, sar_o, rgb_o, ifr_o
    torch.cuda.empty_cache()
    cfg_t = json.loads(json.dumps(DEFAULT_MODEL_CFG))
    card = TriSourceDetector(cfg_t, device="cuda", seed=0, trainable=True)
    host = TriSourceDetector(cfg_t, device="cpu", seed=0, trainable=True)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    tbatch = make_train_batch(np.random.RandomState(1), (1, 1, 1), HOST_IMG,
                              TRAIN_GTS)
    # the proposal NMS is a discrete function of float noise (scores tied
    # to 1e-6 swap, IoU near the threshold decides either way), so the host
    # samples its RoIs from the card's proposals; how far its own differ is
    # logged
    recorded, host_own = [], []
    real_proposals = tri_mod.rpn_get_proposals

    def record(*a, **kw):
        out = real_proposals(*a, **kw)
        recorded.append(out)
        return out

    def replay(*a, **kw):
        host_own.append(real_proposals(*a, **kw))
        return tuple(t.cpu() for t in recorded[len(host_own) - 1])

    runs = {}
    t0 = time.perf_counter()
    for name, m, dv, fn in (("card", card, dev, record),
                            ("host", host, torch.device("cpu"), replay)):
        tri_mod.rpn_get_proposals = fn
        try:
            params = trainable_params(m)
            losses = m(batch_to(tbatch, dv),
                       gen=torch.Generator().manual_seed(5))
            grads = torch.autograd.grad(sum(losses.values()),
                                        list(params.values()))
        finally:
            tri_mod.rpn_get_proposals = real_proposals
        runs[name] = ({k: float(v.detach()) for k, v in losses.items()},
                      subtree_norms(torch, list(params), grads))
        del losses, grads
    log(f"[train fp32] card and host forward + backward, [1:1:1] x "
        f"{HOST_IMG}^2, full width: {time.perf_counter() - t0:.1f} s")
    for (pd, _, vd), (ph, _, vh) in zip(recorded, host_own):
        same = torch.equal(vd.cpu(), vh) and bool(
            ((pd.cpu() - ph).abs().amax(-1) <= 1e-4 * HOST_IMG)[vh].all())
        log(f"[train fp32] host's own proposals equal the card's "
            f"(fieldwise, 1e-4 x {HOST_IMG}): {same}")
    (ld, nd), (lh, nh) = runs["card"], runs["host"]
    for k in lh:
        ok = np.isfinite(ld[k]) and abs(ld[k] - lh[k]) <= \
            1e-3 * abs(lh[k]) + 1e-7
        log(f"[train fp32] {k}: card {ld[k]:.6e} host {lh[k]:.6e} (1e-3 "
            f"relative) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train card/host {k}")
    for k in nh:
        ok = np.isfinite(nd[k]) and abs(nd[k] - nh[k]) <= 1e-2 * nh[k]
        log(f"[train fp32] |grad {k}|: card {nd[k]:.6e} host {nh[k]:.6e} "
            f"(1e-2 relative) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train card/host grad {k}")
    del card, host, recorded, host_own
    torch.cuda.empty_cache()
    if failures:
        fail(f"card-against-host train check failed: {failures}")

    # ---- 5b. the flagship train step, full width, bf16 -------------------
    cfg_f = json.loads(json.dumps(DEFAULT_MODEL_CFG))
    cfg_f["compute_dtype"] = "bfloat16"
    model = TriSourceDetector(cfg_f, seed=0, trainable=True)   # the card
    names = list(trainable_params(model))
    dla_cfg = make_dla_config(warmup_iters=DLA_WARMUP)
    init_fn, update_fn, _ = make_optimizer(
        names, base_lr=1e-4, step_iters=(80000,), warmup_iters=DLA_WARMUP,
        dla_cfg=dla_cfg)
    state = init_train_state(model, init_fn, seed=1)
    train_step = build_train_step(model, update_fn)
    fbatch = batch_to(make_train_batch(np.random.RandomState(0), TRAIN, IMG,
                                       TRAIN_GTS), dev)
    n_train = sum(TRAIN)
    p0 = [p.detach().clone() for p in state.params.values()]
    mult_log = []

    def one_step():
        nonlocal state
        state, met = train_step(state, fbatch)
        # the multipliers the update applied, by the step it ran at
        mult_log.append((state.opt.step - 1, state.opt.mults))
        return met

    t0 = time.perf_counter()
    for _ in range(DLA_WARMUP):                  # warm-up and DLA warm-up
        one_step()
    torch.cuda.synchronize()
    log(f"[train bf16] {DLA_WARMUP} warm-up steps {time.perf_counter() - t0:.1f}"
        f" s")
    build.reset_launches()
    metrics = one_step()
    torch.cuda.synchronize()
    train_launches = dict(build.LAUNCHES)
    log(f"[train bf16] launches in one step: {train_launches}")
    torch.cuda.reset_peak_memory_stats()
    walls, train_q1, train_dt, train_q3 = timed_forwards(torch, one_step,
                                                         n=TRAIN_STEPS)
    train_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: float(v) for k, v in one_step().items()}
    train_ips = n_train / train_dt
    moved = max(float((p.detach() - q).abs().max())
                for p, q in zip(state.params.values(), p0))
    warm_ones = all(mm and all(v == 1.0 for v in mm.values())
                    for st, mm in mult_log if st < DLA_WARMUP)
    on_later = all(any(abs(v - 1.0) > 1e-6 for v in mm.values())
                   for st, mm in mult_log if st >= DLA_WARMUP)
    log(f"[train bf16] step wall times (ms): "
        f"{' '.join(f'{w * 1e3:.2f}' for w in walls)}")
    log(f"[train bf16] [{TRAIN[0]}:{TRAIN[1]}:{TRAIN[2]}] x {IMG}^2, "
        f"full width, DLA + AdamW: median {train_dt * 1e3:.2f} ms a step "
        f"(quartiles {train_q1 * 1e3:.2f}-{train_q3 * 1e3:.2f}), "
        f"{train_ips:.2f} images/s, peak memory {train_peak_gib:.2f} GiB; "
        f"card {smi}")
    log("[train bf16] losses of the last step: " + ", ".join(
        f"{k} {v:.5f}" for k, v in metrics.items()))
    log(f"[train bf16] DLA multipliers: step {mult_log[0][0]} "
        f"{mult_log[0][1]}; step {mult_log[-1][0]} {mult_log[-1][1]}")
    log(f"[train bf16] parameters moved by up to {moved:.3e}; multipliers "
        f"1 in warm-up {warm_ones}, other than 1 after it {on_later}")
    if not all(np.isfinite(v) for v in metrics.values()):
        failures.append("train losses not finite")
    if not moved > 0:
        failures.append("train parameters did not move")
    if not (warm_ones and on_later):
        failures.append("DLA multipliers")
    for k in ("hbb_nms_mask", "nms_keep", "rotated_iou", "roi_align_rotated",
              "roi_align_rotated_bwd", "fused_dwconv_ln_train"):
        if train_launches[k] <= 0:
            failures.append(f"train launches {k}={train_launches[k]}")
    # phase 3 times the assigner's IoU at one launch an R-CNN branch
    if train_launches["rotated_iou"] != 2:
        failures.append(f"train launches rotated_iou="
                        f"{train_launches['rotated_iou']}, expected 2")
    train_syncs = host_syncs(torch, one_step)
    log(f"[train bf16] host synchronisations in one step "
        f"(set_sync_debug_mode('warn')): {sum(train_syncs.values())}; "
        f"by site: {train_syncs}")
    # the 18 ConvNeXt-T blocks: one forward and one backward each
    for k in ("fused_dwconv_ln_train", "fused_dwconv_ln_train_bwd"):
        if train_launches[k] != 18:
            failures.append(f"train launches {k}={train_launches[k]}, "
                            f"expected 18")
    if failures:
        fail(f"flagship train step failed: {failures}")
    for k in ("rotated_iou", "roi_align_rotated_bwd", "fused_dwconv_ln_train"):
        launches[k] = train_launches[k]

    # ---- 6. the evaluation entry point -------------------------------------
    del model, state, train_step, fbatch, p0, mult_log
    torch.cuda.empty_cache()
    eval_failures, eval_rec, eval_launches = phase6(torch, dev, smi, build)
    if eval_failures:
        fail(f"evaluation entry point failed: {eval_failures}")
    launches["rotated_iou_banded"] = eval_rec["rotated_iou_banded_launches"]
    launches["hbb_iou"] = eval_rec["hbb_iou_launches"]
    for k in ("rotated_iou_banded", "hbb_iou"):
        e = eval_rec[f"eval_{k}"]
        recs[k].extra.update(eval_shape=e["shape"], eval_ms=e["kernel_ms"],
                             eval_plain_ms=e["plain_ms"],
                             eval_bound_ms=e["bound_ms"],
                             eval_bound_by=e["bound_by"])

    # ---- 7. the train entry point -----------------------------------------
    train_failures, train_rec, train_entry_launches = phase7(torch, dev, smi,
                                                             build)
    if train_failures:
        fail(f"train entry point failed: {train_failures}")

    # ---- 8. the LSKNet / VAN configurations and the loss reweighting -------
    lsk_failures, lsk_rec, lsk_launches = phase8(torch, dev, smi, build)
    if lsk_failures:
        fail(f"LSKNet / VAN and reweighting phase failed: {lsk_failures}")
    recs["fused_layernorm"].extra["lsk_t_joint_launches"] = \
        lsk_launches["fused_layernorm"]

    # ---- 9. the TriSource variants and the zoo's detectors -----------------
    torch.cuda.empty_cache()
    var_failures, var_rec, var_launches = phase9(torch, dev, smi, build)
    if var_failures:
        fail(f"variants and zoo phase failed: {var_failures}")
    for k, n in var_launches.items():
        if k in recs:
            recs[k].extra["h2r2_train_step_launches"] = n

    # ---- 10. the refinement and cascade detectors --------------------------
    torch.cuda.empty_cache()
    ref_failures, ref_rec, ref_launches = phase10(torch, dev, smi, build)
    if ref_failures:
        fail(f"refinement and cascade phase failed: {ref_failures}")
    for name, launched in ref_launches.items():
        for k, n in launched.items():
            if k in recs:
                recs[k].extra[f"{name.lower()}_train_step_launches"] = n

    # ---- 11. the Domain-Attention baseline and the leftovers ---------------
    torch.cuda.empty_cache()
    da_failures, da_rec, da_launches = phase11(torch, dev, smi, build)
    if da_failures:
        fail(f"Domain-Attention phase failed: {da_failures}")
    ffn_rec = recs["convnext_ffn"]
    for r in da_rec["convnext_ffn"]:
        ffn_rec.add(r["blocks"], r["ms"], r["plain_ms"], r["bound_ms"],
                    r["bound_by"], r["library_ms"])
        ffn_rec.err = max(ffn_rec.err, r["max_abs_err"])
    launches["convnext_ffn"] = da_launches["convnext_ffn"]
    for k, n in da_launches.items():
        if k in recs:
            recs[k].extra["da_joint_launches"] = n

    # ---- 12. the BabelRS ViT-Adapter configuration -------------------------
    torch.cuda.empty_cache()
    vit_failures, vit_rec, vit_launches = phase12(torch, dev, smi, build)
    if vit_failures:
        fail(f"BabelRS phase failed: {vit_failures}")
    for k, n in vit_launches.items():
        if k in recs:
            recs[k].extra["babelrs_joint_launches"] = n

    script_s = time.perf_counter() - t_main
    log(f"[smoke] whole script wall time {script_s:.1f} s (limit "
        f"{SCRIPT_LIMIT_S} s)")
    if script_s > SCRIPT_LIMIT_S:
        fail(f"the script took {script_s:.1f} s")
    log(json.dumps({
        "kernels": [recs[k].json(launches[k]) for k in recs],
        "launches_from": "simple_test_joint [8:4:4]; rotated_nms_mask "
                         "from aug_test('rgb') on 1 image; rotated_iou (the "
                         "R-CNN assigner), roi_align_rotated_bwd and "
                         "fused_dwconv_ln_train from one flagship train "
                         "step; rotated_iou_banded (matrix mode) from the "
                         "eval entry point's rgb mAP over 32 images, "
                         "hbb_iou (matrix mode) from its SAR mAP over 16; "
                         "convnext_ffn from the DA config's joint forward "
                         "[8:4:4] (phase 11b)",
        "eval": eval_rec, "eval_launches": eval_launches,
        "train_step_launches": train_launches,
        "train_images_per_s": train_ips, "train_step_ms": train_dt * 1e3,
        "train_peak_gib": train_peak_gib, "train_losses": metrics,
        "joint_images_per_s": joint_ips, "joint_ms": joint_dt * 1e3,
        "joint_peak_gib": joint_peak_gib, "joint_stage_ms": stages,
        "joint_host_syncs": sum(joint_syncs.values()),
        "train_host_syncs": sum(train_syncs.values()),
        "sar_images_per_s": sar_ips, "sar_peak_gib": peak_gib,
        "train_entry": train_rec,
        "train_entry_launches": train_entry_launches,
        "lsk_van_reweight": lsk_rec,
        "variants_zoo": var_rec, "h2r2_train_step_launches": var_launches,
        "refine_cascade": ref_rec, "da_baseline": da_rec,
        "babelrs": vit_rec,
        "script_s": script_s, "card": smi}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
