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
   every kernel in one step.

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
backward runs for bit-equal gradients).

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
# stage geometry of ConvNeXt-T at 800^2: (H = W, C, dense blocks, MoE
# blocks, LayerNorms: stem, downsample into the next stage, output)
STAGES = [(200, 96, 3, 0, 3), (100, 192, 3, 0, 2), (50, 384, 4, 5, 2),
          (25, 768, 1, 2, 1)]
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
        y0, x0, y1, x1 = sample_taps(r, hgt, wid, out, st, sn)[:4]
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


def main():
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
    strides4 = (4, 8, 16, 32)
    shapes4 = [(2, IMG // st, IMG // st, 256) for st in strides4]
    bwd_steps = 2                      # one align backward per R-CNN branch
    for case, rr in (("random", rois_t), ("all on one centre", crowd),
                     ("long and thin", thin)):
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
                recs["roi_align_rotated_bwd"].extra[
                    "crowded_ms" if case.startswith("all") else
                    "long_thin_ms"] = ms
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
    def spread_class_scores(head, roi_feats):
        """Random weights leave the 27-way softmax near 1/27, under
        rcnn_score_thr, and the NMS would see no candidate: scale fc_cls
        so that the logits' spread is 3."""
        logits, _ = head(roi_feats)
        head.fc_cls.weight.mul_(3.0 / logits.float().std().item())

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
        """Fieldwise within 1e-4 of the image size, or the same rectangle
        in its other description (a tie of w and h swaps them and turns the
        angle by 90 degrees; a tie at the le90 wrap turns it by 180): the
        corners agree up to a cyclic shift, within 1e-4 of the box's
        coordinates. With ``scores`` (card, host), boxes whose scores are
        within 1e-6 may also have changed places: the two devices' sigmoid
        differs in the last bit, and the merge orders by score."""
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
                log(f"[e2e fp32] rgb {what}: differing boxes (card, host): "
                    f"{a[far][dist > 1][:4].tolist()} "
                    f"{b[far][dist > 1][:4].tolist()}")
        log(f"[e2e fp32] rgb {what}: {a.shape[0] - n_far} boxes equal "
            f"fieldwise (1e-4 x {IMG}), {n_far} equal as rectangles"
            f"{' or swapped at tied scores' if scores else ''} only (worst "
            f"corner distance {worst:.2f} of its limit) "
            f"{'ok' if ok else 'FAIL'}")
        return ok

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
    want = {"fused_convnext_block": 11, "dwconv_ln": 18,
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

    def timed_forwards(fn, n=10):
        """Each forward timed on its own (host clock, ended by a
        synchronize): the host's clock varies more than the device's, so
        the median and the quartiles are reported."""
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        q1, med, q3 = statistics.quantiles(walls, n=4)
        return walls, q1, med, q3

    walls, q1, dt, q3 = timed_forwards(lambda: model.simple_test(imgs, "sar"))
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
    want = {"fused_convnext_block": 11, "dwconv_ln": 18,
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

    walls, q1, joint_dt, q3 = timed_forwards(joint)
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
    walls, train_q1, train_dt, train_q3 = timed_forwards(one_step,
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

    log(json.dumps({
        "kernels": [recs[k].json(launches[k]) for k in recs],
        "launches_from": "simple_test_joint [8:4:4]; rotated_nms_mask "
                         "from aug_test('rgb') on 1 image; rotated_iou (the "
                         "R-CNN assigner), roi_align_rotated_bwd and "
                         "fused_dwconv_ln_train from one flagship train "
                         "step; hbb_iou and rotated_iou_banded (matrix "
                         "modes) run on no path",
        "train_step_launches": train_launches,
        "train_images_per_s": train_ips, "train_step_ms": train_dt * 1e3,
        "train_peak_gib": train_peak_gib, "train_losses": metrics,
        "joint_images_per_s": joint_ips, "joint_ms": joint_dt * 1e3,
        "joint_peak_gib": joint_peak_gib, "joint_stage_ms": stages,
        "joint_host_syncs": sum(joint_syncs.values()),
        "train_host_syncs": sum(train_syncs.values()),
        "sar_images_per_s": sar_ips, "sar_peak_gib": peak_gib,
        "card": smi}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
