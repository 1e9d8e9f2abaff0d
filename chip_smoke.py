#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: requires a CUDA card; prints its name and power limit;
2. build: compiles the CUDA kernels from ``sm3det_tpu_torch/ops/cuda/csrc``
   and prints the nvcc time and each kernel's registers and shared memory;
3. kernels: holds every kernel of the SAR path against its plain PyTorch
   version on the card, at the slice's shapes (8 images of 800^2), in fp32
   and bf16, and times kernel, plain version and a PyTorch library call;
4. end to end: one 800^2 image in fp32 on the card against the same model
   on the host (features, head outputs, and detections from the same head
   outputs); then the full-width 8 x 800^2 bf16 ``simple_test(imgs, "sar")``
   with the launch counts of every kernel, images/s and peak memory.

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
# stage geometry of ConvNeXt-T at 800^2: (H = W, C, dense blocks, MoE
# blocks, LayerNorms: stem, downsample into the next stage, output)
STAGES = [(200, 96, 3, 0, 3), (100, 192, 3, 0, 2), (50, 384, 4, 5, 2),
          (25, 768, 1, 2, 1)]


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
    shapes the SAR forward gives it, weighted by its launches there."""

    def __init__(self, name, source, replaces, library, sources=None):
        self.name, self.source, self.replaces = name, source, replaces
        self.sources = sources or [source]
        self.library = library
        self.ms = self.plain_ms = self.bound = 0.0
        self.library_ms = 0.0 if library else None
        self.err = 0.0
        self.bound_kind = {}

    def add(self, n, ms, plain_ms, bound, kind, lib_ms):
        self.ms += n * ms
        self.plain_ms += n * plain_ms
        self.bound += n * bound
        self.bound_kind[kind] = self.bound_kind.get(kind, 0) + n * bound
        if self.library_ms is not None:
            self.library_ms += n * lib_ms

    def json(self, launches):
        return {"name": self.name, "route": "cuda", "source": self.source,
                "sources": self.sources,
                "replaces": self.replaces, "launches": launches,
                "max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound,
                "bound_by": max(self.bound_kind, key=self.bound_kind.get),
                "library_ms": self.library_ms, "library": self.library}


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

    from sm3det_tpu_torch.models.detectors.trisource import (
        DEFAULT_MODEL_CFG, TriSourceDetector)
    from sm3det_tpu_torch.models.moe import MoELayer, group_aligned_dispatch
    from sm3det_tpu_torch.models.moe import stable_topk
    from sm3det_tpu_torch.ops.cuda import convnext_block_kernel as cbk
    from sm3det_tpu_torch.ops.cuda import hbb_iou_kernel as hik
    from sm3det_tpu_torch.ops.cuda import moe_groupgemm_kernel as mgk

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
            "F.conv2d(groups=C) + F.layer_norm"),
        "fused_convnext_block": KernelRecord(
            "fused_convnext_block",
            "sm3det_tpu_torch/ops/cuda/csrc/grouped_ffn.cu",
            "sm3det_tpu/ops/pallas/convnext_block_kernel.py:313",
            "F.conv2d(groups=C) + F.layer_norm + F.linear + F.gelu + "
            "F.linear + residual",
            sources=["sm3det_tpu_torch/ops/cuda/csrc/dwconv_ln.cu",
                     "sm3det_tpu_torch/ops/cuda/csrc/grouped_ffn.cu"]),
        "moe_ffn_grouped": KernelRecord(
            "moe_ffn_grouped",
            "sm3det_tpu_torch/ops/cuda/csrc/grouped_ffn.cu",
            "sm3det_tpu/ops/pallas/moe_groupgemm_kernel.py:42", None),
        "hbb_iou": KernelRecord(
            "hbb_iou", "sm3det_tpu_torch/ops/cuda/csrc/hbb_iou.cu",
            "sm3det_tpu/ops/pallas/hbb_iou_kernel.py:29", None),
        "fused_layernorm": KernelRecord(
            "fused_layernorm", "sm3det_tpu_torch/ops/cuda/csrc/layernorm.cu",
            "sm3det_tpu/ops/pallas/convnext_block_kernel.py:66",
            "F.layer_norm"),
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
                recs["fused_layernorm"].add(n_ln, ms, pms, b, k, lms)
                log(f"[time]   fused_layernorm {shape}: kernel {ms:.4f} ms, "
                    f"plain {pms:.4f} ms, library {lms:.4f} ms, bound "
                    f"{b:.4f} ms ({k})")

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
                recs["moe_ffn_grouped"].add(n_moe, ms, pms, b, k, 0.0)
                log(f"[time]   moe_ffn_grouped {sshape}: kernel {ms:.4f} ms, "
                    f"plain {pms:.4f} ms, bound {b:.4f} ms ({k}); "
                    f"{s} slots for {n_pix * topk} routes")

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
    del model, host, feats_d, feats_h, cls_d, reg_d, cls_h, reg_h
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
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[e2e bf16] launches in one forward: {launches}")
    want = {"fused_convnext_block": 11, "dwconv_ln": 18,
            "moe_ffn_grouped": 7, "fused_layernorm": 8}
    for k, v in launches.items():
        if v <= 0 or (k in want and v != want[k]):
            failures.append(f"launches {k}={v}")
    ok_out = dets.shape == (N_IMGS, 100, 5) and \
        bool(torch.isfinite(dets).all()) and int(valid.sum()) > 0
    log(f"[e2e bf16] dets {tuple(dets.shape)}, {int(valid.sum())} valid, "
        f"finite {bool(torch.isfinite(dets).all())}")
    if not ok_out:
        failures.append("bf16 outputs")
    # each forward timed on its own (host clock, ended by a synchronize):
    # the host's clock varies more than the device's, so the median and
    # the quartiles are reported
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.simple_test(imgs, "sar")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    q1, dt, q3 = statistics.quantiles(walls, n=4)
    head_ms = cuda_ms(torch, lambda: model.head_sar(imgs), iters=3)
    cls_o, reg_o = model.head_sar(imgs)
    post_ms = cuda_ms(torch, lambda: model.get_bboxes_sar(cls_o, reg_o),
                      iters=3)
    log(f"[e2e bf16] forward wall times (ms): "
        f"{' '.join(f'{w * 1e3:.2f}' for w in walls)}")
    log(f"[e2e bf16] {N_IMGS} x {IMG}^2: median {dt * 1e3:.2f} ms per batch "
        f"(quartiles {q1 * 1e3:.2f}-{q3 * 1e3:.2f}), {N_IMGS / dt:.2f} "
        f"images/s, peak memory {peak_gib:.2f} GiB; backbone+neck+head "
        f"{head_ms:.2f} ms, decode+NMS {post_ms:.2f} ms (CUDA events); card "
        f"{smi}")
    if failures:
        fail(f"full-width run failed: {failures}")

    log(json.dumps({"kernels": [recs[k].json(launches[k]) for k in recs],
                    "images_per_s": N_IMGS / dt, "peak_gib": peak_gib}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
