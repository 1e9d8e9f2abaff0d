#!/usr/bin/env python3
"""Where the time of the PyTorch port's forward or train step goes, on one
CUDA card.

Run from the root of the repository on a machine with a card:

    python3 tools/profiling/torch_sar_profile.py [--path sar|joint|train]
        [--batch 8] [--size 800]

It builds the full-width ``TriSourceDetector`` (``DEFAULT_MODEL_CFG``,
bf16, random weights from ``--seed``, the ``gfl_cls`` bias raised to 0 and
the ``fc_cls`` weights scaled up so that every NMS sees real candidates),
warms the forward up and then reports on it. ``--path sar`` (the default)
is ``simple_test(imgs, "sar")`` on ``--batch`` images; ``--path joint`` is
``simple_test_joint`` on ``--batch`` SAR images and half as many RGB and
infrared images each ([8:4:4] by default). ``--path train`` is the
flagship train step (fp32 masters, bf16 forward, DLA switched on after two
warm-up steps, AdamW) on ``--batch`` images split [2:1:1] ([4:2:2] by
default), 16 gts an image.

fp32 convolutions and products run in full fp32 (TF32 off), as in
``chip_smoke.py``.

1. CUDA-event times of the stages of one forward (stem and norms, dense
   blocks, MoE blocks split into dwconv_ln, gate, dispatch + FFN +
   combine, neck, heads, and each decode + NMS), the median of ``--reps``
   forwards (for ``train``: forward with the losses, backward, AdamW +
   DLA, the median of ``--reps`` steps);
2. one forward (or step) under ``torch.profiler``: device time by kernel name, and
   the device's busy share of the forward's wall time (the union of the
   kernels' intervals over the span of the forward).

The kernel table goes to ``torch_<path>_profile.txt`` in the repository's
output directory; the summary is printed. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# the __global__ functions of sm3det_tpu_torch/ops/cuda/csrc/*.cu (the
# align backward's are stencil_kernel and tile_kernel)
PORT_KERNELS = ("dwconv_ln_kernel", "dwconv_ln_bwd_stats_kernel",
                "dwconv_ln_bwd_conv_kernel", "dwconv_ln_bwd_reduce_kernel",
                "ffn_fused_kernel", "gemm_f32_kernel",
                "hbb_iou_kernel", "hbb_nms_mask_kernel", "nms_keep_kernel",
                "layernorm_kernel", "rotated_iou_kernel",
                "roi_align_rotated_kernel", "stencil_kernel", "tile_kernel")


def stage_of(name, module):
    """Category of a module of the detector, or None to leave it untimed."""
    from sm3det_tpu_torch.models.backbones.convnext import ConvNeXtBlock
    if isinstance(module, ConvNeXtBlock):
        return "moe block (total)" if module.moe else "dense block"
    if name.endswith(".ffn.w_gate"):
        return "moe gate"
    if name.endswith(".ffn"):
        return "moe dispatch + ffn + combine (with gate)"
    if name.startswith("backbone.") and name.count(".") == 1:
        return "stem, downsample, out norms"
    if name in ("neck", "sar_bbox_head", "rgb_rpn_head", "ifr_rpn_head",
                "rgb_roi_head", "ifr_roi_head"):
        return name
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("sar", "joint", "train"),
                    default="sar")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    # as chip_smoke.py: fp32 convolutions and products in full fp32 (the
    # train step's fp32 backward of the dw7x7 + LN runs through cuDNN)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from sm3det_tpu_torch.models.detectors.trisource import (
        DEFAULT_MODEL_CFG, TriSourceDetector)
    from sm3det_tpu_torch.ops.cuda import convnext_block_kernel as cbk

    cfg = dict(DEFAULT_MODEL_CFG, compute_dtype="bfloat16")
    if args.path == "train":
        return profile_train(args, torch, cfg)
    model = TriSourceDetector(cfg, seed=args.seed)
    model.sar_bbox_head.gfl_cls.bias.fill_(0.0)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    imgs = torch.rand(args.batch, args.size, args.size, 3, generator=gen,
                      device="cuda")
    shape = (args.size, args.size)
    joint = args.path == "joint"
    if joint:
        n_half = max(args.batch // 2, 1)
        rgb, ifr = (torch.rand(n_half, args.size, args.size, 3,
                               generator=gen, device="cuda")
                    for _ in range(2))
        with torch.no_grad():
            _, x, rpn = model.head_joint(imgs, rgb, ifr)
            props, _, _ = model.get_proposals(*rpn, shape)
            rf = model.roi_feats(x, props)
            # random weights leave the softmax near 1/27, under the score
            # threshold: spread the logits so the R-CNN NMS has candidates
            for head, part in ((model.rgb_roi_head, rf[:rf.shape[0] // 2]),
                               (model.ifr_roi_head, rf[rf.shape[0] // 2:])):
                logits, _ = head(part)
                head.fc_cls.weight.mul_(3.0 / logits.float().std().item())
        del x, rpn, props, rf

    def forward():
        if joint:
            return model.simple_test_joint(imgs, rgb, ifr, img_shape=shape)
        return model.simple_test(imgs, "sar", img_shape=shape)

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        t = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall_med = statistics.median(walls)

    # ---- 1. stage times with CUDA events ---------------------------------
    marks = []          # (stage, start event, end event)
    open_ = {}

    def pre(stage):
        def hook(mod, inp):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            open_.setdefault(id(mod), []).append(ev)
        return hook

    def post(stage):
        def hook(mod, inp, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, open_[id(mod)].pop(), ev))
        return hook

    handles = []
    for name, mod in model.named_modules():
        stage = stage_of(name, mod)
        if stage:
            handles += [mod.register_forward_pre_hook(pre(stage)),
                        mod.register_forward_hook(post(stage))]
    dw = cbk.fused_dwconv_ln
    dw_marks = []

    def timed_dwconv_ln(*a, **k):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = dw(*a, **k)
        e.record()
        dw_marks.append((s, e))
        return out
    # the MoE blocks reach it through the backbone module's own import
    from sm3det_tpu_torch.models.backbones import convnext
    convnext.fused_dwconv_ln = timed_dwconv_ln

    per_rep = []
    for _ in range(args.reps):
        marks.clear()
        dw_marks.clear()
        ts = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        names = ["backbone+neck+head", "decode + NMS"]
        ts[0].record()
        if joint:
            names = ["backbone + necks + GFL and RPN heads",
                     "SAR decode + NMS", "proposal decode + NMS",
                     "RoI align", "RoI heads", "R-CNN decode + NMS"]
            with torch.no_grad():
                (cls_s, reg_s), x, rpn = model.head_joint(imgs, rgb, ifr)
                ts[1].record()
                model.get_bboxes_sar(cls_s, reg_s, shape)
                ts[2].record()
                props, _, pval = model.get_proposals(*rpn, shape)
                ts[3].record()
                rf = model.roi_feats(x, props)
                ts[4].record()
                logits, deltas = model.roi_logits_joint(
                    rf, rgb.shape[0], ifr.shape[0])
                ts[5].record()
                model.get_bboxes_rcnn(logits, deltas, props, pval, shape)
                ts[6].record()
        else:
            cls_s, reg_s = model.head_sar(imgs)
            ts[1].record()
            model.get_bboxes_sar(cls_s, reg_s, shape)
            ts[2].record()
        torch.cuda.synchronize()
        sums = defaultdict(float)
        for stage, s, e in marks:
            sums[stage] += s.elapsed_time(e)
        sums["moe dwconv_ln"] = sum(s.elapsed_time(e) for s, e in dw_marks)
        for i, name in enumerate(names):
            sums[name] = ts[i].elapsed_time(ts[i + 1])
        per_rep.append(sums)
    for h in handles:
        h.remove()
    convnext.fused_dwconv_ln = dw

    print(f"[profile] card {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi_line()}")
    n_imgs = args.batch + (2 * rgb.shape[0] if joint else 0)
    print(f"[profile] path {args.path}: {n_imgs} x {args.size}^2 bf16: "
          f"median forward "
          f"{wall_med:.3f} ms (host clock, no hooks, {args.reps} forwards)")
    print(f"[profile] stages, median of {args.reps} forwards (CUDA events "
          f"around each module; the hooks add host time, so the stages "
          f"include launch gaps, ms):")
    for stage in sorted(per_rep[0], key=lambda k: -per_rep[0][k]):
        vals = [r[stage] for r in per_rep]
        print(f"[profile]   {stage:42s} {statistics.median(vals):9.3f}")

    # ---- 2. one forward under the profiler -------------------------------
    return report_profile(torch, forward, args.path, wall_med)


def nvidia_smi_line():
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def report_profile(torch, run, path, wall_med):
    """``run()`` once under ``torch.profiler``: the device's busy share and
    its time by kernel, against ``wall_med``, the unprofiled median."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("port_forward"):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    # device events, less the annotation's own mirror on the device
    kernels = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.name != "port_forward"]
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in kernels)
    fwd = next((ev.time_range for ev in prof.events()
                if ev.name == "port_forward"
                and ev.device_type == torch.autograd.DeviceType.CPU), None)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_{path}_profile.txt").write_text(table)
    if not spans or fwd is None:
        print("[profile] the profiler recorded no device time: busy share "
              "not measured")
        return 0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span_us = max(fwd.end, spans[-1][1]) - min(fwd.start, spans[0][0])
    print(f"[profile] profiled {path}: wall {wall_ms:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms of {span_us / 1e3:.3f} ms "
          f"({100 * busy / span_us:.1f} %), {len(spans)} device events")
    print(f"[profile] device busy over the unprofiled median: "
          f"{busy / 1e3:.3f} / {wall_med:.3f} ms "
          f"({100 * busy / 1e3 / wall_med:.1f} %)")
    groups = defaultdict(float)
    for ev in kernels:
        n = ev.name
        group = ("port kernels (csrc/*.cu)" if any(
                     f"(anonymous namespace)::{k}" in n for k in PORT_KERNELS)
                 else "cuDNN convolutions" if "xmma" in n or "convolve" in n
                 else "other PyTorch ops")
        groups[group] += ev.time_range.elapsed_us() / 1e3
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   device time, {group:28s} {ms:8.3f} ms")
    for k in PORT_KERNELS:
        evs = [ev for ev in kernels
               if f"(anonymous namespace)::{k}" in ev.name]
        if evs:
            print(f"[profile]   device time of {k:28s} "
                  f"{sum(ev.time_range.elapsed_us() for ev in evs) / 1e3:8.3f}"
                  f" ms, {len(evs)} launches")
    by_name = defaultdict(lambda: [0.0, 0])
    for ev in kernels:
        by_name[ev.name][0] += ev.time_range.elapsed_us()
        by_name[ev.name][1] += 1
    print("[profile] device time by kernel (top 25, ms, count):")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :25]:
        print(f"[profile]   {us / 1e3:8.3f} {n:5d}  {name[:100]}")
    return 0


def profile_train(args, torch, cfg):
    """``--path train``: the flagship train step."""
    import numpy as np

    from sm3det_tpu_torch.models.detectors.trisource import TriSourceDetector
    from sm3det_tpu_torch.train.dla import make_dla_config
    from sm3det_tpu_torch.train.optim import make_optimizer
    from sm3det_tpu_torch.train.train_state import (
        batch_to, build_train_step, init_train_state, trainable_params)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import make_train_batch

    comp = (max(args.batch // 2, 1), max(args.batch // 4, 1),
            max(args.batch // 4, 1))
    model = TriSourceDetector(cfg, seed=args.seed, trainable=True)
    init_fn, update_fn, _ = make_optimizer(
        list(trainable_params(model)), base_lr=1e-4, step_iters=(80000,),
        warmup_iters=2, dla_cfg=make_dla_config(warmup_iters=2))
    state = init_train_state(model, init_fn, seed=args.seed + 1)
    step = build_train_step(model, update_fn)
    batch = batch_to(make_train_batch(np.random.RandomState(args.seed), comp,
                                      args.size, 16), "cuda")

    def run():
        nonlocal state
        state, _ = step(state, batch)

    for _ in range(3):                       # past the DLA warm-up
        run()
    torch.cuda.synchronize()
    walls, parts = [], defaultdict(list)
    for _ in range(args.reps):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    for _ in range(args.reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        masters = list(state.params.values())
        ev[0].record()
        total, losses = step.loss_fn(state.params, batch, state.gen)
        ev[1].record()
        grads = torch.autograd.grad(total, masters)
        ev[2].record()
        opt = update_fn(grads, state.opt, masters, losses)
        ev[3].record()
        torch.cuda.synchronize()
        state = state._replace(opt=opt)
        for name, i in (("forward with the losses", 0), ("backward", 1),
                        ("AdamW + DLA", 2)):
            parts[name].append(ev[i].elapsed_time(ev[i + 1]))
        del total, losses, grads
    wall_med = statistics.median(walls)
    print(f"[profile] card {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi_line()}")
    print(f"[profile] path train: [{comp[0]}:{comp[1]}:{comp[2]}] x "
          f"{args.size}^2 bf16 policy, DLA + AdamW: median step "
          f"{wall_med:.3f} ms (host clock, {args.reps} steps), "
          f"{sum(comp) / wall_med * 1e3:.2f} images/s")
    print(f"[profile] parts of a step, median of {args.reps} (CUDA events, "
          f"ms):")
    for name, vals in parts.items():
        print(f"[profile]   {name:42s} {statistics.median(vals):9.3f}")
    return report_profile(torch, run, "train", wall_med)


if __name__ == "__main__":
    sys.exit(main())
