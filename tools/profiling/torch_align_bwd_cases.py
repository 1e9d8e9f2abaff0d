#!/usr/bin/env python3
"""Row 8 (the pyramid rotated RoI align's feature gradient, CUDA) timed on
one card, on three sets of RoIs, for one or more checkouts of the
repository: to compare two commits inside one call.

Run from the root of the repository on a machine with a card:

    python3 tools/profiling/torch_align_bwd_cases.py [--trees A B B A]
        [--iters 10] [--seed 0]

Each tree (a directory holding ``sm3det_tpu_torch``; default: this
repository) runs in its own process, in the order given, and builds its
own kernels. Shapes are the train step's (one R-CNN branch: 1024 RoIs of
2 images, g (1024, 7, 7, 256) bf16 and fp32, four levels of 800^2 at
strides 4-32); the RoI sets are those of ``chip_smoke.py`` phase 3:
``random`` (log-uniform sides of 8-720 px, some outside, some of no size),
``one_centre`` (every RoI on one point, 24-60 px) and ``long_thin``
(aspect 1:4 to 1:40). Each case is run twice (bit-equal runs are
reported) and timed with CUDA events over ``--iters`` launches after a
warm-up. It prints one JSON line a tree, and the card's name and power
limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
IMG = 800


def worker(tree: str, iters: int, seed: int) -> dict:
    sys.path.insert(0, tree)
    import torch

    from sm3det_tpu_torch.ops.cuda import roi_align_kernel as rak
    from sm3det_tpu_torch.ops.roi_align_rotated import route_levels

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    n = 1024
    side = 8 * 2 ** (u(n) * 6.5)
    asp = 2 ** ((u(n) - 0.5) * 3)
    rois = torch.stack([
        torch.randint(0, 2, (n,), generator=gen, device=dev).float(),
        (u(n) * 1.2 - 0.1) * IMG, (u(n) * 1.2 - 0.1) * IMG, side * asp,
        side / asp, (u(n) - 0.5) * 3.14], -1)
    rois[::11, 1:] = 0.0
    rois[5::50, 1:3] = -3.0 * IMG
    crowd = rois.clone()
    crowd[:, 0] = 0.0
    crowd[:, 1:3] = IMG / 2
    crowd[:, 3:5] = 24 + u(n, 2) * 36
    thin = rois.clone()
    thin[:, 3] = IMG * (0.2 + 0.6 * u(n))
    thin[:, 4] = thin[:, 3] / (4 + 36 * u(n))
    shapes = [(2, IMG // s, IMG // s, 256) for s in (4, 8, 16, 32)]
    out = {"tree": tree, "card": torch.cuda.get_device_name(0)}
    for case, rr in (("random", rois), ("one_centre", crowd),
                     ("long_thin", thin)):
        lv = route_levels(rr)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.randn(n, 7, 7, 256, generator=gen, device=dev) \
                .to(dtype)

            def run():
                return rak.roi_align_rotated_pyramid_bwd(g, rr, lv, shapes,
                                                         dtype)
            a, b = run(), run()
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                run()
            t1.record()
            torch.cuda.synchronize()
            key = f"{case}_{str(dtype)[6:]}"
            out[key + "_ms"] = t0.elapsed_time(t1) / iters
            out[key + "_bit_equal_runs"] = same
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.iters, args.seed)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    rc = 0
    for tree in (str(Path(t).resolve()) for t in args.trees):
        p = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", tree,
             "--iters", str(args.iters), "--seed", str(args.seed)],
            capture_output=True, text=True, cwd=tree)
        lines = p.stdout.strip().splitlines()
        print(lines[-1] if p.returncode == 0 and lines else
              json.dumps({"tree": tree, "rc": p.returncode,
                          "error": p.stderr[-2000:]}), flush=True)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
