"""Convergence runs of the PyTorch port on the synthetic harness.

Trains ``configs/convergence_synth.py`` in bf16 through the port's train
entry point (``sm3det_tpu_torch.tools.train.main``) on the CUDA card and
prints each held-out eval's mAP50 per modality beside the JAX package's
records (``docs/evidence/convergence_*_eval.txt``):

- ``--long``: one run to 1500 iterations with the settings of the JAX
  package's long record (``convergence_long_*``: bf16, the step LR's drop
  at 1200, an eval every 250 iterations);
- ``--seeds 0 1 2``: one 600-iteration run a seed with the config as it is
  (an eval every 100 iterations), then the spread over the seeds of each
  eval's mAP50.

SAR is scored by VOC mAP, as in the records. The card's name and power
limit are printed first. Trains under ``work_dirs/torch_convergence``
(removed at the end) and writes every eval's mAP50 as JSON to ``--out``.

    python3 tools/profiling/torch_convergence.py --long --seeds 0 1 2 \
        [--out work_dirs/torch_convergence.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CFG = "configs/convergence_synth.py"
WORK = "work_dirs/torch_convergence"
RECORDS = (("long bf16", "docs/evidence/convergence_long_eval.txt"),
           ("bf16", "docs/evidence/convergence_bf16_eval.txt"),
           ("fp32", "docs/evidence/convergence_synth_eval.txt"))
MODS = ("sar", "rgb", "ifr")


def read_records():
    """{name: {iteration: (sar, rgb, ifr) mAP50}} of RECORDS."""
    out = {}
    for name, path in RECORDS:
        rec = {}
        with open(os.path.join(ROOT, path)) as f:
            for line in f:
                m = re.match(r"eval\[(\w+)\] @ (\d+): \{'mAP50': ([0-9.e-]+)",
                             line)
                if m:
                    rec.setdefault(int(m.group(2)), {})[m.group(1)] = \
                        float(m.group(3))
        out[name] = {it: tuple(v.get(k) for k in MODS)
                     for it, v in rec.items()}
    return out


def run(tool, seed, iters, extra):
    """One run of the train entry point: (table {iteration: (sar, rgb,
    ifr)}, seconds, first and last log lines)."""
    wd = os.path.join(WORK, f"seed{seed}_{iters}")
    t0 = time.perf_counter()
    res = tool.main([CFG, "--work-dir", wd, "--seed", str(seed),
                     "--max-iters", str(iters), "--cfg-options",
                     "model.compute_dtype=bfloat16", "evaluation.metric=mAP",
                     *extra])
    secs = time.perf_counter() - t0
    got = {}
    for it, name, r, _ in res["stats"]["evals"]:
        got.setdefault(it, {})[name] = float(r["mAP50"])
    lines = res["stats"]["log_lines"]
    shutil.rmtree(wd, ignore_errors=True)
    return ({it: tuple(got[it].get(k) for k in MODS) for it in sorted(got)},
            secs, lines[0], lines[-1])


def fmt(row):
    return " / ".join("-" if v is None else f"{v:.3f}" for v in row)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--long", action="store_true")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default="work_dirs/torch_convergence.json")
    args = p.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    from sm3det_tpu_torch.tools import train as tool
    records = read_records()
    out = dict(card=smi, long=None, seeds={})
    if args.long:
        table, secs, first, last = run(
            tool, 0, 1500, ["evaluation.interval=250",
                            "lr_config.step=[1200]"])
        rec = records["long bf16"]
        for it, row in table.items():
            ref = rec.get(it)
            print(f"[long] @ {it}: mAP50 sar / rgb / ifr {fmt(row)}"
                  + (f" (JAX long record {fmt(ref)})" if ref else ""),
                  flush=True)
        print(f"[long] 1500 iterations in {secs:.1f} s; loss "
              f"{first['loss']} at {first['iter']} -> {last['loss']} at "
              f"{last['iter']}", flush=True)
        out["long"] = dict(map50={str(k): v for k, v in table.items()},
                           seconds=secs, first_loss=first["loss"],
                           last_loss=last["loss"])
    for seed in args.seeds:
        table, secs, first, last = run(tool, seed, 600, [])
        out["seeds"][str(seed)] = {str(k): v for k, v in table.items()}
        for it, row in table.items():
            refs = "; ".join(f"JAX {n} {fmt(r[it])}" for n, r in
                             records.items() if n != "long bf16" and it in r)
            print(f"[seed {seed}] @ {it}: mAP50 sar / rgb / ifr {fmt(row)}"
                  f" ({refs})", flush=True)
        print(f"[seed {seed}] 600 iterations in {secs:.1f} s; loss "
              f"{first['loss']} -> {last['loss']}", flush=True)
    if len(args.seeds) > 1:
        its = sorted(set.intersection(*(set(t) for t in
                                        out["seeds"].values())), key=int)
        for it in its:
            rows = [out["seeds"][str(s)][it] for s in args.seeds]
            spread = []
            for m in range(3):
                vals = [r[m] for r in rows if r[m] is not None]
                spread.append(f"{MODS[m]} mean {statistics.mean(vals):.3f} "
                              f"min {min(vals):.3f} max {max(vals):.3f}")
            print(f"[spread] @ {it} over seeds {args.seeds}: "
                  + "; ".join(spread), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
