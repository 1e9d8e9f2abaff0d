"""Evaluate a detector over a dataset: the port's ``tools/test.py``.

    python -m sm3det_tpu_torch.tools.test CONFIG [CKPT] --subdataset sar \\
        [--synthetic-data] [--num-images N] [--batch-size 8] \\
        [--compute-dtype bfloat16] [--tta] [--eval mAP] \\
        [--format-only --submission-dir D] [--out J] \\
        [--cfg-options k=v ...] [--device cpu]

The config's ``model`` builds the detector (``models/builder.py``, at the
config's ``img_size``, the backbone's ``pretrained`` dropped as JAX's tool
drops it), on the CUDA card unless ``--device cpu``; any ``model.type`` but
``TriSourceDetector`` stops the tool (``check_model_type``); ``CKPT`` is a file of
``train/checkpoint.py::save_params``. The test (else val, else train)
split of the subdataset is built from the config, or synthetic images
where its paths are absent; ``stream_eval`` runs the batched forward
(``aug_test`` with ``--tta``, driven by the config's ``tta``) and maps the
detections back to the original images. Then the metric: COCO ``bbox``
for SAR, VOC ``mAP`` otherwise (or the config's ``evaluation.metric``);
or, with ``--format-only``, the COCO results json (SAR) or the DOTA Task1
zip of the patches merged into their images. SAR records carry the
dataset's COCO category id; when a configured class has none in the json,
the export raises ``ValueError`` naming it before anything is run or
written.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def check_model_type(mtype: str):
    """Stop unless ``mtype`` is ``TriSourceDetector``, the one detector
    this tool evaluates (the JAX tool builds a TriSourceDetector whatever
    the config names)."""
    if mtype == "TriSourceDetector":
        return
    if mtype == "TriSourceVariant":
        raise SystemExit(
            "tools/test.py evaluates TriSourceDetector configs: the "
            "TriSourceVariant detectors have no inference (neither has the "
            "JAX package's)")
    raise SystemExit(
        f"tools/test.py evaluates TriSourceDetector configs; use the "
        f"library API (build_detector(...).simple_test) for the "
        f"single-dataset detector {mtype!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a detector")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?")
    p.add_argument("--subdataset", default="rgb",
                   choices=["sar", "rgb", "ifr"])
    p.add_argument("--eval", default="mAP")
    p.add_argument("--format-only", action="store_true",
                   help="write the submission files instead of evaluating")
    p.add_argument("--submission-dir", default="work_dirs/submission")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-images", type=int, default=None,
                   help="evaluate the first N images (default: all)")
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--out", help="write the eval json here")
    p.add_argument("--tta", action="store_true",
                   help="test-time augmentation from the config's tta "
                        "(scales and flip directions)")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain versions on the host; the "
                        "default is the CUDA card")
    return p.parse_args(argv)


def build_eval_dataset(cfg, sub: str, synthetic: bool, min_n: int = 64):
    """The eval dataset of one modality: the config's test (else val, else
    train) section, through ``data/datasets.py::build_dataset``; synthetic
    images (seed 7, at least ``min_n``) when asked, when the section is
    synthetic or when its paths are absent."""
    from ..data.datasets import SyntheticDetDataset, build_dataset
    section = cfg.data
    for split in ("test", "val"):
        if cfg.data.get(split) is not None and \
                cfg.data[split].get(sub) is not None:
            section = cfg.data[split]
            break
    fallback = dict(n=max(64, min_n), img_size=cfg.img_size,
                    num_classes=cfg.num_classes,
                    box_type="hbb" if sub == "sar" else "obb", seed=7)
    dcfg = section[sub].to_dict()
    if synthetic or dcfg["type"] == "SyntheticDetDataset":
        return SyntheticDetDataset(**fallback)
    return build_dataset(dcfg, version=cfg.angle_version,
                         synthetic_fallback=fallback)


def main(argv=None, dataset=None, model=None):
    """Run the tool. A caller may pass its own ``dataset`` (instead of the
    config's) and ``model`` (instead of building the config's and loading
    CKPT: the one an earlier call returned). Returns a dict: ``metrics``
    (None under ``--format-only``), ``det_results``, ``annotations``,
    ``img_ids``, ``num_images``, ``seconds`` and ``img_per_s`` of the timed
    window, the loop's ``stats`` and the ``model``."""
    args = parse_args(argv)
    from ..apis.eval_loop import make_uint8_test_fn, stream_eval
    from ..data.loader import PipelineCfg
    from ..device import resolve_device
    from ..models.builder import build_detector
    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(Config.parse_cli_options(args.cfg_options))
    check_model_type(cfg.model.get("type", "TriSourceDetector"))
    device = resolve_device(args.device)
    if device.type == "cuda" and args.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if model is None:
        model = build_detector(cfg.model, device=device,
                               compute_dtype=args.compute_dtype, seed=0,
                               img_size=cfg.img_size)
        if args.checkpoint:
            from ..train.checkpoint import load_params
            load_params(args.checkpoint, model)
            print(f"loaded {args.checkpoint}")

    sub = args.subdataset
    ds = dataset if dataset is not None else build_eval_dataset(
        cfg, sub, args.synthetic_data, min_n=args.num_images or 64)
    nc = cfg.num_classes
    classes = list(getattr(ds, "CLASSES", ())) or [
        f"class_{c}" for c in range(nc)]
    cat_ids = getattr(ds, "cat_ids", None)
    if args.format_only and sub == "sar" and cat_ids:
        lacking = [classes[c] for c, cid in enumerate(cat_ids) if cid is None]
        if lacking:
            raise ValueError(
                f"--format-only: the COCO json has no category id for the "
                f"configured classes {lacking}: a results file would hold "
                f"no valid category_id for their detections")
    pipe = PipelineCfg(img_size=cfg.img_size, version=cfg.angle_version)
    S = cfg.img_size

    method = {"sar": "simple_test_sar", "rgb": "simple_test_rgb",
              "ifr": "simple_test_ifr"}[sub]
    method_kwargs = None
    if args.tta:
        # the config's tta: scales (relative) x [identity + each flip]
        tta = cfg.get("tta")
        scales = tuple(tta.get("scales", (1.0,))) if tta else (1.0,)
        flips = tuple(tta.get("flip_directions", ("horizontal",))) \
            if tta else ("horizontal",)
        method = "aug_test"
        method_kwargs = dict(subdataset=sub, scales=scales,
                             flip_directions=(None,) + flips)
        print(f"TTA: {method_kwargs}")
    bs = max(args.batch_size, 1)
    test_fn = make_uint8_test_fn(model, method, S, pipe.mean, pipe.std,
                                 method_kwargs=method_kwargs)
    n_total = len(ds) if args.num_images is None \
        else min(args.num_images, len(ds))

    # the first forward (kernel build and load, allocator warm-up) runs
    # outside the timed window
    test_fn(torch.zeros((bs, S, S, 3), dtype=torch.uint8, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()

    def progress(done, n):
        if done % (bs * 8) < bs or done >= n:
            print(f"  [{done}/{n}] "
                  f"{done / (time.perf_counter() - t0):.1f} img/s",
                  flush=True)

    stats: dict = {}
    det_results, annotations, img_ids = stream_eval(
        test_fn, ds, S, pipe.mean, num_classes=nc,
        box_dim=4 if sub == "sar" else 5,
        gt_key="hbbs" if sub == "sar" else "obbs",
        batch_size=bs, indices=range(n_total), progress=progress,
        device=device, stats=stats)
    dt = time.perf_counter() - t0
    print(f"inference: {n_total} images in {dt:.1f}s "
          f"({n_total / dt:.2f} img/s, batch={bs})", flush=True)
    if stats.get("host_images_per_s"):
        print(f"host pipeline: {stats['host_images_per_s']:.2f} img/s "
              f"(read + pre-process alone); waited "
              f"{stats['queue_wait_s']:.2f}s for it, "
              f"{stats['event_wait_s']:.2f}s for the device", flush=True)
    out = dict(metrics=None, det_results=det_results,
               annotations=annotations, img_ids=img_ids,
               num_images=n_total, seconds=dt, img_per_s=n_total / dt,
               stats=stats, model=model)

    if args.format_only and sub == "sar":
        # COCO results json: one record a detection, xywh box, score,
        # category id, image id
        from ..utils import fileio
        records = []
        for img_id, per_class in zip(img_ids, det_results):
            for c, dets in enumerate(per_class):
                for d in dets:
                    x1, y1, x2, y2, s = (float(v) for v in d[:5])
                    records.append(dict(
                        image_id=int(img_id) if str(img_id).isdigit()
                        else img_id,
                        bbox=[x1, y1, x2 - x1, y2 - y1], score=s,
                        category_id=cat_ids[c] if cat_ids else c))
        os.makedirs(args.submission_dir, exist_ok=True)
        out_json = os.path.join(args.submission_dir, "results.bbox.json")
        fileio.dump(records, out_json, file_format="json")
        print(f"COCO results written: {out_json} "
              f"({len(records)} detections)")
        return out

    if args.format_only:
        # DOTA Task1: patches ('<base>__<scale>__<x>___<y>') merged into
        # their base images, one txt a class, zipped
        from ..core.patch.split_merge import (merge_det_by_patch_ids,
                                              write_dota_submission)
        merged = merge_det_by_patch_ids(img_ids, det_results, nc,
                                        device=device)
        zip_path = write_dota_submission(
            merged, classes[:nc], args.submission_dir,
            version=cfg.angle_version)
        print(f"submission written: {zip_path} "
              f"({len(merged)} merged images)")
        out["merged"] = merged
        return out

    ev = cfg.get("evaluation")
    metric = (ev.get("metric") if ev is not None else None) or (
        "bbox" if sub == "sar" else "mAP")
    if metric == "bbox":
        from ..core.evaluation.coco_eval import coco_eval_bbox
        res = coco_eval_bbox(
            det_results, annotations,
            classwise=bool(ev.get("classwise", True)) if ev else True,
            class_names=classes)
    else:
        from ..core.evaluation.eval_map import eval_rbbox_map
        scale_ranges = ev.get("scale_ranges") if ev is not None else None
        res = eval_rbbox_map(det_results, annotations,
                             box_dim=4 if sub == "sar" else 5,
                             scale_ranges=scale_ranges, device=device)
    print(res)
    out["metrics"] = res
    if args.out:
        from ..utils import fileio
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        fileio.dump({"eval": {k: (float(v) if isinstance(
                                  v, (int, float, np.floating)) else v)
                              for k, v in res.items()
                              if np.isscalar(v)},
                     "num_images": n_total,
                     "img_per_s": n_total / dt},
                    args.out, file_format="json")
        print(f"eval dumped to {args.out}")
    return out


if __name__ == "__main__":
    main()
