"""Train a detector over a dataset: the port's ``tools/train.py``.

    python -m sm3det_tpu_torch.tools.train CONFIG [--work-dir D] \\
        [--resume-from CKPT] [--auto-resume] [--seed N] [--deterministic] \\
        [--max-iters N] [--synthetic-data] [--allow-synthetic] \\
        [--cfg-options k=v ...] [--device cpu]

The config's ``model`` builds a trainable detector (``models/builder.py``,
fp32 masters, at the config's ``img_size``; ``model.compute_dtype=bfloat16``
runs the forward in bf16), on the CUDA card unless ``--device cpu``; the
backbone's ``pretrained`` file is loaded when it exists (an mm-style
ConvNeXt checkpoint, or a HF-format InternViT one for the BabelRS
adapter). The datasets of ``data.sar``, ``data.rgb`` and ``data.ifr`` feed
``TriSourceLoader`` in the config's ``source_ratio``; AdamW with the keys
of ``lr_config`` and ``optimizer`` that JAX's tool passes (``policy``
among the 11 LR policies, ``warmup``, ``warmup_iters``, ``warmup_ratio``,
``step``, ``gamma``, ``min_lr``, ``min_lr_ratio``, ``power``; ``lr``,
``betas``, ``weight_decay``, ``grad_clip``, ``accumulate``,
``layer_decay``) and, for ``lr_config.policy="dynamic"``, DLA; the
config's ``ema_decay`` keeps an EMA of the parameters in the train state;
``model.multi_tasks_reweight`` ``"uncertainty"`` or ``"dwa"`` reweights
the task losses (``train/train_state.py``); then ``run_training``. The
work dir gets ``config.py``, ``train_log.jsonl`` and ``iter_N.pth``
checkpoints of the whole train state, from which ``--resume-from`` /
``--auto-resume`` continue. With ``evaluation`` in the config, the val split of each
modality is evaluated every ``evaluation.interval`` iterations through
``apis/eval_loop.py::stream_eval``: COCO ``bbox`` for SAR, VOC ``mAP``
otherwise, or ``evaluation.metric``.

The TriSource family trains here: ``TriSourceDetector`` and
``TriSourceVariant``, whose ``model.sar_stages`` / ``model.rot_stages``
(1 when absent) build the model and, under DLA, its (loss, subnet) map
(``train/dla.py::reweight_for_variant``). The variants have no inference,
so a variant config with ``evaluation`` set stops before the first step
(``--cfg-options evaluation=None`` trains it without eval hooks). A
single-dataset detector stops the tool: it trains through the library API
(``build_detector(..., trainable=True)`` and ``build_train_step``).

Not ported, and raising ``NotImplementedError``: several devices
(``--num-devices`` > 1, ``expert_parallel`` > 1, a distributed launch)
and a ``pretrained`` file for an LSKNet or VAN backbone. Raising too, by
name: the ``lr_config`` keys JAX's tool drops without a word
(``DROPPED_LR_KEYS``) and a ``momentum_config``, which it never reads.
"""

from __future__ import annotations

import argparse
import os

import torch

PARALLEL = "ROADMAP queue 1 item 6 (parallel)"
ZOO = "ROADMAP queue 1 item 7 (the zoo)"
# lr_config keys the JAX tool does not pass to make_optimizer: a config
# holding one would train on the schedule's defaults
DROPPED_LR_KEYS = ("periods", "restart_weights", "target_ratio",
                   "cyclic_times", "step_ratio_up", "anneal_strategy",
                   "div_factor", "final_div_factor", "start_percent")
MODALITIES = ("sar", "rgb", "ifr")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config")
    p.add_argument("--work-dir")
    p.add_argument("--resume-from")
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--deterministic", action="store_true",
                   help="fp32 matmuls and convolutions without TF32, and "
                        "PyTorch's deterministic algorithms")
    p.add_argument("--max-iters", type=int, default=None,
                   help="override max_iters (smoke runs)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="synthetic images instead of the config's data")
    p.add_argument("--allow-synthetic", action="store_true",
                   help="permit the synthetic fallback when a data root is "
                        "missing (otherwise the run stops)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="only 1 is ported")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain versions on the host; the "
                        "default is the CUDA card")
    return p.parse_args(argv)


def build_datasets(cfg, synthetic: bool, seed_offset: int = 0,
                   split: str = "train", allow_synthetic: bool = True):
    """The three modalities' datasets. ``seed_offset`` > 0 gives held-out
    synthetic draws (val splits); ``split="val"`` reads ``cfg.data.val``
    where the config has it, else the train section. A real-data run
    whose roots are missing stops unless ``allow_synthetic``."""
    from ..data.datasets import SyntheticDetDataset, build_dataset
    section = cfg.data
    if split == "val" and cfg.data.get("val") is not None:
        section = cfg.data.val
    out = []
    for i0, key in enumerate(MODALITIES):
        i = i0 + seed_offset
        dcfg = section[key] if section.get(key) is not None \
            else cfg.data[key]
        dcfg = dcfg.to_dict()
        dtype = dcfg.get("type")
        box_type = "hbb" if key == "sar" else "obb"
        fallback = dict(n=64, img_size=cfg.img_size,
                        num_classes=cfg.num_classes,
                        box_type=box_type, seed=i)
        if dtype == "StructuredSyntheticDetDataset":
            for k, v in (("img_size", cfg.img_size),
                         ("num_classes", cfg.num_classes),
                         ("box_type", box_type), ("seed", i)):
                dcfg.setdefault(k, v)
            ds = build_dataset(dcfg, version=cfg.angle_version)
        elif synthetic:
            ds = SyntheticDetDataset(**fallback)
        else:
            ds = build_dataset(dcfg, version=cfg.angle_version,
                               synthetic_fallback=fallback)
            if isinstance(ds, SyntheticDetDataset) and \
                    dtype != "SyntheticDetDataset":
                msg = (f"data root(s) missing for {split}/{key} "
                       f"({dtype}); this run would silently train/eval "
                       f"on SYNTHETIC fixtures")
                if not allow_synthetic:
                    raise SystemExit(
                        msg + " — pass --synthetic-data or "
                              "--allow-synthetic to permit this")
                print(f"WARNING: {msg} (--allow-synthetic given)",
                      flush=True)
        out.append(ds)
    return out


def check_ported(args, cfg, model_cfg):
    """Raise ``NotImplementedError`` for what the port does not train."""
    def no(what, item):
        raise NotImplementedError(
            f"{what} is not ported to sm3det_tpu_torch: {item}")

    if (args.num_devices or 1) > 1:
        no(f"--num-devices {args.num_devices}", PARALLEL)
    if int(cfg.get("expert_parallel", 1)) > 1:
        no(f"expert_parallel={cfg.expert_parallel}", PARALLEL)
    if any(os.environ.get(k) for k in ("JAX_COORDINATOR_ADDRESS",
                                       "COORDINATOR_ADDRESS",
                                       "SM3DET_DIST")):
        no("a distributed launch (init_distributed)", PARALLEL)
    mtype = model_cfg.get("type", "TriSourceDetector")
    if mtype not in ("TriSourceDetector", "TriSourceVariant"):
        raise SystemExit(
            f"tools/train.py drives the TriSource family; use the "
            f"library API for single-dataset detector {mtype!r}")
    if mtype == "TriSourceVariant" and cfg.get("evaluation") is not None:
        raise NotImplementedError(
            "the TriSourceVariant detectors have no inference (the JAX "
            "package's TriSourceVariant has no simple_test), so the eval "
            "hooks of this config's evaluation cannot run: pass "
            "--cfg-options evaluation=None to train without them")
    dropped = [k for k in DROPPED_LR_KEYS if k in cfg.lr_config]
    if dropped:
        raise NotImplementedError(
            f"lr_config keys {dropped} are not taken: the JAX package's "
            f"tools/train.py does not pass them on, so its schedule runs on "
            f"their defaults")
    if cfg.get("momentum_config") is not None:
        raise NotImplementedError(
            "momentum_config is not taken: the JAX package's tools/train.py "
            "never reads it (make_optimizer's momentum_policy is library "
            "API)")
    ld = cfg.optimizer.get("layer_decay")
    if ld is not None and not (hasattr(ld, "to_dict") and {
            "rate", "num_layers"} <= set(ld.to_dict())):
        raise ValueError(f"optimizer.layer_decay={ld!r}: a dict(rate, "
                         f"num_layers)")


def make_eval_fns(cfg, args, pipes, device):
    """One eval hook a modality, ``fn(state) -> metrics``, over the val
    split's first ``evaluation.num_images`` images (all with None or 0).
    The hooks run an inference copy of the config's model (its compute
    dtype, eval mode) that takes the state's parameters before each
    pass."""
    from ..apis.eval_loop import make_uint8_test_fn, stream_eval
    from ..models.builder import build_detector

    ev = cfg.evaluation
    n_eval = ev.get("num_images", 16)
    n_eval = int(n_eval) if n_eval else 0
    val_sets = build_datasets(
        cfg, args.synthetic_data, seed_offset=int(ev.get("seed_offset", 0)),
        split="val", allow_synthetic=args.allow_synthetic)
    scale_ranges = ev.get("scale_ranges")
    eval_bs = int(ev.get("batch_size", 8))
    eval_workers = int(ev.get("num_workers", 4))
    eval_model = build_detector(cfg.model, device=device,
                                img_size=cfg.img_size)
    synced = {"step": None}

    def sync(state):
        if synced["step"] == state.opt.step:
            return
        with torch.no_grad():
            for k, p in eval_model.named_parameters():
                p.copy_(state.params[k])
        synced["step"] = state.opt.step

    def make(sub, ds, pipe):
        method = {"sar": "simple_test_sar", "rgb": "simple_test_rgb",
                  "ifr": "simple_test_ifr"}[sub]
        tfn = make_uint8_test_fn(eval_model, method, cfg.img_size,
                                 pipe.mean, pipe.std)
        box_dim = 4 if sub == "sar" else 5

        def run(state):
            sync(state)
            n = min(n_eval, len(ds)) if n_eval > 0 else len(ds)
            dets, anns, _ = stream_eval(
                tfn, ds, cfg.img_size, pipe.mean,
                num_classes=cfg.num_classes, box_dim=box_dim,
                gt_key="hbbs" if sub == "sar" else "obbs",
                batch_size=eval_bs, indices=range(n),
                num_workers=eval_workers, device=device)
            # SAR is scored by the COCO bbox protocol, RGB and infrared by
            # VOC mAP, unless the config names one metric
            metric = ev.get("metric") or ("bbox" if sub == "sar" else "mAP")
            if metric == "bbox":
                from ..core.evaluation.coco_eval import coco_eval_bbox
                return coco_eval_bbox(dets, anns, logger=None)
            from ..core.evaluation.eval_map import eval_rbbox_map
            return eval_rbbox_map(dets, anns, box_dim=box_dim,
                                  scale_ranges=scale_ranges, logger=None,
                                  device=device)

        return run

    return {sub: make(sub, val_sets[i], pipes[i])
            for i, sub in enumerate(MODALITIES)}


def main(argv=None):
    """Run the tool. Returns a dict: the final ``state``, ``start_iter``,
    ``max_iters``, ``work_dir``, the loop's ``stats``
    (``train/loop.py::run_training``), the loader's ``loader_stats``
    (``batches``, ``host_busy_s``), the ``model`` and ``lr_scales`` (each
    parameter's layer-decay scale, as the optimizer applies it)."""
    args = parse_args(argv)
    from ..data.loader import PipelineCfg, TriSourceLoader
    from ..device import resolve_device
    from ..models.builder import build_detector, normalize_model_cfg
    from ..models.detectors.trisource_variants import TriSourceVariant
    from ..train.checkpoint import (convnext_torch_to_port,
                                    find_latest_checkpoint,
                                    internvit_hf_to_port,
                                    load_torch_state_dict, load_train_state)
    from ..train.dla import (DEFAULT_REWEIGHT_LOSSES, make_dla_config,
                             reweight_for_variant)
    from ..train.loop import run_training
    from ..train.optim import make_optimizer
    from ..train.train_state import (batch_to, build_train_step,
                                     init_train_state)
    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(Config.parse_cli_options(args.cfg_options))
    device = resolve_device(args.device)
    model_cfg = normalize_model_cfg(cfg.model.to_dict())
    check_ported(args, cfg, model_cfg)
    lr_cfg = cfg.lr_config
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/run")
    os.makedirs(work_dir, exist_ok=True)
    cfg.dump(os.path.join(work_dir, "config.py"))

    seed = args.seed if args.seed is not None else cfg.get("seed", 0)
    if args.deterministic:
        # no TF32 in fp32 matmuls and convolutions, and PyTorch's
        # deterministic scatter-adds (the backward of gathers), so that a
        # run and its resumed twin sum in the same order
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True, warn_only=True)

    datasets = build_datasets(cfg, args.synthetic_data,
                              allow_synthetic=args.allow_synthetic)
    ratio = list(cfg.source_ratio)
    pipes = [PipelineCfg.from_config(
                 cfg.data[k], img_size=cfg.img_size,
                 version=cfg.angle_version,
                 max_gt=cfg.data[k].get("max_gt", 256))
             for k in MODALITIES]
    loader_stats: dict = {}
    loader = TriSourceLoader(datasets, ratio, pipes, seed=seed,
                             pin_memory=device.type == "cuda",
                             stats=loader_stats)
    data_iter = iter(loader)
    try:
        # the JAX tool initialises its parameters on the first batch, so
        # its iteration 0 trains on batch 1 (and a resumed run starts the
        # loader over): the same batches are fed here
        next(data_iter)

        model = build_detector(cfg.model, device=device, seed=seed,
                               trainable=True, img_size=cfg.img_size)
        pretrained = model_cfg["backbone"].get("pretrained")
        btype = model_cfg["backbone"].get("type", "ConvNeXt")
        if pretrained and os.path.exists(pretrained):
            # the loader by backbone type (JAX's tool hands every file to
            # its ConvNeXt mapping)
            if btype.startswith("ConvNeXt"):
                to_port = convnext_torch_to_port
            elif btype == "InternViTAdapter":
                to_port = internvit_hf_to_port
            else:
                raise NotImplementedError(
                    f"a pretrained {btype} backbone is not read by "
                    f"sm3det_tpu_torch: its loader waits for the file "
                    f"({ZOO})")
            model.load_state_dict(to_port(load_torch_state_dict(pretrained),
                                          model.state_dict()))
            print(f"loaded pretrained backbone from {pretrained}")

        dla_cfg = None
        if lr_cfg.get("policy") == "dynamic":
            extra = lr_cfg.get("extra_args") or {}
            # a variant's loss map from the stage numbers it was built with
            reweight = reweight_for_variant(model.sar_stages,
                                            model.rot_stages) \
                if isinstance(model, TriSourceVariant) \
                else DEFAULT_REWEIGHT_LOSSES
            dla_cfg = make_dla_config(
                reweight=reweight,
                T=extra.get("T", 3.0), b=extra.get("b", 0.4),
                ema_beta=extra.get("ema", 0.001),
                backbone_policy=extra.get("backbone_policy", "sigmoid_kl"),
                head_policy=extra.get("head_policy", "normal"),
                warmup_iters=lr_cfg.get("warmup_iters", 500))
        gc = cfg.optimizer.get("grad_clip")
        max_iters = args.max_iters or cfg.get("max_iters", 1000)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        layer_decay = cfg.optimizer.get("layer_decay")
        if layer_decay is not None and hasattr(layer_decay, "to_dict"):
            layer_decay = layer_decay.to_dict()
        init_fn, update_fn, _ = make_optimizer(
            names, base_lr=cfg.optimizer.lr,
            weight_decay=cfg.optimizer.get("weight_decay", 0.0),
            betas=tuple(cfg.optimizer.get("betas", (0.9, 0.999))),
            grad_clip=gc.get("max_norm") if hasattr(gc, "get") else gc,
            step_iters=tuple(lr_cfg.get("step", [])),
            gamma=lr_cfg.get("gamma", 0.1),
            warmup_iters=lr_cfg.get("warmup_iters", 500),
            warmup_ratio=lr_cfg.get("warmup_ratio", 1.0 / 3),
            dla_cfg=dla_cfg, lr_policy=lr_cfg.get("policy", "step"),
            warmup=lr_cfg.get("warmup", "linear"),
            accumulate=int(cfg.optimizer.get("accumulate", 1)),
            layer_decay=layer_decay, min_lr=lr_cfg.get("min_lr"),
            min_lr_ratio=lr_cfg.get("min_lr_ratio"),
            power=lr_cfg.get("power", 1.0), max_iters=max_iters)
        reweight = model_cfg.get("multi_tasks_reweight")
        ema_decay = float(cfg.get("ema_decay", 0.0))
        state = init_train_state(model, init_fn, seed=seed + 1,
                                 dwa=reweight == "dwa", ema=bool(ema_decay))
        start_iter = 0
        resume = args.resume_from or (
            find_latest_checkpoint(work_dir) if args.auto_resume else None)
        if resume:
            state = load_train_state(resume, state)
            start_iter = int(state.opt.step)
            print(f"resumed from {resume} at iter {start_iter}")
        step = build_train_step(model, update_fn,
                                multi_tasks_reweight=reweight,
                                ema_decay=ema_decay)

        eval_fns = eval_interval = None
        if cfg.get("evaluation") is not None:
            eval_interval = cfg.evaluation.get("interval")
            eval_fns = make_eval_fns(cfg, args, pipes, device)

        stats: dict = {}
        state = run_training(
            step, state, data_iter, max_iters, work_dir,
            device_put=lambda b: batch_to(b, device),
            log_interval=cfg.get("log_interval", 50),
            checkpoint_interval=cfg.get("checkpoint_interval"),
            eval_fns=eval_fns, eval_interval=eval_interval,
            start_iter=start_iter, stats=stats)
    finally:
        data_iter.close()
    return dict(state=state, start_iter=start_iter, max_iters=max_iters,
                work_dir=work_dir, stats=stats, loader_stats=loader_stats,
                model=model, lr_scales=update_fn.lr_scales)


if __name__ == "__main__":
    main()
