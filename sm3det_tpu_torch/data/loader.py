"""The train batch loader: per-sample pipeline and multi-source batches.

Port of ``sm3det_tpu/data/loader.py``:

- ``PipelineCfg``: per-modality image size, normalisation (BGR input, RGB
  order after the channel swap) and augmentation flags, built from a
  ``data.<modality>`` config dict with ``from_config``;
- ``run_pipeline``: resize -> random flip -> (polygon random rotate) ->
  (random crop) -> normalise -> pad -> fixed-size gts, in numpy;
- ``TriSourceLoader``: an infinite iterator of
  ``{"sar": {img (Ns, S, S, 3) fp32, gt_bboxes, gt_labels, gt_mask},
  "rgb": {img, gt_obbs, gt_labels, gt_mask}, "ifr": {...}}`` batches.

Each sample's ``RandomState`` is keyed by (seed, step, global slot), so the
augmentations do not depend on which worker runs them, and batch i equals
the JAX package's batch i bit for bit. With ``num_workers > 0`` a producer
thread assembles batches with a thread pool and keeps ``prefetch`` of them
in a queue; ``num_workers=0`` is the synchronous path. With
``pin_memory=True`` the producer hands each batch over as freshly pinned
CPU tensors (the same values), so that the consumer's copy to the card can
be ``non_blocking`` and does not hold the host; the caching host allocator
reuses a pinned block only after the copies that read it have completed.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import transforms as T
from .sampler import MultiSourceSampler

MODALITIES = ("sar", "rgb", "ifr")


class PipelineCfg:
    def __init__(self, img_size: int = 800, max_gt: int = 256,
                 flip_prob=0.5, rotate_ratio: float = 0.0,
                 version: str = "le90",
                 mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375),
                 flip_directions: Sequence[str] = ("horizontal",),
                 angles_range: int = 180,
                 rotate_mode: str = "range",
                 discrete_angles: Sequence[float] = (),
                 rect_classes: Sequence[int] = (),
                 crop_size: Optional[Sequence[int]] = None):
        self.img_size = img_size
        self.max_gt = max_gt
        self.flip_prob = flip_prob
        self.rotate_ratio = rotate_ratio
        self.version = version
        self.mean = mean
        self.std = std
        self.flip_directions = tuple(flip_directions)
        self.angles_range = angles_range
        self.rotate_mode = rotate_mode
        self.discrete_angles = tuple(discrete_angles)
        self.rect_classes = tuple(rect_classes)
        self.crop_size = tuple(crop_size) if crop_size else None

    @classmethod
    def from_config(cls, dcfg, img_size: int, version: str,
                    max_gt: int = 256):
        """From a ``data.<modality>`` dict with an optional ``pipeline``
        sub-dict."""
        p = dcfg.get("pipeline", {})
        if hasattr(p, "to_dict"):
            p = p.to_dict()
        return cls(img_size=img_size, max_gt=max_gt, version=version,
                   flip_prob=p.get("flip_ratio", 0.5),
                   flip_directions=p.get("flip_directions",
                                         ("horizontal",)),
                   rotate_ratio=p.get("rotate_ratio", 0.0),
                   angles_range=p.get("angles_range", 180),
                   rotate_mode=p.get("rotate_mode", "range"),
                   discrete_angles=p.get("discrete_angles", ()),
                   rect_classes=p.get("rect_classes", ()),
                   crop_size=p.get("crop_size"))


def run_pipeline(rng: np.random.RandomState, sample: Dict,
                 cfg: PipelineCfg, train: bool = True) -> Dict:
    """Resize -> (train: flip, rotate, crop) -> normalise -> pad -> gts
    padded to ``cfg.max_gt``: {img (S, S, 3) fp32, gt_obbs (max_gt, 5) or
    gt_bboxes (max_gt, 4), gt_labels, gt_mask}."""
    img = sample["img"]
    obbs = sample.get("obbs")
    hbbs = sample.get("hbbs")
    labels = sample["labels"]

    img, obbs, hbbs, _ = T.resize(
        img, (cfg.img_size, cfg.img_size), obbs, hbbs, keep_ratio=True)
    if train:
        img, obbs, hbbs, _ = T.random_flip(
            rng, img, obbs, hbbs, prob=cfg.flip_prob, version=cfg.version,
            direction=cfg.flip_directions)
        if cfg.rotate_ratio > 0 and obbs is not None:
            img, obbs, labels = T.poly_random_rotate(
                rng, img, obbs, labels, rotate_ratio=cfg.rotate_ratio,
                angles_range=cfg.angles_range, mode=cfg.rotate_mode,
                discrete_angles=cfg.discrete_angles,
                rect_classes=cfg.rect_classes, version=cfg.version)
        if cfg.crop_size is not None and obbs is not None:
            cimg, cobbs, clabels = T.random_crop(
                rng, img, obbs, labels, cfg.crop_size,
                allow_negative=False)
            if cimg is not None:    # else: keep the uncropped sample
                img, obbs, labels = cimg, cobbs, clabels
    img = T.normalize(img, cfg.mean, cfg.std)
    img = T.pad_to(img, (cfg.img_size, cfg.img_size))

    out = {"img": img.astype(np.float32)}
    if obbs is not None:
        b, lab, m = T.pad_gt(obbs, labels, cfg.max_gt, 5)
        out.update(gt_obbs=b, gt_labels=lab, gt_mask=m)
    else:
        b, lab, m = T.pad_gt(hbbs, labels, cfg.max_gt, 4)
        out.update(gt_bboxes=b, gt_labels=lab, gt_mask=m)
    return out


class TriSourceLoader:
    """Infinite iterator over [sar * k, rgb * m, ifr * n] batches.

    ``batches_per_step`` scales the composition (data-parallel replicas on
    one host); ``host_id`` / ``num_hosts`` select this host's share of the
    global batch, and each sample's draws are keyed by its global slot so
    that the hosts' shares put together are the one-host batch.
    ``stats``, if given, receives ``batches`` and ``host_busy_s`` (the
    time spent loading and assembling batches, summed over batches)."""

    def __init__(self, datasets: Sequence, source_ratio: Sequence[int],
                 pipelines: Sequence[PipelineCfg],
                 batches_per_step: int = 1,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 num_workers: int = 4, prefetch: int = 2,
                 pin_memory: bool = False, stats: Optional[Dict] = None):
        assert len(datasets) == 3 and len(source_ratio) == 3
        self.datasets = list(datasets)
        self.ratio = list(source_ratio)
        self.pipelines = list(pipelines)
        self.batches_per_step = batches_per_step
        self.sampler = MultiSourceSampler(
            [len(d) for d in datasets],
            [r * batches_per_step for r in source_ratio],
            seed=seed, host_id=host_id, num_hosts=num_hosts)
        self.seed = seed * 7919
        local_counts = [r * batches_per_step for r in source_ratio]
        self._gslot = []
        goff = 0
        for s, r_local in enumerate(local_counts):
            base = goff + host_id * r_local
            self._gslot.extend(base + p for p in range(r_local))
            goff += r_local * num_hosts
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.pin_memory = pin_memory
        self.stats = stats if stats is not None else {}
        self.stats.update(batches=0, host_busy_s=0.0)

    def _load_one(self, src: int, idx: int, step: int, slot: int) -> Dict:
        rng = np.random.RandomState(
            (self.seed + step * 1000003 + slot * 7907) % (2 ** 31 - 1))
        raw = self.datasets[src].get_raw(idx)
        return run_pipeline(rng, raw, self.pipelines[src])

    def _assemble(self, samples_by_src: List[List[Dict]]) -> Dict:
        out = {}
        for mi, mod in enumerate(MODALITIES):
            samples = samples_by_src[mi]
            out[mod] = {k: np.stack([s[k] for s in samples])
                        for k in samples[0]}
        if self.pin_memory:
            import torch
            out = {m: {k: torch.from_numpy(v).pin_memory()
                       for k, v in d.items()} for m, d in out.items()}
        return out

    def _timed(self, t0: float):
        self.stats["batches"] += 1
        self.stats["host_busy_s"] += time.perf_counter() - t0

    def _iter_sync(self) -> Iterator[Dict]:
        for step, batch_indices in enumerate(self.sampler):
            t0 = time.perf_counter()
            per_source: List[List[Dict]] = [[], [], []]
            for slot, (src, idx) in enumerate(batch_indices):
                per_source[src].append(
                    self._load_one(src, idx, step, self._gslot[slot]))
            batch = self._assemble(per_source)
            self._timed(t0)
            yield batch

    def __iter__(self) -> Iterator[Dict]:
        if self.num_workers <= 0:
            yield from self._iter_sync()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        errors: list = []

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def producer():
            # an error goes to the consumer as None, which raises it
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for step, batch_indices in enumerate(self.sampler):
                        if stop.is_set():
                            return
                        t0 = time.perf_counter()
                        futs = [(src, pool.submit(
                            self._load_one, src, idx, step,
                            self._gslot[slot]))
                            for slot, (src, idx) in enumerate(batch_indices)]
                        per_source: List[List[Dict]] = [[], [], []]
                        for src, f in futs:
                            per_source[src].append(f.result())
                        batch = self._assemble(per_source)
                        self._timed(t0)
                        put(batch)
            except BaseException as e:      # noqa: BLE001
                errors.append(e)
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    raise errors[0]
                yield batch
        finally:
            stop.set()
