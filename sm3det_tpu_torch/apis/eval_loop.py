"""Streamed, batched evaluation over a dataset.

Port of ``sm3det_tpu/apis/eval_loop.py``. Memory stays O(batch): a
producer thread reads and pre-processes images (keep-ratio resize and mean
padding, uint8 throughout, in a pool of worker threads) into a bounded
queue; the consumer uploads each uint8 batch, normalises it on the device
and runs the detector.

On the card the loop keeps one batch in flight: batch k's uint8 images go
up from pinned memory, its forward runs under ``torch.inference_mode()``,
its (dets, labels, valid) are copied into pinned host buffers with
``non_blocking=True`` and a CUDA event is recorded; only then does the
host wait for batch k-1's event and post-process it, while batch k
computes. (A ``.cpu()`` of batch k-1 would wait for batch k as well.)
The wait on that event is the loop's one host synchronisation a batch.
The tail batch repeats its last image, so every batch has one shape; the
repeats' outputs are dropped on the host.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


def preprocess_uint8(raw: Dict, S: int, mean_bgr: Sequence[float]):
    """Keep-ratio resize into S x S and pad with the mean (BGR), staying
    uint8: (img (S, S, 3) uint8, scale). The normalisation on the device
    maps the pad to ~0, as normalise-then-zero-pad does in training."""
    from ..data import transforms as T
    img = raw["img"]
    h, w = img.shape[:2]
    scale = min(S / h, S / w)
    img, _, _, _ = T.resize(img, (S, S), None, None, keep_ratio=True)
    if img.dtype != np.uint8:
        # the bilinear resize gives float32: back to uint8 (one upload
        # dtype, a quarter of the bytes)
        img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    if img.shape[:2] != (S, S):
        out = np.empty((S, S) + img.shape[2:], np.uint8)
        out[...] = np.rint(np.asarray(mean_bgr)[::-1]).astype(np.uint8)
        out[:img.shape[0], :img.shape[1]] = img
        img = out
    return np.ascontiguousarray(img), scale


def normalize_uint8(x_u8: torch.Tensor, mean: torch.Tensor,
                    std: torch.Tensor) -> torch.Tensor:
    """uint8 BGR (B, H, W, 3) -> fp32 RGB ``(x - mean) * (1 / std)``, with
    ``mean`` and ``std`` fp32 (3,) on ``x_u8``'s device: the JAX loop's
    arithmetic (the reciprocal taken in fp32, then a product), so the
    host's result equals JAX's bit for bit."""
    xf = x_u8.float().flip(-1)            # BGR -> RGB
    return (xf - mean) * (1.0 / std)


def make_uint8_test_fn(model, method: str, S: int, mean, std,
                       method_kwargs: Optional[Dict] = None):
    """``fn(x_u8)`` -> the outputs of ``model.<method>`` on the normalised
    images, ``img_shape=(S, S)``, under ``torch.inference_mode()``.
    ``method_kwargs`` go to the method (TTA's subdataset, scales and flip
    directions for ``aug_test``). The normalisation's constants go to the
    device once, on the first call: an upload from pageable memory would
    synchronise every batch."""
    fwd = getattr(model, method)
    kw = dict(method_kwargs or {})
    consts: Dict = {}

    def fn(x_u8: torch.Tensor):
        dev = x_u8.device
        if dev not in consts:
            consts[dev] = tuple(
                torch.tensor(np.asarray(v, np.float32), device=dev)
                for v in (mean, std))
        with torch.inference_mode():
            return fwd(normalize_uint8(x_u8, *consts[dev]),
                       img_shape=(S, S), **kw)
    return fn


def annotation_of(raw: Dict, gt_key: str) -> Dict:
    """The eval's annotation dict of a raw sample: difficult gts as ignore
    boxes; COCO areas and crowd regions where the dataset has them."""
    ann = dict(bboxes=raw[gt_key], labels=raw["labels"])
    if raw.get(gt_key + "_ignore") is not None:
        ann["bboxes_ignore"] = raw[gt_key + "_ignore"]
        ann["labels_ignore"] = raw["labels_ignore"]
    if raw.get("areas") is not None:
        ann["areas"] = raw["areas"]
    if raw.get(gt_key + "_crowd") is not None:
        ann["bboxes_crowd"] = raw[gt_key + "_crowd"]
        ann["labels_crowd"] = raw["labels_crowd"]
        if raw.get("areas_crowd") is not None:
            ann["areas_crowd"] = raw["areas_crowd"]
    return ann


class _Staging:
    """Two pinned host buffers of each input and output of a batch, used
    in turn, so batch k's copies never touch batch k-1's."""

    def __init__(self):
        self.bufs: Dict = {}

    def get(self, key, like: torch.Tensor, turn: int) -> torch.Tensor:
        b = self.bufs.get((key, turn))
        if b is None or b.shape != like.shape or b.dtype != like.dtype:
            b = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self.bufs[(key, turn)] = b
        return b


def stream_eval(test_fn: Callable, ds, S: int, mean_bgr, *,
                num_classes: int, box_dim: int = 5, gt_key: str = "obbs",
                batch_size: int = 8, indices: Optional[Sequence[int]] = None,
                num_workers: int = 4,
                progress: Optional[Callable[[int, int], None]] = None,
                device=None, stats: Optional[Dict] = None
                ) -> Tuple[List, List, List]:
    """Batched inference over ``ds[indices]`` with O(batch) memory.

    ``test_fn(x_u8)`` takes a uint8 (B, S, S, 3) tensor on ``device`` (the
    card unless ``"cpu"``) and returns (dets (B, N, box_dim + 1), labels, valid). Returns
    (det_results, annotations, img_ids): per image, a per-class list of
    (n, box_dim + 1) float32 detections in the original image's
    coordinates, the eval annotation dicts and the image ids.

    ``stats``, if given, receives ``batches``, ``host_busy_s`` (the
    producer's read + pre-process time), ``host_images_per_s`` (images
    over that time), ``queue_wait_s`` (the consumer waiting for the
    producer) and ``event_wait_s`` / ``event_waits`` (waits on the card).
    """
    device = resolve_device(device)
    on_card = device.type == "cuda"
    idxs = list(indices) if indices is not None else list(range(len(ds)))
    n_total = len(idxs)
    det_results: List[List[np.ndarray]] = []
    annotations: List[Dict] = []
    img_ids: List[str] = []
    st = stats if stats is not None else {}
    st.update(batches=0, host_busy_s=0.0, queue_wait_s=0.0,
              event_wait_s=0.0, event_waits=0)
    if n_total == 0:
        return det_results, annotations, img_ids
    bs = max(batch_size, 1)
    bq: "queue.Queue" = queue.Queue(maxsize=2)
    producer_exc: list = []
    busy = [0.0]

    def producer():
        # the sentinel goes in even on error, so the consumer never blocks
        # forever; the error is raised in the caller
        try:
            with ThreadPoolExecutor(max(num_workers, 1)) as pool:
                for start in range(0, n_total, bs):
                    t0 = time.perf_counter()
                    chunk = idxs[start:start + bs]
                    raws = list(pool.map(ds.get_raw, chunk))
                    pre = list(pool.map(
                        lambda r: preprocess_uint8(r, S, mean_bgr), raws))
                    imgs = np.stack([p[0] for p in pre])
                    if len(chunk) < bs:     # the tail: one batch shape
                        imgs = np.concatenate(
                            [imgs, np.repeat(imgs[-1:], bs - len(chunk), 0)])
                    busy[0] += time.perf_counter() - t0
                    bq.put((raws, pre, imgs))
        except BaseException as e:          # noqa: BLE001
            producer_exc.append(e)
        finally:
            bq.put(None)

    threading.Thread(target=producer, daemon=True).start()
    done = 0
    ncol = box_dim + 1
    staging = _Staging()

    def consume(pending):
        nonlocal done
        raws, pre, outs, event = pending
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()
            st["event_wait_s"] += time.perf_counter() - t0
            st["event_waits"] += 1
        dets_b, labels_b, valid_b = (o.numpy() for o in outs)
        done += len(raws)
        if progress is not None:
            progress(done, n_total)
        for j, (raw, (_, scale)) in enumerate(zip(raws, pre)):
            # compact to the valid rows, then fp32, then back to the
            # original image's coordinates
            v = valid_b[j]
            dets = dets_b[j][v, :ncol].astype(np.float32, copy=True)
            labels = labels_b[j][v]
            dets[:, :4] /= scale
            det_results.append(
                [dets[labels == c] for c in range(num_classes)])
            annotations.append(annotation_of(raw, gt_key))
            img_ids.append(str(raw.get("img_id", len(img_ids))))

    def launch(imgs: np.ndarray, turn: int):
        x = torch.from_numpy(imgs)
        if not on_card:
            outs = test_fn(x.to(device))
            return tuple(o.detach() for o in outs), None
        pinned = staging.get("in", x, turn)
        pinned.copy_(x)
        outs = test_fn(pinned.to(device, non_blocking=True))
        host = []
        for k, o in enumerate(outs):
            h = staging.get(k, o, turn)
            h.copy_(o, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record()
        return tuple(host), event

    # one batch in flight: batch k is launched before batch k-1 is read
    pending = None
    turn = 0
    while True:
        t0 = time.perf_counter()
        item = bq.get()
        st["queue_wait_s"] += time.perf_counter() - t0
        if item is not None:
            raws, pre, imgs = item
            outs, event = launch(imgs, turn)
            turn ^= 1
            st["batches"] += 1
        if pending is not None:
            consume(pending)
        if item is None:
            break
        pending = (raws, pre, outs, event)
    if producer_exc:
        raise producer_exc[0]
    st["host_busy_s"] = busy[0]
    st["host_images_per_s"] = n_total / busy[0] if busy[0] > 0 else None
    return det_results, annotations, img_ids
