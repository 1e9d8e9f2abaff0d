"""Datasets, on the host in numpy.

Port of ``sm3det_tpu/data/datasets.py``:

- ``DOTADataset``: a folder of DOTA TXT polygon annotations (mmrotate
  ``dota.py``), cached in a pickle; gts above ``filter_difficulty`` are
  kept as ignore boxes; the DOTA-family aliases set other class lists.
- ``HRSCDataset``: HRSC2016 XML annotations of rotated boxes.
- ``CocoDetDataset``: COCO-json horizontal boxes (SARDet-50K), with each
  gt's ``area`` and the crowd regions for the COCO protocol, and
  ``cat_ids`` (label -> COCO category id).
- ``SyntheticDetDataset``: random images and boxes from a seed, so the
  tools run without data files; ``StructuredSyntheticDetDataset``: class-
  coded rotated rectangles painted into the image, which a detector can
  learn (the convergence config).
- The wrappers ``ConcatDataset``, ``RepeatDataset`` and
  ``ClassBalancedDataset``, which ``build_dataset`` builds recursively.

``get_raw(idx)`` gives {img (H, W, 3) uint8 BGR, obbs (N, 5) or hbbs
(N, 4), labels, img_id, ...}.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.box_convert import obb2poly_np, poly2obb_np
from ..utils.image import check_image_files

# 26-class union of SARDet-50K + DOTA + DroneVehicle
SOI_CLASSES = (
    "ship", "aircraft", "car", "tank", "bridge", "harbor",
    "plane", "baseball-diamond", "ground-track-field",
    "small-vehicle", "large-vehicle", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field",
    "roundabout", "swimming-pool", "helicopter",
    "container-crane", "freight-car", "truck", "bus", "van",
    "trailer", "excavator", "helipad")

DOTA_CLASSES = (
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field",
    "roundabout", "harbor", "swimming-pool", "helicopter")
DOTA15_CLASSES = DOTA_CLASSES + ("container-crane",)
FAIR_CLASSES = (
    "Boeing737", "Boeing747", "Boeing777", "Boeing787", "C919", "A220",
    "A321", "A330", "A350", "ARJ21", "Passenger-Ship", "Motorboat",
    "Fishing-Boat", "Tugboat", "Engineering-Ship", "Liquid-Cargo-Ship",
    "Dry-Cargo-Ship", "Warship", "Small-Car", "Bus", "Cargo-Truck",
    "Dump-Truck", "Van", "Trailer", "Tractor", "Excavator",
    "Truck-Tractor", "Basketball-Court", "Tennis-Court",
    "Football-Field", "Baseball-Field", "Intersection", "Roundabout",
    "Bridge")
SSDD_CLASSES = ("ship",)
HRSC_CLASSES = ("ship",)
DRONEVEHICLE_CLASSES = ("car", "truck", "bus", "van", "freight-car")
SARDET_CLASSES = ("ship", "aircraft", "car", "tank", "bridge", "harbor")


class BaseDetDataset:
    CLASSES: Sequence[str] = ()
    box_type = "obb"   # 'obb' | 'hbb'

    def __len__(self):
        raise NotImplementedError

    def get_raw(self, idx: int) -> Dict:
        raise NotImplementedError


class DOTADataset(BaseDetDataset):
    """DOTA annotation folder: ``<img_id>.txt`` files of lines
    ``x1 y1 x2 y2 x3 y3 x4 y4 class difficulty``."""

    box_type = "obb"

    def __init__(self, ann_folder: str, img_folder: str,
                 classes: Sequence[str] = DOTA_CLASSES,
                 version: str = "le90", filter_difficulty: int = 100,
                 cache: bool = True, device=None):
        self.CLASSES = tuple(classes)
        self.cls_to_id = {c: i for i, c in enumerate(self.CLASSES)}
        self.ann_folder = ann_folder
        self.img_folder = img_folder
        self.version = version
        self.filter_difficulty = filter_difficulty
        from ..utils import fileio
        cache_path = os.path.join(ann_folder, ".sm3det_torch_cache_v2.pkl")
        if cache and os.path.exists(cache_path):
            self.infos = fileio.load(cache_path)
        else:
            self.infos = self._load_annotations()
            if cache:
                try:
                    fileio.dump(self.infos, cache_path)
                except OSError:
                    pass
        self.device = device
        self._paths = _image_paths(img_folder, self.infos,
                                   (".png", ".jpg", ".bmp", ".tif"))
        check_image_files([p for p in self._paths if p], device,
                          "DOTADataset")

    def _load_annotations(self) -> List[Dict]:
        infos = []
        for fname in sorted(os.listdir(self.ann_folder)):
            if not fname.endswith(".txt"):
                continue
            polys, labels = [], []
            polys_ign, labels_ign = [], []
            with open(os.path.join(self.ann_folder, fname)) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 9:
                        continue
                    try:
                        poly = [float(x) for x in parts[:8]]
                    except ValueError:
                        continue
                    cls = parts[8]
                    diff = int(parts[9]) if len(parts) > 9 else 0
                    if cls not in self.cls_to_id:
                        continue
                    # difficult gts stay as ignore boxes: the eval scores
                    # a detection on one as neither tp nor fp
                    if diff > self.filter_difficulty:
                        polys_ign.append(poly)
                        labels_ign.append(self.cls_to_id[cls])
                    else:
                        polys.append(poly)
                        labels.append(self.cls_to_id[cls])

            def to_obb(p):
                return poly2obb_np(np.asarray(p, np.float32),
                                   self.version) \
                    if p else np.zeros((0, 5), np.float32)

            infos.append(dict(
                img_id=fname[:-4], obbs=to_obb(polys),
                labels=np.asarray(labels, np.int32),
                obbs_ignore=to_obb(polys_ign),
                labels_ignore=np.asarray(labels_ign, np.int32)))
        return infos

    def __len__(self):
        return len(self.infos)

    def get_raw(self, idx: int) -> Dict:
        info = self.infos[idx]
        if self._paths[idx] is None:
            raise FileNotFoundError(info["img_id"])
        out = dict(img=_imread(self._paths[idx], self.device),
                   obbs=info["obbs"].copy(), labels=info["labels"].copy(),
                   img_id=info["img_id"])
        if len(info.get("obbs_ignore", ())):
            out["obbs_ignore"] = info["obbs_ignore"].copy()
            out["labels_ignore"] = info["labels_ignore"].copy()
        return out


def DOTA15Dataset(ann_folder, img_folder, **kw):
    """DOTA-v1.5: the DOTA loader with 16 classes."""
    kw.setdefault("classes", DOTA15_CLASSES)
    return DOTADataset(ann_folder, img_folder, **kw)


def FairDataset(ann_folder, img_folder, **kw):
    """FAIR1M: DOTA-format annotations, FAIR1M's classes."""
    kw.setdefault("classes", FAIR_CLASSES)
    return DOTADataset(ann_folder, img_folder, **kw)


def SSDDDataset(ann_folder, img_folder, **kw):
    """SSDD SAR ships, DOTA-format annotations."""
    kw.setdefault("classes", SSDD_CLASSES)
    return DOTADataset(ann_folder, img_folder, **kw)


def DroneVehicleDataset(ann_folder, img_folder, **kw):
    """DroneVehicle infrared, DOTA-format annotations."""
    kw.setdefault("classes", DRONEVEHICLE_CLASSES)
    return DOTADataset(ann_folder, img_folder, **kw)


class HRSCDataset(BaseDetDataset):
    """HRSC2016: one XML file an image, rotated boxes ``mbox_cx, mbox_cy,
    mbox_w, mbox_h, mbox_ang`` (le90), canonicalised into ``version``."""

    box_type = "obb"

    def __init__(self, ann_folder: str, img_folder: str,
                 classes: Sequence[str] = HRSC_CLASSES,
                 version: str = "le90", device=None):
        import xml.etree.ElementTree as ET
        self.CLASSES = tuple(classes)
        self.img_folder = img_folder
        self.version = version
        self.infos = []
        for fname in sorted(os.listdir(ann_folder)):
            if not fname.endswith(".xml"):
                continue
            root = ET.parse(os.path.join(ann_folder, fname)).getroot()
            boxes, labels = [], []
            for obj in root.iter("HRSC_Object"):
                def g(tag):
                    el = obj.find(tag)
                    return float(el.text) if el is not None else 0.0
                boxes.append([g("mbox_cx"), g("mbox_cy"), g("mbox_w"),
                              g("mbox_h"), g("mbox_ang")])
                labels.append(0)
            obbs = np.asarray(boxes, np.float32).reshape(-1, 5)
            if len(obbs):
                obbs = poly2obb_np(obb2poly_np(obbs, "le90"), self.version)
            self.infos.append(dict(
                img_id=fname[:-4], obbs=obbs,
                labels=np.asarray(labels, np.int32)))
        self.device = device
        self._paths = _image_paths(img_folder, self.infos,
                                   (".bmp", ".png", ".jpg"))
        check_image_files([p for p in self._paths if p], device,
                          "HRSCDataset")

    def __len__(self):
        return len(self.infos)

    def get_raw(self, idx: int) -> Dict:
        info = self.infos[idx]
        if self._paths[idx] is None:
            raise FileNotFoundError(info["img_id"])
        return dict(img=_imread(self._paths[idx], self.device),
                    obbs=info["obbs"].copy(), labels=info["labels"].copy(),
                    img_id=info["img_id"])


class CocoDetDataset(BaseDetDataset):
    """COCO-json horizontal boxes. ``cat_ids[label]`` is the COCO category
    id of a label (categories sorted by id)."""

    box_type = "hbb"

    def __init__(self, ann_file: str, img_folder: str,
                 classes: Optional[Sequence[str]] = None, device=None):
        from ..utils import fileio
        coco = fileio.load(ann_file, file_format="json")
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        self.CLASSES = tuple(classes) if classes else tuple(
            c["name"] for c in cats)
        cat_to_label = {}
        for c in cats:
            if c["name"] in self.CLASSES:
                cat_to_label[c["id"]] = self.CLASSES.index(c["name"])
        self.cat_ids: List[Optional[int]] = [None] * len(self.CLASSES)
        for cid, label in cat_to_label.items():
            self.cat_ids[label] = cid
        imgs = {im["id"]: im for im in coco["images"]}
        anns_by_img: Dict[int, List] = {}
        for a in coco["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.infos = []
        for img_id, im in imgs.items():
            boxes, labels, areas = [], [], []
            cboxes, clabels, careas = [], [], []
            for a in anns_by_img.get(img_id, []):
                if a["category_id"] not in cat_to_label:
                    continue
                x, y, w, h = a["bbox"]
                # the COCO protocol's area ranges read 'area' (w * h where
                # the json has only boxes)
                area = float(a.get("area", w * h))
                if a.get("iscrowd", 0):
                    # crowd regions: no gts, ignore regions of the eval
                    cboxes.append([x, y, x + w, y + h])
                    clabels.append(cat_to_label[a["category_id"]])
                    careas.append(area)
                else:
                    boxes.append([x, y, x + w, y + h])
                    labels.append(cat_to_label[a["category_id"]])
                    areas.append(area)
            self.infos.append(dict(
                file_name=im["file_name"], img_id=img_id,
                hbbs=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int32),
                areas=np.asarray(areas, np.float64),
                hbbs_crowd=np.asarray(cboxes, np.float32).reshape(-1, 4),
                labels_crowd=np.asarray(clabels, np.int32),
                areas_crowd=np.asarray(careas, np.float64)))
        self.img_folder = img_folder
        self.device = device
        check_image_files([os.path.join(img_folder, i["file_name"])
                           for i in self.infos], device, "CocoDetDataset")

    def __len__(self):
        return len(self.infos)

    def get_raw(self, idx: int) -> Dict:
        info = self.infos[idx]
        img = _imread(os.path.join(self.img_folder, info["file_name"]),
                      self.device)
        return dict(img=img, hbbs=info["hbbs"].copy(),
                    labels=info["labels"].copy(), img_id=info["img_id"],
                    areas=info["areas"].copy(),
                    hbbs_crowd=info["hbbs_crowd"].copy(),
                    labels_crowd=info["labels_crowd"].copy(),
                    areas_crowd=info["areas_crowd"].copy())


class SyntheticDetDataset(BaseDetDataset):
    """Random images and boxes, image ``idx`` from seed ``seed * 100003 +
    idx``."""

    def __init__(self, n: int = 32, img_size: int = 256,
                 num_classes: int = 26, box_type: str = "obb",
                 max_objects: int = 12, seed: int = 0):
        self.n = n
        self.img_size = img_size
        self.num_classes = num_classes
        self.box_type = box_type
        self.max_objects = max_objects
        self.seed = seed
        self.CLASSES = tuple(f"class_{i}" for i in range(num_classes))

    def __len__(self):
        return self.n

    def get_raw(self, idx: int) -> Dict:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        s = self.img_size
        img = (rng.rand(s, s, 3) * 255).astype(np.uint8)
        k = rng.randint(1, self.max_objects + 1)
        labels = rng.randint(0, self.num_classes, k).astype(np.int32)
        if self.box_type == "obb":
            obbs = np.stack([
                rng.uniform(0.15 * s, 0.85 * s, k),
                rng.uniform(0.15 * s, 0.85 * s, k),
                rng.uniform(0.05 * s, 0.2 * s, k),
                rng.uniform(0.03 * s, 0.1 * s, k),
                rng.uniform(-np.pi / 2, np.pi / 2, k)],
                -1).astype(np.float32)
            return dict(img=img, obbs=obbs, labels=labels, img_id=str(idx))
        cx = rng.uniform(0.15 * s, 0.85 * s, k)
        cy = rng.uniform(0.15 * s, 0.85 * s, k)
        w = rng.uniform(0.05 * s, 0.2 * s, k)
        h = rng.uniform(0.05 * s, 0.2 * s, k)
        hbbs = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        -1).astype(np.float32)
        return dict(img=img, hbbs=hbbs, labels=labels, img_id=str(idx))


class StructuredSyntheticDetDataset(BaseDetDataset):
    """Learnable synthetic data: 1 to ``max_objects`` rotated rectangles a
    image (axis-aligned for ``box_type="hbb"``) painted over a noise
    background, each class with its own fill level, stripe frequency and
    dominant channel, so a detector can generalise to held-out draws
    (other seeds). Image ``idx`` comes from seed ``seed * 1000003 +
    idx``."""

    def __init__(self, n: int = 256, img_size: int = 256,
                 num_classes: int = 4, box_type: str = "obb",
                 max_objects: int = 6, seed: int = 0):
        self.n = n
        self.img_size = img_size
        self.num_classes = num_classes
        self.box_type = box_type
        self.max_objects = max_objects
        self.seed = seed
        self.CLASSES = tuple(f"class_{i}" for i in range(num_classes))

    def __len__(self):
        return self.n

    def _paint(self, img, cx, cy, w, h, theta, cls):
        s = self.img_size
        ext = int(np.ceil(np.hypot(w, h) / 2)) + 1
        x0 = max(int(cx) - ext, 0)
        y0 = max(int(cy) - ext, 0)
        x1 = min(int(cx) + ext + 1, s)
        y1 = min(int(cy) + ext + 1, s)
        ys, xs = np.mgrid[y0:y1, x0:x1]
        dx = xs - cx
        dy = ys - cy
        ct, st = np.cos(theta), np.sin(theta)
        fx = ct * dx + st * dy
        fy = -st * dx + ct * dy
        inside = (np.abs(fx) <= w / 2) & (np.abs(fy) <= h / 2)
        base = 60 + 150 * (cls + 1) / self.num_classes
        stripes = 0.5 + 0.5 * np.sin(fx * (0.3 + 0.25 * cls))
        for ch in range(3):
            chan = img[y0:y1, x0:x1, ch]
            val = base * (0.6 + 0.4 * stripes) * (0.5 + 0.5 * (ch == cls % 3))
            chan[inside] = np.clip(val[inside], 0, 255)

    def get_raw(self, idx: int) -> Dict:
        rng = np.random.RandomState(self.seed * 1000003 + idx)
        s = self.img_size
        img = (rng.rand(s, s, 3) * 40 + 20).astype(np.float32)
        k = rng.randint(1, self.max_objects + 1)
        labels = rng.randint(0, self.num_classes, k).astype(np.int32)
        boxes = []
        for j in range(k):
            cx = rng.uniform(0.18 * s, 0.82 * s)
            cy = rng.uniform(0.18 * s, 0.82 * s)
            w = rng.uniform(0.14 * s, 0.3 * s)
            h = rng.uniform(0.07 * s, 0.15 * s)
            theta = (rng.uniform(-np.pi / 2, np.pi / 2)
                     if self.box_type == "obb" else 0.0)
            self._paint(img, cx, cy, w, h, theta, int(labels[j]))
            boxes.append([cx, cy, w, h, theta])
        img = img.astype(np.uint8)
        boxes = np.asarray(boxes, np.float32)
        if self.box_type == "obb":
            return dict(img=img, obbs=boxes, labels=labels,
                        img_id=str(idx))
        cx, cy, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        hbbs = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        -1).astype(np.float32)
        return dict(img=img, hbbs=hbbs, labels=labels, img_id=str(idx))


def _image_paths(folder: str, infos, exts) -> List[Optional[str]]:
    """Each image id's file in ``folder``: the first of ``exts`` there
    (None where there is none), from one listing of the folder."""
    names = set(os.listdir(folder)) if os.path.isdir(folder) else set()
    return [next((os.path.join(folder, i["img_id"] + e) for e in exts
                  if i["img_id"] + e in names), None) for i in infos]


def _imread(path: str, device=None) -> np.ndarray:
    """A BGR image through ``utils/image.py::imread``, decoded by the
    readers of ``device`` (None: the CPU's)."""
    from ..utils.image import imread
    return imread(path, device=device)


class ConcatDataset(BaseDetDataset):
    """Datasets of one class list end to end: index i maps to (dataset,
    local index) by the cumulative lengths."""

    def __init__(self, datasets):
        assert datasets, "empty ConcatDataset"
        self.datasets = list(datasets)
        self.CLASSES = self.datasets[0].CLASSES
        self.box_type = self.datasets[0].box_type
        self._cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._cum[-1])

    def get_raw(self, idx: int) -> Dict:
        di = int(np.searchsorted(self._cum, idx, side="right"))
        local = idx - (0 if di == 0 else int(self._cum[di - 1]))
        return self.datasets[di].get_raw(local)


class RepeatDataset(BaseDetDataset):
    """A dataset ``times`` times over."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = int(times)
        self.CLASSES = dataset.CLASSES
        self.box_type = dataset.box_type

    def __len__(self):
        return len(self.dataset) * self.times

    def get_raw(self, idx: int) -> Dict:
        return self.dataset.get_raw(idx % len(self.dataset))


class ClassBalancedDataset(BaseDetDataset):
    """Repeat-factor sampling (the LVIS recipe): image i appears
    ``ceil(max over its classes c of r(c))`` times, with ``r(c) = max(1,
    sqrt(oversample_thr / f(c)))`` and ``f(c)`` the fraction of images
    that hold class c."""

    def __init__(self, dataset, oversample_thr: float = 1e-3):
        self.dataset = dataset
        self.CLASSES = dataset.CLASSES
        self.box_type = dataset.box_type
        n = len(dataset)
        cat_in_img = []
        counts: Dict[int, int] = {}
        for i in range(n):
            raw = dataset.get_raw(i)
            cats = set(int(c) for c in np.asarray(raw["labels"]).ravel())
            cat_in_img.append(cats)
            for c in cats:
                counts[c] = counts.get(c, 0) + 1
        freqs = {c: v / max(n, 1) for c, v in counts.items()}
        ratios = {c: max(1.0, np.sqrt(oversample_thr / max(f, 1e-12)))
                  for c, f in freqs.items()}
        self._indices: List[int] = []
        for i, cats in enumerate(cat_in_img):
            r = max([ratios[c] for c in cats], default=1.0)
            self._indices.extend([i] * int(np.ceil(r)))

    def __len__(self):
        return len(self._indices)

    def get_raw(self, idx: int) -> Dict:
        return self.dataset.get_raw(self._indices[idx])


_LEAF_TYPES = {
    "DOTADataset": DOTADataset,
    "DOTA15Dataset": DOTA15Dataset,
    "FairDataset": FairDataset,
    "SSDDDataset": SSDDDataset,
    "DroneVehicleDataset": DroneVehicleDataset,
    "HRSCDataset": HRSCDataset,
    "CocoDetDataset": CocoDetDataset,
    "SyntheticDetDataset": SyntheticDetDataset,
    "StructuredSyntheticDetDataset": StructuredSyntheticDetDataset,
}
# keys of a data config that set the pipeline, not the dataset
_PIPELINE_KEYS = ("pipeline", "max_gt")


def build_dataset(dcfg, version: str = "le90", synthetic_fallback=None,
                  device=None):
    """A dataset from a config dict (its ``type`` and keyword arguments;
    ``pipeline`` / ``max_gt`` are dropped). The wrappers recurse:
    ``ConcatDataset`` (``datasets``), ``RepeatDataset`` (``dataset``,
    ``times``), ``ClassBalancedDataset`` (``dataset``,
    ``oversample_thr``). ``synthetic_fallback``: ``SyntheticDetDataset``
    kwargs used when a leaf's paths are absent. ``device``: where the
    images are decoded for (the tool's device; None is the CPU); a file
    leaf checks its images for it before any loop starts."""
    if hasattr(dcfg, "to_dict"):
        dcfg = dcfg.to_dict()
    dcfg = dict(dcfg)
    for k in _PIPELINE_KEYS:
        dcfg.pop(k, None)
    dtype = dcfg.pop("type")
    if dtype == "ConcatDataset":
        return ConcatDataset([
            build_dataset(c, version, synthetic_fallback, device)
            for c in dcfg["datasets"]])
    if dtype == "RepeatDataset":
        return RepeatDataset(
            build_dataset(dcfg["dataset"], version, synthetic_fallback,
                          device), times=dcfg.get("times", 1))
    if dtype == "ClassBalancedDataset":
        return ClassBalancedDataset(
            build_dataset(dcfg["dataset"], version, synthetic_fallback,
                          device), oversample_thr=dcfg.get("oversample_thr", 1e-3))
    cls = _LEAF_TYPES.get(dtype)
    if cls is None:
        raise KeyError(f"unknown dataset type {dtype!r}")
    if cls in (SyntheticDetDataset, StructuredSyntheticDetDataset):
        return cls(**dcfg)
    paths_ok = all(os.path.exists(v) for v in dcfg.values()
                   if isinstance(v, str) and "/" in v)
    if not paths_ok:
        if synthetic_fallback is not None:
            return SyntheticDetDataset(**synthetic_fallback)
        raise FileNotFoundError(f"{dtype}: missing data paths in {dcfg}")
    if cls is CocoDetDataset:
        return cls(**dcfg, device=device)
    return cls(**dcfg, version=version, device=device)
