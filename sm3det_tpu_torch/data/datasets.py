"""Evaluation datasets, on the host in numpy.

Port of the eval part of ``sm3det_tpu/data/datasets.py``:

- ``DOTADataset``: a folder of DOTA TXT polygon annotations (mmrotate
  ``dota.py``), cached in a pickle; gts above ``filter_difficulty`` are
  kept as ignore boxes; the DOTA-family aliases set other class lists.
- ``CocoDetDataset``: COCO-json horizontal boxes (SARDet-50K), with each
  gt's ``area`` and the crowd regions for the COCO protocol, and
  ``cat_ids`` (label -> COCO category id).
- ``SyntheticDetDataset``: random images and boxes from a seed, so the
  tools run without data files.

``get_raw(idx)`` gives {img (H, W, 3) uint8 BGR, obbs (N, 5) or hbbs
(N, 4), labels, img_id, ...}. The dataset wrappers, HRSC and the
structured synthetic dataset belong to the training pipeline.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.box_convert import poly2obb_np

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
                 cache: bool = True):
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
        out = dict(img=self._read_image(info["img_id"]),
                   obbs=info["obbs"].copy(), labels=info["labels"].copy(),
                   img_id=info["img_id"])
        if len(info.get("obbs_ignore", ())):
            out["obbs_ignore"] = info["obbs_ignore"].copy()
            out["labels_ignore"] = info["labels_ignore"].copy()
        return out

    def _read_image(self, img_id: str) -> np.ndarray:
        for ext in (".png", ".jpg", ".bmp", ".tif"):
            p = os.path.join(self.img_folder, img_id + ext)
            if os.path.exists(p):
                return _imread(p)
        raise FileNotFoundError(img_id)


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


class CocoDetDataset(BaseDetDataset):
    """COCO-json horizontal boxes. ``cat_ids[label]`` is the COCO category
    id of a label (categories sorted by id)."""

    box_type = "hbb"

    def __init__(self, ann_file: str, img_folder: str,
                 classes: Optional[Sequence[str]] = None):
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

    def __len__(self):
        return len(self.infos)

    def get_raw(self, idx: int) -> Dict:
        info = self.infos[idx]
        img = _imread(os.path.join(self.img_folder, info["file_name"]))
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


def _imread(path: str) -> np.ndarray:
    """A BGR image through ``utils/image.py::imread``."""
    from ..utils.image import imread
    return imread(path)


_LEAF_TYPES = {
    "DOTADataset": DOTADataset,
    "DOTA15Dataset": DOTA15Dataset,
    "FairDataset": FairDataset,
    "SSDDDataset": SSDDDataset,
    "DroneVehicleDataset": DroneVehicleDataset,
    "CocoDetDataset": CocoDetDataset,
    "SyntheticDetDataset": SyntheticDetDataset,
}
# types of the JAX package that come with the training pipeline
_NOT_PORTED = ("ConcatDataset", "RepeatDataset", "ClassBalancedDataset",
               "HRSCDataset", "StructuredSyntheticDetDataset")
# keys of a data config that set the pipeline, not the dataset
_PIPELINE_KEYS = ("pipeline", "max_gt")


def build_dataset(dcfg, version: str = "le90", synthetic_fallback=None):
    """A dataset from a config dict (its ``type`` and keyword arguments;
    ``pipeline`` / ``max_gt`` are dropped). ``synthetic_fallback``:
    ``SyntheticDetDataset`` kwargs used when a leaf's paths are absent."""
    if hasattr(dcfg, "to_dict"):
        dcfg = dcfg.to_dict()
    dcfg = dict(dcfg)
    for k in _PIPELINE_KEYS:
        dcfg.pop(k, None)
    dtype = dcfg.pop("type")
    if dtype in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset type {dtype!r} comes with the training pipeline "
            f"(ROADMAP, queue 1: the training runtime)")
    cls = _LEAF_TYPES.get(dtype)
    if cls is None:
        raise KeyError(f"unknown dataset type {dtype!r}")
    if cls is SyntheticDetDataset:
        return cls(**dcfg)
    paths_ok = all(os.path.exists(v) for v in dcfg.values()
                   if isinstance(v, str) and "/" in v)
    if not paths_ok:
        if synthetic_fallback is not None:
            return SyntheticDetDataset(**synthetic_fallback)
        raise FileNotFoundError(f"{dtype}: missing data paths in {dcfg}")
    if cls is CocoDetDataset:
        return cls(**dcfg)
    return cls(**dcfg, version=version)
