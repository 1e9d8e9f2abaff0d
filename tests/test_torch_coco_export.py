"""The port's COCO results export (``tools.test --format-only`` on the SAR
subdataset) never writes a null ``category_id``: a COCO json that lacks a
configured class makes it raise ``ValueError`` naming the class, before
anything is run or written; a json with every class writes each
detection's category id from ``cat_ids``."""

import json

import numpy as np
import pytest
import torch

from sm3det_tpu_torch.data.datasets import CocoDetDataset
from sm3det_tpu_torch.models.builder import build_detector
from sm3det_tpu_torch.tools import test as test_cli
from sm3det_tpu_torch.utils.config import Config
from torch_jax_refs import one_torch_thread  # noqa: F401

SMOKE = "configs/smoke_tiny.py"
CLASSES = ("ship", "aircraft", "car", "tank")       # smoke_tiny: 4 classes


def _coco(tmp_path, cats):
    from PIL import Image
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(2):
        Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
            tmp_path / f"im{i}.png")
        images.append({"id": 10 + i, "file_name": f"im{i}.png"})
        anns.append({"id": i, "image_id": 10 + i,
                     "category_id": cats[i % len(cats)]["id"],
                     "bbox": [8.0, 8.0, 20.0, 16.0], "iscrowd": 0})
    path = tmp_path / "ann.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": cats}))
    return CocoDetDataset(str(path), str(tmp_path), classes=CLASSES)


def _model():
    """smoke_tiny's detector with the GFL prior bias raised, so that the
    random model's scores clear score_thr and the export has records."""
    cfg = Config.fromfile(SMOKE)
    model = build_detector(cfg.model, device="cpu", seed=0)
    with torch.no_grad():
        model.sar_bbox_head.gfl_cls.bias.fill_(0.5)
    return model


def _run(tmp_path, ds):
    return test_cli.main(
        [SMOKE, "--subdataset", "sar", "--format-only", "--submission-dir",
         str(tmp_path / "sub"), "--device", "cpu", "--batch-size", "2"],
        dataset=ds, model=_model())


def test_a_class_without_an_id_raises_before_writing(tmp_path):
    ds = _coco(tmp_path, [{"id": 5, "name": "ship"},
                          {"id": 9, "name": "car"}])
    assert ds.cat_ids == [5, None, 9, None]
    with pytest.raises(ValueError, match="aircraft.*tank"):
        _run(tmp_path, ds)
    assert not (tmp_path / "sub").exists()


def test_every_class_writes_its_category_id(tmp_path):
    ids = {"ship": 5, "aircraft": 2, "car": 9, "tank": 40}
    ds = _coco(tmp_path, [{"id": v, "name": k} for k, v in ids.items()])
    out = _run(tmp_path, ds)
    records = json.loads((tmp_path / "sub" / "results.bbox.json")
                         .read_text())
    assert records, "the random model detects nothing"
    assert {r["category_id"] for r in records} <= set(ids.values())
    n = sum(len(d) for per_img in out["det_results"] for d in per_img)
    assert len(records) == n
    # each record's id is the one of the class its detection came from
    by_class = [ids[c] for c in CLASSES]
    want = sorted(by_class[c] for per_img in out["det_results"]
                  for c, d in enumerate(per_img) for _ in d)
    assert sorted(r["category_id"] for r in records) == want
