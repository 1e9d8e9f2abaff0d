"""Per-modality pipeline settings.

Port of ``sm3det_tpu/data/loader.py::PipelineCfg``: the image size, the
normalisation's mean and std (BGR input, RGB order after the channel swap)
and the train pipeline's flags, built from a ``data.<modality>`` config
dict with ``from_config``. The batch loader belongs to the training
pipeline.
"""

from __future__ import annotations

from typing import Optional, Sequence


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
