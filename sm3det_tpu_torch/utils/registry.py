"""String-keyed registry and ``build_from_cfg``.

Port of ``sm3det_tpu/utils/registry.py`` (the mmcv ``Registry`` contract:
a config dict's ``type`` names a registered class, its other keys are the
keyword arguments).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Any] = {}

    def register_module(self, name: Optional[str] = None,
                        module: Optional[Any] = None):
        if module is not None:
            self._modules[name or module.__name__] = module
            return module

        def deco(cls):
            self._modules[name or cls.__name__] = cls
            return cls
        return deco

    def get(self, key: str):
        if key not in self._modules:
            raise KeyError(
                f"{key!r} not registered in {self.name}; "
                f"known: {sorted(self._modules)}")
        return self._modules[key]

    def __contains__(self, key):
        return key in self._modules


def build_from_cfg(cfg: Dict[str, Any], registry: Registry, **extra):
    cfg = copy.deepcopy(dict(cfg))
    obj_type = cfg.pop("type")
    cls = registry.get(obj_type) if isinstance(obj_type, str) else obj_type
    cfg.update(extra)
    return cls(**cfg)


BACKBONES = Registry("backbones")
NECKS = Registry("necks")
HEADS = Registry("heads")
DETECTORS = Registry("detectors")
DATASETS = Registry("datasets")
