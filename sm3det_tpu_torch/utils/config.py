"""Config files: Python files whose module-level variables form a dict.

Port of ``sm3det_tpu/utils/config.py``. ``_base_`` lists parent configs
(paths relative to the file) merged depth first; a dict that holds
``_delete_=True`` replaces the base's value instead of merging into it;
``Config.merge_from_dict`` applies ``k.a.b=v`` overrides from the command
line. A config file is executed by path; nothing is imported from
``configs/``.
"""

from __future__ import annotations

import ast
import copy
import os
import pprint
import types
from typing import Any, Dict, List, Optional

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


def _exec_config_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = f.read()
    module: Dict[str, Any] = {"__file__": path}
    exec(compile(src, path, "exec"), module)
    return {k: v for k, v in module.items()
            if not k.startswith("__") and
            not isinstance(v, (types.ModuleType, types.FunctionType,
                               type))}


def merge_dict(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``new`` onto ``base``, honouring ``_delete_``."""
    out = copy.deepcopy(base)
    for k, v in new.items():
        if isinstance(v, dict):
            if v.get(DELETE_KEY, False):
                out[k] = {kk: copy.deepcopy(vv) for kk, vv in v.items()
                          if kk != DELETE_KEY}
            elif k in out and isinstance(out.get(k), dict):
                out[k] = merge_dict(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Config:
    """Attribute-style view of a nested dict."""

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None,
                 filename: Optional[str] = None):
        object.__setattr__(self, "_cfg", cfg_dict or {})
        object.__setattr__(self, "_filename", filename)

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        path = os.path.abspath(path)
        raw = _exec_config_file(path)
        bases = raw.pop(BASE_KEY, [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            b_path = os.path.join(os.path.dirname(path), b)
            merged = merge_dict(merged, cls.fromfile(b_path)._cfg)
        return cls(merge_dict(merged, raw), filename=path)

    def __getattr__(self, name):
        try:
            v = self._cfg[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) else v

    def __setattr__(self, name, value):
        self._cfg[name] = value

    def __getitem__(self, name):
        v = self._cfg[name]
        return Config(v) if isinstance(v, dict) else v

    def __setitem__(self, name, value):
        self._cfg[name] = value

    def __contains__(self, name):
        return name in self._cfg

    def get(self, name, default=None):
        v = self._cfg.get(name, default)
        return Config(v) if isinstance(v, dict) else v

    def keys(self):
        return self._cfg.keys()

    def items(self):
        for k, v in self._cfg.items():
            yield k, (Config(v) if isinstance(v, dict) else v)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._cfg)

    @property
    def filename(self):
        return self._filename

    def merge_from_dict(self, options: Dict[str, Any]):
        """Apply dot-key overrides: ``{'model.backbone.arch': 'small'}``."""
        for full_key, v in options.items():
            d = self._cfg
            keys = full_key.split(".")
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = v

    @staticmethod
    def parse_cli_options(pairs: List[str]) -> Dict[str, Any]:
        """``['a.b=1', 'c=[1,2]']`` -> ``{'a.b': 1, 'c': [1, 2]}``; a value
        that is no Python literal stays a string."""
        out = {}
        for p in pairs:
            k, _, v = p.partition("=")
            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                out[k] = v
        return out

    @property
    def pretty_text(self) -> str:
        return pprint.pformat(self._cfg, width=88, sort_dicts=False)

    def dump(self, path: str):
        with open(path, "w") as f:
            f.write(self.pretty_text + "\n")

    def __repr__(self):
        return f"Config(file={self._filename})\n{self.pretty_text}"


def compat_cfg(cfg: "Config") -> "Config":
    """Legacy keys onto the current schema (mmrotate ``compat_cfg``):
    ``data.samples_per_gpu`` -> ``batch_size``, the multi-source loader's
    ``source_ratio`` -> top level; other keys pass through."""
    d = cfg.to_dict()
    data = d.get("data", {})
    if "samples_per_gpu" in data and "batch_size" not in d:
        d["batch_size"] = data["samples_per_gpu"]
    if "train_dataloader" in data:
        tl = data["train_dataloader"]
        if tl.get("multi_datasets") and "source_ratio" in tl and \
                "source_ratio" not in d:
            d["source_ratio"] = tl["source_ratio"]
    return Config(d, filename=cfg.filename)
