"""File IO: a ``FileClient`` with disk, HTTP and in-memory backends,
``load`` / ``dump`` for json and pickle, and the ``list_from_file`` /
``dict_from_file`` parsers that datasets use.

Port of ``sm3det_tpu/utils/fileio.py`` (the mmcv ``fileio`` contract).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List, Optional


class DiskBackend:
    def get(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def get_text(self, path: str) -> str:
        with open(path) as f:
            return f.read()

    def put(self, data: bytes, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)


class HTTPBackend:
    def get(self, url: str) -> bytes:
        from urllib.request import urlopen
        with urlopen(url) as r:
            return r.read()

    def get_text(self, url: str) -> str:
        return self.get(url).decode()

    def exists(self, url: str) -> bool:  # pragma: no cover
        return True


class MemoryBackend:
    """A process-wide dict of blobs (test doubles, cached files)."""

    _store: Dict[str, bytes] = {}

    def get(self, path: str) -> bytes:
        return self._store[path]

    def get_text(self, path: str) -> str:
        return self._store[path].decode()

    def put(self, data: bytes, path: str):
        self._store[path] = data

    def exists(self, path: str) -> bool:
        return path in self._store


class FileClient:
    """Backend chosen by prefix: ``http(s)://``, ``memory://``, else the
    disk; further backends register with ``register_backend``."""

    _backends = {"disk": DiskBackend, "http": HTTPBackend,
                 "memory": MemoryBackend}

    def __init__(self, backend: Optional[str] = None):
        self.backend_name = backend or "disk"
        self.backend = self._backends[self.backend_name]()

    @classmethod
    def register_backend(cls, name: str, backend_cls):
        cls._backends[name] = backend_cls

    @classmethod
    def infer_client(cls, uri: str) -> "FileClient":
        if uri.startswith(("http://", "https://")):
            return cls("http")
        if uri.startswith("memory://"):
            return cls("memory")
        return cls("disk")

    @staticmethod
    def _strip(uri: str) -> str:
        return uri[9:] if uri.startswith("memory://") else uri

    def get(self, path):
        return self.backend.get(self._strip(path))

    def get_text(self, path):
        return self.backend.get_text(self._strip(path))

    def put(self, data: bytes, path: str):
        self.backend.put(data, self._strip(path))

    def exists(self, path) -> bool:
        return self.backend.exists(self._strip(path))


_HANDLERS = {
    "json": (lambda s: json.loads(s), lambda o: json.dumps(o).encode()),
    "pkl": (lambda s: pickle.loads(s), lambda o: pickle.dumps(o)),
}


def load(path: str, file_format: Optional[str] = None) -> Any:
    fmt = file_format or path.rsplit(".", 1)[-1]
    return _HANDLERS[fmt][0](FileClient.infer_client(path).get(path))


def dump(obj: Any, path: str, file_format: Optional[str] = None):
    fmt = file_format or path.rsplit(".", 1)[-1]
    FileClient.infer_client(path).put(_HANDLERS[fmt][1](obj), path)


def list_from_file(filename: str, prefix: str = "", offset: int = 0,
                   max_num: int = 0, encoding: str = "utf-8") -> List[str]:
    """One stripped line an item, from line ``offset`` on, at most
    ``max_num`` items (0: all)."""
    client = FileClient.infer_client(filename)
    items = []
    for cnt, line in enumerate(client.get(filename).decode(
            encoding).splitlines()):
        if cnt < offset:
            continue
        if max_num and len(items) >= max_num:
            break
        items.append(prefix + line.rstrip("\r\n"))
    return items


def dict_from_file(filename: str, key_type=str,
                   encoding: str = "utf-8") -> Dict:
    """The first whitespace-split token of a line is the key, the rest the
    value (a single value stays a scalar)."""
    client = FileClient.infer_client(filename)
    mapping = {}
    for line in client.get(filename).decode(encoding).splitlines():
        items = line.rstrip("\r\n").split()
        assert len(items) >= 2
        mapping[key_type(items[0])] = \
            items[1] if len(items) == 2 else items[1:]
    return mapping
