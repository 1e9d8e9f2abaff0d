"""JPEG decoding through nvJPEG, for ``utils/image.py``.

``csrc/nvjpeg_decode.cpp`` is built by ``nvcc`` at first use into a
library of its own under ``_build/`` (named by a hash of the source), linked
against the toolkit's ``libnvjpeg`` and ``libcudart``, and loaded with
``ctypes``. It is not part of the kernel library, so a toolkit without
nvJPEG leaves the kernels whole; :func:`missing` says what is absent, and
the reader raises ``NotImplementedError`` with it.

Each decode takes a context (an nvJPEG handle and state, a stream of its
own, a device buffer) from a pool, so the loaders' producer threads decode
side by side; the call waits for that stream only.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from . import build

SOURCE = build.CSRC / "nvjpeg_decode.cpp"
_lib = None
_POOL: list = []
_LOCK = threading.Lock()


def _cuda_home() -> Path | None:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return Path(home)
    try:
        return Path(build._nvcc()).resolve().parent.parent
    except RuntimeError:
        return None


def _lib_dirs(home: Path):
    return [d for d in (home / "lib64", home / "targets" / "x86_64-linux"
                        / "lib", home / "lib") if d.is_dir()]


def missing() -> str | None:
    """What the toolkit lacks for nvJPEG (None: header and library are
    there)."""
    home = _cuda_home()
    if home is None:
        return "no CUDA toolkit found (set CUDA_HOME), so no nvJPEG"
    if not ((home / "include" / "nvjpeg.h").is_file() or glob.glob(
            str(home / "targets" / "*" / "include" / "nvjpeg.h"))):
        return f"nvjpeg.h is not in the CUDA toolkit at {home}"
    if not any(glob.glob(str(d / "libnvjpeg.so*")) for d in _lib_dirs(home)):
        return f"libnvjpeg.so is not in the CUDA toolkit at {home}"
    return None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return build.BUILD_DIR / f"libsm3det_nvjpeg_{h}.so"


def load_library():
    """Build (once) and load the nvJPEG binding; raises if nvJPEG is
    missing or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    why = missing()
    if why is not None:
        raise NotImplementedError(why)
    so = library_path()
    if not so.exists():
        home = _cuda_home()
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [build._nvcc(), "-std=c++17", "-O2", "-shared", "-Xcompiler",
               "-fPIC", str(SOURCE), "-o", str(tmp)]
        cmd += [f"-L{d}" for d in _lib_dirs(home)] + ["-lnvjpeg", "-lcudart"]
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building the nvJPEG binding failed:\n"
                               f"{r.stdout}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sm3det_nvjpeg_create.argtypes = [ctypes.POINTER(P), I]
    lib.sm3det_nvjpeg_info.argtypes = [P, P, ctypes.c_size_t] + [
        ctypes.POINTER(I)] * 3
    lib.sm3det_nvjpeg_decode.argtypes = [P, P, ctypes.c_size_t, I, P, I, I]
    for fn in (lib.sm3det_nvjpeg_create, lib.sm3det_nvjpeg_info,
               lib.sm3det_nvjpeg_decode):
        fn.restype = I
    _lib = lib
    return lib


def _check(rc: int, what: str, name: str):
    if rc != 0:
        kind = f"CUDA error {rc - 1000}" if rc >= 1000 else \
            f"nvJPEG status {rc}"
        raise RuntimeError(f"{name}: {what} failed: {kind}")


def decode(content: bytes, flag: str, name: str, device) -> np.ndarray:
    """HWC uint8 of a JPEG, as PIL gives it for ``flag`` (RGB order):
    'color' (H, W, 3), 'grayscale' (H, W) (nvJPEG's luma plane),
    'unchanged' (H, W) for a gray file and (H, W, 3) otherwise."""
    import torch
    lib = load_library()
    dev = torch.device(device)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    with _LOCK:
        ctx = next((c for c in _POOL if c[1] == index), None)
        if ctx is not None:
            _POOL.remove(ctx)
    if ctx is None:
        handle = ctypes.c_void_p()
        _check(lib.sm3det_nvjpeg_create(ctypes.byref(handle), index),
               "creating an nvJPEG context", name)
        ctx = (handle, index)
    try:
        comps, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        _check(lib.sm3det_nvjpeg_info(ctx[0], content, len(content),
                                      ctypes.byref(comps), ctypes.byref(w),
                                      ctypes.byref(h)), "reading the header",
               name)
        if comps.value not in (1, 3):
            raise NotImplementedError(
                f"{name}: JPEG of {comps.value} components (the port reads "
                f"gray and YCbCr JPEG)")
        ch = 1 if (flag == "grayscale" or comps.value == 1) else 3
        out = np.empty((h.value, w.value, ch), np.uint8)
        _check(lib.sm3det_nvjpeg_decode(
            ctx[0], content, len(content), ch,
            out.ctypes.data_as(ctypes.c_void_p), w.value, h.value),
            "decoding", name)
    finally:
        with _LOCK:
            _POOL.append(ctx)
    if ch == 1:
        out = out[..., 0]
        if flag == "color":
            out = np.repeat(out[..., None], 3, -1)
    return out
