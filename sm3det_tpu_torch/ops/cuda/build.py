"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by ``nvcc`` into an
object file, all sources at once in parallel, and the objects are linked
into one shared library with a plain C interface that is loaded with
``ctypes``. The library lands in ``_build/`` beside this file (listed in
``.gitignore``) under a name that hashes the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library.

``csrc/png_unfilter.cu`` is host C++ in the same library (``nvcc`` hands it
to the host compiler): the PNG reader's row unfilter.

Nothing here runs at import: the first wrapper that launches a kernel calls
:func:`load_library`. A failed build or a missing ``nvcc`` raises; there is
no fallback.

Each wrapper counts its launches in :data:`LAUNCHES` (plain ints, one per
kernel), so a caller can show that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches per kernel wrapper; reset with reset_launches()
LAUNCHES = {"dwconv_ln": 0, "fused_convnext_block": 0, "convnext_ffn": 0,
            "moe_ffn_grouped": 0, "hbb_iou": 0, "fused_layernorm": 0,
            "rotated_iou": 0, "rotated_iou_banded": 0,
            "roi_align_rotated": 0, "roi_align_rotated_bwd": 0,
            "fused_dwconv_ln_train": 0, "fused_dwconv_ln_train_bwd": 0,
            "hbb_nms_mask": 0, "rotated_nms_mask": 0,
            "rotated_nms_mask_banded": 0, "nms_keep": 0}

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, taps (49,C) f32, dwb, lns, lnb, out, B, H, W, C, in_bf16,
    # out_bf16, eps, stream
    "sm3det_dwconv_ln": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _P],
    # x, taps (49,C) f32, dwb, lns, g, da scratch, part_a, its rows,
    # part_b, n_groups, dx, ddwk, ddwb, dlns, dlnb, B, H, W, C, in_bf16,
    # g_bf16, bf16 mask of (ddwk, ddwb, dlns, dlnb), eps, stream
    "sm3det_dwconv_ln_bwd": [_P] * 7 + [_I, _P, _I] + [_P] * 5
    + [_I] * 7 + [_F, _P],
    # fp32: a, tile_expert, tile_rows, w, bias, shortcut, gamma, out, M, K,
    # N, epilogue, stream
    "sm3det_grouped_gemm": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _P],
    # bf16: x, tile_expert, tile_rows, w1, b1, w2, b2, shortcut, gamma, out,
    # M, C, H, E, flags, stream
    "sm3det_ffn_fused": [_P, _P, _I] + [_P] * 7 + [_I] * 5 + [_P],
    # boxes1, boxes2, out, B, N, M, triu, eps, stream
    "sm3det_hbb_iou": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    # boxes, out words, B, N, thr, eps, stream
    "sm3det_hbb_nms_mask": [_P, _P, _I, _I, _F, _F, _P],
    # boxes, groups (null: not banded), out words, B, N, thr, stream
    "sm3det_rotated_nms_mask": [_P, _P, _P, _I, _I, _F, _P],
    # mask words, eligible, keep, B, N, stream
    "sm3det_nms_keep": [_P, _P, _P, _I, _I, _P],
    # x, scale, bias, out, rows, C, in_bf16, out_bf16, bf16 mask of
    # (scale, bias), eps, stream
    "sm3det_layernorm": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                         _F, _P],
    # boxes1, boxes2, groups1, groups2 (both null: not banded), out, B, N,
    # M, triu, stream
    "sm3det_rotated_iou": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # 4 level pointers, 4 heights, 4 widths, 4 x 1/stride, rois, lvls, out,
    # B, C, N, out_size, sample_num, bf16, stream
    "sm3det_roi_align_rotated": [_P] * 4 + [_I] * 8 + [_F] * 4
    + [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # 4 gradient pointers, 4 heights, 4 widths, 4 x 1/stride, rois, lvls,
    # g, stencil entries, bin boxes, RoI boxes (scratch), B, C, N,
    # out_size, sample_num, g bf16, gradient bf16, stream
    "sm3det_roi_align_rotated_bwd": [_P] * 4 + [_I] * 8 + [_F] * 4
    + [_P] * 6 + [_I] * 7 + [_P],
    # host C++ (utils/image.py's PNG reader): src, dst, height, row_bytes,
    # bpp; returns 0 or 1 + the row of an unknown filter type
    "sm3det_png_unfilter": [_P, _P, _I, _I, _I],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsm3det_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel, link one .so; returns its path."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "nvcc.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp_so = work / so.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_so)] + [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp_so, so)     # atomic: concurrent builders never see half
    shutil.rmtree(work, ignore_errors=True)
    return so


def load_library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def forbid_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and an input requires grad: a kernel
    without a backward would hand back a tensor with no ``grad_fn`` and
    cut the graph without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward, and an "
                           "input requires grad; run it under "
                           "torch.no_grad() or use the trainable path")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require_cuda(t: torch.Tensor, name: str, device=None) -> None:
    """Raise unless ``t`` is a CUDA tensor (on ``device``, if given)."""
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f"{name} must be a CUDA tensor on "
                         f"{device or 'the card'}, got {t.device}")
