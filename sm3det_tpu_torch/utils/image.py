"""Image files: decode, read and write HWC uint8 arrays, without PIL.

Port of the read path of ``sm3det_tpu/utils/image.py`` (``imfrombytes``,
``imread``, ``imwrite``), which decodes through PIL. The port reads the
formats the datasets hold with readers of its own, and returns what the JAX
package's PIL path returns for the ``color``, ``grayscale`` and
``unchanged`` flags:

- PNG: the chunks parsed (each chunk's CRC checked with ``zlib.crc32``),
  ``IDAT`` inflated with ``zlib``, the row filters undone. 8-bit gray,
  gray + alpha, RGB, RGBA and palette images; an interlaced file or a bit
  depth other than 8 raises ``ValueError``. On the card's device the
  unfilter is the compiled host C++ of ``ops/cuda/csrc/png_unfilter.cu``
  (called through ``ctypes``: no device work, no sync, the GIL released);
  on the CPU it is :func:`png_unfilter_ref`, plain numpy.
- BMP: uncompressed 8-bit palette, 24-bit and 32-bit, bottom-up or
  top-down, read with numpy.
- JPEG: decoded by nvJPEG on the card (``ops/cuda/nvjpeg.py``); on the
  CPU, and where the toolkit has no nvJPEG, it raises
  ``NotImplementedError``.
- TIFF and any other format raise ``NotImplementedError``, naming it.

``device`` (``None`` is the CPU) says where the caller runs: the tools pass
theirs, so the card's run takes the compiled unfilter and nvJPEG, and a
failure to build them raises. :func:`check_image_files` lets a dataset
refuse, before its loop starts, a file it could not decode.

``imwrite`` writes PNG (filter 0, ``zlib`` level 6); other formats raise.
Bytes go through ``fileio.FileClient``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# decodes by route, so a run can show which reader it went through
DECODES = {"png_compiled": 0, "png_numpy": 0, "bmp": 0, "nvjpeg": 0}

# PNG colour type -> (PIL mode, samples a pixel)
_PNG_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
              6: ("RGBA", 4)}


def _on_card(device) -> bool:
    if device is None:
        return False
    return getattr(device, "type", str(device).split(":")[0]) == "cuda"


def image_format(head: bytes) -> str:
    """The format the magic bytes name: 'png' | 'jpeg' | 'bmp' | 'tiff' |
    'unknown'."""
    if head.startswith(PNG_MAGIC):
        return "png"
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(b"BM"):
        return "bmp"
    if head.startswith((b"II*\x00", b"MM\x00*")):
        return "tiff"
    return "unknown"


def decode_refusal(fmt: str, device) -> str | None:
    """Why a ``fmt`` image cannot be decoded on ``device``, or None."""
    if fmt in ("png", "bmp"):
        return None
    if fmt == "jpeg":
        if not _on_card(device):
            return ("JPEG is decoded by nvJPEG on the card only; the port "
                    "has no host JPEG decoder")
        from ..ops.cuda import nvjpeg
        return nvjpeg.missing()
    return (f"the port reads PNG, BMP and (on the card) JPEG, not "
            f"{fmt.upper() if fmt != 'unknown' else 'this format'}")


# ---- PNG ---------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def png_unfilter_ref(data: bytes, height: int, row_bytes: int,
                     bpp: int) -> np.ndarray:
    """Undo the PNG row filters, plain numpy: ``data`` the inflated
    ``IDAT`` (a filter byte before each row) -> (height, row_bytes)
    uint8. ``bpp`` the bytes a pixel (the filters' left neighbour)."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size < height * (row_bytes + 1):
        raise ValueError("PNG image data is shorter than its header says")
    raw = raw[:height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.int32)
    for y in range(height):
        ftype, f = int(raw[y, 0]), raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = f
        elif ftype == 1:        # Sub: a running sum of each byte lane
            cur = np.cumsum(f.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:
            cur = (f + prior) & 255
        elif ftype in (3, 4):   # Average, Paeth: sequential along the row
            fl, up = f.tolist(), prior.tolist()
            row = [0] * row_bytes
            for x in range(row_bytes):
                a = row[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                row[x] = (fl[x] + pred) & 255
            cur = np.asarray(row, np.int32)
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def png_unfilter(data: bytes, height: int, row_bytes: int, bpp: int,
                 device=None) -> np.ndarray:
    """The unfilter of the device the caller runs on: the compiled host
    C++ for the card, :func:`png_unfilter_ref` for the CPU."""
    if not _on_card(device):
        DECODES["png_numpy"] += 1
        return png_unfilter_ref(data, height, row_bytes, bpp)
    import ctypes

    from ..ops.cuda import build
    if len(data) < height * (row_bytes + 1):
        raise ValueError("PNG image data is shorter than its header says")
    out = np.empty((height, row_bytes), np.uint8)
    rc = build.load_library().sm3det_png_unfilter(
        data, out.ctypes.data_as(ctypes.c_void_p), height, row_bytes, bpp)
    if rc != 0:
        raise ValueError(f"PNG row {rc - 1} has an unknown filter type")
    DECODES["png_compiled"] += 1
    return out


def _png_chunks(content: bytes, name: str):
    pos = len(PNG_MAGIC)
    while pos + 12 <= len(content):
        (length,) = struct.unpack(">I", content[pos:pos + 4])
        ctype = content[pos + 4:pos + 8]
        body = content[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", content[pos + 8 + length:
                                             pos + 12 + length] or b"\0" * 4)
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{name}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG file ends before its IEND chunk")


def _decode_png(content: bytes, name: str, device):
    """(PIL mode, pixel array as PIL's np.asarray gives it, palette or
    None)."""
    hdr, plte, idat = None, None, []
    for ctype, body in _png_chunks(content, name):
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError(f"{name}: PNG file has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_TYPES:
        raise ValueError(f"{name}: PNG colour type {ctype} is not valid")
    if depth != 8:
        raise ValueError(f"{name}: PNG bit depth {depth} is not read (the "
                         f"port reads 8-bit PNG only)")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG (Adam7) is not read")
    mode, spp = _PNG_TYPES[ctype]
    if mode == "P" and plte is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    rows = png_unfilter(zlib.decompress(b"".join(idat)), h, w * spp, spp,
                        device)
    arr = rows.reshape(h, w, spp) if spp > 1 else rows.reshape(h, w)
    return mode, arr, plte


# ---- BMP ---------------------------------------------------------------------

def _decode_bmp(content: bytes, name: str):
    (offset,) = struct.unpack("<I", content[10:14])
    (dib,) = struct.unpack("<I", content[14:18])
    if dib < 40:
        raise NotImplementedError(f"{name}: BMP core headers are not read")
    w, h, _, bits, comp, _, _, _, colors = struct.unpack(
        "<iiHHIIiiI", content[18:50])
    if comp != 0 or bits not in (8, 24, 32):
        raise NotImplementedError(
            f"{name}: BMP of {bits} bits, compression {comp}: the port "
            f"reads uncompressed 8-, 24- and 32-bit BMP")
    top_down, h = h < 0, abs(h)
    stride = (w * bits // 8 + 3) & ~3
    px = np.frombuffer(content, np.uint8, stride * h, offset)
    px = px.reshape(h, stride)[:, :w * bits // 8]
    if not top_down:
        px = px[::-1]
    DECODES["bmp"] += 1
    if bits == 8:
        n = colors or 256
        pal = np.frombuffer(content, np.uint8, 4 * n, 14 + dib)
        pal = pal.reshape(n, 4)[:, 2::-1]                # BGRX -> RGB
        if np.array_equal(pal, np.repeat(np.arange(n, dtype=np.uint8)
                                         [:, None], 3, 1)):
            return "L", np.ascontiguousarray(px), None
        return "P", np.ascontiguousarray(px), pal
    # 32-bit BI_RGB: the fourth byte is padding, as PIL reads it (BGRX)
    return "RGB", np.ascontiguousarray(
        px.reshape(h, w, bits // 8)[..., 2::-1]), None


# ---- the flags -----------------------------------------------------------------

def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L: (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _as_flag(mode, arr, pal, flag, channel_order):
    if flag == "unchanged":
        return arr
    if mode == "P":
        full = np.zeros((256, 3), np.uint8)
        full[:len(pal)] = pal[:256]
        rgb = full[arr]
    elif mode in ("L", "LA"):
        gray = arr if mode == "L" else arr[..., 0]
        if flag == "grayscale":
            return np.ascontiguousarray(gray)
        rgb = np.repeat(gray[..., None], 3, -1)
    else:
        rgb = arr[..., :3]
    if flag == "grayscale":
        return _luma(rgb)
    if flag != "color":
        raise ValueError(f"unknown imread flag {flag!r}")
    return np.ascontiguousarray(rgb if channel_order == "rgb"
                                else rgb[..., ::-1])


def imfrombytes(content: bytes, flag: str = "color",
                channel_order: str = "bgr", device=None,
                name: str = "<bytes>") -> np.ndarray:
    """Decode an encoded image. ``flag``: 'color' | 'grayscale' |
    'unchanged'; ``device`` where the caller runs (None: the CPU);
    ``name`` the file, for the errors."""
    fmt = image_format(content[:8])
    why = decode_refusal(fmt, device)
    if why is not None:
        raise NotImplementedError(f"{name}: {why}")
    if fmt == "jpeg":
        from ..ops.cuda import nvjpeg
        arr = nvjpeg.decode(content, flag, name, device)
        DECODES["nvjpeg"] += 1
        if arr.ndim == 3 and flag == "color" and channel_order == "bgr":
            return np.ascontiguousarray(arr[..., ::-1])
        return arr
    if fmt == "png":
        mode, arr, pal = _decode_png(content, name, device)
    else:
        mode, arr, pal = _decode_bmp(content, name)
    return _as_flag(mode, arr, pal, flag, channel_order)


def imread(path: str, flag: str = "color", channel_order: str = "bgr",
           device=None) -> np.ndarray:
    """Read an image from disk, HTTP or memory; BGR by default."""
    from .fileio import FileClient
    content = FileClient.infer_client(path).get(path)
    return imfrombytes(content, flag=flag, channel_order=channel_order,
                       device=device, name=str(path))


def check_image_files(paths, device=None, what: str = "dataset") -> None:
    """Raise, before a loop starts, for an image the reader cannot decode
    on ``device``: every path's extension, and the magic bytes of the
    first, which must name the format its extension does."""
    by_ext = {".png": "png", ".bmp": "bmp", ".jpg": "jpeg", ".jpeg": "jpeg",
              ".tif": "tiff", ".tiff": "tiff"}
    paths = list(paths)
    for p in paths:
        fmt = by_ext.get(os.path.splitext(p)[1].lower(), "unknown")
        why = decode_refusal(fmt, device)
        if why is not None:
            raise NotImplementedError(f"{what}: {p}: {why}")
    if paths:
        with open(paths[0], "rb") as f:
            head = f.read(8)
        fmt = image_format(head)
        want = by_ext[os.path.splitext(paths[0])[1].lower()]
        if fmt != want:
            raise NotImplementedError(
                f"{what}: {paths[0]}: its bytes are {fmt}, its name says "
                f"{want}")


# ---- writing -------------------------------------------------------------------

def encode_png(arr: np.ndarray, filters=(0,), level: int = 6) -> bytes:
    """An 8-bit PNG of an (H, W) or (H, W, 1-4) uint8 array, row y filtered
    with ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth; the forward filters read unfiltered bytes only, so they are
    vectorised), ``IDAT`` deflated at ``level``."""
    h, w = arr.shape[:2]
    spp = 1 if arr.ndim == 2 else arr.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[spp]
    raw = arr.reshape(h, w * spp).astype(np.int32)
    up = np.vstack([np.zeros((1, w * spp), np.int32), raw[:-1]])
    left = np.pad(raw, ((0, 0), (spp, 0)))[:, :-spp]
    upleft = np.pad(up, ((0, 0), (spp, 0)))[:, :-spp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(raw), left, up, (left + up) >> 1, paeth)
    ftypes = np.asarray([filters[y % len(filters)] for y in range(h)],
                        np.int32)
    rows = np.empty((h, w * spp + 1), np.uint8)
    rows[:, 0] = ftypes
    rows[:, 1:] = (raw - np.choose(ftypes[:, None], preds)) & 255

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    return (PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def imwrite(img: np.ndarray, path: str, channel_order: str = "bgr"):
    """Write an HWC uint8 image (BGR by default, as ``imread`` returns) as
    PNG (filter 0, ``zlib`` level 6)."""
    from .fileio import FileClient
    arr = np.ascontiguousarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"imwrite takes uint8 images, got {arr.dtype}")
    if arr.ndim == 3 and channel_order == "bgr":
        arr = np.ascontiguousarray(arr[..., ::-1])   # as the JAX package
    ext = path.rsplit(".", 1)[-1].lower()
    if ext != "png":
        raise NotImplementedError(f"{path}: the port writes PNG, not {ext!r}")
    FileClient.infer_client(path).put(encode_png(arr), path)
