"""Image files: decode, read and write HWC uint8 arrays.

Port of the read path of ``sm3det_tpu/utils/image.py`` (``imfrombytes``,
``imread``, ``imwrite``). PIL is imported inside the functions, so the
module imports where PIL is absent. Bytes go through ``fileio.FileClient``.
"""

from __future__ import annotations

import io

import numpy as np


def imfrombytes(content: bytes, flag: str = "color",
                channel_order: str = "bgr") -> np.ndarray:
    """Decode an encoded image. ``flag``: 'color' | 'grayscale' |
    'unchanged'."""
    from PIL import Image
    img = Image.open(io.BytesIO(content))
    if flag == "grayscale":
        return np.asarray(img.convert("L"))
    if flag == "unchanged":
        return np.asarray(img)
    arr = np.asarray(img.convert("RGB"))
    return arr if channel_order == "rgb" else arr[..., ::-1]


def imread(path: str, flag: str = "color",
           channel_order: str = "bgr") -> np.ndarray:
    """Read an image from disk, HTTP or memory; BGR by default."""
    from .fileio import FileClient
    content = FileClient.infer_client(path).get(path)
    return imfrombytes(content, flag=flag, channel_order=channel_order)


def imwrite(img: np.ndarray, path: str, channel_order: str = "bgr"):
    """Write an HWC uint8 image (BGR by default, as ``imread`` returns)."""
    from PIL import Image

    from .fileio import FileClient
    arr = np.ascontiguousarray(img)
    if arr.ndim == 3 and channel_order == "bgr":
        arr = arr[..., ::-1]
    fmt = path.rsplit(".", 1)[-1].lower()
    fmt = {"jpg": "JPEG", "tif": "TIFF"}.get(fmt, fmt.upper())
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    FileClient.infer_client(path).put(buf.getvalue(), path)
