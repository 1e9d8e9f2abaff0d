"""The port's image reader and writer against the JAX package's PIL path.

PNG decodes bit for bit as ``sm3det_tpu.utils.image.imfrombytes`` (PIL)
does, for PIL-written files of each colour type, hand-filtered files of
each of the five row filters and files the port's ``imwrite`` wrote; BMP
(bottom-up and top-down) the same. Interlaced and 16-bit PNG raise ``ValueError``; TIFF, and JPEG on
the CPU, raise ``NotImplementedError``; a dataset refuses such files before
its loop starts. The compiled unfilter and nvJPEG are held on the card in
``test_torch_kernels_gpu.py``.
"""

import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from sm3det_tpu.utils import image as jax_image
from sm3det_tpu_torch.data import datasets as port_ds
from sm3det_tpu_torch.utils import image as port_image
from torch_jax_refs import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data", "images")
FLAGS = [("color", "bgr"), ("color", "rgb"), ("grayscale", "bgr"),
         ("unchanged", "bgr")]


def _picture(seed, h=21, w=34, c=3):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = (x[..., None] * 7 + y[..., None] * 3 + np.arange(c) * 40
           + rng.randint(0, 30, (h, w, c)))
    return (img % 256).astype(np.uint8)


def _pil_bytes(img: Image.Image, fmt="PNG", **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _same_as_pil(content: bytes):
    for flag, order in FLAGS:
        got = port_image.imfrombytes(content, flag, order)
        ref = jax_image.imfrombytes(content, flag, order)
        assert got.dtype == ref.dtype == np.uint8, flag
        np.testing.assert_array_equal(got, ref, err_msg=f"{flag} {order}")


def _chunk(t: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + t + body
            + struct.pack(">I", zlib.crc32(t + body)))


# ---- PNG ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P-trns"])
def test_png_of_each_colour_type_matches_pil(mode):
    rgba = _picture(1, c=4)
    if mode.startswith("P"):
        img = Image.fromarray(rgba[..., :3]).quantize(40)
        kw = {"transparency": 3} if mode == "P-trns" else {}
        content = _pil_bytes(img, **kw)
    else:
        img = Image.fromarray(rgba).convert(mode)
        content = _pil_bytes(img)
    _same_as_pil(content)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("channels", [3, 4])
def test_png_row_filters_match_pil(filters, channels):
    content = port_image.encode_png(_picture(2, c=channels), filters)
    _same_as_pil(content)
    np.testing.assert_array_equal(
        port_image.imfrombytes(content, "unchanged"),
        _picture(2, c=channels))


@pytest.mark.parametrize("name", ["rgb.png", "rgba.png", "gray.png",
                                  "palette.png"])
def test_committed_pngs_match_pil(name):
    with open(os.path.join(DATA, name), "rb") as f:
        _same_as_pil(f.read())


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_imwrite_files_read_back_as_pil_reads_them(tmp_path, channels):
    img = _picture(3, c=channels)
    img = img[..., 0] if channels == 1 else img
    p = str(tmp_path / "a.png")
    port_image.imwrite(img, p)
    with open(p, "rb") as f:
        content = f.read()
    _same_as_pil(content)
    np.testing.assert_array_equal(port_image.imread(p, "unchanged"),
                                  img if channels == 1 else img[..., ::-1])
    np.testing.assert_array_equal(port_image.imread(p), jax_image.imread(p))


def test_png_faults_raise_by_name():
    good = port_image.encode_png(_picture(4), [4])
    ihdr = good[8:33]
    body = bytearray(ihdr[8:21])
    body[12] = 1                                        # interlace: Adam7
    interlaced = good[:8] + _chunk(b"IHDR", bytes(body)) + good[33:]
    with pytest.raises(ValueError, match="interlaced"):
        port_image.imfrombytes(interlaced, name="i.png")
    deep = _pil_bytes(Image.fromarray(
        (np.arange(600, dtype=np.uint16) * 97).reshape(20, 30)))
    with pytest.raises(ValueError, match="bit depth 16"):
        port_image.imfrombytes(deep, name="d.png")
    broken = bytearray(good)
    broken[40] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        port_image.imfrombytes(bytes(broken), name="b.png")


def test_png_unfilter_ref_rejects_an_unknown_filter():
    data = bytes([5]) + bytes(6)
    with pytest.raises(ValueError, match="filter type 5"):
        port_image.png_unfilter_ref(data, 1, 6, 3)


# ---- BMP ---------------------------------------------------------------------

def _top_down(bmp: bytes) -> bytes:
    """The same BMP stored top-down: the rows reversed, the height
    negative."""
    (offset,) = struct.unpack("<I", bmp[10:14])
    w, h, bits = struct.unpack("<iiH", bmp[18:28])[0:2] + \
        struct.unpack("<H", bmp[28:30])
    stride = (w * bits // 8 + 3) & ~3
    rows = np.frombuffer(bmp, np.uint8, stride * h, offset).reshape(h, -1)
    return (bmp[:22] + struct.pack("<i", -h) + bmp[26:offset]
            + rows[::-1].tobytes())


@pytest.mark.parametrize("mode", ["L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_matches_pil(mode, top_down):
    rgba = _picture(5, h=19, w=27, c=4)     # odd width: padded rows
    img = Image.fromarray(rgba).convert(mode) if mode != "P" else \
        Image.fromarray(rgba[..., :3]).quantize(50)
    content = _pil_bytes(img, "BMP")
    _same_as_pil(_top_down(content) if top_down else content)


# ---- what the reader refuses ------------------------------------------------

def test_tiff_and_jpeg_on_the_cpu_raise_by_name():
    img = Image.fromarray(_picture(6))
    with pytest.raises(NotImplementedError, match="t.tif.*TIFF"):
        port_image.imfrombytes(_pil_bytes(img, "TIFF"), name="t.tif")
    with open(os.path.join(DATA, "j420.jpg"), "rb") as f:
        jpeg = f.read()
    with pytest.raises(NotImplementedError, match="j.jpg.*nvJPEG"):
        port_image.imfrombytes(jpeg, name="j.jpg")
    with pytest.raises(NotImplementedError, match="x.gif"):
        port_image.imfrombytes(_pil_bytes(img, "GIF"), name="x.gif")
    with pytest.raises(NotImplementedError, match="writes PNG"):
        port_image.imwrite(_picture(6), "/nonexistent/a.bmp")


def test_committed_jpegs_have_their_pil_decodes():
    for name, shape in (("j420", (48, 64, 3)), ("j444", (48, 64, 3)),
                        ("jgray", (48, 64))):
        ref = np.load(os.path.join(DATA, name + ".npy"))
        assert ref.shape == shape and ref.dtype == np.uint8
        np.testing.assert_array_equal(
            ref, jax_image.imread(os.path.join(DATA, name + ".jpg"),
                                  "unchanged"))


def _dota_folder(root, ext):
    ann, img = root / "ann", root / "img"
    ann.mkdir()
    img.mkdir()
    for i in range(3):
        Image.fromarray(_picture(7 + i)).save(
            img / f"P{i}.{ext}", format={"jpg": "JPEG", "tif": "TIFF"}.get(
                ext, ext.upper()))
        (ann / f"P{i}.txt").write_text("1 1 9 1 9 5 1 5 plane 0\n")
    return str(ann), str(img)


@pytest.mark.parametrize("ext,ok", [("png", True), ("bmp", True),
                                    ("jpg", False), ("tif", False)])
def test_datasets_check_their_files_before_the_loop(tmp_path, ext, ok):
    ann, img = _dota_folder(tmp_path, ext)
    kw = dict(classes=("plane",), cache=False)
    if ok:
        ds = port_ds.DOTADataset(ann, img, **kw)
        assert ds.get_raw(2)["img"].shape == (21, 34, 3)
    else:
        with pytest.raises(NotImplementedError, match=f"P0.{ext}"):
            port_ds.DOTADataset(ann, img, **kw)
        with pytest.raises(NotImplementedError, match=f"P0.{ext}"):
            port_ds.build_dataset(dict(type="DroneVehicleDataset",
                                       ann_folder=ann, img_folder=img))
    coco = tmp_path / "ann.json"
    coco.write_text(json.dumps({
        "images": [{"id": i, "file_name": f"P{i}.{ext}"} for i in range(3)],
        "annotations": [], "categories": [{"id": 1, "name": "ship"}]}))
    if ok:
        assert len(port_ds.CocoDetDataset(str(coco), img)) == 3
    else:
        with pytest.raises(NotImplementedError, match=f"P0.{ext}"):
            port_ds.CocoDetDataset(str(coco), img)


def test_a_file_whose_bytes_are_not_its_name_is_refused(tmp_path):
    ann, img = _dota_folder(tmp_path, "png")
    os.rename(os.path.join(img, "P0.png"), os.path.join(img, "P0.bmp"))
    with pytest.raises(NotImplementedError, match="P0.bmp.*png"):
        port_ds.DOTADataset(ann, img, classes=("plane",), cache=False)
