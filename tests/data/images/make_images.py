"""Write the small image files of this folder, and PIL's decodes of the
JPEGs beside them (``<name>.npy``, ``np.asarray`` of the opened file).

    python tests/data/images/make_images.py

Each image is 64 x 48, from a seed: smooth ramps and a few squares, so the
JPEGs' chroma subsampling and the PNG filters all have work to do.
"""

import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def picture(seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:48, 0:64].astype(np.float32)
    img = np.stack([x * 4, y * 5, (x + y) * 2], -1)
    for _ in range(4):
        x0, y0 = rng.randint(0, 48), rng.randint(0, 36)
        img[y0:y0 + 12, x0:x0 + 16] = rng.randint(0, 256, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    rgb = picture(0)
    Image.fromarray(rgb).save(os.path.join(HERE, "rgb.png"))
    Image.fromarray(np.concatenate([picture(1), picture(2)[..., :1]], -1),
                    "RGBA").save(os.path.join(HERE, "rgba.png"))
    Image.fromarray(picture(3)).convert("L").save(
        os.path.join(HERE, "gray.png"))
    Image.fromarray(picture(4)).quantize(32).save(
        os.path.join(HERE, "palette.png"))
    jpegs = {"j420.jpg": (Image.fromarray(picture(5)), 2),
             "j444.jpg": (Image.fromarray(picture(6)), 0),
             "jgray.jpg": (Image.fromarray(picture(7)).convert("L"), None)}
    for name, (im, sub) in jpegs.items():
        path = os.path.join(HERE, name)
        kw = {} if sub is None else {"subsampling": sub}
        im.save(path, quality=90, **kw)
        np.save(os.path.join(HERE, name[:-4] + ".npy"),
                np.asarray(Image.open(path)))


if __name__ == "__main__":
    main()
