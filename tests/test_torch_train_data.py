"""The port's train data pipeline against the JAX package's, on the CPU.

The samplers' index streams, every train augmentation, ``run_pipeline`` for
the SAR (horizontal boxes) and oriented pipelines of
``configs/_base_/soi_det.py``, ``TriSourceLoader``'s batches and the
dataset wrappers, HRSC and the structured synthetic dataset: the same
seeds and inputs through both packages give equal arrays (``np.array_equal``,
dtypes too), bit for bit.
"""

import numpy as np
import pytest

from sm3det_tpu.data import datasets as jax_ds
from sm3det_tpu.data import loader as jax_loader
from sm3det_tpu.data import sampler as jax_sampler
from sm3det_tpu.data import transforms as jax_T
from sm3det_tpu_torch.data import datasets as port_ds
from sm3det_tpu_torch.data import loader as port_loader
from sm3det_tpu_torch.data import sampler as port_sampler
from sm3det_tpu_torch.data import transforms as port_T
from sm3det_tpu_torch.utils.config import Config
from torch_jax_refs import one_torch_thread  # noqa: F401

SOI = "configs/_base_/soi_det.py"


def _same(got, ref):
    """Equal nested dicts / tuples / lists of arrays and scalars."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys()
        for k in ref:
            _same(got[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


# ---- samplers ---------------------------------------------------------------

@pytest.mark.parametrize("sizes,ratio,seed", [
    ((7, 5, 3), (2, 1, 1), 0), ((64, 64, 64), (2, 1, 1), 3),
    ((11, 2, 9), (1, 3, 2), 11), ((4, 4, 4), (4, 2, 2), 5)])
@pytest.mark.parametrize("num_hosts", [1, 2])
def test_multi_source_sampler_matches_jax(sizes, ratio, seed, num_hosts):
    for host in range(num_hosts):
        kw = dict(seed=seed, host_id=host, num_hosts=num_hosts)
        got = iter(port_sampler.MultiSourceSampler(sizes, ratio, **kw))
        ref = iter(jax_sampler.MultiSourceSampler(sizes, ratio, **kw))
        for _ in range(50):
            assert next(got) == next(ref)
    unshuffled = port_sampler.MultiSourceSampler(sizes, ratio,
                                                 shuffle=False)
    first = next(iter(unshuffled))
    assert first == next(iter(jax_sampler.MultiSourceSampler(
        sizes, ratio, shuffle=False)))


@pytest.mark.parametrize("seed,num_hosts", [(0, 1), (2, 1), (7, 2)])
def test_group_sampler_matches_jax(seed, num_hosts):
    sizes, ratio = (13, 6, 9), (2, 1, 1)

    def group_of(s, i):
        return (i * 7 + s) % 3 == 0 if s != 1 else 0    # source 1: one group

    for host in range(num_hosts):
        kw = dict(seed=seed, host_id=host, num_hosts=num_hosts)
        got = iter(port_sampler.GroupMultiSourceSampler(sizes, ratio,
                                                        group_of, **kw))
        ref = iter(jax_sampler.GroupMultiSourceSampler(sizes, ratio,
                                                       group_of, **kw))
        for _ in range(50):
            assert next(got) == next(ref)


# ---- transforms -------------------------------------------------------------

def _obbs(rng, n, s):
    return np.stack([rng.uniform(0.1 * s, 0.9 * s, n),
                     rng.uniform(0.1 * s, 0.9 * s, n),
                     rng.uniform(4, 0.3 * s, n), rng.uniform(3, 0.2 * s, n),
                     rng.uniform(-np.pi / 2, np.pi / 2, n)],
                    -1).astype(np.float32)


def _hbbs(rng, n, s):
    xy = rng.uniform(0, 0.7 * s, (n, 2))
    wh = rng.uniform(3, 0.3 * s, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("version", ["le90", "le135", "oc"])
@pytest.mark.parametrize("direction", ["horizontal", "vertical",
                                       "diagonal"])
def test_flip_boxes_match_jax(version, direction):
    rng = np.random.RandomState(3)
    obbs = _obbs(rng, 9, 96)
    obbs[0, 4] = np.pi / 2          # the oc special case
    _same(port_T.flip_obbs(obbs, (80, 96), direction, version),
          jax_T.flip_obbs(obbs, (80, 96), direction, version))
    hbbs = _hbbs(rng, 9, 96)
    _same(port_T.flip_hbbs(hbbs, (80, 96), direction),
          jax_T.flip_hbbs(hbbs, (80, 96), direction))


@pytest.mark.parametrize("prob,direction", [
    (0.5, "horizontal"), (1.0, ("horizontal", "vertical")),
    ([0.25, 0.25, 0.25], ("horizontal", "vertical", "diagonal")),
    ([0.0, 0.6, 0.4], ("horizontal", "vertical", "diagonal"))])
def test_random_flip_matches_jax(prob, direction):
    for seed in range(12):
        rng = np.random.RandomState(100 + seed)
        img = (rng.rand(72, 64, 3) * 255).astype(np.uint8)
        obbs, hbbs = _obbs(rng, 5, 64), _hbbs(rng, 4, 64)
        got = port_T.random_flip(np.random.RandomState(seed), img, obbs,
                                 hbbs, prob=prob, direction=direction)
        ref = jax_T.random_flip(np.random.RandomState(seed), img, obbs,
                                hbbs, prob=prob, direction=direction)
        _same(got, ref)


@pytest.mark.parametrize("mode,rect", [("range", ()), ("range", (0, 2)),
                                       ("discrete", (1,))])
def test_poly_random_rotate_matches_jax(mode, rect):
    kw = dict(rotate_ratio=0.7, angles_range=180, mode=mode,
              discrete_angles=(90.0, 180.0, -90.0, 30.0), rect_classes=rect)
    rotated = 0
    for seed in range(10):
        rng = np.random.RandomState(seed)
        img = (rng.rand(80, 96, 3) * 255).astype(np.uint8)
        obbs = _obbs(rng, 8, 80)
        labels = rng.randint(0, 4, 8).astype(np.int32)
        got = port_T.poly_random_rotate(np.random.RandomState(seed), img,
                                        obbs, labels, **kw)
        ref = jax_T.poly_random_rotate(np.random.RandomState(seed), img,
                                       obbs, labels, **kw)
        _same(got, ref)
        rotated += got[0] is not img
    assert 0 < rotated < 10


def test_rotate_800_image_matches_jax():
    """One full-size rotation of an 800^2 image (the oriented pipeline's
    largest host cost)."""
    rng = np.random.RandomState(8)
    img = (rng.rand(800, 800, 3) * 255).astype(np.uint8)
    for theta in (0.37, -2.1):
        _same(port_T._rotate_image(img, theta),
              jax_T._rotate_image(img, theta))


def test_random_crop_matches_jax():
    outcomes = set()
    for seed in range(30):
        rng = np.random.RandomState(seed)
        img = (rng.rand(96, 80, 3) * 255).astype(np.uint8)
        obbs = _obbs(rng, 3, 80)
        labels = np.arange(3, dtype=np.int32)
        for size in ((48, 40), (120, 60)):
            got = port_T.random_crop(np.random.RandomState(seed), img, obbs,
                                     labels, size)
            ref = jax_T.random_crop(np.random.RandomState(seed), img, obbs,
                                    labels, size)
            _same(got, ref)
            outcomes.add(got[0] is None)
    assert outcomes == {True, False}       # a crop with no box happened
    empty = np.zeros((0, 5), np.float32)
    _same(port_T.random_crop(np.random.RandomState(1), img, empty,
                             labels[:0], (40, 40)),
          jax_T.random_crop(np.random.RandomState(1), img, empty,
                            labels[:0], (40, 40)))


def test_mosaic_matches_jax():
    for seed in range(4):
        rng = np.random.RandomState(seed)
        samples = [dict(img=(rng.rand(40 + 8 * i, 56, 3) * 255).astype(
                            np.uint8),
                        obbs=_obbs(rng, 4, 48),
                        labels=rng.randint(0, 5, 4).astype(np.int32))
                   for i in range(4)]
        samples[2]["obbs"] = np.zeros((0, 5), np.float32)
        samples[2]["labels"] = np.zeros((0,), np.int32)
        _same(port_T.mosaic(np.random.RandomState(seed), samples, 48),
              jax_T.mosaic(np.random.RandomState(seed), samples, 48))


# ---- run_pipeline -----------------------------------------------------------

def _pipes(img_size):
    cfg = Config.fromfile(SOI)
    out = {}
    for key in ("sar", "rgb"):
        kw = dict(img_size=img_size, version=cfg.angle_version,
                  max_gt=cfg.data[key].get("max_gt", 256))
        out[key] = (port_loader.PipelineCfg.from_config(cfg.data[key], **kw),
                    jax_loader.PipelineCfg.from_config(cfg.data[key], **kw))
    return out


@pytest.mark.parametrize("key", ["sar", "rgb"])
@pytest.mark.parametrize("size", [(64, 64), (100, 128), (128, 90)])
def test_run_pipeline_matches_jax(key, size):
    port_cfg, jax_cfg = _pipes(96)[key]
    for seed in range(6):
        rng = np.random.RandomState(seed + size[0])
        raw = dict(img=(rng.rand(*size, 3) * 255).astype(np.uint8),
                   labels=rng.randint(0, 26, 6).astype(np.int32))
        if key == "sar":
            raw["hbbs"] = _hbbs(rng, 6, min(size))
        else:
            raw["obbs"] = _obbs(rng, 6, min(size))
        _same(port_loader.run_pipeline(np.random.RandomState(seed), raw,
                                       port_cfg),
              jax_loader.run_pipeline(np.random.RandomState(seed), raw,
                                      jax_cfg))
    crop = port_loader.PipelineCfg(img_size=96, crop_size=(64, 48),
                                   rotate_ratio=0.5)
    jcrop = jax_loader.PipelineCfg(img_size=96, crop_size=(64, 48),
                                   rotate_ratio=0.5)
    if key == "rgb":
        for seed in range(6):
            _same(port_loader.run_pipeline(np.random.RandomState(seed), raw,
                                           crop),
                  jax_loader.run_pipeline(np.random.RandomState(seed), raw,
                                          jcrop))


def test_run_pipeline_800_with_rotation_matches_jax():
    port_cfg, jax_cfg = _pipes(800)["rgb"]
    rng = np.random.RandomState(4)
    raw = dict(img=(rng.rand(800, 800, 3) * 255).astype(np.uint8),
               obbs=_obbs(rng, 12, 800),
               labels=rng.randint(0, 26, 12).astype(np.int32))
    # a seed whose draw rotates the image
    seed = next(s for s in range(50)
                if np.random.RandomState(s).rand(2)[1] < 0.5)
    got = port_loader.run_pipeline(np.random.RandomState(seed), raw,
                                   port_cfg)
    _same(got, jax_loader.run_pipeline(np.random.RandomState(seed), raw,
                                       jax_cfg))
    assert not np.array_equal(got["gt_obbs"][:12, 4], raw["obbs"][:, 4])


# ---- TriSourceLoader --------------------------------------------------------

@pytest.fixture(scope="module")
def loader_parts():
    cfg = Config.fromfile(SOI)
    S = 64
    out = []
    for pkg_ds, pkg_loader in ((port_ds, port_loader),
                               (jax_ds, jax_loader)):
        dss = [pkg_ds.SyntheticDetDataset(
                   n=n, img_size=sz, num_classes=26, seed=i,
                   box_type="hbb" if i == 0 else "obb")
               for i, (n, sz) in enumerate(((9, 80), (5, 64), (7, 72)))]
        pipes = [pkg_loader.PipelineCfg.from_config(
                     cfg.data[k], img_size=S, version="le90",
                     max_gt=cfg.data[k].get("max_gt", 256) // 4)
                 for k in ("sar", "rgb", "ifr")]
        out.append((dss, pipes))
    return out


@pytest.mark.parametrize("num_workers", [0, 4])
@pytest.mark.parametrize("batches_per_step", [1, 2])
def test_tri_source_loader_matches_jax(loader_parts, num_workers,
                                       batches_per_step):
    (pds, ppipes), (jds, jpipes) = loader_parts
    kw = dict(batches_per_step=batches_per_step, seed=3,
              num_workers=num_workers)
    got = iter(port_loader.TriSourceLoader(pds, (2, 1, 1), ppipes, **kw))
    ref = iter(jax_loader.TriSourceLoader(jds, (2, 1, 1), jpipes,
                                          num_workers=0,
                                          batches_per_step=batches_per_step,
                                          seed=3))
    for _ in range(4):
        b = next(got)
        _same(b, next(ref))
        assert b["sar"]["img"].shape[0] == 2 * batches_per_step
    got.close()


def test_tri_source_loader_host_shares(loader_parts):
    """Two hosts' shares of batch i, put together per source, are the
    one-host batch i."""
    (pds, ppipes), _ = loader_parts
    one = next(iter(port_loader.TriSourceLoader(pds, (2, 1, 1), ppipes,
                                                num_workers=0, seed=5,
                                                batches_per_step=2)))
    shares = [next(iter(port_loader.TriSourceLoader(
        pds, (2, 1, 1), ppipes, num_workers=0, seed=5, host_id=h,
        num_hosts=2))) for h in range(2)]
    for mod in ("sar", "rgb", "ifr"):
        for k, v in one[mod].items():
            np.testing.assert_array_equal(
                np.concatenate([s[mod][k] for s in shares]), v)


def test_tri_source_loader_raises_a_worker_error(loader_parts):
    (pds, ppipes), _ = loader_parts

    class Broken:
        def __len__(self):
            return 3

        def get_raw(self, idx):
            raise OSError("unreadable image")

    it = iter(port_loader.TriSourceLoader([pds[0], Broken(), pds[2]],
                                          (2, 1, 1), ppipes, num_workers=2))
    with pytest.raises(OSError, match="unreadable"):
        next(it)


# ---- datasets ---------------------------------------------------------------

@pytest.mark.parametrize("box_type", ["obb", "hbb"])
def test_structured_synthetic_matches_jax(box_type):
    kw = dict(n=6, img_size=96, num_classes=4, box_type=box_type, seed=101)
    got = port_ds.StructuredSyntheticDetDataset(**kw)
    ref = jax_ds.StructuredSyntheticDetDataset(**kw)
    assert len(got) == len(ref) and got.CLASSES == ref.CLASSES
    for i in range(6):
        _same(got.get_raw(i), ref.get_raw(i))


def test_dataset_wrappers_match_jax():
    leaf = dict(type="SyntheticDetDataset", n=40, img_size=16,
                num_classes=7, max_objects=3, seed=2)
    for dcfg in (
            dict(type="ClassBalancedDataset", oversample_thr=0.8,
                 dataset=leaf),
            dict(type="ClassBalancedDataset", oversample_thr=0.05,
                 dataset=dict(leaf, seed=9)),
            dict(type="RepeatDataset", times=3,
                 dataset=dict(leaf, n=5)),
            dict(type="ConcatDataset", datasets=[
                dict(leaf, n=4), dict(type="RepeatDataset", times=2,
                                      dataset=dict(leaf, n=3, seed=4)),
                dict(type="StructuredSyntheticDetDataset", n=2,
                     img_size=32, num_classes=7)])):
        got = port_ds.build_dataset(dcfg)
        ref = jax_ds.build_dataset(dcfg)
        assert type(got).__name__ == type(ref).__name__
        assert len(got) == len(ref)
        if dcfg["type"] == "ClassBalancedDataset":
            assert got._indices == ref._indices
            assert len(got) >= 40
        for i in range(len(ref)):
            _same(got.get_raw(i), ref.get_raw(i))
    # the first config repeats some images
    assert len(port_ds.build_dataset(dict(
        type="ClassBalancedDataset", oversample_thr=0.8, dataset=leaf))) > 40


def test_hrsc_dataset_matches_jax(tmp_path):
    from PIL import Image
    ann, img = tmp_path / "ann", tmp_path / "img"
    ann.mkdir()
    img.mkdir()
    rng = np.random.RandomState(6)
    for i, n in enumerate((2, 0, 3)):
        objs = "".join(
            "<HRSC_Object>"
            f"<mbox_cx>{rng.uniform(10, 50):.4f}</mbox_cx>"
            f"<mbox_cy>{rng.uniform(10, 50):.4f}</mbox_cy>"
            f"<mbox_w>{rng.uniform(8, 30):.4f}</mbox_w>"
            f"<mbox_h>{rng.uniform(3, 10):.4f}</mbox_h>"
            f"<mbox_ang>{rng.uniform(-1.5, 1.5):.4f}</mbox_ang>"
            "</HRSC_Object>" for _ in range(n))
        (ann / f"1000{i}.xml").write_text(
            f"<HRSC_Image><HRSC_Objects>{objs}</HRSC_Objects></HRSC_Image>")
        Image.fromarray((rng.rand(40, 60, 3) * 255).astype(np.uint8)).save(
            img / f"1000{i}.png")
    for version in ("le90", "le135"):
        got = port_ds.HRSCDataset(str(ann), str(img), version=version)
        ref = jax_ds.HRSCDataset(str(ann), str(img), version=version)
        assert len(got) == len(ref) == 3 and got.CLASSES == ref.CLASSES
        for i in range(3):
            _same(got.get_raw(i), ref.get_raw(i))
    built = port_ds.build_dataset(dict(type="HRSCDataset",
                                       ann_folder=str(ann) + "/",
                                       img_folder=str(img) + "/"))
    assert isinstance(built, port_ds.HRSCDataset) and len(built) == 3
