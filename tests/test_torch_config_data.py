"""The port's config files, registry, detector builder, host IO, eval
datasets and eval pre-processing against the JAX package's, on the CPU.

The detector check builds ``configs/smoke_tiny.py``'s model through the
port's ``build_detector`` with the JAX model's params (``from_flax``) and
compares ``simple_test`` at fp32: scores within 1e-4, boxes within 1e-4 of
the image size (rotated boxes up to their other description, as in
``test_torch_rcnn_slice.py``). With random weights the GFL and R-CNN
scores sit under ``score_thr``: the GFL prior bias is raised and the
``fc_cls`` kernels scaled (and the ``rpn_reg`` kernels scaled down) as
there, so the NMS compares real detections.
"""

import glob
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.apis import eval_loop as jax_loop
from sm3det_tpu.data import datasets as jax_ds
from sm3det_tpu.data import loader as jax_loader
from sm3det_tpu.data import transforms as jax_T
from sm3det_tpu.models.detectors import trisource as jtri
from sm3det_tpu.ops import box_convert as jax_bc
from sm3det_tpu.ops.rotated_iou import box_iou_rotated as jax_iou
from sm3det_tpu.utils import fileio as jax_fileio
from sm3det_tpu.utils.config import Config as JaxConfig
from sm3det_tpu_torch.apis import eval_loop as port_loop
from sm3det_tpu_torch.convert import from_flax
from sm3det_tpu_torch.data import datasets as port_ds
from sm3det_tpu_torch.data import loader as port_loader
from sm3det_tpu_torch.data import transforms as port_T
from sm3det_tpu_torch.models import builder
from sm3det_tpu_torch.models.detectors import trisource as port_tri
from sm3det_tpu_torch.ops import box_convert as port_bc
from sm3det_tpu_torch.utils import fileio as port_fileio
from sm3det_tpu_torch.utils import image as port_image
from sm3det_tpu_torch.utils.config import Config, compat_cfg
from sm3det_tpu_torch.utils.registry import Registry, build_from_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["configs/smoke_tiny.py", "configs/sm3det_convnext_t.py",
           "configs/local_configs/SM3Det_convnext_t.py",
           "configs/local_configs/SM3Det_convnext_s.py",
           "configs/local_configs/SM3Det_convnext_b.py"]


def _cfg(path):
    return os.path.join(ROOT, path)


@pytest.mark.parametrize("path", CONFIGS)
def test_config_fromfile_matches_jax(path):
    got = Config.fromfile(_cfg(path))
    ref = JaxConfig.fromfile(_cfg(path))
    assert got.to_dict() == ref.to_dict()
    assert got.filename == ref.filename
    assert got.model.backbone.to_dict() == ref.model.backbone.to_dict()
    assert compat_cfg(got).to_dict() == got.to_dict()


def test_cli_options_match_jax():
    pairs = ["model.backbone.arch=small", "img_size=640",
             "data.rgb.max_gt=[1, 2]", "evaluation.metric=bbox",
             "model.sar.score_thr=0.1", "new.key.deep=None", "name=a=b"]
    got_opts = Config.parse_cli_options(pairs)
    assert got_opts == JaxConfig.parse_cli_options(pairs)
    got = Config.fromfile(_cfg("configs/smoke_tiny.py"))
    ref = JaxConfig.fromfile(_cfg("configs/smoke_tiny.py"))
    got.merge_from_dict(got_opts)
    ref.merge_from_dict(got_opts)
    assert got.to_dict() == ref.to_dict()
    assert got.model.backbone.arch == "small" and got.img_size == 640


def test_registry_builds_and_names_the_unknown():
    reg = Registry("things")

    @reg.register_module()
    class Thing:
        def __init__(self, a, b=1):
            self.a, self.b = a, b
    t = build_from_cfg(dict(type="Thing", a=3), reg, b=5)
    assert (t.a, t.b) == (3, 5)
    with pytest.raises(KeyError, match="Nope"):
        build_from_cfg(dict(type="Nope"), reg)


# ---- the detector builder --------------------------------------------------

IMG = 64
SHAPE = (IMG, IMG)


def _jax_init_all(m, imgs):
    ids = jnp.zeros((imgs.shape[0],), jnp.int32)
    feats, _ = m.backbone(imgs, train=True, dataset_ids=ids)
    x = m._neck_rcnn(list(feats))
    for rpn, roi in ((m.rgb_rpn_head, m.rgb_roi_head),
                     (m.ifr_rpn_head, m.ifr_roi_head)):
        rpn(x)
        roi(jnp.zeros((1, 7, 7, x[0].shape[-1]), x[0].dtype))
    return m.sar_bbox_head(m._neck_sar(list(feats)))


def jax_tiny_params(model_cfg, seed=0):
    """Params of the JAX detector of a config's ``model``, with the GFL
    prior bias raised, ``fc_cls`` scaled up and ``rpn_reg`` scaled down."""
    mc = dict(model_cfg)
    mc.pop("type", None)
    mc["backbone"] = dict(mc["backbone"])
    mc["backbone"]["moe_block_inds"] = tuple(
        tuple(x) for x in mc["backbone"]["moe_block_inds"])
    jmodel = jtri.TriSourceDetector(cfg=mc)
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    imgs = np.zeros((1, IMG, IMG, 3), np.float32)
    params = jax.jit(lambda x: jmodel.init(
        {"params": keys[0], "dropout": keys[1], "moe_noise": keys[2]}, x,
        method=_jax_init_all))(imgs)["params"]
    params = jax.tree.map(np.asarray, params)
    params["sar_bbox_head"]["gfl_cls"]["bias"] = np.full_like(
        params["sar_bbox_head"]["gfl_cls"]["bias"], 0.5)
    for head in ("rgb_roi_head", "ifr_roi_head"):
        params[head]["fc_cls"]["kernel"] = \
            params[head]["fc_cls"]["kernel"] * 12.0
    for head in ("rgb_rpn_head", "ifr_rpn_head"):
        params[head]["rpn_reg"]["kernel"] = \
            params[head]["rpn_reg"]["kernel"] * 0.2
    return jmodel, params


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = Config.fromfile(_cfg("configs/smoke_tiny.py"))
    jmodel, params = jax_tiny_params(cfg.model.to_dict())
    port = builder.build_detector(cfg.model, device="cpu",
                                  compute_dtype="float32")
    port.load_state_dict(from_flax(params), strict=True)
    imgs = np.random.RandomState(0).rand(2, IMG, IMG, 3).astype(np.float32)
    return jmodel, {"params": params}, port, imgs


def _same_obbs(got, ref, tol=1e-4):
    flat_g, flat_r = got.reshape(-1, 5), ref.reshape(-1, 5)
    close = np.abs(flat_g - flat_r).max(-1) <= tol * IMG
    if not close.all():
        iou = np.asarray(jax_iou(flat_g[~close], flat_r[~close],
                                 aligned=True))
        assert (iou >= 1 - 1e-4).all(), (flat_g[~close], flat_r[~close])


@pytest.mark.parametrize("which", ["sar", "rgb", "ifr"])
def test_build_detector_matches_jax_simple_test(tiny_pair, which):
    jmodel, variables, port, imgs = tiny_pair
    assert type(port) is port_tri.TriSourceDetector
    assert port.compute_dtype == torch.float32
    ref = jax.jit(lambda v, a: jmodel.apply(
        v, a, SHAPE, method=f"simple_test_{which}"))(variables, imgs)
    got = port.simple_test(imgs, which, img_shape=SHAPE)
    dets, labels, valid = (t.numpy() for t in got)
    rdets, rlabels, rvalid = (np.asarray(t) for t in ref)
    assert valid.sum() > 0                        # real detections
    np.testing.assert_array_equal(valid, rvalid)
    np.testing.assert_array_equal(labels, rlabels)
    np.testing.assert_allclose(dets[..., -1], rdets[..., -1], atol=1e-4)
    if which == "sar":
        np.testing.assert_allclose(dets, rdets, atol=1e-4 * IMG)
    else:
        _same_obbs(dets[..., :5], rdets[..., :5])


@pytest.mark.parametrize("arch", ["t", "s", "b"])
def test_flagship_configs_reach_the_detector(monkeypatch, arch):
    """``SM3Det_convnext_{t,s,b}``: the backbone gets the config's keys
    (a recording stand-in keeps the build small, and the initialisers'
    draws, which no assertion reads, are skipped)."""
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *args, **kwargs: t)
    seen = {}
    real = port_tri.ConvNeXtMoE

    def recording(**kw):
        seen.update(kw)
        return real(arch="atto", gen=kw["gen"])
    monkeypatch.setattr(port_tri, "ConvNeXtMoE", recording)
    cfg = Config.fromfile(_cfg(f"configs/local_configs/SM3Det_convnext_"
                               f"{arch}.py"))
    m = builder.build_detector(cfg.model, device="cpu",
                               compute_dtype="bfloat16")
    assert m.compute_dtype == torch.bfloat16
    assert seen["arch"] == {"t": "tiny", "s": "small", "b": "base"}[arch]
    assert seen["moe_block_inds"] == ((), (), (0, 2, 4, 6, 8), (0, 2))
    assert (seen["num_experts"], seen["top_k"], seen["gate"],
            seen["noisy_gating"], seen["capacity_factor"],
            seen["drop_path_rate"]) == (8, 3, "cosine", True, 1.5, 0.1)
    assert m.cfg["neck"]["in_channels"] == cfg.model.neck.in_channels
    assert "pretrained" not in m.cfg["backbone"]


@pytest.mark.parametrize("path,mtype,name", [
    ("configs/local_configs/dota_van_t_orcnn.py", None, "VAN_moe"),
    ("configs/local_configs/dota_lsk_t_orcnn.py", None, "LSKNet_moe"),
    ("configs/local_configs/dota_convnext_t_s2anet.py", "ReDet", "ReDet"),
    ("configs/local_configs/dota_convnext_t_roitrans.py", "GlidingVertex",
     "GlidingVertex")])
def test_unported_types_raise_by_name(path, mtype, name):
    cfg = Config.fromfile(_cfg(path)).model.to_dict()
    if mtype:
        cfg["type"] = mtype
    with pytest.raises(NotImplementedError, match=name):
        builder.build_detector(cfg, device="cpu")


def test_configs_the_port_builds():
    """61 of the 79 configs resolve to a detector the port builds (the DA
    baseline and the BabelRS fine-tune among them); the 18 others are the
    single-dataset LSKNet-MoE / VAN-MoE detectors, whose single-stem
    backbone is not ported."""
    paths = sorted(glob.glob(_cfg("configs/*.py"))
                   + glob.glob(_cfg("configs/local_configs/*.py"))
                   + glob.glob(_cfg("configs/BabelRS_configs/*.py")))
    built, refused = [], []
    for path in paths:
        try:
            builder.resolve_model_cfg(Config.fromfile(path).model)
            built.append(os.path.basename(path))
        except NotImplementedError as e:
            assert re.search(r"'(LSKNet|VAN)_moe'", str(e)), (path, e)
            refused.append(os.path.basename(path))
    assert (len(paths), len(built), len(refused)) == (79, 61, 18)
    assert "main_DA_convnext_t_orcnn_gfl.py" in built
    assert "BabelRS_20kstep.py" in built


def test_unported_keys_raise():
    """Unknown backbone and neck keys raise, naming them; the keys the DA
    baseline and the neck modes brought are taken (a neck mode is checked,
    and the detectors call the neck with "on_output" on each branch, as
    JAX's do); a neck mode that is not one raises, and so does a neck no
    ported backbone feeds."""
    cfg = Config.fromfile(_cfg("configs/smoke_tiny.py")).model.to_dict()
    cfg["backbone"]["da_block_inds"] = [[], [], [0], []]
    cfg["neck"]["add_extra_convs"] = "on_input"
    cls, mc, _ = builder.resolve_model_cfg(cfg)
    assert cls is port_tri.TriSourceDetector
    assert mc["backbone"]["da_block_inds"] == ((), (), (0,), ())
    assert mc["neck"]["add_extra_convs"] == "on_input"
    for key, value, match in (("add_extra_convs", "on_inputs", "on_inputs"),
                              ("type", "SimpleFPN", "SimpleFPN"),
                              ("upsample_cfg", {}, "upsample_cfg")):
        cfg = Config.fromfile(_cfg("configs/smoke_tiny.py")).model.to_dict()
        cfg["neck"][key] = value
        with pytest.raises((NotImplementedError, ValueError), match=match):
            builder.build_detector(cfg, device="cpu")
    cfg = Config.fromfile(_cfg("configs/smoke_tiny.py")).model.to_dict()
    cfg["backbone"]["use_grn"] = True
    with pytest.raises(NotImplementedError, match="use_grn"):
        builder.build_detector(cfg, device="cpu")
    with pytest.raises(KeyError, match="NoSuchDetector"):
        builder.build_detector(dict(cfg, type="NoSuchDetector"),
                               device="cpu")


def test_normalize_model_cfg_translates_kfiou():
    mc = builder.normalize_model_cfg(dict(
        bbox_head=dict(type="KFIoURRetinaHead"),
        refine_heads=[dict(type="KFIoUODMRefineHead")]))
    assert mc["reg_loss"] == "kfiou" and mc["refine_reg_loss"] == "kfiou"


# ---- box conversions, transforms, pipeline settings ------------------------

@pytest.mark.parametrize("version", ["le90", "le135", "oc"])
def test_numpy_box_conversions_match_jax(version):
    rng = np.random.RandomState(1)
    obbs = np.stack([rng.uniform(0, 500, 50), rng.uniform(0, 500, 50),
                     rng.uniform(2, 90, 50), rng.uniform(2, 90, 50),
                     rng.uniform(-1.6, 1.6, 50)], -1).astype(np.float32)
    polys = port_bc.obb2poly_np(obbs, version)
    np.testing.assert_array_equal(polys, jax_bc.obb2poly_np(obbs, version))
    np.testing.assert_array_equal(port_bc.poly2obb_np(polys, version),
                                  jax_bc.poly2obb_np(polys, version))
    a = rng.uniform(-7, 7, 100)
    np.testing.assert_array_equal(port_bc._norm_angle_np(a, version),
                                  jax_bc._norm_angle_np(a, version))
    np.testing.assert_array_equal(port_T._norm_angle_np(a, version),
                                  jax_T._norm_angle_np(a, version))


def test_eval_transforms_match_jax():
    rng = np.random.RandomState(2)
    img = (rng.rand(50, 80, 3) * 255).astype(np.uint8)
    obbs = rng.uniform(5, 40, (4, 5)).astype(np.float32)
    hbbs = rng.uniform(5, 40, (4, 4)).astype(np.float32)
    for keep in (True, False):
        got = port_T.resize(img, (64, 64), obbs, hbbs, keep_ratio=keep)
        ref = jax_T.resize(img, (64, 64), obbs, hbbs, keep_ratio=keep)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    f = img.astype(np.float32)
    np.testing.assert_array_equal(port_T.normalize(f), jax_T.normalize(f))
    np.testing.assert_array_equal(port_T.pad_to(f, (64, 96), 3.0),
                                  jax_T.pad_to(f, (64, 96), 3.0))
    labels = np.arange(4, dtype=np.int32)
    for g, r in zip(port_T.pad_gt(obbs, labels, 6, 5),
                    jax_T.pad_gt(obbs, labels, 6, 5)):
        np.testing.assert_array_equal(g, r)


def test_pipeline_cfg_from_config_matches_jax():
    cfg = Config.fromfile(_cfg("configs/sm3det_convnext_t.py"))
    for sub in ("sar", "rgb"):
        got = port_loader.PipelineCfg.from_config(cfg.data[sub], 800,
                                                  "le90")
        ref = jax_loader.PipelineCfg.from_config(
            JaxConfig.fromfile(_cfg("configs/sm3det_convnext_t.py"))
            .data[sub], 800, "le90")
        assert vars(got) == vars(ref)


# ---- file IO and images -----------------------------------------------------

def test_fileio_round_trips(tmp_path):
    obj = {"a": [1, 2.5, "x"], "b": {"c": None}}
    for fmt in ("json", "pkl"):
        p = str(tmp_path / f"o.{fmt}")
        port_fileio.dump(obj, p)
        assert port_fileio.load(p) == jax_fileio.load(p) == obj
    port_fileio.dump(obj, "memory://k.json")
    assert port_fileio.load("memory://k.json") == obj
    assert port_fileio.FileClient.infer_client("memory://k.json").exists(
        "memory://k.json")
    lst = tmp_path / "list.txt"
    lst.write_text("P0001\nP0002\r\nP0003\n")
    for kw in ({}, {"prefix": "x/", "offset": 1, "max_num": 1}):
        assert port_fileio.list_from_file(str(lst), **kw) == \
            jax_fileio.list_from_file(str(lst), **kw)
    dct = tmp_path / "dict.txt"
    dct.write_text("1 cat\n2 dog big\n")
    assert port_fileio.dict_from_file(str(dct), key_type=int) == \
        jax_fileio.dict_from_file(str(dct), key_type=int)


def test_image_read_write_matches_jax(tmp_path):
    from sm3det_tpu.utils import image as jax_image
    img = (np.random.RandomState(3).rand(20, 30, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "a.png")
    port_image.imwrite(img, p)
    np.testing.assert_array_equal(port_image.imread(p), img)
    np.testing.assert_array_equal(port_image.imread(p),
                                  jax_image.imread(p))
    for flag in ("grayscale", "unchanged"):
        np.testing.assert_array_equal(port_image.imread(p, flag=flag),
                                      jax_image.imread(p, flag=flag))


# ---- datasets ---------------------------------------------------------------

DOTA_CLASSES = ("plane", "ship", "bridge", "harbor")


def _write_dota(root):
    from PIL import Image
    ann, img = root / "annfiles", root / "images"
    ann.mkdir()
    img.mkdir()
    rng = np.random.RandomState(4)
    for i, pid in enumerate(["P0001__1.0__0___0", "P0001__1.0__32___0",
                             "P0002"]):
        Image.fromarray((rng.rand(40 + 8 * i, 48, 3) * 255)
                        .astype(np.uint8)).save(img / f"{pid}.png")
        lines = []
        for j in range(4):
            cx, cy = rng.uniform(10, 30, 2)
            w, h, a = rng.uniform(6, 14), rng.uniform(3, 6), rng.rand()
            c, s = np.cos(a), np.sin(a)
            pts = [(cx + dx * c - dy * s, cy + dx * s + dy * c)
                   for dx, dy in ((-w, -h), (w, -h), (w, h), (-w, h))]
            lines.append(" ".join(f"{v:.1f}" for p in pts for v in p) +
                         f" {DOTA_CLASSES[(i + j) % 5 % 4]} {j % 3}")
        lines.append("imagesource:GoogleEarth")
        lines.append("1 2 3 4 5 6 7 8 unknown-class 0")
        (ann / f"{pid}.txt").write_text("\n".join(lines) + "\n")
    return str(ann), str(img)


def _assert_same_raw(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert got[k] == ref[k]


@pytest.mark.parametrize("version", ["le90", "le135"])
def test_dota_dataset_matches_jax(tmp_path, version):
    ann, img = _write_dota(tmp_path)
    kw = dict(classes=DOTA_CLASSES, version=version, filter_difficulty=1)
    ref = jax_ds.DOTADataset(ann, img, cache=False, **kw)
    for _ in range(2):                  # built, then from the cache
        got = port_ds.DOTADataset(ann, img, **kw)
        assert len(got) == len(ref) == 3
        for i in range(len(ref)):
            _assert_same_raw(got.get_raw(i), ref.get_raw(i))
    assert any("obbs_ignore" in got.get_raw(i) for i in range(3))
    built = port_ds.build_dataset(dict(type="DroneVehicleDataset",
                                       ann_folder=ann, img_folder=img,
                                       max_gt=8), version=version)
    assert built.CLASSES == port_ds.DRONEVEHICLE_CLASSES


def test_coco_dataset_matches_jax(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(5)
    cats = [{"id": 7, "name": "ship"}, {"id": 3, "name": "aircraft"},
            {"id": 11, "name": "car"}]
    images, anns = [], []
    for i in range(3):
        Image.fromarray((rng.rand(32, 40, 3) * 255).astype(np.uint8)).save(
            tmp_path / f"im{i}.jpg", quality=95)
        images.append({"id": 100 + i, "file_name": f"im{i}.jpg"})
        for j in range(3 + i):
            x, y = rng.uniform(0, 20, 2)
            w, h = rng.uniform(3, 12, 2)
            a = {"id": len(anns), "image_id": 100 + i,
                 "category_id": [7, 3, 11, 99][j % 4],
                 "bbox": [float(x), float(y), float(w), float(h)],
                 "iscrowd": int(j == 2)}
            if j % 2:
                a["area"] = float(w * h * 0.8)
            anns.append(a)
    p = tmp_path / "ann.json"
    p.write_text(json.dumps({"images": images, "annotations": anns,
                             "categories": cats}))
    for classes in (None, ("car", "ship")):
        ref = jax_ds.CocoDetDataset(str(p), str(tmp_path), classes=classes)
        got = port_ds.CocoDetDataset(str(p), str(tmp_path), classes=classes)
        assert got.CLASSES == ref.CLASSES
        for i in range(len(ref)):
            _assert_same_raw(got.get_raw(i), ref.get_raw(i))
        assert got.cat_ids == [{"aircraft": 3, "ship": 7, "car": 11}[c]
                               for c in got.CLASSES]


@pytest.mark.parametrize("box_type", ["obb", "hbb"])
def test_synthetic_dataset_matches_jax(box_type):
    kw = dict(n=5, img_size=48, num_classes=6, box_type=box_type, seed=7)
    got, ref = port_ds.SyntheticDetDataset(**kw), \
        jax_ds.SyntheticDetDataset(**kw)
    assert len(got) == len(ref) and got.CLASSES == ref.CLASSES
    for i in range(5):
        _assert_same_raw(got.get_raw(i), ref.get_raw(i))
    # the wrappers build recursively, as the JAX package's builder does
    rep = dict(type="RepeatDataset", times=2,
               dataset=dict(type="SyntheticDetDataset", **kw))
    got, ref = port_ds.build_dataset(rep), jax_ds.build_dataset(rep)
    assert len(got) == len(ref) == 10
    for i in (0, 7):
        _assert_same_raw(got.get_raw(i), ref.get_raw(i))


# ---- the eval pre-processing -----------------------------------------------

MEAN, STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)


@pytest.mark.parametrize("hw", [(64, 64), (100, 100), (80, 50), (37, 90)])
def test_preprocess_uint8_matches_jax(hw):
    rng = np.random.RandomState(hw[0])
    raw = {"img": (rng.rand(*hw, 3) * 255).astype(np.uint8)}
    got, gs = port_loop.preprocess_uint8(raw, 64, MEAN)
    ref, rs = jax_loop.preprocess_uint8(raw, 64, MEAN)
    assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, ref)
    assert gs == rs


def test_device_normalisation_is_jax_bit_for_bit():
    rng = np.random.RandomState(6)
    x = (rng.rand(2, 16, 24, 3) * 255).astype(np.uint8)
    mean_d = jnp.asarray(MEAN, jnp.float32)
    inv_std_d = jnp.asarray(1.0 / np.asarray(STD, np.float32))
    perm = jnp.asarray([2, 1, 0])
    ref = jax.jit(lambda v: (jnp.take(v.astype(jnp.float32), perm, axis=-1)
                             - mean_d) * inv_std_d)(x)
    got = port_loop.normalize_uint8(torch.from_numpy(x), torch.tensor(MEAN),
                                    torch.tensor(STD))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    seen = {}

    class Probe:
        def simple_test_rgb(self, imgs, img_shape):
            seen["x"], seen["shape"] = imgs, img_shape
            return imgs
    fn = port_loop.make_uint8_test_fn(Probe(), "simple_test_rgb", 24, MEAN,
                                      STD)
    fn(torch.from_numpy(x))
    np.testing.assert_array_equal(seen["x"].numpy(), np.asarray(ref))
    assert seen["shape"] == (24, 24)


def test_annotation_of_matches_jax():
    raw = dict(obbs=np.ones((2, 5), np.float32), labels=np.array([0, 1]),
               obbs_ignore=np.zeros((1, 5), np.float32),
               labels_ignore=np.array([2]), areas=np.array([3.0, 4.0]),
               obbs_crowd=np.zeros((1, 5), np.float32),
               labels_crowd=np.array([1]), areas_crowd=np.array([9.0]))
    got = port_loop.annotation_of(raw, "obbs")
    ref = jax_loop.annotation_of(raw, "obbs")
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
