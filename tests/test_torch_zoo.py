"""The zoo's single-dataset detectors against the JAX package, the 19
configs this slice builds, and the train / test entry points on the
variants, on the CPU, at fp32.

The detectors (``OrientedRCNN``, ``GFL``, ``RotatedRetinaNet``,
``FasterRCNN``, ``CascadeRCNN``, ``RetinaNet``) run at the fixture of
``tests/test_detector_variants.py`` (``atto``, 64 px, 4 classes, four gts
an image, two images) with the single-stem backbone and no MoE block, as
the zoo's ConvNeXt configs have it (JAX's zoo backbone always draws gate
noise in training, which the port cannot share), and no stochastic
depth. Their parameters are flax inits of the backbone, the neck and each
head on their own, carried over by ``from_flax``; the layer scales are
drawn from U(0.3, 0.8), the oriented RPN's regressor scaled by 0.2, as in
``tests/test_torch_variant_train.py``, and the rotated RetinaNet's class
bias raised by 3 (scores above the 0.05 test threshold). The samplers are
handed the keys ``jax.random`` drew for the JAX detector.

Held: every loss within 1e-4 relative; ``simple_test``'s detections with
the validity and labels of JAX's, boxes within 1e-4 of scale and scores
within 1e-5 (the two-stage detector's proposals feed the same R-CNN).

The configs: each of the 19 builds through ``build_detector`` on the CPU
as the class its type names (parameters left at the allocation's values:
the build, not the init, is under test here), and the names still not
ported raise naming their ROADMAP item. The entry points:
``tools.train --device cpu`` trains a tiny variant for 2 iterations and
resumes its checkpoint bit for bit; a variant with ``evaluation`` set
stops before its first step; ``tools.test`` refuses a variant and a
single-dataset config; ``tools.train`` refuses a single-dataset config.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sm3det_tpu.models.backbones.convnext import ConvNeXtMoE as JaxConvNeXt
from sm3det_tpu.models.dense_heads.gfl_head import GFLHead as JaxGFLHead
from sm3det_tpu.models.dense_heads.oriented_rpn_head import \
    OrientedRPNHead as JaxORPN
from sm3det_tpu.models.dense_heads.rotated_retina_head import \
    RotatedRetinaHead as JaxRetinaHead
from sm3det_tpu.models.dense_heads.rpn_head import RPNHead as JaxRPN
from sm3det_tpu.models.detectors import hbb_detectors as jhbb
from sm3det_tpu.models.detectors import zoo as jzoo
from sm3det_tpu.models.necks.fpn import MultitaskFPN as JaxFPN
from sm3det_tpu.models.roi_heads.oriented_roi_head import \
    RotatedShared2FCBBoxHead as JaxRoIHead
from sm3det_tpu.models.roi_heads.standard_roi_head import \
    Shared2FCBBoxHead as JaxHBBRoIHead
from sm3det_tpu_torch.convert import from_flax
from sm3det_tpu_torch.models import builder
from sm3det_tpu_torch.models.detectors import hbb_detectors, zoo
from sm3det_tpu_torch.tools import test as test_cli
from sm3det_tpu_torch.tools import train as train_cli
from sm3det_tpu_torch.train.train_state import batch_to
from sm3det_tpu_torch.utils.config import Config

from test_detector_variants import APPLY_RNGS, CFG as VARIANT_CFG, IMG, \
    _batch

CFG = copy.deepcopy(VARIANT_CFG)
CFG["backbone"] = dict(arch="atto", drop_path_rate=0.0,
                       moe_block_inds=[[], [], [], []])
CFG["rcnn"] = dict(rpn_sample=256, rcnn_sample=128, rpn_nms_pre=64,
                   rpn_max=64, rpn_nms_iou=0.8, score_thr=0.05, nms_iou=0.1,
                   max_per_img=50)
NC, G = CFG["num_classes"], 4
CH = CFG["neck"]["out_channels"]
N_ANCHORS = 3 * sum((IMG // s) ** 2 for s in (4, 8, 16, 32, 64))
SMOKE = "configs/smoke_tiny.py"
LC = "configs/local_configs/"
UNLOCKED = (
    ["SM3Det_convnext_t_orcnn_frcnn"]
    + [f"SM3Det_convnext_t_{a}_{b}" for a, b in (
        ("roitrans", "cascade"), ("roitrans", "retina"), ("s2anet", "cascade"),
        ("s2anet", "frcnn"), ("s2anet", "gfl"), ("s2anet", "retina"))]
    + [f"{d}_convnext_{a}_orcnn" for d in ("dota", "dronevehicle")
       for a in "tsb"]
    + [f"sardet50k_convnext_{a}_gfl" for a in "tsb"]
    + [f"sardet50k_convnext_t_{h}" for h in ("frcnn", "cascade", "retina")])
# (JAX class, port class)
DETECTORS = {
    "OrientedRCNN": (jzoo.OrientedRCNN, zoo.OrientedRCNN),
    "GFL": (jzoo.GFLDetector, zoo.GFLDetector),
    "RotatedRetinaNet": (jzoo.RotatedRetinaNet, zoo.RotatedRetinaNet),
    "FasterRCNN": (jhbb.FasterRCNN, hbb_detectors.FasterRCNN),
    "CascadeRCNN": (jhbb.CascadeRCNN, hbb_detectors.CascadeRCNN),
    "RetinaNet": (jhbb.RetinaNet, hbb_detectors.RetinaNet),
}
HBB = ("GFL", "FasterRCNN", "CascadeRCNN", "RetinaNet")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


class _StageRngs(nn.Module):
    n: int

    def __call__(self):
        return [self.make_rng("sampling") for _ in range(self.n)]


def _split_keys(rng, b, p):
    kp, kn = [], []
    for r in jax.random.split(rng, b):
        rp, rn = jax.random.split(r)
        kp.append(np.asarray(jax.random.uniform(rp, (p,))))
        kn.append(np.asarray(jax.random.uniform(rn, (p,))))
    return torch.from_numpy(np.stack(kp)), torch.from_numpy(np.stack(kn))


def sample_keys(name, b):
    """The sampler keys the JAX detector draws under ``APPLY_RNGS``."""
    if name == "OrientedRCNN":
        sizes = [N_ANCHORS, G + CFG["rcnn"]["rpn_max"]]
    elif name == "FasterRCNN":
        sizes = [N_ANCHORS, G + 256]
    elif name == "CascadeRCNN":
        sizes = [N_ANCHORS, G + 256, G + 128, G + 128]
    else:
        return None
    rngs = _StageRngs(len(sizes)).apply(
        {}, rngs={"sampling": APPLY_RNGS["sampling"]})
    return [_split_keys(r, b, p) for r, p in zip(rngs, sizes)]


@pytest.fixture(scope="module")
def data():
    b = _batch(np.random.RandomState(0))
    obb = {k: np.concatenate([b["rgb"][k], b["ifr"][k]])
           for k in b["rgb"]}
    return {"hbb": b["sar"], "obb": obb}


@pytest.fixture(scope="module")
def modules():
    """Flax inits of every module the six detectors are made of."""
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 8)
    imgs = jnp.zeros((1, IMG, IMG, 3))
    bb = JaxConvNeXt(arch="atto", moe_block_inds=((), (), (), ()))
    p_bb = jax.jit(bb.init)(ks[0], imgs)["params"]
    feats = [jnp.zeros((1, IMG // s, IMG // s, c)) for s, c in
             zip((4, 8, 16, 32), CFG["neck"]["in_channels"])]
    neck = JaxFPN(in_channels=tuple(CFG["neck"]["in_channels"]),
                  out_channels=CH, num_outs=5, extra_level=1)
    p_neck = jax.jit(neck.init)(ks[1], feats)["params"]
    lv_r = [jnp.zeros((1, IMG // s, IMG // s, CH)) for s in (4, 8, 16, 32)] \
        + [jnp.zeros((1, 1, 1, CH))]
    lv_s = [jnp.zeros((1, max(IMG // s, 1), max(IMG // s, 1), CH))
            for s in (8, 16, 32, 64, 128)]
    roi = jnp.zeros((2, 7, 7, CH))
    out = {"backbone": p_bb, "neck": p_neck}
    for name, mod, x, k in (
            ("orpn", JaxORPN(), lv_r, ks[2]), ("rpn", JaxRPN(), lv_r, ks[3]),
            ("oroi", JaxRoIHead(num_classes=NC), roi, ks[4]),
            ("hroi", JaxHBBRoIHead(num_classes=NC), roi, ks[5]),
            ("gfl", JaxGFLHead(num_classes=NC), lv_s, ks[6]),
            ("retina", JaxRetinaHead(num_classes=NC), lv_s, ks[7]),
            ("hretina", JaxRetinaHead(num_classes=NC, feat_channels=CH),
             lv_s, ks[7])):
        out[name] = jax.jit(mod.init)(k, x)["params"]
    rng = np.random.RandomState(1)
    out = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key == "gamma" else np.asarray(v), out)
    out["orpn"]["rpn_reg"]["kernel"] = out["orpn"]["rpn_reg"]["kernel"] * 0.2
    # class scores of a trained head: above the 0.05 test threshold
    out["retina"]["retina_cls"]["bias"] = \
        out["retina"]["retina_cls"]["bias"] + 3.0
    return out


def detector_params(modules, name):
    p = {"backbone": modules["backbone"], "neck": modules["neck"]}
    if name == "OrientedRCNN":
        p.update(rpn_head=modules["orpn"], roi_head=modules["oroi"])
    elif name == "GFL":
        p["bbox_head"] = modules["gfl"]
    elif name == "RotatedRetinaNet":
        p["bbox_head"] = modules["retina"]
    elif name in ("FasterRCNN", "CascadeRCNN"):
        p["rpn_head"] = modules["rpn"]
        for i in range(1 if name == "FasterRCNN" else 3):
            p[f"bbox_head{i}"] = modules["hroi"]
    else:                         # RetinaNet: 4 deltas an anchor, top level
        h = copy.deepcopy(modules["hretina"])
        h["retina_reg"] = {"kernel": h["retina_reg"]["kernel"][..., :36],
                           "bias": h["retina_reg"]["bias"][:36]}
        p.update(h)
    return p


def _port(name, params):
    port = DETECTORS[name][1](CFG, device="cpu", trainable=True)
    port.load_state_dict(from_flax(params), strict=True)
    return port


@pytest.mark.parametrize("name", list(DETECTORS))
def test_losses_match_jax(modules, data, name):
    batch = data["hbb" if name in HBB else "obb"]
    params = detector_params(modules, name)
    jmodel = DETECTORS[name][0](cfg=CFG)
    ref = jax.jit(lambda p, b: jmodel.apply({"params": p}, b, train=True,
                                            rngs=APPLY_RNGS))(params, batch)
    port = _port(name, params)
    keys = sample_keys(name, len(batch["img"]))
    kw = {} if keys is None else {"sample_keys": keys}
    got = port(batch_to({"d": batch}, "cpu")["d"],
               gen=torch.Generator().manual_seed(0), **kw)
    assert set(got) == set(ref)
    got = {k: v.detach() for k, v in got.items()}
    bad = [(k, float(got[k]), float(ref[k])) for k in ref
           if not (np.isfinite(float(got[k])) and abs(
               float(got[k]) - float(ref[k])) <= 1e-4 * abs(float(ref[k]))
               + 1e-9)]
    assert not bad, bad
    assert any(float(v) > 0 for k, v in ref.items() if "bbox" in k)


@pytest.mark.parametrize("name", ["OrientedRCNN", "GFL", "RotatedRetinaNet"])
def test_simple_test_matches_jax(modules, data, name):
    imgs = data["hbb" if name in HBB else "obb"]["img"]
    params = detector_params(modules, name)
    jmodel = DETECTORS[name][0](cfg=CFG)
    ref = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, (IMG, IMG), method="simple_test"))(params, imgs)
    port = DETECTORS[name][1](CFG, device="cpu")
    port.load_state_dict(from_flax(params), strict=True)
    got = port.simple_test(torch.from_numpy(imgs), (IMG, IMG))
    box = got[0].shape[-1] - 1
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(np.asarray(ref[2]).sum()) > 0
    r = np.asarray(ref[0])
    scale = float(np.abs(r[..., :box]).max())
    assert float(np.abs(got[0][..., :box].numpy() - r[..., :box]).max()) \
        <= 1e-4 * scale
    assert float(np.abs(got[0][..., box].numpy() - r[..., box]).max()) \
        <= 1e-5


# ---- the configs -------------------------------------------------------------

@pytest.mark.parametrize("name", UNLOCKED)
def test_unlocked_configs_build(monkeypatch, name):
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *args, **kwargs: t)
    cfg = Config.fromfile(f"{LC}{name}.py")
    want = {"SM3Det": "TriSourceVariant", "dota": "OrientedRCNN",
            "dronevehicle": "OrientedRCNN"}.get(name.split("_")[0])
    mtype = cfg.model.get("type")
    model = builder.build_detector(cfg.model, device="cpu")
    assert type(model) is builder.DETECTORS.get(mtype)
    assert want is None or mtype == want
    if mtype == "TriSourceVariant":
        assert (model.sar_stages, model.rot_stages) == (
            cfg.model.sar_stages, cfg.model.rot_stages)
    else:
        assert hasattr(model.backbone, "stem_conv")
    assert all(p.device.type == "cpu" for p in model.parameters())


@pytest.mark.parametrize("path,name", [
    (f"{LC}dota_convnext_t_roitrans.py", "item 7"),
    (f"{LC}dronevehicle_convnext_t_s2anet.py", "item 7"),
    (f"{LC}dota_van_t_orcnn.py", "item 7"),
    (f"{LC}sardet50k_lsk_t_gfl.py", "item 7")])
def test_still_unported_raise(path, name):
    with pytest.raises(NotImplementedError, match=name):
        builder.build_detector(Config.fromfile(path).model, device="cpu")


# ---- the entry points ------------------------------------------------------

VARIANT_OPTS = ["model.type=TriSourceVariant", "model.sar_stages=2",
                "model.rot_stages=1"]


def test_train_cli_trains_a_variant_and_resumes(tmp_path):
    wd = tmp_path / "wd"
    argv = [SMOKE, "--synthetic-data", "--max-iters", "2", "--device", "cpu",
            "--deterministic", "--work-dir", str(wd), "--cfg-options",
            "checkpoint_interval=2", "log_interval=1", *VARIANT_OPTS]
    out = train_cli.main(argv)
    assert out["stats"]["iters"] == 2
    assert (out["model"].sar_stages, out["model"].rot_stages) == (2, 1)
    line = out["stats"]["log_lines"][-1]
    assert {"sar_loss_rpn_cls", "sar_loss_cls", "rgb_loss_cls",
            "ifr_loss_bbox"} <= set(line)
    assert all(np.isfinite(v) for v in line.values())
    assert set(out["state"].opt.mults) >= {"sar_rpn_head", "sar_roi_head",
                                           "rgb_bbox_head", "_shared_"}
    again = train_cli.main(argv[:-4] + ["--resume-from",
                                        str(wd / "iter_2.pth"),
                                        "--cfg-options", *VARIANT_OPTS])
    assert again["start_iter"] == 2 and again["stats"]["iters"] == 0
    a, b = again["state"], out["state"]
    assert list(a.params) == list(b.params)
    assert all(torch.equal(x, y) for x, y in zip(a.params.values(),
                                                 b.params.values()))
    assert all(torch.equal(x, y) for x, y in zip(a.opt.mu, b.opt.mu))
    assert all(torch.equal(x, y) for x, y in zip(a.opt.nu, b.opt.nu))
    assert torch.equal(a.opt.dla.ema, b.opt.dla.ema)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


@pytest.mark.parametrize("argv", [
    [SMOKE, "--cfg-options", "evaluation.interval=1", *VARIANT_OPTS],
    [f"{LC}SM3Det_convnext_t_orcnn_frcnn.py"]])
def test_train_cli_refuses_a_variant_with_eval_hooks(tmp_path, argv):
    with pytest.raises(NotImplementedError, match="evaluation=None"):
        train_cli.main(argv[:1] + ["--synthetic-data", "--device", "cpu",
                                   "--work-dir", str(tmp_path / "wd")]
                       + argv[1:])
    assert not (tmp_path / "wd" / "train_log.jsonl").exists()


@pytest.mark.parametrize("path", [f"{LC}SM3Det_convnext_t_s2anet_gfl.py",
                                  f"{LC}dota_convnext_t_orcnn.py"])
def test_test_cli_refuses_other_types(path):
    with pytest.raises(SystemExit, match="TriSourceDetector"):
        test_cli.main([path, "--device", "cpu", "--synthetic-data",
                       "--subdataset", "rgb"])


def test_train_cli_refuses_a_single_dataset_detector(tmp_path):
    with pytest.raises(SystemExit, match="library API"):
        train_cli.main([f"{LC}sardet50k_convnext_t_frcnn.py",
                        "--synthetic-data", "--device", "cpu",
                        "--work-dir", str(tmp_path / "wd")])
