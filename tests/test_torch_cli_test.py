"""The port's eval entry point, ``python -m sm3det_tpu_torch.tools.test``,
against the JAX package's ``tools/test.py``, on the CPU at fp32.

Both tools read the same on-disk DOTA fixture as ``tests/test_cli_eval.py``
(two base images, two patches each) and ``configs/smoke_tiny.py``'s
synthetic images, with the same weights: the JAX params are saved as an
orbax checkpoint for the JAX tool (``train/checkpoint.py::save_checkpoint``)
and, through ``from_flax``, as the port's own checkpoint
(``sm3det_tpu_torch/train/checkpoint.py::save_params``). The GFL prior bias
is raised, ``fc_cls`` scaled up and ``rpn_reg`` scaled down (as in
``test_torch_config_data.py``), so both detect. Per image and class the
detections agree within 1e-4 (scores) and 1e-4 of the image size (boxes;
rotated ones up to their other description), and the ``--out`` mAPs
agree.
"""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from sm3det_tpu.train.checkpoint import save_checkpoint
from sm3det_tpu_torch.convert import from_flax
from sm3det_tpu_torch.models import builder
from sm3det_tpu_torch.tools import test as port_cli
from sm3det_tpu_torch.train import checkpoint as port_ckpt
from sm3det_tpu_torch.utils.config import Config

from test_torch_config_data import IMG, _same_obbs, jax_tiny_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("plane", "ship", "bridge", "harbor")


def _make_dota_fixture(root):
    """The fixture of ``tests/test_cli_eval.py``."""
    from PIL import Image
    ann = os.path.join(root, "annfiles")
    img = os.path.join(root, "images")
    os.makedirs(ann), os.makedirs(img)
    rng = np.random.RandomState(0)
    for base in ("P0001", "P0002"):
        for x0 in (0, 32):
            pid = f"{base}__1.0__{x0}___0"
            arr = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(img, pid + ".png"))
            with open(os.path.join(ann, pid + ".txt"), "w") as f:
                cx, cy = rng.uniform(20, 44, 2)
                w, h = rng.uniform(10, 20), rng.uniform(6, 10)
                quad = [cx - w / 2, cy - h / 2, cx + w / 2, cy - h / 2,
                        cx + w / 2, cy + h / 2, cx - w / 2, cy + h / 2]
                cls = CLASSES[rng.randint(0, 4)]
                f.write(" ".join(f"{v:.1f}" for v in quad) +
                        f" {cls} 0\n")
    return ann, img


def _write_config(path, ann, img):
    base = os.path.join(ROOT, "configs", "smoke_tiny.py")
    with open(path, "w") as f:
        f.write(f"""
_base_ = ["{base}"]
source_ratio = [1, 1, 1]
data = dict(
    sar=dict(type="SyntheticDetDataset", max_gt=8),
    rgb=dict(type="DOTADataset", ann_folder="{ann}", img_folder="{img}",
             classes={CLASSES!r}, max_gt=8),
    ifr=dict(type="SyntheticDetDataset", max_gt=8),
)
""")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    ann, img = _make_dota_fixture(str(root))
    cfg_path = str(root / "tiny_dota.py")
    _write_config(cfg_path, ann, img)
    model_cfg = Config.fromfile(os.path.join(ROOT, "configs",
                                             "smoke_tiny.py")).model
    _, params = jax_tiny_params(model_cfg.to_dict())
    jax_ckpt = save_checkpoint(str(root / "jax_ckpt"), 0,
                               {"params": params})
    port = builder.build_detector(model_cfg, device="cpu",
                                  compute_dtype="float32")
    port.load_state_dict(from_flax(params), strict=True)
    port_path = port_ckpt.save_params(str(root / "port" / "iter_0.pth"),
                                      port)
    return dict(root=root, cfg=cfg_path, jax_ckpt=jax_ckpt,
                port_ckpt=port_path, model_cfg=model_cfg)


def _run_jax(monkeypatch, argv):
    """``tools/test.py`` main, returning what its stream_eval gave."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import importlib
        jax_cli = importlib.import_module("test")
        from sm3det_tpu.apis import eval_loop
        seen = {}
        real = eval_loop.stream_eval

        def recording(*a, **kw):
            seen["out"] = real(*a, **kw)
            return seen["out"]
        monkeypatch.setattr(eval_loop, "stream_eval", recording)
        monkeypatch.setattr(sys, "argv", ["test.py"] + argv)
        jax_cli.main()
        return seen["out"]
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))


def _assert_same_dets(got, ref, box_dim):
    assert len(got) == len(ref)
    n = 0
    for g_img, r_img in zip(got, ref):
        for g, r in zip(g_img, r_img):
            assert g.shape == r.shape
            n += len(r)
            if not len(r):
                continue
            np.testing.assert_allclose(g[:, -1], r[:, -1], atol=1e-4)
            if box_dim == 5:
                _same_obbs(g[:, :5], r[:, :5])
            else:
                np.testing.assert_allclose(g, r, atol=1e-4 * IMG)
    assert n > 0


@pytest.mark.parametrize("which", ["dota", "synthetic"])
def test_eval_matches_the_jax_tool(env, monkeypatch, capsys, which):
    root = env["root"]
    if which == "dota":
        common = [env["cfg"], "--subdataset", "rgb", "--batch-size", "3",
                  "--compute-dtype", "float32"]
    else:
        common = [os.path.join(ROOT, "configs", "smoke_tiny.py"),
                  "--synthetic-data", "--num-images", "8",
                  "--compute-dtype", "float32"]
    jax_out, port_out = str(root / f"jax_{which}.json"), \
        str(root / f"port_{which}.json")
    rd, ra, ri = _run_jax(monkeypatch, [common[0], env["jax_ckpt"]] +
                          common[1:] + ["--out", jax_out])
    got = port_cli.main([common[0], env["port_ckpt"]] + common[1:] +
                        ["--out", port_out, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"loaded {env['port_ckpt']}" in printed
    assert got["img_ids"] == ri
    _assert_same_dets(got["det_results"], rd, 5)
    for g, r in zip(got["annotations"], ra):
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(g[k], r[k])
    with open(jax_out) as f:
        ref = json.load(f)
    with open(port_out) as f:
        mine = json.load(f)
    assert mine["num_images"] == ref["num_images"]
    assert mine["eval"].keys() == ref["eval"].keys()
    for k, v in ref["eval"].items():
        assert abs(mine["eval"][k] - v) <= 1e-6, k
    if which == "dota":
        _check_format_only(env, got, rd, ri)


def _check_format_only(env, got, jax_dets, jax_ids):
    """The port's ``--format-only`` zip against what the JAX tool writes
    from its own detections (merge by patch id, then Task1 files)."""
    from sm3det_tpu.core.patch.split_merge import (merge_det_by_patch_ids,
                                                   write_dota_submission)
    root = env["root"]
    zj = write_dota_submission(merge_det_by_patch_ids(jax_ids, jax_dets, 4),
                               CLASSES, str(root / "sub_jax"))
    out = port_cli.main([env["cfg"], env["port_ckpt"], "--subdataset", "rgb",
                         "--batch-size", "3", "--compute-dtype", "float32",
                         "--device", "cpu", "--format-only",
                         "--submission-dir", str(root / "sub_port")])
    assert out["metrics"] is None and set(out["merged"]) == {"P0001",
                                                              "P0002"}
    zp = os.path.join(root / "sub_port", "submission.zip")
    with zipfile.ZipFile(zj) as a, zipfile.ZipFile(zp) as b:
        assert sorted(a.namelist()) == sorted(b.namelist()) == sorted(
            f"Task1_{c}.txt" for c in CLASSES)
        n = 0
        for name in a.namelist():
            ra = [ln.split() for ln in a.read(name).decode().splitlines()]
            rb = [ln.split() for ln in b.read(name).decode().splitlines()]
            assert len(ra) == len(rb)
            n += len(ra)
            ra = sorted(ra, key=lambda r: (r[0], -float(r[1])))
            rb = sorted(rb, key=lambda r: (r[0], -float(r[1])))
            for x, y in zip(ra, rb):
                assert x[0] == y[0]
                assert abs(float(x[1]) - float(y[1])) <= 2e-4
    assert n > 0


def test_the_module_runs_as_a_command(env):
    """The command of the README, with the default bf16 policy."""
    r = subprocess.run(
        [sys.executable, "-m", "sm3det_tpu_torch.tools.test",
         os.path.join(ROOT, "configs", "smoke_tiny.py"), env["port_ckpt"],
         "--device", "cpu", "--synthetic-data", "--num-images", "8",
         "--batch-size", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "inference: 8 images" in r.stdout
    assert "'mAP50'" in r.stdout


def test_save_and_load_params_round_trip(env, tmp_path):
    cfg = env["model_cfg"]
    a = builder.build_detector(cfg, device="cpu", seed=1)
    b = builder.build_detector(cfg, device="cpu", seed=2,
                               compute_dtype="bfloat16")
    path = port_ckpt.save_params(str(tmp_path / "w" / "iter_7.pth"), a)
    port_ckpt.load_params(path, b)
    for (k, va), (kb, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert k == kb and vb.dtype == torch.bfloat16
        assert torch.equal(va.to(torch.bfloat16), vb)
    c = builder.build_detector(cfg, device="cpu", seed=3)
    port_ckpt.load_params(path, c)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 c.state_dict().values()))
    (tmp_path / "w" / "iter_12").mkdir()
    (tmp_path / "w" / "other_99").mkdir()
    assert port_ckpt.find_latest_checkpoint(str(tmp_path / "w")) == \
        str(tmp_path / "w" / "iter_12")
    assert port_ckpt.find_latest_checkpoint(str(tmp_path / "none")) is None


def test_load_params_refuses_a_mismatch(env, tmp_path):
    cfg = env["model_cfg"].to_dict()
    a = builder.build_detector(cfg, device="cpu")
    path = port_ckpt.save_params(str(tmp_path / "a.pth"), a)
    wider = dict(cfg, neck=dict(cfg["neck"], out_channels=48))
    with pytest.raises(ValueError, match="shape"):
        port_ckpt.load_params(path, builder.build_detector(wider,
                                                           device="cpu"))
    more = dict(cfg, backbone=dict(cfg["backbone"],
                                   moe_block_inds=[[], [], [0, 1], []]))
    with pytest.raises(ValueError, match="does not match"):
        port_ckpt.load_params(path, builder.build_detector(more,
                                                           device="cpu"))
    torch.save({"state_dict": a.state_dict()}, tmp_path / "plain.pth")
    with pytest.raises(ValueError, match="not a"):
        port_ckpt.load_params(str(tmp_path / "plain.pth"), a)


def test_tta_routes_to_aug_test(env, capsys):
    """``--tta`` runs ``aug_test`` with the config's scales and flips (the
    identity first); its detections are those of ``aug_test`` on the same
    normalised images, mapped back the same way."""
    from sm3det_tpu_torch.apis.eval_loop import (normalize_uint8,
                                                 preprocess_uint8)
    from sm3det_tpu_torch.data.datasets import SyntheticDetDataset
    tta = "tta={'scales': [1.0], 'flip_directions': ['horizontal']}"
    out = port_cli.main([os.path.join(ROOT, "configs", "smoke_tiny.py"),
                         env["port_ckpt"], "--synthetic-data",
                         "--num-images", "3", "--batch-size", "3",
                         "--compute-dtype", "float32", "--device", "cpu",
                         "--tta", "--cfg-options", tta])
    assert "TTA: {'subdataset': 'rgb', 'scales': (1.0,), " \
        "'flip_directions': (None, 'horizontal')}" in capsys.readouterr().out
    ds = SyntheticDetDataset(n=64, img_size=IMG, num_classes=4,
                             box_type="obb", seed=7)
    mean = torch.tensor((123.675, 116.28, 103.53))
    std = torch.tensor((58.395, 57.12, 57.375))
    pre = [preprocess_uint8(ds.get_raw(i), IMG, mean.tolist())
           for i in range(3)]
    x = normalize_uint8(torch.from_numpy(np.stack([p[0] for p in pre])),
                        mean, std)
    dets, labels, valid = out["model"].aug_test(
        x, "rgb", img_shape=(IMG, IMG), scales=(1.0,),
        flip_directions=(None, "horizontal"))
    n = 0
    for i in range(3):
        v = valid[i].numpy()
        d, lab = dets[i].numpy()[v], labels[i].numpy()[v]
        d[:, :4] /= pre[i][1]
        for c in range(4):
            np.testing.assert_array_equal(out["det_results"][i][c],
                                          d[lab == c])
            n += int((lab == c).sum())
    assert n > 0
