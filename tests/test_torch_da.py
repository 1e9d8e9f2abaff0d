"""The port's Domain-Attention baseline (``ConvNeXt_DA_MultiInput``, the
config ``configs/local_configs/main_DA_convnext_t_orcnn_gfl.py``) against
the JAX package, on the CPU, at fp32.

A tiny DA detector (ConvNeXt ``atto``, no MoE block, DA in stage-2 blocks
0, 2, 4 and stage-3 block 0, a 32-channel neck, 4 classes, 64 px) takes
one parameter tree: the port's own seeded init laid out as the flax tree
(``jax.eval_shape`` of JAX's training init gives its structure, no
compile), with the layer scales drawn from U(0.3, 0.8) and the heads set up
as in ``tests/test_torch_rcnn_slice.py`` so that the NMS sees candidates.
Both packages run the same numpy images, one a modality.

JAX's entry points pass each image's dataset id to the backbone (0 SAR, 1
RGB, 2 infrared; the composition in the joint and training forwards), and
the DA blocks pick their branch by it; one jitted function holds every JAX
inference output (one compile). Held: the backbone features, the SAR neck
and GFL logits, the R-CNN necks and RPN logits of each modality within
1e-4 absolute and relative (fp32 summation order, as the other slices);
the detections of the port's ``simple_test_{sar,rgb,ifr}`` and
``simple_test_joint`` against JAX's ``simple_test_joint`` (which JAX makes
equal to each modality's ``simple_test``), as ``_assert_dets`` holds them
(labels and validity equal, scores within 1e-4, boxes geometrically
within 1e-4 of the image size).

Training: one forward's losses within 1e-4 relative, the same keys as
JAX's (no ``gate_loss``: the backbone has no MoE block), and every
backbone gradient leaf, DA layers included, within 1e-3 of the leaf's
norm, against a jitted ``jax.value_and_grad``; the samplers take the very
keys ``jax.random.uniform`` drew (``forward(..., sample_keys=...)``).

The entry points: ``tools.test`` on the DA config for each subdataset and
``tools.train`` for two iterations with DLA, on synthetic data, the config
cut to this test's size by ``--cfg-options``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.detectors.trisource import \
    TriSourceDetector as JaxDetector
from sm3det_tpu_torch.convert import from_flax, to_flax
from sm3det_tpu_torch.models.detectors.trisource import TriSourceDetector
from sm3det_tpu_torch.tools import test as test_cli
from sm3det_tpu_torch.tools import train as train_cli
from sm3det_tpu_torch.train.train_state import batch_to, trainable_params

from test_torch_rcnn_slice import _assert_dets
from test_torch_train_step import G, make_batch
from test_torch_variant_train import _StageRngs, _split_keys
from torch_jax_refs import jax_refs_at_lowest_level  # noqa: F401

IMG = 64
SHAPE = (IMG, IMG)
TOL = dict(rtol=1e-4, atol=1e-4)
DA_INDS = ((), (), (0, 2, 4), (0,))
CFG = dict(
    num_classes=4,
    angle_version="le90",
    backbone=dict(type="ConvNeXt_DA_MultiInput", arch="atto",
                  drop_path_rate=0.0, moe_block_inds=((), (), (), ()),
                  use_da=True, da_block_inds=DA_INDS),
    neck=dict(in_channels=(40, 80, 160, 320), out_channels=32,
              num_outs=5, extra_level=1, add_extra_convs="on_output"),
    sar=dict(strides=(8, 16, 32, 64, 128), reg_max=8,
             nms_pre=50, score_thr=0.05, nms_iou=0.6, max_per_img=20),
    rgb=dict(rpn_strides=(4, 8, 16, 32, 64), rpn_sample=256,
             rcnn_sample=512, rpn_nms_pre=64, rpn_max=64, rpn_nms_iou=0.8,
             rcnn_score_thr=0.05, rcnn_nms_iou=0.1, rcnn_max=20),
)
N_ANCHORS = 3 * sum((IMG // s) ** 2 for s in (4, 8, 16, 32, 64))
RNGS = dict(zip(("dropout", "moe_noise", "sampling"),
                jax.random.split(jax.random.PRNGKey(2), 3)))
DA_CONFIG = "configs/local_configs/main_DA_convnext_t_orcnn_gfl.py"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _jax_infer(m, sar, rgb, ifr):
    """Every inference output the tests hold, in one compile: the stages
    of each modality (one backbone pass over the three images under their
    ids, as the joint forward makes it: no block mixes images, so each
    image's features are those of a pass of its modality alone) and the
    joint forward's detections, which the JAX package makes equal to each
    modality's ``simple_test`` (its ``simple_test_joint`` contract)."""
    out = {}
    feats, _ = m.backbone(jnp.concatenate([sar, rgb, ifr]), train=False,
                          dataset_ids=jnp.asarray([0, 1, 2], jnp.int32))
    for i, name in enumerate(("sar", "rgb", "ifr")):
        f = [level[i:i + 1] for level in feats]
        if name == "sar":
            sar_x = m._neck_sar(f)
            head = (sar_x, m.sar_bbox_head(sar_x))
        else:
            x = m._neck_rcnn(f)
            rpn = m.rgb_rpn_head if name == "rgb" else m.ifr_rpn_head
            head = (x, rpn(x))
        out[name] = (f, head)
    out["dets"] = m.simple_test_joint(sar, rgb, ifr, SHAPE)
    return out


@pytest.fixture(scope="module")
def setup():
    """The shared parameter tree, the port at inference and the JAX
    inference outputs."""
    batch = make_batch(seed=0, n=(1, 1, 1))
    jmodel = JaxDetector(CFG)
    port = TriSourceDetector(CFG, device="cpu", seed=0)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), **RNGS}, b, source_ratio=(1, 1, 1),
        train=True), batch)["params"]
    template = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    params = to_flax(dict(port.state_dict()), template)
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if p[-1].key == "gamma" else v, params)
    params["sar_bbox_head"]["gfl_cls"]["bias"] = np.full_like(
        params["sar_bbox_head"]["gfl_cls"]["bias"], 0.5)
    for m in ("rgb", "ifr"):
        params[f"{m}_roi_head"]["fc_cls"]["kernel"] *= 12.0
        params[f"{m}_rpn_head"]["rpn_reg"]["kernel"] *= 0.2
    port.load_state_dict(from_flax(params), strict=True)
    imgs = {k: batch[k]["img"] for k in ("sar", "rgb", "ifr")}
    ref = jax.jit(lambda p, s, r, i: jmodel.apply(
        {"params": p}, s, r, i, method=_jax_infer))(
            params, imgs["sar"], imgs["rgb"], imgs["ifr"])
    return {"batch": batch, "params": params, "jmodel": jmodel,
            "port": port, "imgs": imgs, "ref": ref}


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_from_flax_carries_the_da_layers(setup):
    params, port = setup["params"], setup["port"]
    state = from_flax(params)
    assert set(state) == set(port.state_dict())
    assert tuple(state["backbone.stage2_block0.da.fc2_0.weight"].shape) == \
        (160 // 16, 160)
    assert tuple(state["backbone.stage3_block0.da.fc1_1.weight"].shape) == \
        (320, 320 // 16)
    assert not any(".da." in k for k in state
                   if k.startswith("backbone.stage2_block1."))
    back = dict(_flat(to_flax(dict(port.named_parameters()), params)))
    ref = dict(_flat(params))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("which", ["sar", "rgb", "ifr"])
def test_stages_match_jax(setup, which):
    """Features, neck and head logits of one modality under its id; the
    id matters (another id gives other features)."""
    port, imgs = setup["port"], setup["imgs"]
    d = {"sar": 0, "rgb": 1, "ifr": 2}[which]
    feats_ref, (x_ref, head_ref) = setup["ref"][which]
    with torch.no_grad():
        feats = port.extract_feat(torch.from_numpy(imgs[which]), d)
        if which == "sar":
            x = port.neck_sar(feats)
            head = port.sar_bbox_head(x)
        else:
            x = port.neck_rcnn(feats)
            head = port.head_rpn(x, which)
        other = port.extract_feat(torch.from_numpy(imgs[which]), (d + 1) % 3)
    got = list(feats) + list(x) + list(head[0]) + list(head[1])
    want = jax.tree_util.tree_leaves((feats_ref, x_ref, head_ref))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w)
    assert float((other[-1] - feats[-1]).abs().max()) > 1e-2


@pytest.mark.parametrize("which", ["sar", "rgb", "ifr", "joint"])
def test_entry_points_match_jax(setup, which):
    """The port's ``simple_test`` of each modality (its dataset id) and its
    joint forward against JAX's joint forward's detections."""
    port, imgs = setup["port"], setup["imgs"]
    sar, rgb, ifr = (torch.from_numpy(imgs[k]) for k in ("sar", "rgb", "ifr"))
    ref = dict(zip(("sar", "rgb", "ifr"), setup["ref"]["dets"]))
    if which == "joint":
        got = port.simple_test_joint(sar, rgb, ifr, img_shape=SHAPE)
        pairs = zip(got, (ref[k] for k in ("sar", "rgb", "ifr")))
    else:
        got = port.simple_test({"sar": sar, "rgb": rgb, "ifr": ifr}[which],
                               which, img_shape=SHAPE)
        pairs = [(got, ref[which])]
    for g, r in pairs:
        assert int(g[2].sum()) > 0
        _assert_dets(g, r)


@pytest.fixture(scope="module")
def train_pair(setup):
    """One training forward of each package on the shared tree: JAX's
    losses and gradients (jitted value_and_grad) and the port's, the port's
    samplers handed JAX's draws."""
    batch, params, jmodel = setup["batch"], setup["params"], setup["jmodel"]

    def loss_fn(p, b):
        losses = jmodel.apply({"params": p}, b, source_ratio=(1, 1, 1),
                              train=True, rngs=RNGS)
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch)
    sizes = [(1, N_ANCHORS), (1, G + CFG["rgb"]["rpn_max"])] * 2
    rngs = _StageRngs(len(sizes)).apply({}, rngs={"sampling": RNGS[
        "sampling"]})
    keys = [_split_keys(r, b, p) for r, (b, p) in zip(rngs, sizes)]
    port = TriSourceDetector(CFG, device="cpu", trainable=True)
    port.load_state_dict(from_flax(params), strict=True)
    tp = trainable_params(port)
    p_losses = port(batch_to(batch, "cpu"), gen=torch.Generator()
                    .manual_seed(0), sample_keys=keys)
    p_grads = torch.autograd.grad(sum(p_losses.values()), list(tp.values()))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": dict(_flat(jax.tree.map(np.asarray, grads))),
            "p_losses": {k: float(v) for k, v in p_losses.items()},
            "p_grads": dict(_flat(to_flax(dict(zip(tp, p_grads)), params)))}


def test_train_losses_match_jax(train_pair):
    ref, got = train_pair["losses"], train_pair["p_losses"]
    assert set(got) == set(ref) and "gate_loss" not in got
    bad = [(k, got[k], ref[k]) for k in ref
           if abs(got[k] - ref[k]) > 1e-4 * abs(ref[k]) + 1e-7]
    assert not bad, bad
    assert ref["rgb_loss_bbox"] > 0 and ref["ifr_loss_cls"] > 0


def test_backbone_gradients_match_jax(train_pair):
    ref, got = train_pair["grads"], train_pair["p_grads"]
    names = [k for k in ref if k.startswith("backbone/")]
    assert any("/da/" in k for k in names)
    bad = []
    for k in names:
        scale = float(np.linalg.norm(ref[k]))
        err = float(np.abs(got[k] - ref[k]).max())
        if not err <= 1e-3 * scale + 1e-9:
            bad.append((k, err, scale))
    assert not bad, bad
    assert all(np.linalg.norm(ref[k]) > 0 for k in names if "/da/" in k)


# ---- the entry points on the DA config ------------------------------------

TINY = ["img_size=64", "num_classes=4", "model.num_classes=4",
        "model.backbone.arch=atto",
        "model.backbone.da_block_inds=[[],[],[0,2],[0]]",
        "model.neck.in_channels=[40,80,160,320]",
        "model.neck.out_channels=32", "model.sar.nms_pre=50",
        "model.sar.max_per_img=20", "model.rgb.rpn_nms_pre=64",
        "model.rgb.rpn_max=64", "model.rgb.rcnn_max=20",
        "model.rgb.rpn_sample=32", "model.rgb.rcnn_sample=32"]


@pytest.mark.parametrize("sub", ["sar", "rgb", "ifr"])
def test_test_cli_evaluates_the_da_config(sub):
    out = test_cli.main([DA_CONFIG, "--subdataset", sub, "--device", "cpu",
                         "--synthetic-data", "--num-images", "4",
                         "--batch-size", "2", "--compute-dtype", "float32",
                         "--cfg-options", *TINY])
    bb = out["model"].backbone
    assert bb.stage2_block2.use_da and not bb.stage2_block1.use_da
    key = "bbox_mAP" if sub == "sar" else "mAP"     # SAR: the COCO protocol
    assert np.isfinite(out["metrics"][key])
    assert out["num_images"] == 4 and len(out["det_results"]) == 4


def test_train_cli_trains_the_da_config(tmp_path):
    out = train_cli.main([DA_CONFIG, "--synthetic-data", "--max-iters", "2",
                          "--device", "cpu", "--work-dir", str(tmp_path),
                          "--cfg-options", "log_interval=1",
                          "evaluation=None", "lr_config.warmup_iters=1",
                          "source_ratio=[1,1,1]", *TINY])
    assert out["stats"]["iters"] == 2
    line = out["stats"]["log_lines"][-1]
    assert "gate_loss" not in line and "sar_loss_cls" in line
    assert all(np.isfinite(v) for v in line.values())
    assert out["model"].backbone.stage3_block0.use_da
