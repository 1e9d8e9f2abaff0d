"""The port's BabelRS configuration (``configs/BabelRS_configs/
BabelRS_20kstep.py``: the InternViT ViT-Adapter backbone under the
TriSource heads, trained with layer decay) against the JAX package, on the
CPU, at fp32.

- ``ms_deform_attn`` against JAX's on locations inside, on the border of
  and outside each level (JAX's bilinear, not ``grid_sample``'s: a
  location half a pixel out reads the edge, one beyond gives 0), values
  and gradients within 1e-5.
- A standalone ``InternViTAdapter``'s ``encoder_only`` for the windowed
  (on a grid that needs padding, so the padded qkv rows carry the qkv
  bias), QK-norm and RMSNorm variants, within 1e-4 of scale.
- The tiny BabelRS detector (``tests/test_babelrs.py``'s
  ``TINY_OVERRIDES``: 64 px, embed 32, depth 4, 2 heads, adapter 16) on one
  parameter tree: the port's own seeded init laid out as the flax tree
  (``jax.eval_shape`` of JAX's init gives its structure), with
  nonzero deformable offsets and layer scales, and the heads set up as in
  ``tests/test_torch_da.py``. Its encoder alone and, stage by stage, the
  full adapter's 4 levels, the necks, the GFL and RPN outputs within 1e-4
  absolute and relative; the
  detections of each ``simple_test`` and of ``simple_test_joint``
  against JAX's joint forward; one train forward's losses within 1e-4
  relative and every gradient leaf (ViT blocks, adapter, SPM, neck,
  heads) within 1e-3 of the leaf's norm, the samplers handed JAX's draws.
- ``internvit_hf_to_port`` against ``internvit_torch_to_jax`` +
  ``from_flax`` on a seeded HF-format dict with a cls token and a 6 x 6
  grid (resized bicubic to the model's 4 x 4), read back from a
  ``.safetensors`` file through the port's reader.
- The layer-decay scales of every leaf of the tree against JAX's.
- ``build_detector``'s refusals, and a forward at another grid.
- Both tools on the tiny BabelRS config: ``tools.test`` (rgb) and
  ``tools.train`` with the config's layer decay (block i at ``0.95^(3 -
  i)``), EMA, ``accumulate=2`` and the cosine policy, resumed from its
  checkpoint (mid-accumulation) equal to it bit for bit.
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.backbones.intern_vit import \
    InternViTAdapter as JaxAdapter
from sm3det_tpu.models.detectors.trisource import \
    TriSourceDetector as JaxDetector
from sm3det_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from sm3det_tpu.train import extras as jax_extras
from sm3det_tpu.train.checkpoint import internvit_torch_to_jax
from sm3det_tpu_torch.convert import from_flax, to_flax
from sm3det_tpu_torch.models.backbones.intern_vit import InternViTAdapter
from sm3det_tpu_torch.models.builder import build_detector
from sm3det_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from sm3det_tpu_torch.tools import test as test_cli
from sm3det_tpu_torch.tools import train as train_cli
from sm3det_tpu_torch.train import checkpoint as ckpt
from sm3det_tpu_torch.train import extras
from sm3det_tpu_torch.train.train_state import batch_to, trainable_params
from sm3det_tpu_torch.utils.config import Config

from test_babelrs import CFG as BABELRS, TINY_OVERRIDES, _tiny_batch
from test_torch_rcnn_slice import _assert_dets
from test_torch_variant_train import _StageRngs, _split_keys

IMG = 64
SHAPE = (IMG, IMG)
TOL = dict(rtol=1e-4, atol=1e-4)
G = 4
RNGS = dict(zip(("dropout", "moe_noise", "sampling"),
                jax.random.split(jax.random.PRNGKey(2), 3)))
N_ANCHORS = 3 * sum((IMG // s) ** 2 for s in (4, 8, 16, 32, 64))


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


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's lowest backend
    optimisation level: these references run once, and the level cuts the
    compile by a third (fp32 throughout; the results agree with the
    optimised build's to the tests' tolerances)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _randomise(params, rng):
    """Nonzero deformable offsets (zero at init: every tap on its
    reference point), layer scales and norm weights away from their
    init, so that each shows."""
    def tweak(p, v):
        keys = [getattr(k, "key", "") for k in p]
        if keys[-2:] == ["sampling_offsets", "kernel"]:
            return rng.normal(0.0, 0.6, v.shape).astype(np.float32)
        if keys[-1] in ("ls1", "ls2"):
            return rng.uniform(0.3, 0.8, v.shape).astype(np.float32)
        if keys[-1] in ("scale", "weight") and v.ndim == 1:
            return rng.uniform(0.6, 1.4, v.shape).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(tweak, params)


# ---- ms_deform_attn ----------------------------------------------------------

def test_ms_deform_attn_matches_jax():
    rng = np.random.RandomState(0)
    shapes = [(5, 7), (3, 4)]
    b, q, nh, hd, p = 2, 9, 2, 4, 3
    value = rng.randn(b, sum(h * w for h, w in shapes), nh, hd) \
        .astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (b, q, nh, len(shapes), p, 2)) \
        .astype(np.float32)
    # the border cases of each level: half a pixel out (reads the edge),
    # a pixel and a half out (0), the last centre, exactly 0 and 1
    h, w = shapes[0]
    edge = np.array([[-0.5 / w, 0.3], [1 + 0.5 / w, 0.6], [0.4, -1.5 / h],
                     [(w - 0.5) / w, (h - 0.5) / h], [0.0, 1.0],
                     [1.0, 0.0]], np.float32)
    loc[0, :6, 0, 0, 0] = edge
    h, w = shapes[1]
    loc[1, :3, 1, 1, 2] = np.array([[-1.0 / w, 0.5], [0.5, 1 + 1.2 / h],
                                    [1.0, 1.0]], np.float32)
    attn = rng.rand(b, q, nh, len(shapes), p).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)

    def jf(v, lc, a):
        return jax_msda(v, shapes, lc, a)

    cot = rng.randn(b, q, nh * hd).astype(np.float32)

    @jax.jit
    def ref_fn(v, lc, a, ct):
        out, vjp = jax.vjp(jf, v, lc, a)
        return out, vjp(ct)

    ref, ref_grads = ref_fn(value, loc, attn, cot)
    ts = [torch.tensor(x, requires_grad=True) for x in (value, loc, attn)]
    got = ms_deform_attn(ts[0], shapes, ts[1], ts[2])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(cot))
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    # one level, one tap on row 0: half a pixel left of the map reads
    # column 0 whole (grid_sample's zero padding would give half of it),
    # a pixel and a half left gives 0, half a pixel right reads the last
    h, w = 3, 4
    v = torch.arange(1.0, h * w + 1).reshape(1, h * w, 1, 1)
    xs = torch.tensor([-0.5 / w, -1.5 / w, 1 + 0.5 / w])
    lc = torch.stack([xs, torch.full((3,), 0.5 / h)], -1) \
        .reshape(1, 3, 1, 1, 1, 2)
    one = ms_deform_attn(v, [(h, w)], lc, torch.ones(1, 3, 1, 1, 1))
    assert one.flatten().tolist() == [1.0, 0.0, float(w)]
    # a NaN location (a diverged model) stays in bounds and gives NaN
    lc[0, 1, 0, 0, 0, 0] = float("nan")
    one = ms_deform_attn(v, [(h, w)], lc, torch.ones(1, 3, 1, 1, 1))
    assert torch.isnan(one[0, 1]).all() and one[0, 2].item() == float(w)


# ---- the standalone adapter's variants --------------------------------------

VARIANTS = {
    "window": dict(window_blocks=(0,), window_size=2),
    "qk_norm": dict(qk_norm=True, window_blocks=(1,), window_size=4),
    "rms": dict(use_rms=True, qk_norm=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encoder_variants_match_jax(variant):
    """``encoder_only`` on a 48 x 80 image: a 3 x 5 token grid, which the
    windows of 2 and 4 pad (the adapter around the encoder is held in the
    detector's tests below)."""
    kw = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16,
              interaction_indexes=(0, 1), adapter_dim=16, multi_input=True,
              **VARIANTS[variant])
    port = InternViTAdapter((48, 80), gen=torch.Generator().manual_seed(0),
                            **kw)
    jm = JaxAdapter(**kw)
    x = np.random.RandomState(1).rand(2, 48, 80, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a), x)
    template = {"backbone": jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), shapes["params"])}
    params = _randomise(to_flax(
        {f"backbone.{k}": v for k, v in port.state_dict().items()},
        template), np.random.RandomState(2))
    port.load_state_dict({k[len("backbone."):]: v for k, v in
                          from_flax(dict(params, neck={})).items()})

    def run(p, a):
        return jm.apply({"params": p}, a, encoder_only=True)

    ref = np.asarray(_compiled(run, params["backbone"], x)(
        params["backbone"], x))
    with torch.no_grad():
        got = port(torch.from_numpy(x), encoder_only=True)
    assert tuple(got.shape) == ref.shape == (2, 15, 32)
    assert float(np.abs(got.numpy() - ref).max()) <= \
        1e-4 * max(float(np.abs(ref).max()), 1.0)


# ---- the tiny BabelRS detector -----------------------------------------------

def _tiny_cfg():
    cfg = Config.fromfile(BABELRS)
    cfg.merge_from_dict(TINY_OVERRIDES)
    return cfg


def _jax_infer(m, sar, rgb, ifr):
    """Every inference output the tests hold, in one compile: the encoder
    alone, the stages of each modality (the backbone mixes no images) and
    the joint forward's detections."""
    imgs = jnp.concatenate([sar, rgb, ifr])
    out = {"encoder": m.backbone(imgs, encoder_only=True)}
    feats, _ = m.backbone(imgs, train=False)
    for i, name in enumerate(("sar", "rgb", "ifr")):
        f = [level[i:i + 1] for level in feats]
        if name == "sar":
            x = m._neck_sar(f)
            head = (x, m.sar_bbox_head(x))
        else:
            x = m._neck_rcnn(f)
            rpn = m.rgb_rpn_head if name == "rgb" else m.ifr_rpn_head
            head = (x, rpn(x))
        out[name] = (f, head)
    out["dets"] = m.simple_test_joint(sar, rgb, ifr, SHAPE)
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = _tiny_cfg()
    port = build_detector(cfg.model, device="cpu", img_size=cfg.img_size)
    mc = {k: v for k, v in port.cfg.items() if k != "img_size"}
    mc["backbone"] = dict(mc["backbone"])
    jmodel = JaxDetector(mc)
    batch = _tiny_batch(g=G, img=IMG)
    imgs = {k: batch[k]["img"] for k in ("sar", "rgb", "ifr")}
    # the joint forward's init makes every parameter the training init
    # makes (no reweighting sigmas here), in half its trace time
    shapes = jax.eval_shape(lambda s, r, i: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, s, r, i, SHAPE,
        method="simple_test_joint"), imgs["sar"], imgs["rgb"],
        imgs["ifr"])["params"]
    template = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    params = _randomise(to_flax(dict(port.state_dict()), template),
                        np.random.RandomState(1))
    params["sar_bbox_head"]["gfl_cls"]["bias"] = np.full_like(
        params["sar_bbox_head"]["gfl_cls"]["bias"], 0.5)
    for m in ("rgb", "ifr"):
        params[f"{m}_roi_head"]["fc_cls"]["kernel"] *= 12.0
        params[f"{m}_rpn_head"]["rpn_reg"]["kernel"] *= 0.2
    port.load_state_dict(from_flax(params), strict=True)
    args = (params, imgs["sar"], imgs["rgb"], imgs["ifr"])
    ref = _compiled(lambda p, s, r, i: jmodel.apply(
        {"params": p}, s, r, i, method=_jax_infer), *args)(*args)
    return {"cfg": cfg, "batch": batch, "params": params, "jmodel": jmodel,
            "port": port, "imgs": imgs, "ref": ref, "template": template}


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_from_flax_carries_the_vit_tree(setup):
    params, port = setup["params"], setup["port"]
    state = from_flax(params)
    assert set(state) == set(port.state_dict())
    assert tuple(state["backbone.pos_embed"].shape) == (1, 16, 32)
    assert tuple(state["backbone.block2.qkv.weight"].shape) == (96, 32)
    assert tuple(state["backbone.spm.stem1.weight"].shape) == (64, 3, 3, 3)
    assert tuple(state["backbone.inject1.sampling_offsets.weight"].shape) \
        == (8 * 3 * 4 * 2, 16)
    back = dict(_flat(to_flax(dict(port.named_parameters()), params)))
    ref = dict(_flat(params))
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_encoder_only_matches_jax(setup):
    imgs = np.concatenate([setup["imgs"][k] for k in ("sar", "rgb", "ifr")])
    with torch.no_grad():
        got = setup["port"].backbone(torch.from_numpy(imgs),
                                     encoder_only=True)
    assert tuple(got.shape) == (3, 16, 32)
    _close(got, setup["ref"]["encoder"])


@pytest.mark.parametrize("which", ["sar", "rgb", "ifr"])
def test_stages_match_jax(setup, which):
    port, imgs = setup["port"], setup["imgs"]
    feats_ref, (x_ref, head_ref) = setup["ref"][which]
    with torch.no_grad():
        feats = port.extract_feat(torch.from_numpy(imgs[which]))
        if which == "sar":
            x = port.neck_sar(feats)
            head = port.sar_bbox_head(x)
        else:
            x = port.neck_rcnn(feats)
            head = port.head_rpn(x, which)
    got = list(feats) + list(x) + list(head[0]) + list(head[1])
    want = jax.tree_util.tree_leaves((feats_ref, x_ref, head_ref))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("which", ["sar", "rgb", "ifr", "joint"])
def test_entry_points_match_jax(setup, which):
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
    batch, params, jmodel = setup["batch"], setup["params"], setup["jmodel"]
    r = setup["port"].cfg["rgb"]

    def loss_fn(p, b):
        losses = jmodel.apply({"params": p}, b, source_ratio=(1, 1, 1),
                              train=True, rngs=RNGS)
        return sum(losses.values()), losses

    (_, losses), grads = _compiled(jax.value_and_grad(
        loss_fn, has_aux=True), params, batch)(params, batch)
    sizes = [(1, N_ANCHORS), (1, G + r["rpn_max"])] * 2
    rngs = _StageRngs(len(sizes)).apply({}, rngs={"sampling": RNGS[
        "sampling"]})
    keys = [_split_keys(k, b, p) for k, (b, p) in zip(rngs, sizes)]
    cfg = setup["cfg"]
    port = build_detector(cfg.model, device="cpu", img_size=cfg.img_size,
                          trainable=True)
    port.load_state_dict(from_flax(params), strict=True)
    tp = trainable_params(port)
    p_losses = port(batch_to(batch, "cpu"), gen=torch.Generator()
                    .manual_seed(0), sample_keys=keys)
    # the last interaction's inject reaches no output (as in JAX, whose
    # gradient there is 0)
    p_grads = torch.autograd.grad(sum(p_losses.values()), list(tp.values()),
                                  allow_unused=True)
    p_grads = [torch.zeros_like(p) if g is None else g
               for p, g in zip(tp.values(), p_grads)]
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
    assert ref["rgb_loss_bbox"] > 0 and ref["sar_loss_bbox"] > 0


@pytest.mark.parametrize("part", ["vit", "adapter", "spm", "neck_heads"])
def test_gradients_match_jax(train_pair, part):
    ref, got = train_pair["grads"], train_pair["p_grads"]

    def part_of(k):
        if not k.startswith("backbone/"):
            return "neck_heads"
        mod = k.split("/")[1]
        if mod == "spm":
            return "spm"
        if mod.startswith(("block", "stem", "pos_embed")):
            return "vit"
        return "adapter"

    names = [k for k in ref if part_of(k) == part]
    assert names
    bad = []
    for k in names:
        scale = float(np.linalg.norm(ref[k]))
        err = float(np.abs(got[k] - ref[k]).max())
        if not err <= 1e-3 * scale + 1e-9:
            bad.append((k, err, scale))
    assert not bad, bad
    assert sum(np.linalg.norm(ref[k]) > 0 for k in names) > len(names) // 2


def test_layer_decay_scales_match_jax(setup):
    """Every leaf of the tiny BabelRS tree: the port's scale of the
    parameter equals JAX's of the flax leaf it converts from."""
    params, port = setup["params"], setup["port"]
    rate, n_layers = 0.95, 4
    ref = dict(_flat(jax_extras.layer_decay_scales(
        params, num_layers=n_layers, decay_rate=rate)))
    named = dict(port.named_parameters())
    scales = extras.layer_decay_scales(list(named), n_layers, rate)
    got = dict(_flat(to_flax(
        {n: torch.full(p.shape, s) for (n, p), s in zip(named.items(),
                                                        scales)},
        params)))
    assert got.keys() == ref.keys()
    bad = [k for k in ref
           if not np.all(np.abs(got[k] - float(ref[k]))
                         <= 1e-6 * float(ref[k]))]
    assert not bad, bad[:8]
    by = {k: float(v) for k, v in ref.items()}
    assert np.isclose(by["backbone/stem_single/kernel"], rate ** 4)
    assert np.isclose(by["backbone/spm/stem2/kernel"], rate ** 4)
    assert by["backbone/spm/gn1/scale"] == 1.0
    assert by["backbone/extract0/value_proj/kernel"] == 1.0
    for i in range(4):
        assert np.isclose(by[f"backbone/block{i}/fc1/kernel"],
                          rate ** (3 - i))


# ---- the HF checkpoint ------------------------------------------------------

def _hf_state_dict(rng, state, grid=6):
    """A HF-format InternViT state dict for the tiny ViT, with the cls
    token in the position embedding and a ``grid`` x ``grid`` grid."""
    c = state["backbone.pos_embed"].shape[-1]
    sd = {"vision_model.embeddings.patch_embedding.weight":
          rng.randn(*state["backbone.stem_single.weight"].shape),
          "vision_model.embeddings.patch_embedding.bias": rng.randn(c),
          "vision_model.embeddings.position_embedding":
          rng.randn(1, grid * grid + 1, c)}
    i = 0
    while f"backbone.block{i}.qkv.weight" in state:
        tp = f"vision_model.encoder.layers.{i}."
        for src, dst in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                         ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2"),
                         ("norm1", "norm1"), ("norm2", "norm2")):
            for leaf in ("weight", "bias"):
                sd[tp + f"{src}.{leaf}"] = rng.randn(
                    *state[f"backbone.block{i}.{dst}.{leaf}"].shape)
        sd[tp + "ls1"] = rng.randn(c)
        sd[tp + "ls2"] = rng.randn(c)
        i += 1
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _write_safetensors(path, tensors):
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        raw = np.ascontiguousarray(arr, np.float32).tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def test_internvit_hf_to_port_matches_jax(setup, tmp_path):
    params, port = setup["params"], setup["port"]
    state = dict(port.state_dict())
    sd = _hf_state_dict(np.random.RandomState(5), state)
    path = str(tmp_path / "vit.safetensors")
    _write_safetensors(path, sd)
    loaded = ckpt.load_torch_state_dict(path)
    got = ckpt.internvit_hf_to_port(loaded, state)
    ref = from_flax(internvit_torch_to_jax(sd, params))
    assert set(got) == set(ref)
    changed = 0
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        changed += not torch.equal(got[k], state[k])
    # the ViT's leaves changed, the adapter's stayed at their init
    assert not torch.equal(got["backbone.pos_embed"],
                           state["backbone.pos_embed"])
    assert torch.equal(got["backbone.extract0.value_proj.weight"],
                       state["backbone.extract0.value_proj.weight"])
    assert changed == 2 + 1 + 4 * 14
    # the grid was resized: not just a crop of the checkpoint's rows
    pe = sd["vision_model.embeddings.position_embedding"][0, 1:]
    assert not np.allclose(got["backbone.pos_embed"][0].numpy(), pe[:16])


# ---- the builder --------------------------------------------------------------

def test_builder_takes_the_config_and_refuses_what_jax_ignores():
    cfg = _tiny_cfg()
    with pytest.raises(ValueError, match="img_size"):
        build_detector(cfg.model, device="cpu")
    model = build_detector(cfg.model, device="cpu", img_size=80)
    with pytest.raises(ValueError, match="4x4 token grid.*5x5"):
        model.extract_feat(torch.zeros(1, 64, 64, 3))
    for key, value in (("moe_block_inds", [[], [0], [], []]),
                       ("multi_input", False), ("drop_path_rate", 0.1)):
        mc = cfg.model.to_dict()
        mc["backbone"][key] = value
        with pytest.raises(NotImplementedError, match=key):
            build_detector(mc, device="cpu", img_size=64)
    mc = cfg.model.to_dict()
    mc["backbone"]["type"] = "InternViT"
    with pytest.raises(ValueError, match="unknown backbone type"):
        build_detector(mc, device="cpu", img_size=64)


# ---- the entry points on the BabelRS config ---------------------------------

TINY = [f"{k}={json.dumps(v).replace(' ', '')}" if isinstance(v, list)
        else f"{k}={v}" for k, v in TINY_OVERRIDES.items()
        if k != "model.backbone.pretrained"]


def test_test_cli_evaluates_the_babelrs_config():
    out = test_cli.main([BABELRS, "--subdataset", "rgb", "--device", "cpu",
                         "--synthetic-data", "--num-images", "4",
                         "--batch-size", "2", "--compute-dtype", "float32",
                         "--cfg-options", *TINY])
    assert out["model"].backbone.grid == (4, 4)
    assert np.isfinite(out["metrics"]["mAP"])
    assert out["num_images"] == 4 and len(out["det_results"]) == 4


def test_train_cli_trains_the_babelrs_config(tmp_path):
    base = [BABELRS, "--synthetic-data", "--device", "cpu",
            "--cfg-options", "log_interval=1",
            "lr_config.warmup_iters=1", *TINY]
    wd = str(tmp_path / "ema")
    extra = ["ema_decay=0.9", "optimizer.accumulate=2",
             "lr_config.policy=cosine", "checkpoint_interval=3"]
    out = train_cli.main(base + extra + ["--max-iters", "3",
                                         "--work-dir", wd])
    assert out["stats"]["iters"] == 3
    assert all(np.isfinite(v) for v in out["stats"]["log_lines"][-1].values())
    # the config's layer decay, as the optimizer applies it
    sc = out["lr_scales"]
    for i in range(4):
        assert np.isclose(sc[f"backbone.block{i}.qkv.weight"], 0.95 ** (3 - i))
    assert np.isclose(sc["backbone.spm.stem1.weight"], 0.95 ** 4)
    assert sc["sar_bbox_head.gfl_cls.weight"] == 1.0
    st = out["state"]
    assert st.opt.step == 3 and st.opt.count == 1 and st.opt.accum_count == 1
    assert any(bool((e - p).abs().max() > 0)
               for e, p in zip(st.ema, st.params.values()))
    again = train_cli.main(base + extra + ["--max-iters", "3", "--work-dir",
                                           wd, "--auto-resume"])
    assert again["start_iter"] == 3 and again["stats"]["iters"] == 0
    rs = again["state"]
    for xs, ys in ((rs.params.values(), st.params.values()),
                   (rs.ema, st.ema), (rs.opt.accum, st.opt.accum),
                   (rs.opt.mu, st.opt.mu), (rs.opt.nu, st.opt.nu)):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    assert (rs.opt.count, rs.opt.accum_count) == (1, 1)
