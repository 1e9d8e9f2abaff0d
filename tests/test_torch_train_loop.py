"""The port's training runtime against the JAX package's, on the CPU.

- ``grad_clip``: three AdamW updates with a global-norm clip (one step
  clipped hard, one not) against JAX's ``make_optimizer(grad_clip=...)``:
  the moments and the parameters within 1e-6 of each leaf's largest
  magnitude (the two packages sum the global norm in different orders, and
  a moment that cancels to near 0 keeps that rounding in absolute terms).
- ``run_training``: fed the same stub step, metrics and eval results as
  JAX's ``run_training``, it writes the same ``train_log.jsonl`` apart
  from the timing fields.
- The whole train state round-trips through ``iter_N.pth`` bit for bit,
  and a resumed run equals an unbroken one bit for bit: the ``atto``
  detector at 64 px with gate noise and stochastic depth on (so the
  step's ``torch.Generator`` must be restored), 2 steps, saved, reloaded
  into a fresh state, 2 more, against 4 straight steps, at fp32, with
  deterministic algorithms on.
- ``convnext_torch_to_port`` on synthetic torch ConvNeXt state dicts
  (plain, MultiInput stem, trained MoE) equals JAX's
  ``convnext_torch_to_jax`` followed by the port's conversion.
- The CLI in-process on ``configs/smoke_tiny.py``: config, log lines,
  ``iter_2`` and ``iter_4``; ``--auto-resume`` starts at 4; without a card
  and without ``--device`` it raises; what is not ported raises, and so do
  the ``lr_config`` keys and the ``momentum_config`` that JAX's tool drops
  without a word.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sm3det_tpu.models.backbones.convnext import ConvNeXtMoE as JaxConvNeXt
from sm3det_tpu.train.checkpoint import convnext_torch_to_jax
from sm3det_tpu.train.loggers import TextLogger as JaxTextLogger
from sm3det_tpu.train.loop import run_training as jax_run_training
from sm3det_tpu.train.optim import make_optimizer as jax_make_optimizer
from sm3det_tpu_torch.convert import convert_tree
from sm3det_tpu_torch.models.detectors.trisource import TriSourceDetector
from sm3det_tpu_torch.tools import train as train_cli
from sm3det_tpu_torch.train import checkpoint as ckpt
from sm3det_tpu_torch.train import loggers
from sm3det_tpu_torch.train.dla import make_dla_config
from sm3det_tpu_torch.train.loop import run_training
from sm3det_tpu_torch.train.optim import make_optimizer
from sm3det_tpu_torch.train.train_state import (batch_to, build_train_step,
                                                init_train_state,
                                                trainable_params)
from torch_jax_refs import jax_refs_at_lowest_level  # noqa: F401

TIMING = ("elapsed_s", "data_time", "step_time")
SMOKE = "configs/smoke_tiny.py"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores, and the train steps' many small parallel regions stall
    on oversubscribed cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


# ---- grad_clip --------------------------------------------------------------

def test_grad_clip_matches_jax():
    rng = np.random.RandomState(0)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    # step 1 clipped hard (norm ~1e3 against 10), step 2 not, step 3 a bit
    grads = [{k: (rng.randn(*s) * g).astype(np.float32)
              for k, s in shapes.items()} for g in (300.0, 0.1, 2.5)]
    kw = dict(base_lr=2e-3, weight_decay=0.05, betas=(0.9, 0.999),
              step_iters=(2,), warmup_iters=2, warmup_ratio=1.0 / 3)

    def port_run(clip):
        names = list(shapes)
        ps = [torch.tensor(params[k]) for k in names]
        init_fn, update_fn, _ = make_optimizer(names, grad_clip=clip, **kw)
        st = init_fn(ps)
        for g in grads:
            st = update_fn([torch.tensor(g[k]) for k in names], st, ps)
        return ({k: p.numpy() for k, p in zip(names, ps)},
                {k: m.numpy() for k, m in zip(names, st.mu)},
                {k: v.numpy() for k, v in zip(names, st.nu)})

    init_fn, update_fn, _ = jax_make_optimizer(grad_clip=10.0, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = init_fn(jp)
    for g in grads:
        upd, st = update_fn({k: jnp.asarray(v) for k, v in g.items()}, st,
                            jp)
        jp = optax.apply_updates(jp, upd)
    adam = st.adam[0]
    ref = ({k: np.asarray(v) for k, v in jp.items()},
           {k: np.asarray(v) for k, v in adam.mu.items()},
           {k: np.asarray(v) for k, v in adam.nu.items()})
    got = port_run(10.0)
    for g_tree, r_tree in zip(got, ref):
        for k in shapes:
            scale = np.abs(r_tree[k]).max()
            assert np.abs(g_tree[k] - r_tree[k]).max() <= 1e-6 * scale, k
    # the clip shows: without it the first moments differ by far more
    unclipped_mu = port_run(None)[1]
    assert max(np.abs(unclipped_mu[k] - ref[1][k]).max() /
               np.abs(ref[1][k]).max() for k in shapes) > 0.1


# ---- run_training's log -----------------------------------------------------

def _stub_step(metrics_seq, as_tensor):
    def step(state, batch):
        m = metrics_seq[state]
        return state + 1, {k: torch.tensor(v) if as_tensor else jnp.asarray(v)
                           for k, v in m.items()}
    return step


def _log_lines(path):
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return [{k: v for k, v in x.items() if k not in TIMING} for x in lines]


@pytest.mark.parametrize("start_iter", [0, 3])
def test_run_training_writes_jax_log(tmp_path, start_iter):
    rng = np.random.RandomState(1)
    keys = ("loss", "sar_loss_cls", "gate_loss", "rgb_loss_bbox")
    seq = [{k: np.float32(rng.rand() * 10 ** rng.randint(-3, 2))
            for k in keys} for _ in range(12)]

    def evals():
        return {"sar": lambda s: {"mAP50": 0.5 + 0.01 * s, "mAP": 0.25,
                                  "per_class_ap50": {0: 0.5}},
                "rgb": lambda s: {"mAP50": 0.125}}

    out = {}
    for name, fn, as_tensor in (("port", run_training, True),
                                ("jax", jax_run_training, False)):
        wd = tmp_path / name
        final = fn(_stub_step(seq, as_tensor), start_iter,
                   iter(range(100)), 11, str(wd), log_interval=4,
                   eval_fns=evals(), eval_interval=5, logger=lambda *a: None,
                   start_iter=start_iter)
        assert final == 11
        out[name] = _log_lines(wd / "train_log.jsonl")
    assert out["port"] == out["jax"]
    assert len(out["port"]) == 2 + 2 * 2     # 2 logs, 2 evals x 2
    assert {k for x in out["port"] if "mode" not in x for k in x} == \
        {"iter", *keys}


def test_text_logger_matches_jax(tmp_path, capsys):
    for name, cls in (("port", loggers.TextLogger), ("jax", JaxTextLogger)):
        lg = cls(str(tmp_path / name))
        lg.log({"loss": 1.25, "mAP50": 0.5}, 10)
        lg.log({"loss": 0.75}, 20)
        lg.close()
    assert (tmp_path / "port" / "train_log.jsonl").read_text() == \
        (tmp_path / "jax" / "train_log.jsonl").read_text()
    # a backend whose package is missing is skipped
    built = loggers.build_loggers(["text", "wandb"], str(tmp_path / "b"))
    assert [type(x) for x in built][:1] == [loggers.TextLogger]
    assert "'wandb' unavailable" in capsys.readouterr().out or \
        len(built) == 2


# ---- the train state: round trip and resume ---------------------------------

IMG = 64
G = 4
CFG = dict(
    num_classes=4, angle_version="le90",
    backbone=dict(arch="atto", drop_path_rate=0.2,
                  moe_block_inds=((), (), (0,), ()), num_experts=2, top_k=1,
                  gate="cosine", capacity_factor=1.0, noisy_gating=True),
    neck=dict(in_channels=(40, 80, 160, 320), out_channels=32,
              num_outs=5, extra_level=1, add_extra_convs="on_output"),
    sar=dict(strides=(8, 16, 32, 64, 128), reg_max=8,
             nms_pre=50, score_thr=0.05, nms_iou=0.6, max_per_img=20),
    rgb=dict(rpn_strides=(4, 8, 16, 32, 64), rpn_sample=64,
             rcnn_sample=32, rpn_nms_pre=64, rpn_max=64, rpn_nms_iou=0.8,
             rcnn_score_thr=0.05, rcnn_nms_iou=0.1, rcnn_max=20),
)


def _batch(seed, n=(2, 1, 1)):
    rng = np.random.RandomState(seed)

    def common(b):
        return {"img": rng.rand(b, IMG, IMG, 3).astype(np.float32),
                "gt_labels": rng.randint(0, 4, (b, G)).astype(np.int32),
                "gt_mask": np.ones((b, G), bool)}

    cx, cy = rng.uniform(10, IMG - 10, (2, n[0], G))
    w, h = rng.uniform(6, 16, (2, n[0], G))
    sar = dict(common(n[0]), gt_bboxes=np.stack(
        [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(
            np.float32))

    def obb(b):
        return dict(common(b), gt_obbs=np.stack(
            [rng.uniform(12, IMG - 12, (b, G)),
             rng.uniform(12, IMG - 12, (b, G)),
             rng.uniform(8, 18, (b, G)), rng.uniform(5, 8, (b, G)),
             rng.uniform(-1.2, 1.2, (b, G))], -1).astype(np.float32))

    return batch_to({"sar": sar, "rgb": obb(n[1]), "ifr": obb(n[2])}, "cpu")


def _fresh(seed):
    model = TriSourceDetector(CFG, device="cpu", seed=seed, trainable=True)
    init_fn, update_fn, _ = make_optimizer(
        list(trainable_params(model)), base_lr=1e-3, warmup_iters=1,
        grad_clip=5.0, dla_cfg=make_dla_config(warmup_iters=1))
    state = init_train_state(model, init_fn, seed=seed + 1)
    return state, build_train_step(model, update_fn)


def _assert_states_equal(a, b):
    assert list(a.params) == list(b.params)
    for x, y in zip(a.params.values(), b.params.values()):
        assert torch.equal(x, y)
    for xs, ys in ((a.opt.mu, b.opt.mu), (a.opt.nu, b.opt.nu)):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    assert (a.opt.count, a.opt.step, a.opt.dla.steps, a.opt.mults) == \
        (b.opt.count, b.opt.step, b.opt.dla.steps, b.opt.mults)
    assert torch.equal(a.opt.dla.ema, b.opt.dla.ema)
    assert torch.equal(a.opt.dla.initialized, b.opt.dla.initialized)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


@pytest.fixture(scope="module")
def batches():
    return [_batch(s) for s in range(4)]


@pytest.fixture
def deterministic():
    """PyTorch's CPU scatter-adds (the backward of the plain versions'
    gathers) sum in thread order unless deterministic algorithms are on,
    as ``--deterministic`` turns them on."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_train_state_round_trip(tmp_path, batches):
    state, step = _fresh(0)
    state, _ = step(state, batches[0])
    path = ckpt.save_train_state(str(tmp_path), 1, state)
    assert path.endswith("iter_1.pth")
    other, _ = _fresh(5)
    loaded = ckpt.load_train_state(path, other)
    _assert_states_equal(loaded, state)
    # the masters are the model's own parameters, loaded in place
    assert all(p is q for p, q in zip(loaded.params.values(),
                                      other.params.values()))
    assert ckpt.find_latest_checkpoint(str(tmp_path)) == path
    # names and shapes are checked
    smaller = dict(CFG, num_classes=3)
    model = TriSourceDetector(smaller, device="cpu", trainable=True)
    init_fn, _, _ = make_optimizer(list(trainable_params(model)),
                                   dla_cfg=make_dla_config(warmup_iters=1))
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_train_state(path, init_train_state(model, init_fn))
    with pytest.raises(ValueError, match="not a"):
        ckpt.load_train_state(ckpt.save_params(
            str(tmp_path / "p.pth"), model), init_train_state(model,
                                                              init_fn))


def test_resume_equals_an_unbroken_run(tmp_path, batches, deterministic):
    straight, step = _fresh(0)
    losses = []
    for b in batches:
        straight, m = step(straight, b)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))

    first, step = _fresh(0)
    for b in batches[:2]:
        first, _ = step(first, b)
    path = ckpt.save_train_state(str(tmp_path), 2, first)
    resumed, step = _fresh(3)
    resumed = ckpt.load_train_state(path, resumed)
    assert resumed.opt.step == 2
    for b in batches[2:]:
        resumed, m = step(resumed, b)
    assert float(m["loss"]) == losses[-1]
    _assert_states_equal(resumed, straight)


def test_resume_needs_the_generator_state(tmp_path, batches):
    """Without the generator's state the draws (gate noise, stochastic
    depth, samplers) differ: the resume test above can see it."""
    a, step = _fresh(0)
    a, _ = step(a, batches[0])
    path = ckpt.save_train_state(str(tmp_path), 1, a)
    b, step_b = _fresh(0)
    b = ckpt.load_train_state(path, b)
    b.gen.manual_seed(12345)
    a, ma = step(a, batches[1])
    b, mb = step_b(b, batches[1])
    assert float(ma["loss"]) != float(mb["loss"])


# ---- convnext_torch_to_port -------------------------------------------------

DIMS = (40, 80, 160, 320)
DEPTHS = (2, 2, 6, 2)


def _torch_convnext_sd(rng, layout, experts=0):
    """A synthetic mm-style ConvNeXt (atto) state dict."""
    def r(*s):
        return rng.randn(*s).astype(np.float32)
    sd = {}
    if layout == "multi":
        sd["backbone.dataset_stems.single.weight"] = r(40, 3, 4, 4)
        sd["backbone.dataset_stems.single.bias"] = r(40)
        sd["backbone.downsample_layers.0.0.weight"] = r(40)
        sd["backbone.downsample_layers.0.0.bias"] = r(40)
    else:
        sd["downsample_layers.0.0.weight"] = r(40, 3, 4, 4)
        sd["downsample_layers.0.0.bias"] = r(40)
        sd["downsample_layers.0.1.weight"] = r(40)
        sd["downsample_layers.0.1.bias"] = r(40)
    p = "backbone." if layout == "multi" else ""
    for i in range(1, 4):
        sd[f"{p}downsample_layers.{i}.0.weight"] = r(DIMS[i - 1])
        sd[f"{p}downsample_layers.{i}.0.bias"] = r(DIMS[i - 1])
        sd[f"{p}downsample_layers.{i}.1.weight"] = r(DIMS[i], DIMS[i - 1],
                                                     2, 2)
        sd[f"{p}downsample_layers.{i}.1.bias"] = r(DIMS[i])
    for si, (c, d) in enumerate(zip(DIMS, DEPTHS)):
        for bi in range(d):
            tp = f"{p}stages.{si}.{bi}."
            sd[tp + "depthwise_conv.weight"] = r(c, 1, 7, 7)
            sd[tp + "depthwise_conv.bias"] = r(c)
            sd[tp + "norm.weight"] = r(c)
            sd[tp + "norm.bias"] = r(c)
            sd[tp + "gamma"] = r(c)
            if experts and (si, bi) == (2, 0):
                for j in range(experts):
                    e = tp + f"ffn.experts.{j}."
                    sd[e + "pointwise_conv1.weight"] = r(4 * c, c)
                    sd[e + "pointwise_conv1.bias"] = r(4 * c)
                    sd[e + "pointwise_conv2.weight"] = r(c, 4 * c)
                    sd[e + "pointwise_conv2.bias"] = r(c)
                g = tp + "ffn.w_gate."
                sd[g + "sim_matrix"] = r(c // 2, experts)
                sd[g + "temperature"] = r(1)
                sd[g + "cosine_projector.weight"] = r(c // 2, c)
                sd[g + "cosine_projector.bias"] = r(c // 2)
                sd[tp + "ffn.w_noise"] = r(c, experts)
            else:
                sd[tp + "ffn.pointwise_conv1.weight"] = r(4 * c, c)
                sd[tp + "ffn.pointwise_conv1.bias"] = r(4 * c)
                sd[tp + "ffn.pointwise_conv2.weight"] = r(c, 4 * c)
                sd[tp + "ffn.pointwise_conv2.bias"] = r(c)
    for i, c in enumerate(DIMS):
        sd[f"{p}norm{i}.weight"] = r(c)
        sd[f"{p}norm{i}.bias"] = r(c)
    return sd


@pytest.fixture(scope="module")
def jax_backbone_params():
    net = JaxConvNeXt(arch="atto", multi_input=True,
                      moe_block_inds=((), (), (0,), ()), num_experts=2,
                      top_k=2, gate="cosine", noisy_gating=True)
    params = jax.jit(net.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("layout,experts", [("plain", 0), ("multi", 0),
                                            ("plain", 2)])
def test_convnext_torch_to_port_matches_jax(jax_backbone_params, layout,
                                            experts):
    sd = _torch_convnext_sd(np.random.RandomState(len(layout) + experts),
                            layout, experts)
    params = {"backbone": jax_backbone_params}
    ref = convert_tree(convnext_torch_to_jax(sd, params)["backbone"],
                       ("backbone",))
    before = convert_tree(jax_backbone_params, ("backbone",))
    got = ckpt.convnext_torch_to_port(
        {k: torch.from_numpy(v) for k, v in sd.items()}, before)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    # every expert of the MoE block took the checkpoint's FFN
    w1 = got["backbone.stage2_block0.ffn.experts.w1"]
    assert not torch.equal(w1, before["backbone.stage2_block0.ffn.experts.w1"])
    if not experts:
        assert torch.equal(w1[0], w1[1])


def test_convnext_torch_to_port_checks_shapes(jax_backbone_params):
    sd = _torch_convnext_sd(np.random.RandomState(0), "plain")
    sd["norm1.weight"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="out_norm1"):
        ckpt.convnext_torch_to_port(
            sd, convert_tree(jax_backbone_params, ("backbone",)))


# ---- the CLI ----------------------------------------------------------------

def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    wd = tmp_path / "wd"
    argv = [SMOKE, "--synthetic-data", "--max-iters", "4", "--device",
            "cpu", "--work-dir", str(wd), "--cfg-options",
            "checkpoint_interval=2"]
    out = train_cli.main(argv)
    assert out["start_iter"] == 0 and out["stats"]["iters"] == 4
    assert (wd / "config.py").is_file()
    assert sorted(p.name for p in wd.iterdir()) == [
        "config.py", "iter_2.pth", "iter_4.pth", "train_log.jsonl"]
    lines = [json.loads(x) for x in
             (wd / "train_log.jsonl").read_text().splitlines()]
    assert [x["iter"] for x in lines] == [2, 4]
    assert {"elapsed_s", "data_time", "step_time", "loss",
            "sar_loss_cls", "rgb_loss_rpn_cls", "ifr_loss_bbox"} <= \
        set(lines[0])
    assert all(np.isfinite(v) for x in lines for v in x.values())

    again = train_cli.main(argv + ["--auto-resume"])
    assert again["start_iter"] == 4 and again["stats"]["iters"] == 0
    _assert_states_equal(again["state"], out["state"])
    assert "resumed from" in capsys.readouterr().out


def test_cli_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([SMOKE, "--synthetic-data", "--max-iters", "1",
                        "--work-dir", str(tmp_path / "wd")])


@pytest.mark.parametrize("extra,match", [
    (["--num-devices", "2"], "item 6"),
    (["--cfg-options", "expert_parallel=2"], "item 6"),
    (["--cfg-options", "lr_config.periods=[10,20]"], "periods"),
    (["--cfg-options", "momentum_config.policy=cyclic"], "momentum_config"),
    (["--cfg-options", "lr_config.div_factor=10"], "div_factor"),
    (["--cfg-options", "lr_config.anneal_strategy=linear"],
     "anneal_strategy"),
    (["--cfg-options", "model.type=TriSourceVariant",
      "evaluation.interval=1"], "evaluation=None")])
def test_cli_raises_for_what_is_not_ported(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        train_cli.main([SMOKE, "--synthetic-data", "--device", "cpu",
                        "--work-dir", str(tmp_path / "wd")] + extra)
