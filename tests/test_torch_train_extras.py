"""The rest of the port's train runtime against the JAX package, on the CPU.

- The LR zoo: each of the 11 policies under each of the 3 warmups, the
  port's ``make_lr_schedule`` against JAX's at chosen iterations (warmup,
  step boundaries, period and phase edges, past ``max_iters``), within
  1e-6 relative, both evaluating in fp32, or 1e-6 of the schedule's peak
  where the formula cancels: at the end of a cosine phase ``cos(pi f) +
  1`` is a difference of two numbers near 1, and XLA's fp32 cosine and
  PyTorch's differ by one ulp there (both one ulp from the exact value),
  4e-5 relative of a value 1e-3 of the peak.
- The momentum schedules (4 policies, with and without warmup) against
  JAX's, and 5 AdamW steps whose b1 follows each (JAX's
  ``scale_by_adam_dynamic_b1``): moments and parameters within 1e-6 of
  each leaf's scale.
- ``accumulate=2`` as ``tests/test_optim_accum.py`` holds JAX's: the
  first step changes nothing and advances the step (and the LR schedule
  with it), the second applies the update of the mean gradient; over 4
  steps against JAX's ``make_optimizer(accumulate=2)``, with layer decay
  and a cosine schedule.
- Layer decay: the port's scale of every parameter equals JAX's
  ``layer_decay_scales`` of the flax leaf it converts from, for the tiny
  BabelRS detector (``test_torch_babelrs.py``, on its tree) and for
  ``configs/smoke_tiny.py``'s ConvNeXt-MoE backbone.
- EMA: three steps of ``ema_update`` against JAX's; the train state's EMA
  and accumulator through ``iter_N.pth``, and a resumed step (saved
  between the two steps of an accumulation) equal to an unbroken run's
  bit for bit.
- The safetensors reader against ``safetensors.numpy.save_file`` where
  that package imports, and always against a file written here byte by
  byte; an unknown dtype and a truncated file raise ``ValueError``.
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.backbones.convnext import ConvNeXtMoE as JaxConvNeXt
from sm3det_tpu.train import extras as jax_extras
from sm3det_tpu.train import optim as jax_optim
from sm3det_tpu_torch.convert import to_flax
from sm3det_tpu_torch.models.builder import build_detector
from sm3det_tpu_torch.models.detectors.trisource import TriSourceDetector
from sm3det_tpu_torch.train import checkpoint as ckpt
from sm3det_tpu_torch.train import extras, optim
from sm3det_tpu_torch.train.train_state import (build_train_step,
                                                init_train_state,
                                                trainable_params)
from sm3det_tpu_torch.utils.config import Config

from test_torch_train_loop import CFG as ATTO_CFG
from test_torch_train_loop import _assert_states_equal, _batch
from torch_jax_refs import jax_refs_at_lowest_level  # noqa: F401

REL = 1e-6
ITERS = (0, 1, 5, 9, 10, 11, 37, 59, 60, 61, 99, 100, 119, 150, 199, 200,
         250)
MAX_ITERS = 200
POLICY_KW = {
    "step": dict(step_iters=(60, 150), gamma=0.1, min_lr=2e-6),
    "dynamic": dict(step_iters=(60, 150)),
    "cosine": dict(min_lr_ratio=0.01),
    "flat_cosine": dict(min_lr=1e-6, lr_schedule_kwargs=dict(
        start_percent=0.5)),
    "cosine_restart": dict(min_lr=1e-5, lr_schedule_kwargs=dict(
        periods=(60, 90, 50), restart_weights=(1.0, 0.5, 0.25))),
    "cyclic": dict(lr_schedule_kwargs=dict(
        target_ratio=(10.0, 1e-4), cyclic_times=2, step_ratio_up=0.4,
        cyclic_gamma=0.8)),
    "one_cycle": dict(lr_schedule_kwargs=dict(
        start_percent=0.3, div_factor=25.0, final_div_factor=1e4,
        anneal_strategy="linear")),
    "linear": dict(min_lr=1e-6),
    "poly": dict(power=0.9, min_lr=1e-6),
    "exp": dict(gamma=0.99),
    "inv": dict(gamma=0.01, power=0.75),
    "fixed": dict(),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _schedule_kwargs(policy):
    kw = dict(POLICY_KW[policy])
    kw.update(kw.pop("lr_schedule_kwargs", {}))
    return kw


@pytest.mark.parametrize("warmup", ["constant", "linear", "exp"])
@pytest.mark.parametrize("policy", list(POLICY_KW))
def test_lr_schedule_matches_jax(policy, warmup):
    kw = dict(base_lr=2e-4, max_iters=MAX_ITERS, warmup=warmup,
              warmup_iters=10, warmup_ratio=0.1, **_schedule_kwargs(policy))
    ref = np.asarray(jax_optim.make_lr_schedule(policy, **kw)(
        jnp.asarray(ITERS, jnp.float32)))
    port = optim.make_lr_schedule(policy, **kw)
    got = np.asarray([port(i) for i in ITERS], np.float64)
    np.testing.assert_allclose(got, ref, rtol=REL, atol=REL * ref.max())
    assert len(set(np.round(got / got.max(), 6))) >= (
        2 if policy == "fixed" else 3)


def test_unknown_schedule_names_raise():
    with pytest.raises(ValueError, match="triangle"):
        optim.make_lr_schedule("triangle")
    with pytest.raises(ValueError, match="warmup 'cubic'"):
        optim.make_lr_schedule("step", warmup="cubic")
    with pytest.raises(ValueError, match="momentum policy 'poly'"):
        optim.make_momentum_schedule("poly")


MOMENTUM_KW = {
    "step": dict(step_iters=(2, 4), gamma=0.9, min_momentum=0.8),
    "cosine": dict(min_momentum_ratio=0.9),
    "linear": dict(min_momentum=0.85),
    "cyclic": dict(cyclic_times=2, step_ratio_up=0.4, warmup="linear",
                   warmup_iters=2, warmup_ratio=0.9),
}


def _tree(rng, shapes, scale=1.0):
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("policy", list(MOMENTUM_KW))
def test_momentum_schedule_and_dynamic_b1_adam_match_jax(policy):
    kw = MOMENTUM_KW[policy]
    ref = np.asarray(jax_optim.make_momentum_schedule(
        policy, base_momentum=0.95, max_iters=6, **kw)(
            jnp.arange(8, dtype=jnp.float32)))
    sched = optim.make_momentum_schedule(policy, base_momentum=0.95,
                                         max_iters=6, **kw)
    np.testing.assert_allclose([sched(i) for i in range(8)], ref, rtol=REL)
    assert len(set(np.round(ref, 6))) > 1

    rng = np.random.RandomState(0)
    shapes = {"a": (6, 5), "b": (7,)}
    params = _tree(rng, shapes)
    grads = [_tree(rng, shapes, 0.1) for _ in range(5)]
    okw = dict(base_lr=1e-2, weight_decay=0.05, betas=(0.95, 0.999),
               warmup_iters=0, max_iters=6, momentum_policy=policy,
               momentum_kwargs=kw)
    j_init, j_update, _ = jax_optim.make_optimizer(**okw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = j_init(jp)
    for g in grads:
        upd, st = j_update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
    names = list(shapes)
    ps = [torch.tensor(params[k]) for k in names]
    p_init, p_update, _ = optim.make_optimizer(names, **okw)
    pst = p_init(ps)
    for g in grads:
        pst = p_update([torch.tensor(g[k]) for k in names], pst, ps)
    adam = st.adam[0]
    for got, want in ((ps, jp), (pst.mu, adam.mu), (pst.nu, adam.nu)):
        for k, t in zip(names, got):
            w = np.asarray(want[k])
            assert np.abs(t.numpy() - w).max() <= REL * np.abs(w).max(), k
    assert pst.count == 5 and int(adam.count) == 5


def test_accumulate_two_matches_jax():
    """JAX's ``accumulate=2`` (``test_optim_accum.py``'s semantics): a
    skip step leaves the parameters and Adam's state as they are and
    advances the step; the next applies the mean gradient's update at the
    LR of its own step. Over 4 steps, with layer decay and a cosine LR."""
    rng = np.random.RandomState(1)
    # the port's names are module.leaf, the flax tree's module/leaf
    shapes = {"block0": (4, 3), "block1": (5,), "head": (3, 2)}
    params = _tree(rng, shapes)
    grads = [_tree(rng, shapes, 0.2) for _ in range(4)]
    okw = dict(base_lr=1e-2, weight_decay=0.05, warmup_iters=1,
               lr_policy="cosine", max_iters=6, accumulate=2,
               layer_decay=dict(rate=0.5, num_layers=3))
    j_init, j_update, _ = jax_optim.make_optimizer(**okw)

    def nest(tree):
        return {k: {"kernel": jnp.asarray(v)} for k, v in tree.items()}

    jp = nest(params)
    st = j_init(jp)
    names = list(shapes)
    ps = [torch.tensor(params[k]) for k in names]
    p_init, p_update, sched = optim.make_optimizer(
        [f"{k}.weight" for k in names], **okw)
    pst = p_init(ps)
    for i, g in enumerate(grads):
        before = [p.clone() for p in ps]
        upd, st = j_update(nest(g), st, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        pst = p_update([torch.tensor(g[k]) for k in names], pst, ps)
        assert pst.step == i + 1 and pst.count == (i + 1) // 2
        assert pst.accum_count == (i + 1) % 2
        if i % 2 == 0:
            assert all(torch.equal(a, b) for a, b in zip(ps, before))
            assert i > 0 or not any(a.any() for a in pst.mu)
        for k, t in zip(names, ps):
            w = np.asarray(jp[k]["kernel"])
            assert np.abs(t.numpy() - w).max() <= REL * np.abs(w).max(), k
    # the three layer-decay scales showed: the update of each parameter
    # over its own gradient's Adam direction differs
    moved = [float((t - torch.tensor(params[k])).abs().max())
             for k, t in zip(names, ps)]
    assert moved[0] < moved[1] < moved[2]
    # the LR of the applying steps moved with every step
    assert sched(1) != sched(3)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def test_layer_decay_scales_match_jax():
    """Every leaf of ``configs/smoke_tiny.py``'s ConvNeXt-MoE backbone:
    the port's scale of the parameter equals JAX's of the flax leaf it
    converts from (the tiny BabelRS tree: ``test_torch_babelrs.py``)."""
    cfg = Config.fromfile("configs/smoke_tiny.py")
    port = build_detector(cfg.model, device="cpu")
    b = port.cfg["backbone"]
    jm = JaxConvNeXt(arch=b["arch"], moe_block_inds=b["moe_block_inds"],
                     num_experts=b.get("num_experts", 2),
                     top_k=b.get("top_k", 2), multi_input=True)
    shapes = jax.eval_shape(lambda x: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "moe_noise": jax.random.PRNGKey(2)}, x),
        np.zeros((1, 64, 64, 3), np.float32))["params"]
    template = {"backbone": jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), shapes), "neck": {}}
    rate, n_layers = 0.9, 12
    ref = dict(_flat(jax_extras.layer_decay_scales(
        template, num_layers=n_layers, decay_rate=rate)))
    named = {n: p for n, p in port.named_parameters()
             if n.startswith("backbone.")}
    scales = extras.layer_decay_scales(list(named), n_layers, rate)
    got = dict(_flat(to_flax(
        {n: torch.full(p.shape, s) for (n, p), s in zip(named.items(),
                                                        scales)},
        template)))
    assert got.keys() == ref.keys()
    bad = [k for k in ref
           if not np.all(np.abs(got[k] - float(ref[k]))
                         <= REL * float(ref[k]))]
    assert not bad, bad[:8]
    by = {k: float(v) for k, v in ref.items()}
    assert np.isclose(by["backbone/stem_single/kernel"], rate ** n_layers)
    assert np.isclose(by["backbone/stage2_block1/dwconv/kernel"],
                      rate ** (n_layers - 8))
    assert by["backbone/downsample_norm1/scale"] == 1.0
    assert len(set(np.round(list(by.values()), 9))) > 5


def test_ema_update_matches_jax():
    rng = np.random.RandomState(2)
    shapes = {"a": (5, 4), "b": (3,)}
    ema = _tree(rng, shapes)
    seq = [_tree(rng, shapes) for _ in range(3)]
    j = {k: jnp.asarray(v) for k, v in ema.items()}
    names = list(shapes)
    t = [torch.tensor(ema[k]) for k in names]
    for p in seq:
        j = jax_extras.ema_update(j, {k: jnp.asarray(v)
                                      for k, v in p.items()}, decay=0.9)
        extras.ema_update(t, [torch.tensor(p[k]) for k in names], 0.9)
    for k, x in zip(names, t):
        np.testing.assert_allclose(x.numpy(), np.asarray(j[k]), rtol=REL,
                                   atol=REL)


def _fresh_extras(seed):
    model = TriSourceDetector(ATTO_CFG, device="cpu", seed=seed,
                              trainable=True)
    names = list(trainable_params(model))
    init_fn, update_fn, _ = optim.make_optimizer(
        names, base_lr=1e-3, warmup_iters=1, lr_policy="cosine",
        max_iters=4, accumulate=2, layer_decay=dict(rate=0.9,
                                                    num_layers=12))
    state = init_train_state(model, init_fn, seed=seed + 1, ema=True)
    return state, build_train_step(model, update_fn, ema_decay=0.9)


def _assert_extras_equal(a, b):
    _assert_states_equal(a, b)
    assert a.opt.accum_count == b.opt.accum_count
    for xs, ys in ((a.ema, b.ema), (a.opt.accum, b.opt.accum)):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))


def test_ema_and_accumulator_resume_bit_for_bit(tmp_path):
    """An unbroken run of 2 steps saved after its 1st (mid-accumulation);
    a fresh state loaded from the file equals the saved one, and its 2nd
    step the unbroken run's."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        batches = [_batch(s, (1, 1, 1)) for s in range(2)]
        straight, step = _fresh_extras(0)
        start = [p.clone() for p in straight.params.values()]
        straight, _ = step(straight, batches[0])
        assert straight.opt.accum_count == 1 and straight.opt.count == 0
        assert any(a.any() for a in straight.opt.accum)
        path = ckpt.save_train_state(str(tmp_path), 1, straight)
        resumed, step_r = _fresh_extras(4)
        resumed = ckpt.load_train_state(path, resumed)
        _assert_extras_equal(resumed, straight)
        straight, _ = step(straight, batches[1])
        resumed, _ = step_r(resumed, batches[1])
        _assert_extras_equal(resumed, straight)
        assert straight.opt.count == 1 and straight.opt.accum_count == 0
        # the EMA followed the parameters, a tenth a step
        assert max(float((e - s).abs().max()) for e, s in zip(
            straight.ema, start)) > 0
        # ... and lags behind them
        assert sum(not torch.equal(e, p) for e, p in zip(
            straight.ema, straight.params.values())) > len(straight.ema) // 2
        # a state without EMA does not take the file
        model = TriSourceDetector(ATTO_CFG, device="cpu", trainable=True)
        init_fn, _, _ = optim.make_optimizer(list(trainable_params(model)),
                                             accumulate=2)
        with pytest.raises(ValueError, match="ema present"):
            ckpt.load_train_state(path, init_train_state(model, init_fn))
    finally:
        torch.use_deterministic_algorithms(was)


# ---- the safetensors reader -------------------------------------------------

def _write_safetensors(path, tensors, dtypes, pad_header=0):
    """A .safetensors file byte by byte: tensors (name -> numpy array),
    dtypes (name -> the format's dtype name)."""
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        raw = arr.tobytes()
        header[name] = {"dtype": dtypes[name], "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    header["__metadata__"] = {"format": "pt"}
    h = json.dumps(header).encode() + b" " * pad_header
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def _bf16_bits(x):
    return (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


def test_safetensors_reader_byte_by_byte(tmp_path):
    rng = np.random.RandomState(3)
    f32 = rng.randn(3, 4).astype(np.float32)
    f16 = rng.randn(5).astype(np.float16)
    bf = rng.randn(2, 3).astype(np.float32)
    i64 = rng.randint(-9, 9, (4,)).astype(np.int64)
    i32 = rng.randint(-9, 9, (2, 2)).astype(np.int32)
    empty = np.zeros((0, 3), np.float32)
    path = str(tmp_path / "a.safetensors")
    _write_safetensors(path, {"f32": f32, "f16": f16, "bf": _bf16_bits(bf),
                              "i64": i64, "i32": i32, "empty": empty},
                       {"f32": "F32", "f16": "F16", "bf": "BF16",
                        "i64": "I64", "i32": "I32", "empty": "F32"},
                       pad_header=5)
    sd = ckpt.load_torch_state_dict(path)
    assert set(sd) == {"f32", "f16", "bf", "i64", "i32", "empty"}
    assert torch.equal(sd["f32"], torch.from_numpy(f32))
    assert torch.equal(sd["f16"], torch.from_numpy(f16))
    assert sd["bf"].dtype == torch.bfloat16
    want = torch.from_numpy((_bf16_bits(bf).astype(np.uint32) << 16)
                            .view(np.float32))
    assert torch.equal(sd["bf"].float(), want)
    assert torch.equal(sd["i64"], torch.from_numpy(i64))
    assert torch.equal(sd["i32"], torch.from_numpy(i32))
    assert tuple(sd["empty"].shape) == (0, 3)

    bad = str(tmp_path / "b.safetensors")
    _write_safetensors(bad, {"x": f32}, {"x": "F64"})
    with pytest.raises(ValueError, match="F64"):
        ckpt.read_safetensors(bad)
    raw = open(path, "rb").read()
    for cut in (4, 20, len(raw) - 3):
        cut_path = str(tmp_path / f"cut{cut}.safetensors")
        with open(cut_path, "wb") as f:
            f.write(raw[:cut])
        with pytest.raises(ValueError, match="truncated|spans"):
            ckpt.read_safetensors(cut_path)


def test_safetensors_reader_against_the_package(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.RandomState(4)
    arrays = {"w": rng.randn(7, 3).astype(np.float32),
              "h": rng.randn(4).astype(np.float16),
              "n": rng.randint(0, 100, (3, 2)).astype(np.int64),
              "m": rng.randint(0, 100, (5,)).astype(np.int32)}
    path = str(tmp_path / "p.safetensors")
    st.save_file(arrays, path)
    sd = ckpt.read_safetensors(path)
    assert set(sd) == set(arrays)
    for k, v in arrays.items():
        assert torch.equal(sd[k], torch.from_numpy(v)), k
    assert os.path.getsize(path) > 0
