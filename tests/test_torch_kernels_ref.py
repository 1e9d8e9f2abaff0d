"""Plain versions of the port's kernels against the JAX Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own kernel tests run them; the port's wrappers, given CPU tensors, run
their plain PyTorch versions. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.ops.pallas.convnext_block_kernel import (
    fused_convnext_block as jax_block, fused_dwconv_ln as jax_dwconv_ln,
    fused_layernorm as jax_layernorm)
from sm3det_tpu.ops.pallas.hbb_iou_kernel import hbb_iou_pallas
from sm3det_tpu.ops.pallas.moe_groupgemm_kernel import (
    moe_ffn_grouped as jax_moe_ffn)
from sm3det_tpu_torch.ops.cuda import build
from sm3det_tpu_torch.ops.cuda.convnext_block_kernel import (
    fused_convnext_block, fused_dwconv_ln, fused_layernorm)
from sm3det_tpu_torch.ops.cuda.hbb_iou_kernel import hbb_iou
from sm3det_tpu_torch.ops.cuda.moe_groupgemm_kernel import moe_ffn_grouped
from torch_jax_refs import one_torch_thread  # noqa: F401


def _block_params(rng, c, hidden):
    """Flax layouts: dw (7, 7, 1, C), dense (in, out)."""
    return dict(
        dwk=rng.randn(7, 7, 1, c).astype(np.float32) * 0.15,
        dwb=rng.randn(c).astype(np.float32) * 0.1,
        lns=(1 + 0.1 * rng.randn(c)).astype(np.float32),
        lnb=rng.randn(c).astype(np.float32) * 0.1,
        w1=(rng.randn(c, hidden) / np.sqrt(c)).astype(np.float32),
        b1=rng.randn(hidden).astype(np.float32) * 0.1,
        w2=(rng.randn(hidden, c) / np.sqrt(hidden)).astype(np.float32),
        b2=rng.randn(c).astype(np.float32) * 0.1,
        gamma=rng.uniform(0.5, 1.0, c).astype(np.float32))


def _port_dwk(dwk):
    """(7, 7, 1, C) -> the port's (C, 1, 7, 7)."""
    return torch.from_numpy(np.ascontiguousarray(dwk.transpose(3, 2, 0, 1)))


@pytest.fixture(autouse=True)
def _no_launches():
    """A CPU tensor runs the plain version: no kernel is ever launched."""
    build.reset_launches()
    yield
    assert all(v == 0 for v in build.LAUNCHES.values()), build.LAUNCHES


# C = 40 and 96 are not multiples of the TPU kernel's 128 lanes
@pytest.mark.parametrize("c", [40, 96])
def test_fused_dwconv_ln_fp32(c):
    rng = np.random.RandomState(c)
    x = rng.randn(2, 10, 12, c).astype(np.float32)
    p = _block_params(rng, c, 4 * c)
    ref = jax_dwconv_ln(x, p["dwk"], p["dwb"], p["lns"], p["lnb"],
                        interpret=True)
    got = fused_dwconv_ln(torch.from_numpy(x), _port_dwk(p["dwk"]),
                          *(torch.from_numpy(p[k])
                            for k in ("dwb", "lns", "lnb")))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("c", [40, 96])
def test_fused_convnext_block_fp32(c):
    rng = np.random.RandomState(c + 1)
    x = rng.randn(2, 10, 12, c).astype(np.float32)
    p = _block_params(rng, c, 4 * c)
    ref = jax_block(x, *(p[k] for k in ("dwk", "dwb", "lns", "lnb", "w1",
                                        "b1", "w2", "b2", "gamma")),
                    interpret=True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = fused_convnext_block(torch.from_numpy(x), _port_dwk(p["dwk"]),
                               t["dwb"], t["lns"], t["lnb"], t["w1"],
                               t["b1"], t["w2"], t["b2"], t["gamma"])
    assert got.dtype == torch.float32
    # fp32 through two products of depth C and 4C: summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("c", [40, 96, 192])
def test_fused_convnext_block_bf16(c):
    """The contract the fused bf16 FFN kernel keeps: the port's plain
    version against the Pallas kernel at bf16 (LN output, hidden activation
    and output rounded to bf16, tanh GELU, fp32 sums)."""
    rng = np.random.RandomState(c + 3)
    x = rng.randn(2, 10, 12, c).astype(np.float32)
    p = _block_params(rng, c, 4 * c)
    names = ("dwk", "dwb", "lns", "lnb", "w1", "b1", "w2", "b2", "gamma")
    j = {k: jnp.asarray(p[k], jnp.bfloat16) for k in names}
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_block(jx, *(j[k] for k in names), interpret=True),
                     np.float32)
    t = {k: torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16)
         for k, v in j.items()}
    got = fused_convnext_block(
        torch.from_numpy(np.array(jx, np.float32)).to(torch.bfloat16),
        t["dwk"].permute(3, 2, 0, 1).contiguous(), t["dwb"], t["lns"],
        t["lnb"], t["w1"], t["b1"], t["w2"], t["b2"], t["gamma"])
    assert got.dtype == torch.bfloat16
    # the two round the same fp32 values to bf16 three times (LN output,
    # hidden, output) after sums taken in other orders: a value may land
    # on the neighbouring bf16 step, and a hidden step moves the output by
    # ~2^-8 of its scale: 2^-6 of the output scale, as the other bf16 rows
    tol = 2 ** -6 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("c", [40, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layernorm(c, dtype):
    rng = np.random.RandomState(c + 2)
    x = (rng.randn(3, 7, 5, c) * 2 + 0.5).astype(np.float32)
    s = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    jx, js, jb = (jnp.asarray(v, dtype) for v in (x, s, b))
    ref = np.asarray(jax_layernorm(jx, js, jb, interpret=True), np.float32)
    tx, ts, tb = (torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, dtype)) for v in (jx, js, jb))
    got = fused_layernorm(tx, ts, tb)
    assert str(got.dtype)[6:] == dtype
    # bf16: both round one fp32 value; it may land on either neighbour
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_grouped(dtype):
    _check_moe_ffn_grouped(dtype, [0, 0, 1, 1, 1, 2])


# expert 1 owns no tile; one expert owns every tile
@pytest.mark.parametrize("te", [[0, 0, 2, 2], [1, 1, 1]],
                         ids=["idle", "single"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_grouped_tile_experts(dtype, te):
    _check_moe_ffn_grouped(dtype, te)


def _check_moe_ffn_grouped(dtype, tile_expert):
    rng = np.random.RandomState(3)
    e, d, h, tile = 3, 96, 160, 128
    te = np.array(tile_expert, np.int32)
    s = tile * len(te)
    arrs = dict(x=rng.randn(s, d), w1=rng.randn(e, d, h) / np.sqrt(d),
                b1=rng.randn(e, h) * 0.1, w2=rng.randn(e, h, d) / np.sqrt(h),
                b2=rng.randn(e, d) * 0.1)
    j = {k: jnp.asarray(v, dtype) for k, v in arrs.items()}
    ref = jax_moe_ffn(j["x"], jnp.asarray(te), j["w1"], j["b1"], j["w2"],
                      j["b2"], interpret=True)
    t = {k: torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, dtype)) for k, v in j.items()}
    got = moe_ffn_grouped(t["x"], torch.from_numpy(te), t["w1"], t["b1"],
                          t["w2"], t["b2"])
    assert str(got.dtype)[6:] == dtype
    ref = np.asarray(ref, np.float32)
    # bf16: the hidden activation and the output may each round to the
    # neighbouring bf16 value (the GELU is evaluated in other steps), 2^-6
    # of the output scale
    tol = 1e-5 if dtype == "float32" else 2 ** -6 * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("n,m", [(150, 270), (260, 260)])
@pytest.mark.parametrize("triu", [False, True])
def test_hbb_iou(n, m, triu):
    rng = np.random.RandomState(n + m)

    def rand(k):
        xy = rng.uniform(0, 300, (k, 2))
        return np.concatenate([xy, xy + rng.uniform(1, 80, (k, 2))],
                              -1).astype(np.float32)
    b1 = rand(n)
    b2 = b1 if n == m else rand(m)
    ref = np.asarray(hbb_iou_pallas(b1, b2, triu=triu, interpret=True))
    got = hbb_iou(torch.from_numpy(b1), torch.from_numpy(b2), triu=triu)
    assert got.shape == (n, m)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    batched = hbb_iou(torch.from_numpy(np.stack([b1, b1])),
                      torch.from_numpy(np.stack([b2, b2])), triu=triu)
    assert torch.equal(batched[1], got)


def test_wrappers_reject_other_devices():
    x = torch.empty(1, 4, 4, 8, device="meta")
    v = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_dwconv_ln(x, torch.empty(8, 1, 7, 7, device="meta"), v, v, v)
    with pytest.raises(ValueError, match="unsupported device"):
        hbb_iou(torch.empty(3, 4, device="meta"),
                torch.empty(3, 4, device="meta"))
