"""ConvNeXt-L's and -XL's widest stages (C = 1536, 2048) in the PyTorch
port against the JAX package, on the CPU.

The port's LayerNorm and dw7x7 + LN kernels take every C up to 2048 on the
card; on the host their wrappers run the plain versions, which these tests
hold against JAX at those widths on tiny images (a few pixels): the
LayerNorm of ``LayerNormOpt`` and of the Pallas ``fused_layernorm``
(interpret mode), the dw7x7 + LN prefix, and one ConvNeXt block, dense and
MoE, whose flax params go through ``convert_tree`` into the port. Inputs
come from numpy with a seed. Tolerances: fp32 1e-4 absolute and relative
(summation order over up to 2048 channels and a 4C-wide hidden layer);
bf16 one rounding step of the output (2^-7 relative, 2^-6 absolute for
|y| up to ~4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.models.backbones import convnext as jconvnext
from sm3det_tpu.ops.pallas.convnext_block_kernel import (
    fused_dwconv_ln as jax_dwconv_ln, fused_layernorm as jax_layernorm)
from sm3det_tpu_torch.convert import convert_tree
from sm3det_tpu_torch.models.backbones import convnext
from sm3det_tpu_torch.ops.cuda import build
from sm3det_tpu_torch.ops.cuda.convnext_block_kernel import (
    MAX_CHANNELS, fused_dwconv_ln, fused_layernorm)
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)

WIDE = [1536, 2048]
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = dict(rtol=2 ** -7, atol=2 ** -6)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors run the plain versions: no kernel is launched."""
    build.reset_launches()
    yield
    assert all(v == 0 for v in build.LAUNCHES.values()), build.LAUNCHES


def _ln_inputs(seed, c):
    rng = np.random.RandomState(seed)
    return ((rng.randn(1, 6, 6, c) * 3 + 1).astype(np.float32),
            (1 + 0.1 * rng.randn(c)).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32))


def test_wide_stages_are_within_the_kernels_reach():
    widest = max(max(a["channels"]) for a in convnext.ARCH_SETTINGS.values())
    assert widest == MAX_CHANNELS == 2048
    assert convnext.ARCH_SETTINGS["large"]["channels"][-1] == 1536


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", WIDE)
def test_layernorm_opt(c, dtype):
    """``LayerNormOpt`` (through ``fused_layernorm``) against the JAX
    module's ``layernorm_math``, and the Pallas ``fused_layernorm``."""
    x, s, b = _ln_inputs(c, c)
    jt = getattr(jnp, dtype)
    ref = jconvnext.layernorm_math(jnp.asarray(x, jt), jnp.asarray(s, jt),
                                   jnp.asarray(b, jt))
    ref_pallas = jax_layernorm(jnp.asarray(x, jt), jnp.asarray(s, jt),
                               jnp.asarray(b, jt), interpret=True)
    tt = getattr(torch, dtype)
    ln = convnext.LayerNormOpt(c).to(tt)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(s))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(torch.from_numpy(x).to(tt))
    assert str(got.dtype)[6:] == str(ref.dtype) == str(ref_pallas.dtype)
    tol = TOL if dtype == "float32" else TOL_BF16
    for r in (ref, ref_pallas):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(r, np.float32), **tol)


@pytest.mark.parametrize("c", WIDE)
def test_fused_dwconv_ln(c):
    rng = np.random.RandomState(c + 1)
    x = rng.randn(1, 5, 6, c).astype(np.float32)
    dwk = (rng.randn(7, 7, 1, c) * 0.15).astype(np.float32)
    dwb, lnb = ((rng.randn(c) * 0.1).astype(np.float32) for _ in range(2))
    lns = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    ref = jax_dwconv_ln(x, dwk, dwb, lns, lnb, interpret=True)
    got = fused_dwconv_ln(
        torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(dwk.transpose(3, 2, 0, 1))),
        *(torch.from_numpy(v) for v in (dwb, lns, lnb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _randomize(params, rng, scale):
    """Seeded noise around each leaf's init (norm scales and the layer
    scale near 1), so that the block is no identity."""
    def f(path, v):
        v = np.asarray(v, np.float32)
        noise = rng.randn(*v.shape).astype(np.float32) * scale
        if path[-1].key in ("scale", "gamma") and v.ndim == 1:
            return 1.0 + noise
        return v + noise
    return jax.tree_util.tree_map_with_path(f, params)


@pytest.mark.parametrize("use_moe", [False, True])
def test_convnext_block_at_1536(use_moe):
    """One ConvNeXt-L stage-3 block, dense and with a 2-expert grid MoE."""
    dim = 1536
    rng = np.random.RandomState(7)
    x = rng.randn(1, 4, 5, dim).astype(np.float32)
    moe_cfg = dict(num_experts=2, top_k=1, gating="cosine",
                   noisy_gating=True) if use_moe else None
    block = jconvnext.ConvNeXtBlock(dim=dim, moe=moe_cfg)
    params = jax.jit(lambda v: block.init(
        {"params": jax.random.PRNGKey(0), "moe_noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, v, train=True))(x)["params"]
    params = _randomize(params, rng, 0.02)
    ref, _ = jax.jit(lambda p, v: block.apply({"params": p}, v))(params, x)
    port = convnext.ConvNeXtBlock(dim, moe=moe_cfg)
    port.load_state_dict(convert_tree(jax.tree.map(np.asarray, params)),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
