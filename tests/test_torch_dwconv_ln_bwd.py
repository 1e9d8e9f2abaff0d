"""The trainable dw7x7 + LN's backward in closed form, on the CPU.

``dwconv_ln_bwd_ref`` (the plain version of the ``dwconv_ln_bwd.cu``
kernels) against ``jax.vjp`` of the JAX package's ``_dwconv_ln_math``,
which its custom VJP differentiates, and against autograd of the port's
``dwconv_ln_ref``. All in fp32; each gradient within 1e-5 of its largest
magnitude (the two sides differ only in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sm3det_tpu.ops.pallas.convnext_block_kernel import _dwconv_ln_math
from sm3det_tpu_torch.ops.cuda import build
from sm3det_tpu_torch.ops.cuda.convnext_block_kernel import (
    dwconv_ln_bwd_ref, dwconv_ln_ref, fused_dwconv_ln_train)
from torch_jax_refs import (jax_refs_at_lowest_level,  # noqa: F401
                            one_torch_thread)

EPS = 1e-6
CASES = [(16, 16, 96), (16, 16, 36), (9, 13, 96), (9, 13, 36)]
NAMES = ("dx", "ddwk", "ddwb", "dlns", "dlnb")
# the clamp case's channels: a power of two, so that the channel mean of
# 0.5 is exact whether a framework divides by C or multiplies by 1/C, and
# the fast variance is exactly 0 in both
CLAMP_C = 64


@jax.jit
def _jax_vjp(x, dwk, dwb, lns, lnb, g):
    _, vjp = jax.vjp(lambda *a: _dwconv_ln_math(*a, EPS, jnp.float32),
                     x, dwk, dwb, lns, lnb)
    return vjp(g)


def _inputs(h, w, c, clamp=False):
    """numpy inputs in the JAX layouts (dwk (7, 7, 1, C)). ``clamp``: x = 0
    and the conv bias 0.5 everywhere, so every channel of every pixel is
    0.5 and the variance sits exactly on the clamp."""
    rng = np.random.RandomState(h * 1000 + w * 10 + c)
    x = rng.randn(2, h, w, c).astype(np.float32)
    dwk = (rng.randn(7, 7, 1, c) * 0.15).astype(np.float32)
    dwb = (rng.randn(c) * 0.1).astype(np.float32)
    if clamp:
        x[:] = 0.0
        dwb[:] = 0.5
    lns = (1 + rng.randn(c) * 0.1).astype(np.float32)
    lnb = (rng.randn(c) * 0.1).astype(np.float32)
    g = rng.randn(2, h, w, c).astype(np.float32)
    return x, dwk, dwb, lns, lnb, g


def _port(x, dwk, dwb, lns, lnb, g):
    """The same inputs as torch tensors in the port's layouts."""
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (x, dwk.transpose(3, 2, 0, 1), dwb, lns, lnb, g)]


def _jax_ref(ins):
    grads = [np.asarray(r) for r in _jax_vjp(*map(jnp.asarray, ins))]
    grads[1] = grads[1].transpose(3, 2, 0, 1)
    return grads


@pytest.fixture(scope="module")
def cases():
    out = {}
    for h, w, c in CASES:
        ins = _inputs(h, w, c)
        out[(h, w, c)] = (ins, _jax_ref(ins))
    ins = _inputs(9, 13, CLAMP_C, clamp=True)
    out["clamp"] = (ins, _jax_ref(ins))
    return out


def _assert_close(got, ref):
    for name, a, b in zip(NAMES, got, ref):
        a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max()
        assert err <= 1e-5 * max(np.abs(b).max(), 1e-30), (name, err)


@pytest.mark.parametrize("key", CASES + ["clamp"],
                         ids=[f"{h}x{w}-c{c}" for h, w, c in CASES]
                         + ["clamp"])
def test_closed_form_matches_jax_vjp(cases, key):
    ins, ref = cases[key]
    got = dwconv_ln_bwd_ref(*_port(*ins), EPS)
    assert all(t.dtype == torch.float32 for t in got)
    _assert_close(got, ref)


def test_clamp_case_sits_on_the_clamp(cases):
    """x = 0, dwb = 0.5: a = 0.5 at every channel, so the fast variance is
    exactly 0, r = eps^-1/2, and the input gradient, r (gh - mean gh)
    through the taps, is large but finite."""
    ins, ref = cases["clamp"]
    x, dwk, dwb, lns, lnb, g = _port(*ins)
    a = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), dwk, dwb, padding=3, groups=x.shape[-1])
    assert bool((a == 0.5).all())
    v_raw = (a * a).mean(1) - a.mean(1) ** 2
    assert bool((v_raw == 0).all())
    assert np.isfinite(ref[0]).all() and np.abs(ref[0]).max() > 100


@pytest.mark.parametrize("key", CASES,
                         ids=[f"{h}x{w}-c{c}" for h, w, c in CASES])
def test_closed_form_matches_autograd(cases, key):
    """Off the clamp the closed form is autograd of dwconv_ln_ref."""
    ins, _ = cases[key]
    x, dwk, dwb, lns, lnb, g = _port(*ins)
    leaves = [t.clone().requires_grad_(True) for t in (x, dwk, dwb, lns,
                                                        lnb)]
    ref = torch.autograd.grad(dwconv_ln_ref(*leaves, EPS), leaves, g)
    _assert_close(dwconv_ln_bwd_ref(x, dwk, dwb, lns, lnb, g, EPS), ref)


def test_train_backward_on_the_host_is_the_closed_form(cases):
    """fused_dwconv_ln_train's CPU backward is dwconv_ln_bwd_ref, launches
    no kernel, and leaves None for inputs that need no gradient."""
    ins, ref = cases[(9, 13, 36)]
    x, dwk, dwb, lns, lnb, g = _port(*ins)
    build.reset_launches()
    leaves = [x, dwk.clone().requires_grad_(True), dwb,
              lns.clone().requires_grad_(True), lnb]
    out = fused_dwconv_ln_train(*leaves, EPS)
    out.backward(g)
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert x.grad is None and dwb.grad is None and lnb.grad is None
    want = dwconv_ln_bwd_ref(x, dwk, dwb, lns, lnb, g, EPS)
    assert torch.equal(leaves[1].grad, want[1])
    assert torch.equal(leaves[3].grad, want[3])
    _assert_close([want[0], leaves[1].grad, want[2], leaves[3].grad,
                   want[4]], ref)
