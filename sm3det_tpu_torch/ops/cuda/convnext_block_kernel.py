"""ConvNeXt kernels: ``fused_dwconv_ln``, ``fused_convnext_block``,
``convnext_ffn`` (the block's MLP alone, for the Domain-Attention blocks)
and ``fused_layernorm``, each a CUDA path (``csrc/dwconv_ln.cu``; its MLP
``csrc/ffn_wgmma.cu`` in bf16, ``csrc/grouped_ffn.cu`` in fp32;
``csrc/layernorm.cu``) and a plain PyTorch version,
and ``fused_dwconv_ln_train``, the trainable dw7x7 + LN, whose backward is
``csrc/dwconv_ln_bwd.cu`` on the card and :func:`dwconv_ln_bwd_ref` on the
host.

The three inference kernels have no backward: on the card their wrappers
raise when grad mode is on and an input requires grad.

Counterpart of ``sm3det_tpu/ops/pallas/convnext_block_kernel.py``, with the
contract of its ``_make_block_kernel``:

- the 7x7 depthwise conv accumulates in fp32 (zero padding 3) and the LN
  statistics come from the unrounded fp32 accumulator, with the variance
  ``max(E[x^2] - mean^2, 0)`` and eps 1e-6. That is not ``F.layer_norm``,
  whose two-pass variance differs;
- ``fused_dwconv_ln`` returns ``result_type(x, ln_scale, ln_bias)``;
- ``fused_convnext_block`` rounds the LN output to the compute dtype
  (``x.dtype``), computes ``h = gelu(round(xn @ w1 + b1))`` and
  ``out = shortcut + gamma * (h @ w2 + b2)`` summed in fp32 and rounded
  once to ``result_type(x, w2, gamma)``;
- ``fused_layernorm`` is ``layernorm_math``: the trailing-axis LayerNorm
  of ``flax.linen.LayerNorm`` with the same fast variance.

Parameter layouts are the port's: ``dwk`` (C, 1, 7, 7), ``w1`` (C, 4C) and
``w2`` (4C, C) in the JAX (in, out) layout the GEMM kernel reads.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ...models.layers import gelu
from . import build
from .moe_groupgemm_kernel import (EPI_BIAS, EPI_GELU, EPI_RESIDUAL,
                                   ffn_fused, ffn_ref, grouped_gemm)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the widest C the LayerNorm and dw7x7 + LN kernels take, ConvNeXt-XL's
# last stage: the user-facing check of ``dwcore::MAX_CHANNELS``
# (``csrc/dwconv_core.cuh``), which both kernels' C entries enforce
MAX_CHANNELS = 2048


def _ln_dtype(x, lns, lnb):
    return torch.promote_types(torch.promote_types(x.dtype, lns.dtype),
                               lnb.dtype)


def layernorm_math(x, scale, bias, eps: float = 1e-6):
    """Trailing-axis LayerNorm as ``flax.linen.LayerNorm`` computes it: fp32
    statistics with the fast variance ``max(E[x^2] - mean^2, 0)``, output in
    the promoted dtype of x, scale and bias. The plain version of
    :func:`fused_layernorm`."""
    xf = x.to(torch.promote_types(torch.float32, x.dtype))
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (x - mean) * (torch.rsqrt(var + eps) * scale) + bias
    return y.to(_ln_dtype(x, scale, bias))


def fused_layernorm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm over the trailing axis: the kernel on a CUDA tensor,
    :func:`layernorm_math` on a CPU tensor."""
    if x.device.type == "cpu":
        return layernorm_math(x, scale, bias, eps)
    if not x.is_cuda:
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    build.forbid_grad("fused_layernorm", x, scale, bias)
    out_dtype = _ln_dtype(x, scale, bias)
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused_layernorm: unsupported dtypes {x.dtype} -> "
                         f"{out_dtype}")
    c = x.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"fused_layernorm: C={c} > {MAX_CHANNELS}")
    for t, name in ((scale, "scale"), (bias, "bias")):
        build.require_cuda(t, name, x.device)
        if t.dtype not in _KERNEL_DTYPES or t.shape != (c,):
            raise ValueError(f"fused_layernorm: {name} {t.dtype} "
                             f"{tuple(t.shape)} for C={c}")
    x = _aligned(x)
    # the kernel reads scale and bias in their own dtype: no per-call copy
    s, b = scale.contiguous(), bias.contiguous()
    out = torch.empty(x.shape, device=x.device, dtype=out_dtype)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    rc = lib.sm3det_layernorm(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
        x.numel() // c, c, int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16),
        int(s.dtype == torch.bfloat16) | 2 * int(b.dtype == torch.bfloat16),
        eps, build.stream_ptr(x.device))
    build.check(rc, "fused_layernorm")
    build.LAUNCHES["fused_layernorm"] += 1
    return out


def dwconv_ln_ref(x, dwk, dwb, lns, lnb, eps: float = 1e-6,
                  out_dtype=None):
    """Plain version of ``fused_dwconv_ln`` (fp32 conv and statistics),
    and of the trainable version's forward; :func:`dwconv_ln_bwd_ref` is
    the plain version of its backward. The conv runs on a contiguous NCHW
    copy, which cuDNN serves faster than the channels-last view."""
    out_dtype = out_dtype or _ln_dtype(x, lns, lnb)
    c = x.shape[-1]
    acc = F.conv2d(x.float().permute(0, 3, 1, 2).contiguous(), dwk.float(),
                   dwb.float(), padding=3, groups=c).permute(0, 2, 3, 1)
    mean = acc.mean(-1, keepdim=True)
    var = torch.clamp((acc * acc).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (acc - mean) * torch.rsqrt(var + eps)
    y = y * lns.float() + lnb.float()
    return y.to(out_dtype)


def dwconv_ln_bwd_ref(x, dwk, dwb, lns, lnb, g, eps: float = 1e-6):
    """The VJP of :func:`dwconv_ln_ref` in closed form, all in fp32, with
    no autograd: the plain version of the ``dwconv_ln_bwd.cu`` kernels.
    Returns ``(dx, ddwk, ddwb, dlns, dlnb)`` in their inputs' dtypes.

    Per pixel p and channel c, with ``a = dw7x7(x) + dwb``, ``d = a - mean_c
    a``, ``v_raw = mean_c a^2 - (mean_c a)^2``, ``r = (max(v_raw, 0) +
    eps)^-1/2`` and ``gh = g * lns``::

        dlnb = sum_p g        dlns = sum_p g * d * r
        da = r * (gh - mean_c gh) - m * r^3 * mean_c(gh * d) * d
        ddwb = sum_p da       ddwk[c, i, j] = sum_p da[p, c] x[p + (i-3, j-3), c]
        dx[q, c] = sum_ij da[q - (i-3, j-3), c] * dwk[c, i, j]

    ``m`` is the gradient of the clamp ``max(v_raw, 0)``: 1 above 0, 0
    below, and 1/2 at 0, as ``jnp.maximum`` gives it in the JAX VJP (where
    ``torch.clamp``'s autograd would give 1).
    """
    out_dtype = _ln_dtype(x, lns, lnb)
    b, h, w, c = x.shape
    xf = x.float()
    k = dwk.float().reshape(c, 7, 7)
    a = F.conv2d(xf.permute(0, 3, 1, 2).contiguous(), dwk.float(),
                 dwb.float(), padding=3, groups=c).permute(0, 2, 3, 1)
    mean = a.mean(-1, keepdim=True)
    v_raw = (a * a).mean(-1, keepdim=True) - mean * mean
    r = torch.rsqrt(torch.clamp(v_raw, min=0.0) + eps)
    m = (v_raw > 0).float() + 0.5 * (v_raw == 0).float()
    gf = g.to(out_dtype).float()
    d = a - mean
    dlnb = gf.sum((0, 1, 2))
    dlns = (gf * d * r).sum((0, 1, 2))
    gh = gf * lns.float()
    da = r * (gh - gh.mean(-1, keepdim=True)) \
        - m * r ** 3 * (gh * d).mean(-1, keepdim=True) * d
    ddwb = da.sum((0, 1, 2))
    xp = F.pad(xf, (0, 0, 3, 3, 3, 3))
    dap = F.pad(da, (0, 0, 3, 3, 3, 3))
    ddwk = torch.empty(c, 7, 7, dtype=torch.float32, device=x.device)
    dx = torch.zeros_like(xf)
    for i in range(7):
        for j in range(7):
            ddwk[:, i, j] = (da * xp[:, i:i + h, j:j + w]).sum((0, 1, 2))
            dx += dap[:, 6 - i:6 - i + h, 6 - j:6 - j + w] * k[:, i, j]
    return (dx.to(x.dtype), ddwk.reshape(dwk.shape).to(dwk.dtype),
            ddwb.to(dwb.dtype), dlns.to(lns.dtype), dlnb.to(lnb.dtype))


def convnext_block_ref(x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma,
                       eps: float = 1e-6):
    """Plain version of ``fused_convnext_block``."""
    out_dtype = torch.promote_types(torch.promote_types(x.dtype, w2.dtype),
                                    gamma.dtype)
    b, h, w, c = x.shape
    xn = dwconv_ln_ref(x, dwk, dwb, lns, lnb, eps, out_dtype=x.dtype)
    hid = xn.reshape(-1, c).float() @ w1.float() + b1.float()
    hid = gelu(hid.to(x.dtype))
    y = hid.float() @ w2.float() + b2.float()
    y = x.float() + gamma.float() * y.reshape(b, h, w, c)
    return y.to(out_dtype)


def _check_dwconv_args(x, dwk, dwb, lns, lnb, out_dtype):
    build.require_cuda(x, "x")
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"dwconv_ln: unsupported dtypes {x.dtype} -> "
                         f"{out_dtype}")
    c = x.shape[-1]
    if dwk.shape != (c, 1, 7, 7) or c > MAX_CHANNELS:
        raise ValueError(f"dwconv_ln: dwk {tuple(dwk.shape)} for C={c} "
                         f"(C <= {MAX_CHANNELS})")
    for t, name in ((dwk, "dwk"), (dwb, "dwb"), (lns, "lns"), (lnb, "lnb")):
        build.require_cuda(t, name, x.device)


def _aligned(t):
    """Contiguous, and at a 16-byte address (the kernels copy 16 bytes at
    a time where the row allows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _taps(dwk):
    """(C, 1, 7, 7) -> fp32 (49, C): a tap's channels side by side."""
    return dwk.float().reshape(dwk.shape[0], 49).t().contiguous()


def _dwconv_ln_launch(x, dwk, dwb, lns, lnb, eps, out_dtype,
                      counter="dwconv_ln"):
    _check_dwconv_args(x, dwk, dwb, lns, lnb, out_dtype)
    b, h, w, c = x.shape
    x = _aligned(x)
    vecs = [_taps(dwk)] + [v.float().contiguous() for v in (dwb, lns, lnb)]
    out = torch.empty((b, h, w, c), device=x.device, dtype=out_dtype)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    rc = lib.sm3det_dwconv_ln(
        x.data_ptr(), *[v.data_ptr() for v in vecs], out.data_ptr(),
        b, h, w, c, int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), eps, build.stream_ptr(x.device))
    build.check(rc, "dwconv_ln")
    build.LAUNCHES[counter] += 1
    return out


# the backward kernels' pixel tile and channel chunk (``dwconv_core.cuh``)
# and the resident blocks an SM they are sized for
_TILE_H, _TILE_W, _CHUNK = 4, 16, 32
_STATS_BLOCKS_PER_SM, _CONV_BLOCKS_PER_SM = 4, 4


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_grid(b, h, w, c, device):
    """Rows of the two persistent backward kernels' partials: the stats
    kernel's clusters (at most one a tile, and no more than the card holds
    at once: the kernel picks how many it uses) and the conv kernel's tile
    groups (each runs once per channel chunk). Fixed for a card and a
    shape, so the fixed-order sums of the partials give the same bits on
    every run."""
    sms = _sm_count(device.index if device.index is not None
                    else torch.cuda.current_device())
    tiles = b * -(-h // _TILE_H) * -(-w // _TILE_W)
    chunks = -(-c // _CHUNK)
    n_stats = max(1, min(tiles, _STATS_BLOCKS_PER_SM * sms))
    n_groups = max(1, min(tiles, _CONV_BLOCKS_PER_SM * sms // chunks))
    return n_stats, n_groups


def _dwconv_ln_bwd_launch(x, dwk, dwb, lns, lnb, g, eps):
    """The three backward kernels of ``dwconv_ln_bwd.cu``: recompute + LN
    backward into an fp32 ``da``, then the depthwise dgrad and wgrad, then
    the fixed-order sum of the per-block partials. One count of
    ``fused_dwconv_ln_train_bwd``."""
    out_dtype = _ln_dtype(x, lns, lnb)
    _check_dwconv_args(x, dwk, dwb, lns, lnb, out_dtype)
    pdt = {dwk.dtype, dwb.dtype, lns.dtype, lnb.dtype}
    if not pdt <= set(_KERNEL_DTYPES):
        raise ValueError(f"dwconv_ln_bwd: unsupported parameter dtypes {pdt}")
    b, h, w, c = x.shape
    x = _aligned(x)
    g = _aligned(g.to(out_dtype))
    taps = _taps(dwk)
    dwb32, lns32 = dwb.float().contiguous(), lns.float().contiguous()
    dev = x.device
    grads = (torch.empty_like(x), torch.empty(dwk.shape, device=dev,
                                              dtype=dwk.dtype),
             torch.empty(c, device=dev, dtype=dwb.dtype),
             torch.empty(c, device=dev, dtype=lns.dtype),
             torch.empty(c, device=dev, dtype=lnb.dtype))
    if x.numel() == 0:
        return tuple(t.zero_() for t in grads)
    n_stats, n_groups = _bwd_grid(b, h, w, c, dev)
    da = torch.empty(x.shape, device=dev, dtype=torch.float32)
    part_a = torch.empty((n_stats, 2, c), device=dev, dtype=torch.float32)
    part_b = torch.empty((n_groups, 50, c), device=dev, dtype=torch.float32)
    bf16_mask = sum(1 << i for i, t in enumerate(grads[1:])
                    if t.dtype == torch.bfloat16)
    lib = build.load_library()
    rc = lib.sm3det_dwconv_ln_bwd(
        x.data_ptr(), taps.data_ptr(), dwb32.data_ptr(), lns32.data_ptr(),
        g.data_ptr(), da.data_ptr(), part_a.data_ptr(), n_stats,
        part_b.data_ptr(), n_groups, *[t.data_ptr() for t in grads],
        b, h, w, c, int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), bf16_mask, eps,
        build.stream_ptr(dev))
    build.check(rc, "dwconv_ln_bwd")
    build.LAUNCHES["fused_dwconv_ln_train_bwd"] += 1
    return grads


def fused_dwconv_ln(x, dwk, dwb, lns, lnb, eps: float = 1e-6):
    """``LN(dw7x7(x))`` on NHWC ``x``: the dense prefix of a MoE block.

    A CUDA tensor goes through the kernel, a CPU tensor through
    :func:`dwconv_ln_ref`.
    """
    out_dtype = _ln_dtype(x, lns, lnb)
    if x.is_cuda:
        build.forbid_grad("fused_dwconv_ln", x, dwk, dwb, lns, lnb)
        return _dwconv_ln_launch(x, dwk, dwb, lns, lnb, eps, out_dtype)
    if x.device.type == "cpu":
        return dwconv_ln_ref(x, dwk, dwb, lns, lnb, eps, out_dtype)
    raise ValueError(f"fused_dwconv_ln: unsupported device {x.device}")


class _DwconvLnTrain(torch.autograd.Function):
    """Counterpart of the custom VJP ``fused_dwconv_ln_train``
    (``sm3det_tpu/ops/pallas/convnext_block_kernel.py:345``); only the
    inputs are saved, as there. On the card, forward ``dwconv_ln.cu`` and
    backward the ``dwconv_ln_bwd.cu`` kernels; on the host,
    :func:`dwconv_ln_ref` and :func:`dwconv_ln_bwd_ref`."""

    @staticmethod
    def forward(ctx, x, dwk, dwb, lns, lnb, eps):
        ctx.save_for_backward(x, dwk, dwb, lns, lnb)
        ctx.eps = eps
        out_dtype = _ln_dtype(x, lns, lnb)
        if x.is_cuda:
            return _dwconv_ln_launch(x, dwk, dwb, lns, lnb, eps, out_dtype,
                                     counter="fused_dwconv_ln_train")
        return dwconv_ln_ref(x, dwk, dwb, lns, lnb, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if saved[0].is_cuda:
            grads = _dwconv_ln_bwd_launch(*saved, g, ctx.eps)
        else:
            grads = dwconv_ln_bwd_ref(*saved, g, ctx.eps)
        return (*[t if n else None
                  for t, n in zip(grads, ctx.needs_input_grad[:5])], None)


def fused_dwconv_ln_train(x, dwk, dwb, lns, lnb, eps: float = 1e-6):
    """Trainable ``LN(dw7x7(x))``: on a CUDA tensor the ``dwconv_ln.cu``
    kernel forward (counted as ``fused_dwconv_ln_train``) and the
    ``dwconv_ln_bwd.cu`` kernels backward (``fused_dwconv_ln_train_bwd``);
    on a CPU tensor the plain versions of both."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_dwconv_ln_train: unsupported device "
                         f"{x.device}")
    return _DwconvLnTrain.apply(x, dwk, dwb, lns, lnb, eps)


def fused_convnext_block(x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma,
                         eps: float = 1e-6):
    """Whole dense ConvNeXt block:
    ``x + gamma * fc2(gelu(fc1(LN(dw7x7(x)))))``.

    On a CUDA tensor: one ``dwconv_ln`` launch, then the MLP: in bf16 one
    launch of the fused FFN (:func:`ffn_fused`, one expert, the layer-scale
    and residual epilogue), in fp32 the fp32 grouped GEMM twice (GELU
    epilogue, then the layer-scale and residual epilogue). On a CPU tensor:
    :func:`convnext_block_ref`.
    """
    if x.device.type == "cpu":
        return convnext_block_ref(x, dwk, dwb, lns, lnb, w1, b1, w2, b2,
                                  gamma, eps)
    if not x.is_cuda:
        raise ValueError(f"fused_convnext_block: unsupported device "
                         f"{x.device}")
    build.forbid_grad("fused_convnext_block", x, dwk, dwb, lns, lnb, w1, b1,
                      w2, b2, gamma)
    dt = x.dtype
    out_dtype = torch.promote_types(torch.promote_types(dt, w2.dtype),
                                    gamma.dtype)
    if out_dtype != dt:
        raise ValueError(f"fused_convnext_block: the kernel writes {dt}, "
                         f"but x, w2, gamma promote to {out_dtype}")
    if dt == torch.bfloat16 and w1.dtype != dt:
        # the fused FFN reads the weights as they are: no per-call copy
        raise ValueError(f"fused_convnext_block: bf16 x needs bf16 w1, got "
                         f"{w1.dtype}")
    b, h, w, c = x.shape
    xn = _dwconv_ln_launch(x, dwk, dwb, lns, lnb, eps, dt)
    if dt == torch.bfloat16:
        out = ffn_fused(xn.reshape(-1, c), w1[None], b1, w2[None], b2,
                        shortcut=x.reshape(-1, c), gamma=gamma)
    else:
        hid = grouped_gemm(xn.reshape(-1, c), w1.to(dt)[None], b1, EPI_GELU)
        out = grouped_gemm(hid, w2.to(dt)[None], b2, EPI_RESIDUAL,
                           shortcut=x.reshape(-1, c), gamma=gamma)
    build.LAUNCHES["fused_convnext_block"] += 1
    return out.reshape(b, h, w, c)


def convnext_ffn(x, w1, b1, w2, b2):
    """The dense block's MLP alone, ``fc2(gelu(fc1(x)))`` on (M, C) tokens,
    under the FFN contract of ``fused_convnext_block`` (products summed in
    fp32, GELU at ``x.dtype``, output in ``x.dtype``): the Domain-Attention
    blocks, whose attention sits between the MLP and the layer scale.

    On a CUDA tensor the same FFN kernels as ``fused_convnext_block``: in
    bf16 one launch of :func:`ffn_fused` (one expert, no epilogue), in fp32
    the fp32 grouped GEMM twice (GELU epilogue, then the bias epilogue);
    one count of ``convnext_ffn`` either way. On a CPU tensor
    :func:`ffn_ref`.
    """
    if x.device.type == "cpu":
        return ffn_ref(x, w1, b1, w2, b2)
    if not x.is_cuda:
        raise ValueError(f"convnext_ffn: unsupported device {x.device}")
    build.forbid_grad("convnext_ffn", x, w1, b1, w2, b2)
    dt = x.dtype
    if dt == torch.bfloat16:
        out = ffn_fused(x, w1[None], b1, w2[None], b2)
    else:
        hid = grouped_gemm(x, w1.to(dt)[None], b1, EPI_GELU)
        out = grouped_gemm(hid, w2.to(dt)[None], b2, EPI_BIAS)
    build.LAUNCHES["convnext_ffn"] += 1
    return out
