"""ConvNeXt kernels: ``fused_dwconv_ln``, ``fused_convnext_block`` and
``fused_layernorm``, each a CUDA path (``csrc/dwconv_ln.cu``,
``csrc/grouped_ffn.cu``, ``csrc/layernorm.cu``) and a plain PyTorch version.

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

import torch
import torch.nn.functional as F

from ...models.layers import gelu
from . import build
from .moe_groupgemm_kernel import EPI_GELU, EPI_RESIDUAL, grouped_gemm

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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
    out_dtype = _ln_dtype(x, scale, bias)
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused_layernorm: unsupported dtypes {x.dtype} -> "
                         f"{out_dtype}")
    c = x.shape[-1]
    if c > 1024:
        raise ValueError(f"fused_layernorm: C={c} > 1024")
    for t, name in ((scale, "scale"), (bias, "bias")):
        build.require_cuda(t, name, x.device)
    x = x.contiguous()
    s, b = (v.float().contiguous() for v in (scale, bias))
    out = torch.empty(x.shape, device=x.device, dtype=out_dtype)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    rc = lib.sm3det_layernorm(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
        x.numel() // c, c, int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), eps, build.stream_ptr(x.device))
    build.check(rc, "fused_layernorm")
    build.LAUNCHES["fused_layernorm"] += 1
    return out


def dwconv_ln_ref(x, dwk, dwb, lns, lnb, eps: float = 1e-6,
                  out_dtype=None):
    """Plain version of ``fused_dwconv_ln`` (fp32 conv and statistics)."""
    out_dtype = out_dtype or _ln_dtype(x, lns, lnb)
    c = x.shape[-1]
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), dwk.float(), dwb.float(),
                   padding=3, groups=c).permute(0, 2, 3, 1)
    mean = acc.mean(-1, keepdim=True)
    var = torch.clamp((acc * acc).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (acc - mean) * torch.rsqrt(var + eps)
    y = y * lns.float() + lnb.float()
    return y.to(out_dtype)


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


def _dwconv_ln_launch(x, dwk, dwb, lns, lnb, eps, out_dtype):
    build.require_cuda(x, "x")
    if x.dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"dwconv_ln: unsupported dtypes {x.dtype} -> "
                         f"{out_dtype}")
    b, h, w, c = x.shape
    if dwk.shape != (c, 1, 7, 7) or c > 1024:
        raise ValueError(f"dwconv_ln: dwk {tuple(dwk.shape)} for C={c} "
                         f"(C <= 1024)")
    for t, name in ((dwk, "dwk"), (dwb, "dwb"), (lns, "lns"), (lnb, "lnb")):
        build.require_cuda(t, name, x.device)
    x = x.contiguous()
    vecs = [v.float().reshape(-1).contiguous() for v in (dwk, dwb, lns, lnb)]
    out = torch.empty((b, h, w, c), device=x.device, dtype=out_dtype)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    rc = lib.sm3det_dwconv_ln(
        x.data_ptr(), *[v.data_ptr() for v in vecs], out.data_ptr(),
        b, h, w, c, int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), eps, build.stream_ptr(x.device))
    build.check(rc, "dwconv_ln")
    build.LAUNCHES["dwconv_ln"] += 1
    return out


def fused_dwconv_ln(x, dwk, dwb, lns, lnb, eps: float = 1e-6):
    """``LN(dw7x7(x))`` on NHWC ``x``: the dense prefix of a MoE block.

    A CUDA tensor goes through the kernel, a CPU tensor through
    :func:`dwconv_ln_ref`.
    """
    out_dtype = _ln_dtype(x, lns, lnb)
    if x.is_cuda:
        return _dwconv_ln_launch(x, dwk, dwb, lns, lnb, eps, out_dtype)
    if x.device.type == "cpu":
        return dwconv_ln_ref(x, dwk, dwb, lns, lnb, eps, out_dtype)
    raise ValueError(f"fused_dwconv_ln: unsupported device {x.device}")


def fused_convnext_block(x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma,
                         eps: float = 1e-6):
    """Whole dense ConvNeXt block:
    ``x + gamma * fc2(gelu(fc1(LN(dw7x7(x)))))``.

    On a CUDA tensor: one ``dwconv_ln`` launch, then the grouped GEMM with
    one expert twice (GELU epilogue, then the layer-scale and residual
    epilogue). On a CPU tensor: :func:`convnext_block_ref`.
    """
    if x.device.type == "cpu":
        return convnext_block_ref(x, dwk, dwb, lns, lnb, w1, b1, w2, b2,
                                  gamma, eps)
    if not x.is_cuda:
        raise ValueError(f"fused_convnext_block: unsupported device "
                         f"{x.device}")
    dt = x.dtype
    out_dtype = torch.promote_types(torch.promote_types(dt, w2.dtype),
                                    gamma.dtype)
    if out_dtype != dt:
        raise ValueError(f"fused_convnext_block: the kernel writes {dt}, "
                         f"but x, w2, gamma promote to {out_dtype}")
    b, h, w, c = x.shape
    xn = _dwconv_ln_launch(x, dwk, dwb, lns, lnb, eps, dt)
    hid = grouped_gemm(xn.reshape(-1, c), w1.to(dt)[None], b1, EPI_GELU)
    out = grouped_gemm(hid, w2.to(dt)[None], b2, EPI_RESIDUAL,
                       shortcut=x.reshape(-1, c), gamma=gamma)
    build.LAUNCHES["fused_convnext_block"] += 1
    return out.reshape(b, h, w, c)
