"""InternViT encoder + ViT-Adapter detection backbone, NHWC.

Port of ``sm3det_tpu/models/backbones/intern_vit.py`` (the BabelRS
backbone, ``configs/BabelRS_configs/BabelRS_20kstep.py``): a patch-embed
stem and a learned position embedding fixed to the token grid of the image
size the model is built for, ``depth`` pre-norm ViT blocks (LayerNorm or
RMSNorm, optional QK-norm and windowed attention, layer scales ``ls1`` /
``ls2``), and the adapter: a conv ``SpatialPriorModule`` making 1/4 to 1/32
priors, and after each interaction block an ``extract{i}`` (the priors
attend into the ViT tokens) and an ``inject{i}`` (the tokens attend into
the priors) multi-scale deformable attention, then the pyramid rebuilt
from the priors. Module and parameter names follow the flax tree.

The attention is ``F.scaled_dot_product_attention`` (JAX's is
``jax.nn.dot_product_attention``, XLA's fused attention), the norms
``F.layer_norm`` / the RMS formula (flax's, eps 1e-6), the deformable
sampling ``ops/ms_deform_attn.py`` (a gather, as in JAX): nothing on this
path is a JAX Pallas kernel. The backbone has no stochastic part, so
``forward_train`` is ``forward``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.ms_deform_attn import ms_deform_attn
from ..layers import Conv2d, Dense, GroupNorm, gelu, trunc_normal_


class RMSNorm(nn.Module):
    """The mean square in fp32, ``x * rsqrt(ms + eps)`` cast back to x's
    dtype, then ``* weight``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = torch.mean(x.float() ** 2, dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


class ViTBlock(nn.Module):
    """Pre-norm block: ``x + ls1 * proj(attn(norm1 x))``, then ``x + ls2 *
    fc2(gelu(fc1(norm2 x)))``; the layer scales start at 0.1."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qk_norm: bool = False, use_rms: bool = False,
                 window: int = 0, gen: torch.Generator | None = None):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.qk_norm = qk_norm
        # flax's LayerNorm(epsilon=1e-6): F.layer_norm keeps its statistics
        # in fp32 for bf16 inputs too
        norm = RMSNorm if use_rms else functools.partial(nn.LayerNorm,
                                                         eps=1e-6)
        self.ls1 = nn.Parameter(torch.full((dim,), 0.1))
        self.ls2 = nn.Parameter(torch.full((dim,), 0.1))
        self.norm1 = norm(dim)
        self.qkv = Dense(dim, 3 * dim, gen)
        if qk_norm:
            self.q_norm = RMSNorm(dim)
            self.k_norm = RMSNorm(dim)
        self.proj = Dense(dim, dim, gen)
        self.norm2 = norm(dim)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Dense(dim, hidden, gen)
        self.fc2 = Dense(hidden, dim, gen)

    def attend(self, qkv):
        """Attention of (BN, N, 3C) qkv rows -> (BN, N, C). QK-norm is an
        RMSNorm over the flattened (N, C) q and k, not per head."""
        bn, n, _ = qkv.shape
        hd = self.dim // self.num_heads
        qkv = qkv.reshape(bn, n, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.qk_norm:
            q = self.q_norm(q.reshape(bn, n, -1)).reshape(q.shape)
            k = self.k_norm(k.reshape(bn, n, -1)).reshape(k.shape)
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return out.transpose(1, 2).reshape(bn, n, -1)

    def attention(self, x, hw: Tuple[int, int]):
        """The attention branch before the layer scale: proj(attn(norm1
        x)). A windowed block pads the token grid to whole windows with
        rows of ``qkv(0)`` (the qkv bias: the padded normed tokens are
        zeros), attends within each window, and crops."""
        b, n, c = x.shape
        h, w = hw
        qkv = self.qkv(self.norm1(x))
        if self.window > 0:
            ws = self.window
            hp = int(np.ceil(h / ws)) * ws
            wp = int(np.ceil(w / ws)) * ws
            img = qkv.reshape(b, h, w, 3 * c)
            if (hp, wp) != (h, w):
                pad_tok = self.qkv(torch.zeros(c, dtype=qkv.dtype,
                                               device=qkv.device))
                img = F.pad(img - pad_tok,
                            (0, 0, 0, wp - w, 0, hp - h)) + pad_tok
            win = img.reshape(b, hp // ws, ws, wp // ws, ws, 3 * c) \
                .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, 3 * c)
            att = self.attend(win).reshape(b, hp // ws, wp // ws, ws, ws, c)
            att = att.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
            att = att[:, :h, :w].reshape(b, n, c)
        else:
            att = self.attend(qkv)
        return self.proj(att)

    def mlp(self, x):
        """fc2(gelu(fc1(norm2 x)))."""
        return self.fc2(gelu(self.fc1(self.norm2(x))))

    def forward(self, x, hw: Tuple[int, int]):
        x = x + self.ls1 * self.attention(x, hw)
        return x + self.ls2 * self.mlp(x)


class SpatialPriorModule(nn.Module):
    """Conv stem -> 1/4, 1/8, 1/16, 1/32 priors, each projected to
    ``out_dim`` by a 1x1 conv; GroupNorm(1) with flax's eps 1e-6."""

    def __init__(self, dim: int = 64, out_dim: int = 256,
                 gen: torch.Generator | None = None):
        super().__init__()
        d = dim
        self.stem1 = Conv2d(3, d, 3, stride=2, padding=1, gen=gen)
        self.gn1 = GroupNorm(1, d)
        self.stem2 = Conv2d(d, d, 3, padding=1, gen=gen)
        self.gn2 = GroupNorm(1, d)
        self.conv2 = Conv2d(d, 2 * d, 3, stride=2, padding=1, gen=gen)
        self.gn3 = GroupNorm(1, 2 * d)
        self.conv3 = Conv2d(2 * d, 4 * d, 3, stride=2, padding=1, gen=gen)
        self.gn4 = GroupNorm(1, 4 * d)
        self.conv4 = Conv2d(4 * d, 4 * d, 3, stride=2, padding=1, gen=gen)
        self.gn5 = GroupNorm(1, 4 * d)
        for i, cin in enumerate((d, 2 * d, 4 * d, 4 * d)):
            setattr(self, f"fc{i + 1}", Conv2d(cin, out_dim, 1, gen=gen))

    def forward(self, x):
        y = F.relu(self.gn1(self.stem1(x)))
        y = F.relu(self.gn2(self.stem2(y)))
        c1 = F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        c2 = F.relu(self.gn3(self.conv2(c1)))
        c3 = F.relu(self.gn4(self.conv3(c2)))
        c4 = F.relu(self.gn5(self.conv4(c3)))
        return (self.fc1(c1), self.fc2(c2), self.fc3(c3), self.fc4(c4))


class DeformAttnModule(nn.Module):
    """MSDeformAttn: query tokens attend into multi-level value maps at
    learned offsets around reference points. ``sampling_offsets`` starts
    at zero; the attention weights are a softmax over L * P; the offsets
    are divided by each level's (w, h)."""

    def __init__(self, dim: int, num_heads: int = 8, num_points: int = 4,
                 num_levels: int = 3, gen: torch.Generator | None = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.num_points, self.num_levels = num_points, num_levels
        self.value_proj = Dense(dim, dim, gen)
        self.sampling_offsets = Dense(dim, num_heads * num_levels
                                      * num_points * 2, gen)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
        self.attention_weights = Dense(dim, num_heads * num_levels
                                       * num_points, gen)
        self.output_proj = Dense(dim, dim, gen)

    def sampling(self, query, ref_points, value, value_shapes):
        """(value (B, S, nh, hd), locations, attention weights): what
        ``ms_deform_attn`` takes."""
        b, q, c = query.shape
        nh, npt, nl = self.num_heads, self.num_points, self.num_levels
        v = self.value_proj(value).reshape(value.shape[0], value.shape[1],
                                           nh, c // nh)
        offsets = self.sampling_offsets(query).reshape(b, q, nh, nl, npt, 2)
        attn = torch.softmax(self.attention_weights(query).reshape(
            b, q, nh, nl * npt), dim=-1).reshape(b, q, nh, nl, npt)
        # each level's offsets over its (w, h), in fp32, by Python numbers:
        # a tensor of the sizes would be a copy to the card every call
        offsets = offsets.float()
        off = torch.stack([torch.stack(
            [offsets[:, :, :, lvl, :, 0] / float(wl),
             offsets[:, :, :, lvl, :, 1] / float(hl)], dim=-1)
            for lvl, (hl, wl) in enumerate(value_shapes)], dim=3)
        loc = ref_points[:, :, None, None, None, :] + off
        return v, loc, attn

    def forward(self, query, ref_points, value, value_shapes):
        """query (B, Q, C); ref_points (B, Q, 2) in [0, 1]; value
        (B, sum HW, C); value_shapes the levels' (H, W)."""
        v, loc, attn = self.sampling(query, ref_points, value, value_shapes)
        return self.output_proj(ms_deform_attn(v, value_shapes, loc, attn))


def _grid(hh: int, ww: int, device):
    """Cell centres of an hh x ww grid, (hh * ww, 2) as (x, y) in [0, 1]."""
    ys = (torch.arange(hh, device=device, dtype=torch.float32) + 0.5) / hh
    xs = (torch.arange(ww, device=device, dtype=torch.float32) + 0.5) / ww
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


class InternViTAdapter(nn.Module):
    """ViT + adapter -> 4-scale features (1/4 to 1/32, ``adapter_dim``
    channels each). ``img_size`` (an int or (H, W)) fixes the position
    embedding's grid, ``(H // patch_size, W // patch_size)``, as JAX's
    tools initialise at the config's ``img_size``: a forward at another
    grid raises ``ValueError``. ``multi_input`` names the stem
    ``stem_single`` (the TriSource detectors), else ``patch_embed``."""

    def __init__(self, img_size, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, patch_size: int = 16,
                 mlp_ratio: float = 4.0, use_rms: bool = False,
                 qk_norm: bool = False, window_blocks: Sequence[int] = (),
                 window_size: int = 14,
                 interaction_indexes: Sequence[int] = (5, 11, 17, 23),
                 adapter_dim: int = 256, multi_input: bool = False,
                 gen: torch.Generator | None = None):
        super().__init__()
        ih, iw = (img_size, img_size) if isinstance(img_size, int) \
            else tuple(img_size)
        self.grid = (ih // patch_size, iw // patch_size)
        self.embed_dim, self.depth = embed_dim, depth
        self.patch_size, self.adapter_dim = patch_size, adapter_dim
        self.interaction_indexes = tuple(interaction_indexes)
        self.stem_name = "stem_single" if multi_input else "patch_embed"
        setattr(self, self.stem_name, Conv2d(3, embed_dim, patch_size,
                                             stride=patch_size, gen=gen))
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, self.grid[0] * self.grid[1], embed_dim), 0.02,
            gen))
        for i in range(depth):
            setattr(self, f"block{i}", ViTBlock(
                embed_dim, num_heads, mlp_ratio, qk_norm=qk_norm,
                use_rms=use_rms,
                window=window_size if i in tuple(window_blocks) else 0,
                gen=gen))
        self.spm = SpatialPriorModule(out_dim=adapter_dim, gen=gen)
        self.vit_proj = Dense(embed_dim, adapter_dim, gen)
        self.vit_unproj = Dense(adapter_dim, embed_dim, gen)
        for i in range(len(self.interaction_indexes)):
            setattr(self, f"extract{i}", DeformAttnModule(
                adapter_dim, num_levels=1, gen=gen))
            setattr(self, f"inject{i}", DeformAttnModule(
                adapter_dim, num_levels=3, gen=gen))

    def stem_tokens(self, x):
        """Patch embed + position embedding: ((B, h * w, C), h, w)."""
        b, ih, iw, _ = x.shape
        tokens = getattr(self, self.stem_name)(x)
        h, w = tokens.shape[1:3]
        if (h, w) != self.grid:
            raise ValueError(
                f"InternViTAdapter: a {ih}x{iw} image makes a {h}x{w} token "
                f"grid; the position embedding was built for the "
                f"{self.grid[0]}x{self.grid[1]} grid of the model's "
                f"img_size")
        return tokens.reshape(b, h * w, self.embed_dim) + self.pos_embed, h, w

    def forward(self, x, dataset_ids=None, encoder_only: bool = False):
        """x (B, H, W, 3) -> (f1, s2, s3, s4), NHWC; ``encoder_only``
        returns the ViT tokens (B, h * w, C) after every block, without the
        adapter. ``dataset_ids`` is taken and unused (no DA block)."""
        b = x.shape[0]
        tokens, h, w = self.stem_tokens(x)
        if encoder_only:
            for i in range(self.depth):
                tokens = getattr(self, f"block{i}")(tokens, (h, w))
            return tokens

        c1, c2, c3, c4 = self.spm(x)
        shapes = [tuple(c.shape[1:3]) for c in (c2, c3, c4)]
        spatial = torch.cat([c.reshape(b, -1, self.adapter_dim)
                             for c in (c2, c3, c4)], dim=1)
        vit_ref = _grid(h, w, x.device)[None].expand(b, -1, -1)
        spa_ref = torch.cat([_grid(hh, ww, x.device) for hh, ww in shapes],
                            0)[None].expand(b, -1, -1)

        idx = 0
        inter = self.interaction_indexes
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens, (h, w))
            if idx < len(inter) and i == inter[idx]:
                # extract: the priors attend into the ViT tokens (1 level)
                q_tok = self.vit_proj(tokens)
                spatial = spatial + getattr(self, f"extract{idx}")(
                    spatial, spa_ref, q_tok, [(h, w)])
                # inject: the tokens attend into the priors (3 levels)
                upd = getattr(self, f"inject{idx}")(q_tok, vit_ref, spatial,
                                                    shapes)
                tokens = tokens + self.vit_unproj(upd)
                idx += 1

        n2 = shapes[0][0] * shapes[0][1]
        n3 = shapes[1][0] * shapes[1][1]
        s2 = spatial[:, :n2].reshape(b, *shapes[0], self.adapter_dim)
        s3 = spatial[:, n2:n2 + n3].reshape(b, *shapes[1], self.adapter_dim)
        s4 = spatial[:, n2 + n3:].reshape(b, *shapes[2], self.adapter_dim)
        up2 = s2.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        f1 = c1 + up2[:, :c1.shape[1], :c1.shape[2]]
        return (f1, s2, s3, s4)

    def forward_train(self, x, gen: torch.Generator | None = None,
                      dataset_ids=None):
        """The training forward: ``forward``'s features and no gate loss."""
        return self.forward(x, dataset_ids), None
