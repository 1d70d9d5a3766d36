"""Stable-Diffusion-1.5-style UNet (port of ``paddle_tpu.models.unet``:
``UNetConfig``, ``unet_config_sd15``, ``unet_config_tiny``,
``timestep_embedding``, ``ResBlock``, ``CrossAttention``,
``TransformerBlock``, ``UNet2DConditionModel``).

The JAX model's topology: a sinusoidal timestep embedding and its MLP; a
down path of ResBlocks (GroupNorm + SiLU + 3 x 3 convolutions, the time
embedding added between them) with a self- and cross-attention
TransformerBlock after each at the attention levels, and a stride-2
convolution between levels; a middle ResBlock-attention-ResBlock; an up
path over the skip concatenations with nearest 2x upsampling and a
convolution between levels.  The modules are ``torch.nn.Module``s whose
``named_parameters()`` names are the JAX model's (``down_res.0.conv1.weight``,
``down_attn.0.attn1.to_q.weight`` ...; a level without attention holds
``None`` in ``down_attn`` / ``up_attn``, as JAX's ``LayerList`` does), with
Linear weights in the JAX ``[in, out]`` layout and convolutions in Paddle's
``[out, in, kh, kw]``, so weights cross by name
(:func:`~paddle_tpu_torch.models.convert.unet_params_from_numpy`).
Parameters are drawn from a ``torch.Generator`` seeded with ``seed`` on
``device`` (``None``: the CUDA device, raising without one).

Self-attention runs through the port's ``scaled_dot_product_attention``:
at SD-1.5's 64 x 64 latents its levels 0-2 attend over 4,096, 1,024 and 256
tokens with heads of 40, 80 and 160, which the flash-attention kernels take
(at widths 48, 80 and 160); the cross-attention (77 context tokens) and the
8 x 8 middle block (64 tokens) take ``flash_attention_ref``, as the JAX
dispatch sends them.  ``kernels`` (``use_pallas_kernels``) and
``norm_kernels`` (``use_pallas_norm_kernels``, off) are the JAX flags, as in
``models/ernie.py``: with both on, the TransformerBlocks' LayerNorms whose
width is a multiple of 128 (640 and 1,280 in SD-1.5) take the LayerNorm
kernels.  Convolutions, GroupNorm, SiLU and the upsampling are
``torch.nn.functional`` calls: JAX leaves them to XLA, outside any kernel
of its own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from .. import resolve_device
from ..nn.functional.activation import gelu, silu
from ..nn.functional.attention import scaled_dot_product_attention
from ..nn.functional.common import interpolate
from ..nn.layers import Conv2D, GroupNorm, LayerNorm, Linear

__all__ = ["UNetConfig", "UNet2DConditionModel", "unet_config_sd15",
           "unet_config_tiny", "timestep_embedding", "ResBlock",
           "CrossAttention", "TransformerBlock"]


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attn_levels: Tuple[int, ...] = (0, 1, 2)    # levels with attention
    num_heads: int = 8
    cross_attention_dim: int = 768
    norm_groups: int = 32
    time_embed_mult: int = 4


def unet_config_sd15():
    """SD 1.5's widths: channels 320 / 640 / 1,280 / 1,280, attention at
    levels 0-2 with 8 heads, a 768-wide text context (JAX ``unet.py:40``)."""
    return UNetConfig()


def unet_config_tiny():
    return UNetConfig(in_channels=4, out_channels=4,
                      block_channels=(32, 64), layers_per_block=1,
                      attn_levels=(1,), num_heads=4, cross_attention_dim=32,
                      norm_groups=8)


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal embedding [B] -> [B, dim] f32 (SD convention, JAX
    ``unet.py:50``): cos then sin of t times ``max_period ** (-i / half)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class _Parts:
    """What every submodule needs at construction: the parameters' dtype,
    device and generator (seeded with ``seed``), and the knobs."""

    def __init__(self, dtype, device, seed, kernels, norm_kernels):
        dev = resolve_device(device)
        self.kernels = kernels
        self.mk = dict(dtype=dtype, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           int(seed)))
        self.ln = dict(dtype=dtype, device=dev, kernels=kernels,
                       norm_kernels=norm_kernels)
        self.gn = dict(dtype=dtype, device=dev)


class ResBlock(nn.Module):
    def __init__(self, c_in, c_out, t_dim, groups, parts):
        super().__init__()
        self.norm1 = GroupNorm(min(groups, c_in), c_in, **parts.gn)
        self.conv1 = Conv2D(c_in, c_out, 3, padding=1, **parts.mk)
        self.time_proj = Linear(t_dim, c_out, **parts.mk)
        self.norm2 = GroupNorm(min(groups, c_out), c_out, **parts.gn)
        self.conv2 = Conv2D(c_out, c_out, 3, padding=1, **parts.mk)
        self.skip = Conv2D(c_in, c_out, 1, **parts.mk) \
            if c_in != c_out else None

    def forward(self, x, temb):
        h = self.conv1(silu(self.norm1(x)))
        h = h + self.time_proj(silu(temb)).reshape(temb.shape[0], -1, 1, 1)
        h = self.conv2(silu(self.norm2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class CrossAttention(nn.Module):
    def __init__(self, dim, ctx_dim, heads, parts):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False, **parts.mk)
        self.to_k = Linear(ctx_dim, dim, bias=False, **parts.mk)
        self.to_v = Linear(ctx_dim, dim, bias=False, **parts.mk)
        self.to_out = Linear(dim, dim, **parts.mk)
        self.kernels = parts.kernels

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, n, _ = x.shape
        hd = x.shape[-1] // self.heads
        q = self.to_q(x).reshape(b, n, self.heads, hd)
        k = self.to_k(ctx).reshape(b, ctx.shape[1], self.heads, hd)
        v = self.to_v(ctx).reshape(b, ctx.shape[1], self.heads, hd)
        o = scaled_dot_product_attention(q, k, v, is_causal=False,
                                         training=self.training,
                                         kernels=self.kernels)
        return self.to_out(o.reshape(b, n, -1))


class TransformerBlock(nn.Module):
    """Self-attention -> cross-attention -> GEGLU feed-forward (exact GELU)
    over the flattened spatial tokens, between 1 x 1 projections."""

    def __init__(self, dim, ctx_dim, heads, parts):
        super().__init__()
        self.norm1 = LayerNorm(dim, **parts.ln)
        self.attn1 = CrossAttention(dim, dim, heads, parts)
        self.norm2 = LayerNorm(dim, **parts.ln)
        self.attn2 = CrossAttention(dim, ctx_dim, heads, parts)
        self.norm3 = LayerNorm(dim, **parts.ln)
        self.ff1 = Linear(dim, dim * 8, **parts.mk)
        self.ff2 = Linear(dim * 4, dim, **parts.mk)
        self.proj_in = Conv2D(dim, dim, 1, **parts.mk)
        self.proj_out = Conv2D(dim, dim, 1, **parts.mk)
        self.norm_in = GroupNorm(min(32, dim), dim, **parts.gn)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        res = x
        t = self.proj_in(self.norm_in(x))
        t = t.reshape(b, c, h * w).transpose(1, 2)
        t = t + self.attn1(self.norm1(t))
        t = t + self.attn2(self.norm2(t), ctx)
        ff = self.ff1(self.norm3(t))
        half = ff.shape[-1] // 2
        ff = ff[:, :, :half] * gelu(ff[:, :, half:])
        t = t + self.ff2(ff)
        t = t.transpose(1, 2).reshape(b, c, h, w)
        return self.proj_out(t) + res


class UNet2DConditionModel(nn.Module):
    """The SD UNet (JAX ``unet.py:132``): (latents [B, C, H, W], timesteps
    [B], context [B, L, ctx]) -> the predicted noise [B, C_out, H, W]."""

    def __init__(self, config: UNetConfig = None, dtype=torch.float32,
                 device=None, seed: int = 0, kernels: bool = True,
                 norm_kernels: bool = False):
        super().__init__()
        c = config or unet_config_sd15()
        self.config = c
        parts = _Parts(dtype, device, seed, kernels, norm_kernels)
        ch = c.block_channels
        t_dim = ch[0] * c.time_embed_mult
        self.t_dim0 = ch[0]
        self.time_fc1 = Linear(ch[0], t_dim, **parts.mk)
        self.time_fc2 = Linear(t_dim, t_dim, **parts.mk)
        self.conv_in = Conv2D(c.in_channels, ch[0], 3, padding=1, **parts.mk)

        def attention(cout, lvl):
            return TransformerBlock(cout, c.cross_attention_dim, c.num_heads,
                                    parts) if lvl in c.attn_levels else None

        self.down_res = nn.ModuleList()
        self.down_attn = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        cur = ch[0]
        for lvl, cout in enumerate(ch):
            for _ in range(c.layers_per_block):
                self.down_res.append(ResBlock(cur, cout, t_dim, c.norm_groups,
                                              parts))
                self.down_attn.append(attention(cout, lvl))
                cur = cout
            if lvl < len(ch) - 1:
                self.downsamplers.append(Conv2D(cur, cur, 3, stride=2,
                                                padding=1, **parts.mk))

        self.mid_res1 = ResBlock(cur, cur, t_dim, c.norm_groups, parts)
        self.mid_attn = TransformerBlock(cur, c.cross_attention_dim,
                                         c.num_heads, parts)
        self.mid_res2 = ResBlock(cur, cur, t_dim, c.norm_groups, parts)

        self.up_res = nn.ModuleList()
        self.up_attn = nn.ModuleList()
        self.upsamplers = nn.ModuleList()
        skip_ch = [cout for cout in ch for _ in range(c.layers_per_block)]
        for lvl in reversed(range(len(ch))):
            cout = ch[lvl]
            for _ in range(c.layers_per_block):
                s = skip_ch.pop()
                self.up_res.append(ResBlock(cur + s, cout, t_dim,
                                            c.norm_groups, parts))
                self.up_attn.append(attention(cout, lvl))
                cur = cout
            if lvl > 0:
                self.upsamplers.append(Conv2D(cur, cur, 3, padding=1,
                                              **parts.mk))

        self.norm_out = GroupNorm(min(c.norm_groups, cur), cur, **parts.gn)
        self.conv_out = Conv2D(cur, c.out_channels, 3, padding=1, **parts.mk)

    def forward(self, latents, timesteps, context):
        c = self.config
        # the sinusoidal table is f32; it follows the latents' dtype, so
        # that the time-projection adds keep the conv stream in it
        temb = timestep_embedding(timesteps, self.t_dim0).to(latents.dtype)
        temb = self.time_fc2(silu(self.time_fc1(temb)))

        x = self.conv_in(latents)
        skips = []
        idx = 0
        for lvl in range(len(c.block_channels)):
            for _ in range(c.layers_per_block):
                x = self.down_res[idx](x, temb)
                if self.down_attn[idx] is not None:
                    x = self.down_attn[idx](x, context)
                skips.append(x)
                idx += 1
            if lvl < len(c.block_channels) - 1:
                x = self.downsamplers[lvl](x)

        x = self.mid_res1(x, temb)
        x = self.mid_attn(x, context)
        x = self.mid_res2(x, temb)

        idx = 0
        us = 0
        for lvl in reversed(range(len(c.block_channels))):
            for _ in range(c.layers_per_block):
                x = torch.cat([x, skips.pop()], dim=1)
                x = self.up_res[idx](x, temb)
                if self.up_attn[idx] is not None:
                    x = self.up_attn[idx](x, context)
                idx += 1
            if lvl > 0:
                x = interpolate(x, scale_factor=2, mode="nearest")
                x = self.upsamplers[us](x)
                us += 1

        return self.conv_out(silu(self.norm_out(x)))
