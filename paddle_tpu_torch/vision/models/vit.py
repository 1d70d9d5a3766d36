"""Vision Transformer (port of ``paddle_tpu.vision.models.vit``:
``PatchEmbed``, ``MLP``, ``Attention``, ``Block``, ``VisionTransformer``,
``vit_b_16``, ``vit_l_16``).

A pre-LN transformer over 16 x 16 patches with a class token and learned
positions.  The modules are ``torch.nn.Module``s whose
``named_parameters()`` names are the JAX model's (``cls_token``,
``pos_embed``, ``patch_embed.proj.weight``, ``blocks.0.attn.qkv.weight``
...), with Linear weights in the JAX ``[in, out]`` layout and the patch
convolution's in Paddle's ``[out, in, kh, kw]``, so weights cross by name
(:func:`~paddle_tpu_torch.models.convert.vit_params_from_numpy`).
Parameters are drawn from a ``torch.Generator`` seeded with ``seed`` on
``device`` (``None``: the CUDA device, raising without one); the class
token and the positions from N(0, 0.02^2) cut at +-2, as JAX's
``TruncatedNormal(std=0.02)``.

Attention runs through the port's ``scaled_dot_product_attention``, so at
384 px (577 tokens) it takes the flash-attention kernels' pad-to-tile path
(640 rows, the padding in a segment of its own) and at 224 px (197 tokens,
below the JAX package's 384-token threshold) the plain path, as the JAX
dispatch does.  ``kernels`` (``use_pallas_kernels``) and ``norm_kernels``
(``use_pallas_norm_kernels``, off) are the JAX flags, as in
``models/ernie.py``; the fused AdamW is the optimizer's.  Dropout is
where JAX has it (``drop_rate`` on the positions, the attention output and
the MLP, ``attn_drop_rate`` on the attention probabilities), from the
model's two generators: ``dropout_generator`` on its device for the
hidden masks and ``attention_seed_generator`` on the host for the
in-kernel attention masks' seeds.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from ...nn.functional.attention import scaled_dot_product_attention
from ...nn.layers import GELU, Conv2D, Dropout, LayerNorm, Linear

__all__ = ["VisionTransformer", "vit_b_16", "vit_l_16"]


class _Parts:
    """What every submodule needs at construction: the parameters'
    generator (seeded with ``seed``), the two dropout generators (seeded
    from it, apart from the parameters' stream) and the knobs."""

    def __init__(self, dtype, device, seed, kernels, norm_kernels, epsilon):
        dev = resolve_device(device)
        self.kernels = kernels
        self.mk = dict(dtype=dtype, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           int(seed)))
        self.ln = dict(dtype=dtype, device=dev, kernels=kernels,
                       norm_kernels=norm_kernels)
        self.epsilon = epsilon
        self.dropout_generator = torch.Generator(device=dev).manual_seed(
            int(seed) + 1)
        self.attention_seed_generator = torch.Generator().manual_seed(
            int(seed) + 2)

    def norm(self, dim):
        return LayerNorm(dim, self.epsilon, **self.ln)

    def dropout(self, p):
        return Dropout(p, generator=self.dropout_generator)


class PatchEmbed(nn.Module):
    def __init__(self, img_size, patch_size, in_chans, embed_dim, parts):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = Conv2D(in_chans, embed_dim, patch_size, stride=patch_size,
                           **parts.mk)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)    # [B, N, C]


class MLP(nn.Module):
    def __init__(self, dim, hidden, drop, parts):
        super().__init__()
        self.fc1 = Linear(dim, hidden, **parts.mk)
        self.act = GELU()
        self.fc2 = Linear(hidden, dim, **parts.mk)
        self.drop = parts.dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))


class Attention(nn.Module):
    def __init__(self, dim, num_heads, attn_drop, proj_drop, qkv_bias, parts):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, **parts.mk)
        self.proj = Linear(dim, dim, **parts.mk)
        self.attn_drop = attn_drop
        self.proj_drop = parts.dropout(proj_drop)
        self.kernels = parts.kernels
        self.generator = parts.dropout_generator
        self.seed_generator = parts.attention_seed_generator

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, self.head_dim)
        out = scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
            dropout_p=self.attn_drop, training=self.training,
            kernels=self.kernels, generator=self.generator,
            seed_generator=self.seed_generator)
        return self.proj_drop(self.proj(out.reshape(b, n, c)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, drop, attn_drop, qkv_bias,
                 parts):
        super().__init__()
        self.norm1 = parts.norm(dim)
        self.attn = Attention(dim, num_heads, attn_drop, drop, qkv_bias,
                              parts)
        self.norm2 = parts.norm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio), drop, parts)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """JAX ``VisionTransformer`` (``vit.py:83``): images [B, C, H, W] ->
    logits [B, num_classes] (the final norm's class token when
    ``num_classes`` is 0).  ``qkv_bias=False`` builds the qkv projection
    without a bias (no ``qkv.bias`` parameter), as JAX's does."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, qkv_bias=True, drop_rate=0.0,
                 attn_drop_rate=0.0,
                 epsilon=1e-6, dtype=torch.float32, device=None,
                 seed: int = 0, kernels: bool = True,
                 norm_kernels: bool = False):
        super().__init__()
        parts = _Parts(dtype, device, seed, kernels, norm_kernels, epsilon)
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, parts)
        n = self.patch_embed.num_patches

        def trunc_normal(*shape):
            z = torch.randn(shape, generator=parts.mk["generator"],
                            device=parts.mk["device"])
            return nn.Parameter((0.02 * z).clamp(-2.0, 2.0).to(dtype))

        self.cls_token = trunc_normal(1, 1, embed_dim)
        self.pos_embed = trunc_normal(1, n + 1, embed_dim)
        self.pos_drop = parts.dropout(drop_rate)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, drop_rate, attn_drop_rate,
                  qkv_bias, parts) for _ in range(depth))
        self.norm = parts.norm(embed_dim)
        self.head = Linear(embed_dim, num_classes, **parts.mk) \
            if num_classes > 0 else None
        self.dropout_generator = parts.dropout_generator
        self.attention_seed_generator = parts.attention_seed_generator

    def forward(self, x):
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], 1, x.shape[2])
        x = self.pos_drop(torch.cat([cls, x], dim=1) + self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        cls_out = self.norm(x)[:, 0]
        return self.head(cls_out) if self.head is not None else cls_out


def vit_b_16(**kwargs):
    """ViT-B/16: hidden 768, 12 layers, 12 heads of 64."""
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, **kwargs)


def vit_l_16(**kwargs):
    """ViT-L/16: hidden 1,024, 24 layers, 16 heads of 64, MLP 4,096."""
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16,
                             **kwargs)
