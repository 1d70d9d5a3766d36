"""Attention functionals (port of ``paddle_tpu.nn.functional.attention``:
``scaled_dot_product_attention``, ``flash_attention`` and the plain
``_sdpa_ref``).

Layout ``[batch, seqlen, num_heads, head_dim]``, as in the JAX package.
Attention dropout takes two explicit generators: ``seed_generator``, a
host ``torch.Generator`` that draws the seed of the flash kernels'
in-kernel mask (a CPU draw, so the step never waits for the card), and
``generator``, on the tensors' device, for the mask of the plain path that
materialises the probabilities."""
from __future__ import annotations

import math

import torch

from .common import dropout as _dropout

__all__ = ["flash_attention", "scaled_dot_product_attention"]


def _sdpa_ref(q, k, v, mask=None, dropout=0.0, causal=False, scale=None,
              generator=None):
    """JAX ``_sdpa_ref`` (``attention.py:27``): q, k, v [B, S, H, D] ->
    [B, S, H, D]; scores in q's dtype, then f32 with the causal and the
    boolean or additive mask; probabilities cast back to q's dtype, then,
    with ``dropout``, ``where(keep, probs / (1 - dropout), 0)`` under a mask
    drawn from ``generator``; GQA by repeating the KV heads."""
    d = q.shape[-1]
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * s).float()
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout > 0.0:
        probs = _dropout(probs, dropout, generator=generator)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, kernels=True, generator=None,
                                 seed_generator=None):
    """JAX ``attention.py:73``.  Without a mask, and with ``kernels`` (the
    counterpart of the JAX flag ``use_pallas_kernels``), attention goes to
    :func:`paddle_tpu_torch.ops.flash_attention.flash_attention` — the CUDA
    kernels for CUDA tensors, with in-kernel dropout in training (its seed
    drawn from ``seed_generator``) — and, on the shapes that declines, to
    the JAX ``flash_attention_ref`` (or to :func:`_sdpa_ref` under dropout),
    as the dispatch of ``ops/pallas/__init__.py`` does.  A mask, or
    ``kernels`` off, runs :func:`_sdpa_ref` (JAX computes it outside any
    kernel), with dropout from ``generator`` in training."""
    rate = dropout_p if training else 0.0
    if attn_mask is None and kernels:
        from ...ops.flash_attention import flash_attention as fa, \
            flash_attention_ref
        out = fa(query, key, value, causal=is_causal, dropout_rate=rate,
                 generator=seed_generator)
        if out is not None:
            return out
        if rate == 0.0:
            return flash_attention_ref(query, key, value, causal=is_causal)
    return _sdpa_ref(query, key, value, mask=attn_mask, dropout=rate,
                     causal=is_causal, generator=generator)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    training=True, kernels=True, generator=None,
                    seed_generator=None):
    """JAX ``attention.py:99`` (Paddle's ``flash_attention``): returns
    ``(out, None)``, the out of :func:`scaled_dot_product_attention` without
    a mask."""
    return scaled_dot_product_attention(
        query, key, value, dropout_p=dropout, is_causal=causal,
        training=training, kernels=kernels, generator=generator,
        seed_generator=seed_generator), None
