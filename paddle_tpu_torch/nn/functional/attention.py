"""Attention functionals (port of ``paddle_tpu.nn.functional.attention``:
``scaled_dot_product_attention`` and its plain ``_sdpa_ref``).

Layout ``[batch, seqlen, num_heads, head_dim]``, as in the JAX package."""
from __future__ import annotations

import math

import torch

__all__ = ["scaled_dot_product_attention"]


def _sdpa_ref(q, k, v, mask=None, causal=False, scale=None):
    """JAX ``_sdpa_ref`` (``attention.py:27``) without dropout: q, k, v
    [B, S, H, D] -> [B, S, H, D]; scores in q's dtype, then f32 with the
    causal and the boolean or additive mask; probabilities cast back to q's
    dtype; GQA by repeating the KV heads."""
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
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, kernels=True):
    """JAX ``attention.py:73``.  Without a mask or dropout, and with
    ``kernels`` (the counterpart of the JAX flag ``use_pallas_kernels``),
    attention goes to :func:`paddle_tpu_torch.ops.flash_attention.
    flash_attention` — the CUDA kernels for CUDA tensors — and to the JAX
    ``flash_attention_ref`` on the shapes that declines, as the dispatch of
    ``ops/pallas/__init__.py`` does; with ``kernels`` off it is
    :func:`_sdpa_ref`.  A mask runs :func:`_sdpa_ref` (JAX computes it
    outside any kernel).  Dropout in training is not ported yet (it needs
    the in-kernel dropout of the flash kernels) and raises."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "scaled_dot_product_attention: attention dropout is not ported "
            "yet")
    if attn_mask is None and kernels:
        from ...ops.flash_attention import flash_attention, \
            flash_attention_ref
        out = flash_attention(query, key, value, causal=is_causal)
        return out if out is not None else flash_attention_ref(
            query, key, value, causal=is_causal)
    return _sdpa_ref(query, key, value, mask=attn_mask, causal=is_causal)
