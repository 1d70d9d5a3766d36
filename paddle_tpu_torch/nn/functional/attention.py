"""Attention functionals (port of ``paddle_tpu.nn.functional.attention``:
``scaled_dot_product_attention``, ``flash_attention``,
``flash_attn_unpadded`` and the plain ``_sdpa_ref``).

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

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention"]


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


def _fa_varlen(q, k, v, seg, causal=False, rate=0.0, seed_generator=None):
    """The JAX dispatch's ``flash_attention_varlen`` route
    (``ops/pallas/__init__.py:70``): segment-masked flash attention over
    [B, S, H, D] with segment ids [B, S], with in-kernel dropout at
    ``rate`` (its seed drawn from ``seed_generator``); ``None`` on the
    shapes the kernels decline, so that the caller runs its block-diagonal
    plain path."""
    from ...ops.flash_attention import flash_attention as fa
    return fa(q, k, v, causal=causal, segment_ids=seg, dropout_rate=rate,
              generator=seed_generator)


def _segment_ids(cu, total):
    """[total] int64 segment ids of packed sequences with cumulative
    boundaries ``cu`` (JAX: ``cumsum(zeros.at[cu[1:-1]].add(1))``)."""
    marks = torch.zeros(total, dtype=torch.int64, device=cu.device)
    marks.index_add_(0, cu[1:-1], torch.ones_like(cu[1:-1]))
    return marks.cumsum(0)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        kernels=True, generator=None, seed_generator=None):
    """JAX ``attention.py:118`` (Paddle's varlen attention): packed
    sequences ``[total, H, D]`` with cumulative boundaries ``cu_seqlens_*``
    (``[n + 1]`` ints); returns ``(out [total_q, H, D], None)``.

    With equal q and k boundaries, ``scale`` unset and ``kernels`` on, it
    runs the flash-attention kernels with segment ids (:func:`_fa_varlen`:
    the CUDA kernels for CUDA tensors, with in-kernel dropout in training,
    its seed from ``seed_generator``); otherwise, or where those decline
    the length, the block-diagonal mask (per-sequence causal when
    ``causal``) through :func:`_sdpa_ref`, its dropout mask from
    ``generator``.  ``max_seqlen_*``, ``return_softmax``,
    ``fixed_seed_offset`` and ``rng_name`` are taken for Paddle's
    signature and unused, as in JAX."""
    dev = query.device
    cu_q = torch.as_tensor(cu_seqlens_q, device=dev).long()
    cu_k = torch.as_tensor(cu_seqlens_k, device=dev).long()
    tq, tk = query.shape[0], key.shape[0]
    seg_q, seg_k = _segment_ids(cu_q, tq), _segment_ids(cu_k, tk)
    rate = float(dropout) if training else 0.0
    same = cu_q.shape == cu_k.shape and bool(torch.equal(cu_q, cu_k))
    if kernels and tq == tk and same and scale is None:
        out = _fa_varlen(query[None], key[None], value[None], seg_q[None],
                         causal=causal, rate=rate,
                         seed_generator=seed_generator)
        if out is not None:
            return out[0], None
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(tq, device=dev) - cu_q[seg_q]
        pos_k = torch.arange(tk, device=dev) - cu_k[seg_k]
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    out = _sdpa_ref(query[None], key[None], value[None],
                    mask=mask[None, None], dropout=rate, causal=False,
                    scale=scale, generator=generator)
    return out[0], None
