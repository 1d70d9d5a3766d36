"""Quantized serving: the int8/fp8 KV codec and the serving-weight
quantizer (port of ``paddle_tpu/serving/quant.py``).

  * :func:`quantize_kv` / :func:`dequantize_kv` — the one symmetric-absmax
    KV codec, one f32 scale per (page, kv head, token row).  Per-row scales
    make quantization independent of write order: a token row quantizes the
    same whether a dense prefill, a chunk, a decode step or a speculative
    verify wrote it, so the quantized engine stays exact against itself.
  * :func:`kv_spec` — ``kv_dtype`` name -> (storage dtype, qmax).
  * :func:`page_bytes` — bytes of one KV page (K and V, all layers, scales
    included).
  * :func:`quantize_params` — per-channel weight quantization of the
    serving parameters, stored dequantized in their own dtype.

Codes and scales equal the JAX codec's bit for bit: the same f32 divide,
round half to even, clip, and the same f32 -> float8_e4m3fn cast.
"""
from __future__ import annotations

import torch

from ..quantization import dequantize_weight, quantize_weight

__all__ = ["KV_DTYPES", "kv_spec", "quantize_kv", "dequantize_kv",
           "page_bytes", "quantize_params"]

# kv_dtype name -> (storage dtype, qmax): 127 keeps the int8 grid symmetric
# (-128 is never emitted); 448 is the largest finite e4m3 value, so the
# absmax maps onto the whole fp8 range without rounding into NaN.
KV_DTYPES = {"int8": (torch.int8, 127.0),
             "fp8": (torch.float8_e4m3fn, 448.0)}


def kv_spec(kv_dtype):
    """``kv_dtype`` name -> (storage torch dtype, qmax); ValueError for an
    unknown name."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r} (expected one of "
            f"{sorted(KV_DTYPES)}, or None for the f32/bf16 page store)")
    return KV_DTYPES[kv_dtype]


def quantize_kv(x, *, qmax, dtype):
    """Symmetric absmax quantization of K/V rows: ``x [..., D]`` (any float
    dtype) -> ``(q [..., D] in dtype, scale [...] f32)``, one scale per row.
    Zero rows round-trip to exact zeros."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / qmax
    y = xf / scale[..., None]
    if dtype.is_floating_point:
        # fp8: the cast is the rounding; |y| <= qmax, so it never overflows
        return y.to(dtype), scale
    return torch.clamp(torch.round(y), -qmax, qmax).to(dtype), scale


def dequantize_kv(q, scale):
    """``(q [..., D], scale [...])`` -> f32 values; the one dequant
    expression every attention path uses."""
    return q.float() * scale[..., None].float()


def page_bytes(config, page_size: int, kv_dtype=None, dtype=None) -> int:
    """Bytes of ONE page of KV cache: K and V across all layers, with the
    per-row f32 scales for a quantized ``kv_dtype``."""
    L = config.num_hidden_layers
    hkv = config.num_key_value_heads
    d = config.hidden_size // config.num_attention_heads
    rows = 2 * L * hkv * page_size
    if kv_dtype is None:
        item = torch.empty(0, dtype=dtype or torch.float32).element_size()
        return rows * d * item
    storage, _ = kv_spec(kv_dtype)
    return rows * d * torch.empty(0, dtype=storage).element_size() + rows * 4


def _quant_leaf(w, bits, reduce_axis):
    q, scale = quantize_weight(w, bits=bits, axis=reduce_axis)
    return dequantize_weight(q, scale, dtype=w.dtype)


def quantize_params(params, bits: int = 8):
    """Snap the ``(embed, block, head)`` serving parameters onto the
    per-channel int grid: matmul weights with one absmax scale per output
    channel (reducing the contraction axis), the embedding per row; the
    norm gains (``ln*``) pass through.  Values come back dequantized in
    their own dtype."""
    ep, bp, hp = params
    ep = dict(ep, tok=_quant_leaf(ep["tok"], bits, -1))
    bp = {k: (v if k.startswith("ln") else _quant_leaf(v, bits, -2))
          for k, v in bp.items()}
    hp = dict(hp, lm=_quant_leaf(hp["lm"], bits, -2))
    return ep, bp, hp
