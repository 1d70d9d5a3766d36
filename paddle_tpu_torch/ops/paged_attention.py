"""Ragged paged attention — one kernel for every serving path.

Port of ``paddle_tpu/ops/pallas/paged_attention.py``.  The KV cache lives in
fixed-size pages of ``page_size`` tokens; each slot owns a page-table row and
contributes one ragged query segment ``(q_start, q_len, kv_len)``: ``q_len``
fresh queries at absolute positions ``q_start ..`` attending the slot's
paged context causally.  Decode is the ``q_len = 1`` segment, a chunked or
suffix prefill the ``q_len = chunk`` segment.

Layout (the JAX package's, so the tests compare like with like)::

    q          [S, Qmax, Hq, D]    ragged query segments, right-padded
    k_pages    [Hkv, NP, ps, D]
    v_pages    [Hkv, NP, ps, D]
    page_table [S, P] int32        physical page of each logical page
    q_start    [S]    int32        absolute position of query 0 per slot
    q_len      [S]    int32        valid queries per slot (0 = inactive)
    kv_len     [S]    int32        valid KV tokens (segment included)

:func:`ragged_paged_attention` launches the hand-written CUDA kernel
(``csrc/ragged_paged_attention.cu``) for CUDA tensors and runs the plain
PyTorch version :func:`ragged_paged_attention_ref` for CPU tensors — the
device of the tensors is the only thing that picks.  On a CUDA tensor it
launches or raises; nothing falls back.  Quantized pages
(``k_scales``/``v_scales``) are rejected here: the fused-dequant body is a
later port.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "ragged_paged_attention_decode", "paged_attention_decode_ref",
           "paged_gather_kv", "NEG_INF"]

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _check_common(q, k_pages, v_pages, k_scales, v_scales):
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "quantized KV pages (k_scales/v_scales) are not ported yet")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"want q [S, Qmax, Hq, D] and k/v pages [Hkv, NP, ps, D] of one "
            f"shape, got q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
            f"v {tuple(v_pages.shape)}")
    hq, hkv = q.shape[2], k_pages.shape[0]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"num q heads ({hq}) must be a multiple of kv "
                         f"heads ({hkv})")
    if q.shape[3] != k_pages.shape[3]:
        raise ValueError(f"head dim mismatch: q {q.shape[3]}, "
                         f"pages {k_pages.shape[3]}")


def _launch_kernel(q, k_pages, v_pages, page_table, q_start, q_len, kv_len,
                   sm_scale, out_dtype):
    s_slots, qmax, hq, d = q.shape
    hkv, num_pages, page_size, _ = k_pages.shape
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("q_start", q_start),
                    ("q_len", q_len), ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {_HEAD_DIMS})")
    if page_size <= 0 or page_size % 8:
        raise ValueError(f"page_size {page_size} must be a positive "
                         f"multiple of 8")
    if page_table.dim() != 2 or page_table.shape[0] != s_slots:
        raise ValueError(f"page_table must be [S={s_slots}, P], "
                         f"got {tuple(page_table.shape)}")
    for name, t in (("page_table", page_table), ("q_start", q_start),
                    ("q_len", q_len), ("kv_len", kv_len)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q_start", q_start), ("q_len", q_len),
                    ("kv_len", kv_len)):
        if t.shape != (s_slots,):
            raise ValueError(f"{name} must be [S={s_slots}], "
                             f"got {tuple(t.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("q_start", q_start),
                    ("q_len", q_len), ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"loads 16-byte vectors)")
    out = torch.empty(q.shape, dtype=out_dtype, device=dev)
    fn = _build.library("ragged_paged_attention").ragged_paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
        + [ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), q_start.data_ptr(), q_len.data_ptr(),
                 kv_len.data_ptr(), out.data_ptr(), s_slots, qmax, hq, hkv,
                 num_pages, page_size, page_table.shape[1], d,
                 _DTYPE_CODE[q.dtype], _DTYPE_CODE[out_dtype], sm_scale,
                 stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention: CUDA error {err} at "
                           f"launch")
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_table, q_start, q_len,
                           kv_len, sm_scale=None, out_dtype=None,
                           k_scales=None, v_scales=None):
    """Ragged-segment paged attention over each slot's page list.

    q [S, Qmax, Hq, D], k_pages/v_pages [Hkv, NP, ps, D], page_table
    [S, P] int32 (entries past a slot's pages may hold any in-range id;
    they are never read), q_start/q_len/kv_len [S] int32 ->
    o [S, Qmax, Hq, D] in ``out_dtype`` (default ``q.dtype``).  Query j of
    slot s at position q_start[s] + j attends positions <= its own and
    < kv_len[s]; rows past q_len[s] — every row of a q_len = 0 slot — come
    back exactly zero.  Accumulation is f32.

    CUDA tensors launch ``csrc/ragged_paged_attention.cu`` (f32 or bf16,
    D in {64, 128}, page_size a multiple of 8, every tensor contiguous,
    index tensors int32) and add one to ``ragged_paged_attention.launches``;
    CPU tensors run :func:`ragged_paged_attention_ref`."""
    _check_common(q, k_pages, v_pages, k_scales, v_scales)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, k_pages, v_pages, page_table,
                                          q_start, q_len, kv_len,
                                          sm_scale=sm_scale,
                                          out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    out = _launch_kernel(q, k_pages, v_pages, page_table, q_start, q_len,
                         kv_len, float(sm_scale), out_dtype)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def paged_gather_kv(pages, page_table):
    """Gather a slot-major dense view [S, P*ps, Hkv, D] out of the page pool
    (pages [Hkv, NP, ps, D], page_table [S, P]) — the plain version's dense
    reconstruction."""
    g = pages[:, page_table.long()]               # [Hkv, S, P, ps, D]
    hkv, s, p, ps, d = g.shape
    return g.permute(1, 2, 3, 0, 4).reshape(s, p * ps, hkv, d)


def ragged_paged_attention_ref(q, k_pages, v_pages, page_table, q_start,
                               q_len, kv_len, sm_scale=None, out_dtype=None,
                               k_scales=None, v_scales=None):
    """Plain PyTorch version with the kernel's semantics: gather the pages
    dense, mask causally inside each slot's segment, zero padding query
    rows and q_len = 0 slots.  Masks with ``NEG_INF`` (not -inf), so a fully
    masked row softmaxes to a finite value that the q_len mask then zeroes.
    Each call adds one to ``ragged_paged_attention_ref.calls``."""
    _check_common(q, k_pages, v_pages, k_scales, v_scales)
    ragged_paged_attention_ref.calls += 1
    s_slots, qmax, hq, d = q.shape
    hkv = k_pages.shape[0]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    k = paged_gather_kv(k_pages, page_table)      # [S, T, Hkv, D]
    v = paged_gather_kv(v_pages, page_table)
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("sqhd,sthd->shqt", q.float(), k.float()) * sm_scale
    dev = q.device
    t_pos = torch.arange(s.shape[-1], device=dev)[None, None, None, :]
    qi = torch.arange(qmax, device=dev)[None, None, :, None]
    qs = q_start.long()[:, None, None, None]
    ql = q_len.long()[:, None, None, None]
    kl = kv_len.long()[:, None, None, None]
    ok = (t_pos <= qs + qi) & (qi < ql) & (t_pos < kl)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("shqt,sthd->sqhd", p, v.float())
    keep = torch.arange(qmax, device=dev)[None, :, None, None] \
        < q_len.long()[:, None, None, None]
    o = torch.where(keep, o, torch.zeros_like(o))
    return o.to(out_dtype or q.dtype)


ragged_paged_attention_ref.calls = 0


def _decode_segments(lengths):
    lengths = lengths.to(torch.int32)
    return ((lengths - 1).clamp(min=0).to(torch.int32),
            (lengths > 0).to(torch.int32), lengths.contiguous())


def ragged_paged_attention_decode(q, k_pages, v_pages, page_table, lengths,
                                  sm_scale=None, out_dtype=None,
                                  k_scales=None, v_scales=None):
    """Decode-shape wrapper: one query per slot (``q [S, Hq, D]``,
    ``lengths [S]`` = valid KV including the freshly written token) is the
    ``q_len = 1`` case of :func:`ragged_paged_attention`.  A slot with
    length 0 produces exact zeros."""
    qs, ql, kl = _decode_segments(lengths)
    return ragged_paged_attention(
        q[:, None].contiguous(), k_pages, v_pages, page_table, qs, ql, kl,
        sm_scale=sm_scale, out_dtype=out_dtype, k_scales=k_scales,
        v_scales=v_scales)[:, 0]


def paged_attention_decode_ref(q, k_pages, v_pages, page_table, lengths,
                               sm_scale=None, out_dtype=None, k_scales=None,
                               v_scales=None):
    """Decode-shape wrapper over :func:`ragged_paged_attention_ref` — the
    same ``q_len = 1`` specialization as the kernel-side wrapper."""
    qs, ql, kl = _decode_segments(lengths)
    return ragged_paged_attention_ref(
        q[:, None], k_pages, v_pages, page_table, qs, ql, kl,
        sm_scale=sm_scale, out_dtype=out_dtype, k_scales=k_scales,
        v_scales=v_scales)[:, 0]
