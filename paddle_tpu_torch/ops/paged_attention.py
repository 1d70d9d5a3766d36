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
launches or raises; nothing falls back.

Split-KV: :func:`split_plan` (a host function of shapes alone, never of
``kv_len``) picks how many blocks share a slot's token range; with more than
one split the kernel writes per-split partial softmax states to a workspace
the wrapper allocates and a second kernel merges them
(:func:`ragged_paged_attention_combine`, plain version
:func:`ragged_paged_attention_combine_ref`), counted by
``ragged_paged_attention.combine_launches``.

Quantized pages: with ``k_scales``/``v_scales`` (``[Hkv, NP, ps]`` f32, both
or neither) the pages hold int8 or float8_e4m3fn codes and every row
dequantizes as ``code * scale`` — inside the kernel
(``csrc/ragged_paged_attention_quant.cu``, counted by
``ragged_paged_attention.quant_launches``) for CUDA tensors, on the
gathered rows in the plain version, which then rounds them to ``q.dtype``
as the JAX reference does.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "ragged_paged_attention_combine",
           "ragged_paged_attention_combine_ref", "split_plan", "SplitPlan",
           "head_width",
           "ragged_paged_attention_decode", "paged_attention_decode_ref",
           "paged_gather_kv", "paged_gather_scales", "NEG_INF"]

NEG_INF = -1e30

_KV_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}


def head_width(d):
    """The width the kernels run head dim ``d`` at
    (``csrc/ragged_paged_attention.cuh rpa_width``): ``d`` rounded up to a
    multiple of 32 (a CUDA-core lane owns width / 32 output dims), 224 up to
    256, for a multiple of 8 up to 256 (the head dims the JAX kernel
    takes); ``None`` for any other ``d``, which would break the kernels'
    16-byte row copies."""
    if d <= 0 or d % 8 or d > 256:
        return None
    return 256 if d > 192 else -(-d // 32) * 32


# query rows of a block: the CUDA-core tile (one row for a one-row group:
# decode without GQA), and the tensor-core tile that bf16 q takes once a
# (slot, kv head) group has MMA_MIN_ROWS rows
CORE_ROWS, MMA_ROWS = 8, 64
MMA_MIN_ROWS = 2
# the split grid aims at this many blocks per SM for CUDA-core and for
# tensor-core tiles (measured in phase 5 of chip_smoke.py), with no more
# splits than the table holds pieces of MIN_SPLIT_TOKENS tokens and of
# SPLIT_TOKENS_PER_ROW tokens per query row of a group, so that the
# partials (f32 rows) stay small beside the K/V rows a split reads
BLOCKS_PER_SM = 4
MMA_BLOCKS_PER_SM = 2
MIN_SPLIT_TOKENS = 64
SPLIT_TOKENS_PER_ROW = 4
H100_SMS = 132


class SplitPlan(NamedTuple):
    """How one launch cuts its work: query rows per block, ``n_splits``
    splits of ``split_len`` tokens (whole pages), the grid's block count,
    and the partials' workspace shapes (``ml``: m and l per row, ``acc``:
    the f32 accumulator; both unused with one split)."""
    row_tile: int
    n_splits: int
    split_len: int
    blocks: int
    ml_shape: tuple
    acc_shape: tuple


def split_plan(s_slots, qmax, hq, hkv, head_dim, table_width, page_size,
               tensor_cores, sms=H100_SMS):
    """The split-KV plan of a launch, from shapes alone (never ``kv_len``,
    so it needs nothing from the device): the row tile (``MMA_ROWS`` when
    ``tensor_cores`` — bf16 q — and a group has ``MMA_MIN_ROWS`` rows,
    else ``CORE_ROWS``, or 1 for a one-row group), then enough splits of
    the table's ``table_width`` pages for ``BLOCKS_PER_SM`` blocks
    (``MMA_BLOCKS_PER_SM`` for the tensor-core tile) on each of ``sms``
    SMs, but no more splits than the table holds pieces of
    ``MIN_SPLIT_TOKENS`` tokens and of ``SPLIT_TOKENS_PER_ROW`` tokens per
    group row — one split for a short table, never more splits than
    pages."""
    rows = qmax * (hq // hkv)
    row_tile = MMA_ROWS if tensor_cores and rows >= MMA_MIN_ROWS else \
        CORE_ROWS if rows > 1 else 1
    base = -(-rows // row_tile) * hkv * s_slots
    per_split = -(-max(MIN_SPLIT_TOKENS, SPLIT_TOKENS_PER_ROW * rows)
                  // page_size)                         # pages, at least
    most = max(1, -(-table_width // per_split))
    blocks_per_sm = MMA_BLOCKS_PER_SM if row_tile == MMA_ROWS \
        else BLOCKS_PER_SM
    want = math.ceil(sms * blocks_per_sm / max(base, 1))
    n = max(1, min(want, most))
    split_pages = max(1, -(-table_width // n))
    n = max(1, -(-table_width // split_pages))
    return SplitPlan(row_tile, n, split_pages * page_size, n * base,
                     (n, s_slots, hkv, rows, 2),
                     (n, s_slots, hkv, rows, head_dim))


def _check_common(q, k_pages, v_pages, k_scales, v_scales):
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if k_scales is not None and (k_scales.shape != k_pages.shape[:3]
                                 or v_scales.shape != v_pages.shape[:3]):
        raise ValueError(
            f"scale pages must be [Hkv, NP, ps] = {tuple(k_pages.shape[:3])}, "
            f"got {tuple(k_scales.shape)}, {tuple(v_scales.shape)}")
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
                   sm_scale, out_dtype, k_scales=None, v_scales=None):
    s_slots, qmax, hq, d = q.shape
    hkv, num_pages, page_size, _ = k_pages.shape
    dev = q.device
    quant = k_scales is not None
    scales = (("k_scales", k_scales), ("v_scales", v_scales)) if quant else ()
    index = (("page_table", page_table), ("q_start", q_start),
             ("q_len", q_len), ("kv_len", kv_len))
    pages = (("k_pages", k_pages), ("v_pages", v_pages))
    for name, t in pages + scales + index:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, "
                        f"got {q.dtype}")
    if quant:
        if k_pages.dtype not in _KV_CODE or v_pages.dtype != k_pages.dtype:
            raise TypeError(f"quantized pages must both be int8 or "
                            f"float8_e4m3fn, got {k_pages.dtype}, "
                            f"{v_pages.dtype}")
        for name, t in scales:
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
    elif k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"the kernel takes q/k/v of one dtype, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if out_dtype not in _build.DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if head_width(d) is None:
        raise ValueError(f"head dim {d} not supported on the card (a multiple "
                         f"of 8 up to 256: the kernels copy rows in 16-byte "
                         f"vectors)")
    if page_size <= 0 or page_size % 8:
        raise ValueError(f"page_size {page_size} must be a positive "
                         f"multiple of 8")
    if page_table.dim() != 2 or page_table.shape[0] != s_slots:
        raise ValueError(f"page_table must be [S={s_slots}, P], "
                         f"got {tuple(page_table.shape)}")
    for name, t in index:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in index[1:]:
        if t.shape != (s_slots,):
            raise ValueError(f"{name} must be [S={s_slots}], "
                             f"got {tuple(t.shape)}")
    for name, t in (("q", q),) + pages + scales + index:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q),) + pages + scales:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"copies 16-byte vectors)")
    plan = split_plan(s_slots, qmax, hq, hkv, d, page_table.shape[1],
                      page_size, q.dtype == torch.bfloat16,
                      sms=_sm_count(dev))
    out = torch.empty(q.shape, dtype=out_dtype, device=dev)
    ml = acc = None
    if plan.n_splits > 1:
        ml = torch.empty(plan.ml_shape, dtype=torch.float32, device=dev)
        acc = torch.empty(plan.acc_shape, dtype=torch.float32, device=dev)
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    ints = [s_slots, qmax, hq, hkv, num_pages, page_size, page_table.shape[1],
            d, _build.DTYPE_CODE[q.dtype], _build.DTYPE_CODE[out_dtype]]
    lib = _build.width_library("ragged_paged_attention_quant" if quant
                               else "ragged_paged_attention", head_width(d))
    if quant:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
        ints.append(_KV_CODE[k_pages.dtype])
    ptrs += [t.data_ptr() for _, t in index]
    ptrs += [0 if t is None else t.data_ptr() for t in (ml, acc)]
    ptrs.append(out.data_ptr())
    ints += [plan.row_tile, plan.n_splits, plan.split_len]
    entry = "ragged_paged_attention_quant" if quant \
        else "ragged_paged_attention"
    _build.launch(lib, f"{entry}_launch",
                  [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints)
                  + [ctypes.c_float], [*ptrs, *ints, sm_scale], dev)
    return out, plan.n_splits > 1


def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
    back exactly zero.  Accumulation is f32.  ``k_scales``/``v_scales``
    ``[Hkv, NP, ps]`` f32 (both or neither) mark int8 / float8_e4m3fn pages
    dequantized by their per-row scale.

    CUDA tensors launch ``csrc/ragged_paged_attention.cu`` (f32 or bf16
    pages of q's dtype) or, with scales, ``csrc/
    ragged_paged_attention_quant.cu`` (int8 or fp8 pages, f32 or bf16 q),
    for D a multiple of 8 up to 256 (:func:`head_width`), page_size a
    multiple of 8, every tensor contiguous,
    index tensors int32, and add one to ``ragged_paged_attention.launches``
    or ``.quant_launches``; CPU tensors run
    :func:`ragged_paged_attention_ref`."""
    _check_common(q, k_pages, v_pages, k_scales, v_scales)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = out_dtype or q.dtype
    if not _build.on_card("ragged_paged_attention", q):
        return ragged_paged_attention_ref(q, k_pages, v_pages, page_table,
                                          q_start, q_len, kv_len,
                                          sm_scale=sm_scale,
                                          out_dtype=out_dtype,
                                          k_scales=k_scales,
                                          v_scales=v_scales)
    out, combined = _launch_kernel(q, k_pages, v_pages, page_table, q_start,
                                   q_len, kv_len, float(sm_scale), out_dtype,
                                   k_scales, v_scales)
    if k_scales is None:
        ragged_paged_attention.launches += 1
    else:
        ragged_paged_attention.quant_launches += 1
    ragged_paged_attention.combine_launches += combined
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.quant_launches = 0
ragged_paged_attention.combine_launches = 0


def ragged_paged_attention_combine(ml, acc, q_len, hq, out_dtype):
    """The split-KV merge alone: partials ``ml [n, S, Hkv, R, 2]`` (m in
    base-2 units, l) and ``acc [n, S, Hkv, R, D]`` f32 (R = Qmax * rep rows
    of a (slot, kv head) group) -> ``out [S, Qmax, hq, D]`` in
    ``out_dtype``, rows past ``q_len`` zero.  The main kernel launches it
    itself after a split grid; this entry holds and times it alone.  CUDA
    tensors launch ``ragged_paged_attention_combine_launch`` and add one to
    ``ragged_paged_attention.combine_launches``; CPU tensors run
    :func:`ragged_paged_attention_combine_ref`."""
    if not _build.on_card("ragged_paged_attention_combine", acc):
        return ragged_paged_attention_combine_ref(ml, acc, q_len, hq,
                                                  out_dtype)
    n, s_slots, hkv, rows, d = acc.shape
    qmax = rows // (hq // hkv)
    if ml.shape != (n, s_slots, hkv, rows, 2) or head_width(d) is None \
            or out_dtype not in _build.DTYPE_CODE:
        raise ValueError(f"combine: ml {tuple(ml.shape)}, acc "
                         f"{tuple(acc.shape)}, out {out_dtype}")
    for t in (ml, acc, q_len):
        if not t.is_contiguous() or t.device != acc.device:
            raise ValueError("combine: ml, acc and q_len contiguous, on one "
                             "device")
    out = torch.empty(s_slots, qmax, hq, d, dtype=out_dtype,
                      device=acc.device)
    _build.launch(_build.width_library("ragged_paged_attention",
                                       head_width(d)),
                  "ragged_paged_attention_combine_launch",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7,
                  [ml.data_ptr(), acc.data_ptr(), q_len.data_ptr(),
                   out.data_ptr(), s_slots, qmax, hq, hkv, n, d,
                   _build.DTYPE_CODE[out_dtype]], acc.device)
    ragged_paged_attention.combine_launches += 1
    return out


def ragged_paged_attention_combine_ref(ml, acc, q_len, hq, out_dtype):
    """Plain version of the merge: per row, the splits with l > 0 weighted
    by exp2(m - max m), divided by their summed l (rows with none, and rows
    past ``q_len``, zero)."""
    n, s_slots, hkv, rows, d = acc.shape
    rep = hq // hkv
    qmax = rows // rep
    m, l = ml[..., 0], ml[..., 1]
    live = l > 0
    mx = torch.where(live, m, torch.full_like(m, -math.inf)).amax(0)
    w = torch.where(live, torch.exp2(m - mx), torch.zeros_like(m))
    den = (l * w).sum(0)
    o = torch.where(live[..., None], acc * w[..., None],
                    torch.zeros_like(acc)).sum(0)
    o = torch.where(den[..., None] > 0, o / den[..., None],
                    torch.zeros_like(o))
    o = o.reshape(s_slots, hkv, qmax, rep, d).permute(0, 2, 1, 3, 4) \
        .reshape(s_slots, qmax, hq, d)
    keep = torch.arange(qmax, device=o.device)[None, :, None, None] \
        < q_len.long()[:, None, None, None]
    return torch.where(keep, o, torch.zeros_like(o)).to(out_dtype)


def _byte_view(t):
    """A 1-byte page store as uint8: gathers and scatters move the codes
    bit for bit without needing float8 support in the index kernels."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def paged_gather_kv(pages, page_table):
    """Gather a slot-major dense view [S, P*ps, Hkv, D] out of the page pool
    (pages [Hkv, NP, ps, D], page_table [S, P]) — the plain version's dense
    reconstruction."""
    g = _byte_view(pages)[:, page_table.long()]    # [Hkv, S, P, ps, D]
    hkv, s, p, ps, d = g.shape
    return g.permute(1, 2, 3, 0, 4).reshape(s, p * ps, hkv, d) \
        .view(pages.dtype)


def paged_gather_scales(scales, page_table):
    """Scale-page analog of :func:`paged_gather_kv`: [Hkv, NP, ps] pages +
    [S, P] table -> slot-major [S, P*ps, Hkv] per-row scales."""
    g = scales[:, page_table.long()]              # [Hkv, S, P, ps]
    hkv, s, p, ps = g.shape
    return g.permute(1, 2, 3, 0).reshape(s, p * ps, hkv)


def ragged_paged_attention_ref(q, k_pages, v_pages, page_table, q_start,
                               q_len, kv_len, sm_scale=None, out_dtype=None,
                               k_scales=None, v_scales=None):
    """Plain PyTorch version with the kernel's semantics: gather the pages
    dense (dequantizing them by their scales and rounding to ``q.dtype``
    when scales are given), mask causally inside each slot's segment, zero
    padding query rows and q_len = 0 slots.  Masks with ``NEG_INF`` (not
    -inf), so a fully masked row softmaxes to a finite value that the q_len
    mask then zeroes.  Each call adds one to
    ``ragged_paged_attention_ref.calls``."""
    _check_common(q, k_pages, v_pages, k_scales, v_scales)
    ragged_paged_attention_ref.calls += 1
    s_slots, qmax, hq, d = q.shape
    hkv = k_pages.shape[0]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    k = paged_gather_kv(k_pages, page_table)      # [S, T, Hkv, D]
    v = paged_gather_kv(v_pages, page_table)
    if k_scales is not None:
        ks = paged_gather_scales(k_scales, page_table)   # [S, T, Hkv]
        vs = paged_gather_scales(v_scales, page_table)
        # one rounded value per stored row on every path of an engine,
        # as in the JAX reference (a no-op at f32)
        k = (k.float() * ks.float()[..., None]).to(q.dtype)
        v = (v.float() * vs.float()[..., None]).to(q.dtype)
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
