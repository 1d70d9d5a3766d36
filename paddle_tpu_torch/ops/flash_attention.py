"""Flash attention, forward and backward (port of
``paddle_tpu/ops/pallas/flash_attention.py``).

Layout: ``[B, S, H, D]`` at every public function, as in the JAX package.
The per-row statistics ``lse`` and ``delta`` are compact ``[B*Hq, S_q]``
f32, which on the card is byte for byte the TPU's packed
``[B*Hq, S_q/128, 128]`` layout.

Each kernel has a wrapper that launches the hand-written CUDA kernel of
``csrc/flash_attention.cuh`` for CUDA tensors and adds one to its
``launches`` counter, and runs its plain PyTorch version (``*_ref``) for CPU
tensors — the device of the tensors is the only thing that picks:

  ``flash_attention_fwd``      -> (o, lse)      TPU ``_fwd_kernel`` (+ the
                                                ``_pack_lse`` epilogue)
  ``pack_lse``                 [BH, S, 1] -> [BH, S]   TPU ``_pack_lse``
  ``flash_attention_bwd_dkv``  -> (dk, dv)      TPU ``_bwd_dkv_kernel``
  ``flash_attention_bwd_dq``   -> dq            TPU ``_bwd_dq_kernel``

:func:`flash_attention` is the differentiable op (a ``torch.autograd.Function``
that saves ``(q, k, v, o, lse)`` and never reruns the forward).  It returns
``None`` for shapes the kernels do not take (:func:`_supported`), so that
the caller runs plain attention, as the JAX dispatch does.

Segment ids (the TPU kernels' ``has_segments`` branch) run inside all
three kernels: with ``segment_ids`` [B, S] (s_q == s_k), a score whose q
row and key lie in different segments is NEG_INF, as in JAX; each
wrapper also counts those launches in ``.segment_launches``.  They are
how :func:`flash_attention` takes a long untileable sequence
(:func:`_pad_to_tile`: S >= 384 padded to the 128 tile, the padding in a
segment of its own) and how ``nn.functional.flash_attn_unpadded`` runs
packed varlen attention.  In bf16 the forward launches with segments, and
every dK/dV and dQ launch, with or without segments or dropout (but dK/dV
without segments at head dims 136-160), run wgmma bodies that class
every (q tile, key tile) pair before loading it — skipped, full or masked,
:func:`segment_tile_plan` at each body's :func:`segment_tiles` (without
segments only the causal frontier and the end of the keys count) — and
:func:`kernel_body` names the body a launch takes.

Head dims: every D that the JAX kernels take (a multiple of 8 up to 256)
runs on the card.  The kernels are compiled at the widths
:data:`HEAD_WIDTHS` (``csrc/flash_attention.cu``, one library for 64 and
128 and one for each other width: ``_build.WIDTH_LIBRARIES``); D runs at
:func:`head_width` (the narrowest width that holds it: D 40 at 48), with
columns D .. W zero in the kernels' shared tiles and never stored.

Attention dropout (the TPU kernels' ``dropout_rate > 0`` branch) runs
inside all three kernels: each score's keep bit is one 32-bit word of
Philox4x32-10 (:func:`philox4x32_10`), keyed by the 64-bit seed and
counted by the score's global coordinates (:func:`dropout_keep`), so the
backward kernels rebuild the forward's mask and the mask never reaches
device memory.  JAX's rule stays: keep iff ``word >= uint32(rate * 2**32)``
and kept probabilities scale by ``1 / (1 - rate)``; only ``P V`` and
``dP`` see the mask, ``l`` and ``lse`` keep the undropped ``p``.  The bits
are not the TPU PRNG's, which no other device can reproduce.  The wgmma
dK/dV and dQ draw a tile's words while its score products run and keep
one bit a score; which lane draws which call, and where its bits land, is
pinned on the CPU by ``tests/test_torch_flash_attention.py``'s model of
their fragments.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["HEAD_WIDTHS", "NEG_INF", "dropout_keep", "head_width", "dropout_scale", "dropout_threshold",
           "flash_attention", "flash_attention_ref",
           "flash_attention_fwd", "flash_attention_fwd_ref",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_ref",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_ref",
           "kernel_body", "pack_lse", "pack_lse_ref", "philox4x32_10",
           "segment_tile_plan", "segment_tiles", "TILE_SKIP", "TILE_FULL",
           "TILE_MASKED", "FWD_DESIGNS", "fwd_tile_order",
           "kernel_fwd_design"]

NEG_INF = -1e30

# the head widths the kernels are compiled at (csrc/flash_attention.cuh
# fa_width); a head dim runs at the narrowest that holds it
HEAD_WIDTHS = (32, 48, 64, 80, 96, 128, 160, 192, 256)


def head_width(d):
    """The width the kernels run head dim ``d`` at: the narrowest of
    :data:`HEAD_WIDTHS` that holds it, for a multiple of 8 up to 256 (the
    head dims the JAX kernels take); ``None`` for any other ``d``."""
    if d <= 0 or d % 8 or d > 256:
        return None
    return next(w for w in HEAD_WIDTHS if w >= d)


def _supported(q_shape, k_shape, causal=False):
    """The shapes the JAX package sends to its kernel (``_supported``):
    GQA head counts, D a multiple of 8 up to 256, no causal s_q > s_k,
    sequence lengths multiples of 128."""
    b, s_q, h, d = q_shape
    s_k = k_shape[1]
    hkv = k_shape[2]
    if h % hkv != 0:
        return False
    if d > 256 or d % 8 != 0:
        return False
    if causal and s_q > s_k:
        return False
    return s_q % 128 == 0 and s_k % 128 == 0


def _mask(s_q, s_k, device):
    """Bottom-right-aligned causal mask [s_q, s_k]: row i sees key j iff
    i + s_k - s_q >= j."""
    qi = torch.arange(s_q, device=device)[:, None]
    kj = torch.arange(s_k, device=device)[None, :]
    return qi + (s_k - s_q) >= kj


def _rep_kv(k, hq):
    hkv = k.shape[2]
    return k if hkv == hq else k.repeat_interleave(hq // hkv, dim=2)


def _heads_first(x):
    """[B, S, H, D] -> [B*H, S, D] float32."""
    b, s, h, d = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b * h, s, d)


def _seq_first(x, b, h, dtype):
    """[B*H, S, D] -> [B, S, H, D] in dtype."""
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3).to(dtype).contiguous()


def _scores(q, k, causal, sm_scale, segment_ids=None):
    """f32 scores [B*Hq, S_q, S_k] with masked entries at NEG_INF: past the
    causal frontier, and, with ``segment_ids`` [B, S], between a q row and
    a key of different segments (the ids compared as f32, as JAX does)."""
    hq = q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", _heads_first(q),
                     _heads_first(_rep_kv(k, hq))) * sm_scale
    if causal:
        s = torch.where(_mask(q.shape[1], k.shape[1], q.device), s,
                        torch.full_like(s, NEG_INF))
    if segment_ids is not None:
        seg = segment_ids.float()
        same = (seg[:, :, None] == seg[:, None, :]).repeat_interleave(hq,
                                                                      dim=0)
        s = torch.where(same, s, torch.full_like(s, NEG_INF))
    return s


# -- the dropout mask --------------------------------------------------------
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)      # Random123's Philox4x32 constants
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK_CHUNK = 1 << 24                     # Philox calls per pass of the mask


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of a * m for int64 a in [0, 2**32) and a
    constant m < 2**32, through m's 16-bit halves so that no product passes
    2**49 (int64 has no unsigned 64-bit product)."""
    x, y = a * (m >> 16), a * (m & 0xFFFF)
    return (x + (y >> 16)) >> 16, (((x & 0xFFFF) << 16) + y) & _M32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's ``philox4x32``):
    four counter words (int64 tensors, broadcastable, or ints) and two key
    words (ints) -> the four 32-bit output words as int64 tensors in
    [0, 2**32).  Runs on whatever device the counter lies on."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _M32
                      for c in counter)
    k0, k1 = (int(k) & _M32 for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def dropout_threshold(rate):
    """The keep threshold: a score is kept iff its word >= this (JAX's
    ``uint32(rate * 2**32)``), so P(keep) = 1 - rate."""
    return int(rate * 4294967296.0)


def dropout_scale(rate):
    """The kept probabilities' factor, 1 / (1 - rate) rounded as f32 (JAX's
    ``keep.astype(float32) / (1 - rate)``)."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _seed_words(seed):
    seed = int(seed)
    return seed & _M32, (seed >> 32) & _M32


def dropout_keep(seed, bhq, rows, cols, rate):
    """The attention-dropout keep mask, bool [len(bhq), len(rows),
    len(cols)], of the scores of q-head rows ``bhq`` (b * Hq + h), query
    indices ``rows`` and key indices ``cols`` (1-D int sequences or
    tensors; the mask lies on their device).

    Each score takes one full 32-bit word of Philox4x32-10 keyed by the
    64-bit ``seed`` (low word, high word).  Key columns come in groups of
    16, and the columns {2t, 2t+1, 8+2t, 9+2t} of a group share one call
    (the 4 score columns one thread holds in an m16n8k16 fragment), which
    takes the counter (4 * (col // 16) + t, row, bhq, 0) and gives them its
    words 0, 1, 2, 3 in that order.  The mask is a function of the
    coordinates alone, so every kernel rebuilds it however it tiles."""
    dev = torch.as_tensor(cols).device
    bhq, rows, cols = (torch.as_tensor(x, dtype=torch.int64,
                                       device=dev).reshape(-1)
                       for x in (bhq, rows, cols))
    out = torch.empty((len(bhq), len(rows), len(cols)), dtype=torch.bool,
                      device=dev)
    if rate <= 0.0:
        return out.fill_(True)
    cell = (cols >> 4) * 4 + ((cols & 7) >> 1)
    word = ((cols >> 3) & 1) * 2 + (cols & 1)
    ucell, inv = torch.unique(cell, return_inverse=True)
    thresh, key = dropout_threshold(rate), _seed_words(seed)
    step = max(1, _MASK_CHUNK // max(1, len(rows) * len(ucell)))
    for i in range(0, len(bhq), step):
        words = torch.stack(philox4x32_10(
            (ucell[None, None, :], rows[None, :, None],
             bhq[i:i + step, None, None], 0), key), dim=-1)
        out[i:i + step] = words[:, :, inv, word] >= thresh
    return out


def _drop_factor(seed, b, hq, s_q, s_k, rate, device):
    """[B*Hq, S_q, S_k] f32: 1 / (1 - rate) where the score is kept, else
    0."""
    keep = dropout_keep(seed, torch.arange(b * hq, device=device),
                        torch.arange(s_q, device=device),
                        torch.arange(s_k, device=device), rate)
    return torch.where(keep, dropout_scale(rate), 0.0)


# -- plain versions ----------------------------------------------------------
def flash_attention_fwd_ref(q, k, v, causal, sm_scale, dropout_rate=0.0,
                            seed=0, segment_ids=None):
    """The forward kernel's function in plain PyTorch: o [B, S_q, Hq, D] in
    q's dtype and lse [B*Hq, S_q] f32, with the kernel's finalize rules
    (o = acc / l where l > 0, lse = m + log(max(l, 1e-30))).  With
    dropout, P V takes p * keep / (1 - rate) under :func:`dropout_keep`;
    l and lse keep the undropped p (the TPU kernel's rule).  With
    ``segment_ids`` [B, S], attention stays within equal ids."""
    b, _, hq, _ = q.shape
    s = _scores(q, k, causal, sm_scale, segment_ids)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        p = p * _drop_factor(seed, b, hq, q.shape[1], k.shape[1],
                             dropout_rate, q.device)
    acc = torch.einsum("bqk,bkd->bqd", p, _heads_first(_rep_kv(v, hq)))
    o = torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(acc))
    lse = (m + torch.log(l.clamp(min=1e-30)))[..., 0]
    return _seq_first(o, b, hq, q.dtype), lse.contiguous()


def pack_lse_ref(lse3):
    """[BH, S, 1] -> compact [BH, S] f32 (the TPU's packed layout)."""
    return lse3[..., 0].float().contiguous()


def _p_and_ds(q, k, v, do, lse, delta, causal, sm_scale, dropout_rate,
              seed, segment_ids):
    """The backward's recomputed p = exp(s - lse) (times the keep factor
    under dropout: dV's p) and ds = p * (dp * factor - delta) * sm_scale
    (delta = rowsum(do * o) keeps its form: o holds the mask), s masked
    as the forward's, [B*Hq, S_q, S_k] f32."""
    b, _, hq, _ = q.shape
    p = torch.exp(_scores(q, k, causal, sm_scale, segment_ids)
                  - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", _heads_first(do),
                      _heads_first(_rep_kv(v, hq)))
    pd = p
    if dropout_rate > 0.0:
        f = _drop_factor(seed, b, hq, q.shape[1], k.shape[1], dropout_rate,
                         q.device)
        pd, dp = p * f, dp * f
    return pd, p * (dp - delta[..., None]) * sm_scale


def _sum_groups(x, b, hq, hkv):
    """[B*Hq, S, D] -> [B*Hkv, S, D], summing the q heads of each kv
    head."""
    _, s, d = x.shape
    return x.reshape(b, hkv, hq // hkv, s, d).sum(dim=2).reshape(b * hkv, s, d)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal, sm_scale,
                                dropout_rate=0.0, seed=0, segment_ids=None):
    """dK and dV (FA2 formulas from the saved lse and delta, summed over the
    GQA group) in k's and v's dtypes, [B, S_k, Hkv, D]; under dropout dV
    takes the masked p and ds the masked dp (the forward's mask, rebuilt
    from the seed); ``segment_ids`` mask as in the forward."""
    b, _, hq, _ = q.shape
    hkv = k.shape[2]
    p, ds = _p_and_ds(q, k, v, do, lse, delta, causal, sm_scale,
                      dropout_rate, seed, segment_ids)
    dv = _sum_groups(torch.einsum("bqk,bqd->bkd", p, _heads_first(do)),
                     b, hq, hkv)
    dk = _sum_groups(torch.einsum("bqk,bqd->bkd", ds, _heads_first(q)),
                     b, hq, hkv)
    return _seq_first(dk, b, hkv, k.dtype), _seq_first(dv, b, hkv, v.dtype)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal, sm_scale,
                               dropout_rate=0.0, seed=0, segment_ids=None):
    """dQ (FA2 formula from the saved lse and delta, the masked dp under
    dropout, ``segment_ids`` masking as in the forward) in q's dtype."""
    b, _, hq, _ = q.shape
    _, ds = _p_and_ds(q, k, v, do, lse, delta, causal, sm_scale,
                      dropout_rate, seed, segment_ids)
    dq = torch.einsum("bqk,bkd->bqd", ds, _heads_first(_rep_kv(k, hq)))
    return _seq_first(dq, b, hq, q.dtype)


def flash_attention_ref(q, k, v, causal=False):
    """The JAX package's ``flash_attention_ref``: [B, S, H, D], GQA by
    repeating K/V, f32 softmax, probabilities cast to q's dtype."""
    d = q.shape[-1]
    hq = q.shape[2]
    k, v = _rep_kv(k, hq), _rep_kv(v, hq)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        s = torch.where(_mask(s.shape[-2], s.shape[-1], q.device), s,
                        torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# -- kernel launches ---------------------------------------------------------
def _as_rows(x):
    """Rows as the kernels read them: unit stride along D, and 16-byte
    aligned rows (the bf16 kernels stage them in 16-byte vectors); other
    strides stay."""
    vec = 16 // x.element_size()
    aligned = x.data_ptr() % 16 == 0 and all(s % vec == 0
                                             for s in x.stride()[:3])
    return x if x.stride(-1) == 1 and aligned else x.contiguous()


def _check(name, tensors, dtype=None):
    dev = tensors[0].device
    dtype = tensors[0].dtype if dtype is None else dtype
    if dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: q, k, v (and dout) must share one "
                            f"dtype, got {t.dtype} and {dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: want [B, S, H, D], got "
                             f"{tuple(t.shape)}")
    d = tensors[0].shape[-1]
    if head_width(d) is None:
        raise ValueError(f"{name}: head dim {d} not supported by the kernel "
                         f"(a multiple of 8 up to 256, as the JAX kernels)")
    return dev


def _geometry(q, k):
    b, s_q, hq, d = q.shape
    _, s_k, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"form a (GQA) attention")
    return b, hq, hkv, s_q, s_k, d


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stats(x, bh, s_q, name):
    if x.shape != (bh, s_q) or x.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 [B*Hq={bh}, S_q={s_q}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _dropout_args(rate, seed):
    """The C entries' dropout arguments: (threshold, 1 / (1 - rate), seed
    low word, seed high word); a threshold of 0 launches the kernels
    without the dropout branch."""
    if rate <= 0.0:
        return 0, 1.0, 0, 0
    return (dropout_threshold(rate), dropout_scale(rate), *_seed_words(seed))


def _segments(segment_ids, b, s_q, s_k, dev):
    """(buffer, pointer) of the segment ids as the C entries take them: a
    contiguous f32 [B, S] buffer on the card (compared as f32, as JAX
    compares them), or (None, 0) without segments, which launches the
    kernels without the segment branch."""
    if segment_ids is None:
        return None, 0
    if s_q != s_k or tuple(segment_ids.shape) != (b, s_q):
        raise ValueError(f"segment_ids must be [B={b}, S={s_q}] with s_q == "
                         f"s_k ({s_k}), got {tuple(segment_ids.shape)}")
    seg = segment_ids.to(device=dev, dtype=torch.float32).contiguous()
    return seg, seg.data_ptr()


# the classes of segment_tile_plan, as the kernels number them
TILE_SKIP, TILE_FULL, TILE_MASKED = 0, 1, 2


def segment_tile_plan(seg, s_q, s_k, bq, bk, causal):
    """The class of every (q tile, key tile) pair, int64 [B, ceil(s_q / bq),
    ceil(s_k / bk)], by the rule every launch of the bf16 wgmma bodies
    (:func:`kernel_body`) applies before it loads a tile
    (``csrc/flash_attention.cuh tile_class``): ``seg`` [B, S] (or None: no
    segments, the plan of the dK/dV and dQ launches without them, where
    only the causal frontier skips and masks and the end of the keys
    masks), q tiles of ``bq`` rows, key tiles of ``bk``.

    With the [min, max] of the tile's row ids and of its key ids (only rows
    inside s_q and keys inside s_k count), a pair is
    :data:`TILE_SKIP` when the ranges are disjoint (no pair shares an id) or
    the key tile lies wholly past the causal frontier of the tile's last
    row; :data:`TILE_FULL` when both ranges are one and the same value, no
    key is past the frontier of the tile's first row and none past s_k;
    else :data:`TILE_MASKED`.  The kernels compute no skipped tile (nor load
    one that no consumer of the block needs), take the unmasked path on a
    full one and mask a masked one per score, each at its own tiles
    (:func:`segment_tiles`): the forward and dQ at bq = 128 q rows, bk = 64
    keys (dQ at bq = 64 above W 128); dK/dV at bk = 64 against q tiles of
    64 rows (32 above W 64)."""
    n_qt, n_kt = -(-s_q // bq), -(-s_k // bk)
    b = 1 if seg is None else seg.shape[0]
    r0 = torch.arange(n_qt)[:, None] * bq
    r_last = torch.clamp(r0 + bq, max=s_q) - 1
    c0 = torch.arange(n_kt)[None, :] * bk
    offset = s_k - s_q
    beyond = (c0 > r_last + offset) if causal \
        else torch.zeros(n_qt, n_kt, dtype=torch.bool)
    crossing = (c0 + bk - 1 > r0 + offset) if causal \
        else torch.zeros(n_qt, n_kt, dtype=torch.bool)
    masked = (crossing | (c0 + bk > s_k)).expand(b, n_qt, n_kt)
    skip = beyond.expand(b, n_qt, n_kt)
    if seg is not None:
        seg = seg.detach().to("cpu", torch.float32)

        def ranges(ids, n, t):
            pad = (-n) % t
            lo = torch.nn.functional.pad(ids[:, :n], (0, pad),
                                         value=float("inf"))
            hi = torch.nn.functional.pad(ids[:, :n], (0, pad),
                                         value=float("-inf"))
            return (lo.reshape(b, -1, t).amin(-1),
                    hi.reshape(b, -1, t).amax(-1))

        rlo, rhi = ranges(seg, s_q, bq)
        klo, khi = ranges(seg, s_k, bk)
        rlo, rhi = rlo[:, :, None], rhi[:, :, None]
        klo, khi = klo[:, None, :], khi[:, None, :]
        skip = skip | (khi < rlo) | (klo > rhi)
        masked = masked | ~((rlo == rhi) & (klo == khi) & (rlo == klo))
    return torch.where(skip, TILE_SKIP,
                       torch.where(masked, TILE_MASKED, TILE_FULL))


def segment_tiles(which, head_dim):
    """(bq, bk) of the bf16 wgmma body of ``which`` ("fwd", "bwd_dkv" or
    "bwd_dq") at ``head_dim``, with or without segments: the q rows and
    keys of the tile pairs it classes (:func:`segment_tile_plan`), as
    ``csrc/flash_attention.cuh`` sizes them from the head width W.  The
    forward's segment branch classes 128 q rows against 64 keys (without
    segments, the design of the launch: :func:`kernel_fwd_design`); dK/dV
    a q tile of 64 rows (32 above W 64) against each consumer's 64 keys; dQ
    128 q rows (64 above W 128, where a block holds 64 rows) against 64
    keys."""
    w = head_width(head_dim)
    if w is None or which not in ("fwd", "bwd_dkv", "bwd_dq"):
        raise ValueError(f"no segment body {which!r} at head dim {head_dim}")
    return {"fwd": (128, 64), "bwd_dkv": (64 if w <= 64 else 32, 64),
            "bwd_dq": (128 if w <= 128 else 64, 64)}[which]


# The bf16 forward's designs, numbered as ``csrc/flash_attention.cuh``
# numbers them, by two bits (1: 128 keys a tile, else 64; 2: a persistent
# grid): (q rows a block, keys a tile, persistent grid).  A block holds 128
# q rows in two consumer groups, one block an SM; a persistent grid holds
# one block an SM, which walks the q tiles (:func:`fwd_tile_order`).
FWD_DESIGNS = tuple((128, 128 if ds & 1 else 64, bool(ds & 2))
                    for ds in range(4))


def fwd_tile_order(batch_heads, s_q, bq, blocks=None):
    """The q tiles each block of the forward takes, in order: one list per
    block of (batch x q-head row, q tile index).  Tile i of the launch is q
    tile n_qt - 1 - i // BH of row i % BH (the tiles with the most key
    tiles first, when causal); block j takes tile j, or with a persistent
    grid of ``blocks`` blocks tiles j, j + blocks, j + 2 blocks, ..."""
    n_qt = -(-s_q // bq)
    n = batch_heads * n_qt
    step = n if blocks is None else blocks
    return [[(i % batch_heads, n_qt - 1 - i // batch_heads)
             for i in range(j, n, step)] for j in range(min(step, n))]


def kernel_fwd_design(batch, hq, s_q, s_k, head_dim, causal, segments):
    """The design (an index of :data:`FWD_DESIGNS`) that the library's
    dispatch gives a bf16 forward launch (the C entry
    ``flash_attention_fwd_design``, which picks it from the launch's q
    tiles against the card's SMs and the rings that fit its width)."""
    fn = getattr(_build.library(_build.width_library(
        "flash_attention", head_width(head_dim))),
        "flash_attention_fwd_design")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 7
    return fn(batch, hq, s_q, s_k, head_dim, int(bool(causal)),
              int(bool(segments)))


def kernel_body(which, dtype, head_dim, segments, dropout):
    """The body that a launch of ``which`` ("fwd", "bwd_dkv" or "bwd_dq")
    takes on the card for q's ``dtype``, ``head_dim`` and the two branches
    (``segments``, ``dropout``: bools): "cuda cores" (f32), "mma.sync" or
    "wgmma".  In bf16, at every head dim: the forward and dQ take wgmma
    with or without segments and dropout; dK/dV too, but for dK/dV without
    segments at width 160 (head dims 136-160), with or without dropout,
    which keeps mma.sync, where it measured faster.  Read from the library's own dispatch (the C entry
    ``flash_attention_body``, per launch), so it names what the launch
    runs."""
    code = getattr(_build.library(_build.width_library(
        "flash_attention", head_width(head_dim))), "flash_attention_body")
    code.restype = ctypes.c_int
    code.argtypes = [ctypes.c_int] * 5
    body = code(("fwd", "bwd_dkv", "bwd_dq").index(which), head_dim,
                _build.DTYPE_CODE[dtype], int(bool(segments)),
                int(bool(dropout)))
    if body < 0:
        raise ValueError(f"no {which} body for {dtype} at head dim "
                         f"{head_dim}")
    return ("cuda cores", "mma.sync", "wgmma")[body]


def _call(fn_name, ptrs, strides, ints, sm_scale, dropout, seg, dev):
    # ints: b, hq, hkv, s_q, s_k, d, dtype, causal
    _build.launch(_build.width_library("flash_attention",
                                       head_width(ints[5])), fn_name,
                  [ctypes.c_void_p] * (len(ptrs) + 1)
                  + [ctypes.c_int] * len(ints)
                  + [ctypes.c_float, ctypes.c_uint, ctypes.c_float,
                     ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p],
                  [*ptrs, ctypes.cast(strides, ctypes.c_void_p), *ints,
                   float(sm_scale), *dropout, seg], dev)


def _count(fn, dropout_rate, segment_ids):
    fn.launches += 1
    if dropout_rate > 0.0:
        fn.dropout_launches += 1
    if segment_ids is not None:
        fn.segment_launches += 1


def flash_attention_fwd(q, k, v, causal, sm_scale, dropout_rate=0.0,
                        seed=0, segment_ids=None):
    """q [B, S_q, Hq, D], k/v [B, S_k, Hkv, D] -> (o [B, S_q, Hq, D] in q's
    dtype, lse [B*Hq, S_q] f32).  CUDA tensors (f32 or bf16, D a multiple
    of 8 up to 256) launch ``flash_attention_fwd_launch`` of the library of
    D's width (:func:`head_width`) and add one to
    ``flash_attention_fwd.launches`` (and, with ``dropout_rate`` > 0, to
    ``.dropout_launches``: the kernel's dropout branch, masked by
    :func:`dropout_keep` of ``seed``; with ``segment_ids`` [B, S], to
    ``.segment_launches``: its segment branch); CPU tensors run
    :func:`flash_attention_fwd_ref`."""
    if not _build.on_card("flash_attention_fwd", q):
        return flash_attention_fwd_ref(q, k, v, causal, sm_scale,
                                       dropout_rate, seed, segment_ids)
    q, k, v = _as_rows(q), _as_rows(k), _as_rows(v)
    dev = _check("flash_attention_fwd", (q, k, v))
    b, hq, hkv, s_q, s_k, d = _geometry(q, k)
    seg, seg_ptr = _segments(segment_ids, b, s_q, s_k, dev)
    o = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((b * hq, s_q), dtype=torch.float32, device=dev)
    _call("flash_attention_fwd_launch",
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr()], _strides(q, k, v, o),
          [b, hq, hkv, s_q, s_k, d, _build.DTYPE_CODE[q.dtype],
           int(bool(causal))],
          sm_scale, _dropout_args(dropout_rate, seed), seg_ptr, dev)
    _count(flash_attention_fwd, dropout_rate, seg)
    return o, lse


def pack_lse(lse3):
    """Per-row stats ``[BH, S, 1]`` (any strides) -> compact ``[BH, S]`` f32.
    CUDA tensors launch ``pack_lse_launch`` and add one to
    ``pack_lse.launches``; CPU tensors run :func:`pack_lse_ref`.  The
    forward writes this layout itself; the entry is for stats that arrive
    3-D, as the JAX backward accepts them."""
    if lse3.dim() != 3 or lse3.shape[-1] != 1:
        raise ValueError(f"pack_lse wants [BH, S, 1], got "
                         f"{tuple(lse3.shape)}")
    if not _build.on_card("pack_lse", lse3):
        return pack_lse_ref(lse3)
    if lse3.dtype != torch.float32:
        raise TypeError(f"pack_lse takes float32 stats, got {lse3.dtype}")
    bh, s, _ = lse3.shape
    out = torch.empty((bh, s), dtype=torch.float32, device=lse3.device)
    _build.launch("flash_attention", "pack_lse_launch",
                  [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4,
                  [lse3.data_ptr(), out.data_ptr(), bh, s, lse3.stride(0),
                   lse3.stride(1)], lse3.device)
    pack_lse.launches += 1
    return out


def _bwd_launch(fn_name, q, k, v, do, lse, delta, causal, sm_scale,
                dropout_rate, seed, segment_ids, outs):
    q, k, v, do = (_as_rows(t) for t in (q, k, v, do))
    dev = _check(fn_name, (q, k, v, do))
    b, hq, hkv, s_q, s_k, d = _geometry(q, k)
    seg, seg_ptr = _segments(segment_ids, b, s_q, s_k, dev)
    lse = _stats(lse, b * hq, s_q, "lse")
    delta = _stats(delta, b * hq, s_q, "delta")
    grads = [torch.empty(like.shape, dtype=like.dtype, device=dev)
             for like in outs]
    _call(fn_name,
          [t.data_ptr() for t in (q, k, v, do, lse, delta, *grads)],
          _strides(q, k, v, do, *grads),
          [b, hq, hkv, s_q, s_k, d, _build.DTYPE_CODE[q.dtype],
           int(bool(causal))],
          sm_scale, _dropout_args(dropout_rate, seed), seg_ptr, dev)
    return grads, seg


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale,
                            dropout_rate=0.0, seed=0, segment_ids=None):
    """(dk, dv) [B, S_k, Hkv, D] from the saved lse and
    ``delta = rowsum(do * o)`` (both [B*Hq, S_q] f32), under the forward's
    dropout mask when ``dropout_rate`` > 0 (rebuilt from ``seed``) and its
    segments.  CUDA tensors launch ``flash_attention_bwd_dkv_launch`` and
    add one to ``flash_attention_bwd_dkv.launches`` (and
    ``.dropout_launches``, ``.segment_launches``); CPU tensors run
    :func:`flash_attention_bwd_dkv_ref`."""
    if not _build.on_card("flash_attention_bwd_dkv", q):
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                           sm_scale, dropout_rate, seed,
                                           segment_ids)
    (dk, dv), seg = _bwd_launch("flash_attention_bwd_dkv_launch", q, k, v,
                                do, lse, delta, causal, sm_scale,
                                dropout_rate, seed, segment_ids, (k, v))
    _count(flash_attention_bwd_dkv, dropout_rate, seg)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale,
                           dropout_rate=0.0, seed=0, segment_ids=None):
    """dq [B, S_q, Hq, D]; arguments as :func:`flash_attention_bwd_dkv`.
    CUDA tensors launch ``flash_attention_bwd_dq_launch`` and add one to
    ``flash_attention_bwd_dq.launches`` (and ``.dropout_launches``,
    ``.segment_launches``); CPU tensors run
    :func:`flash_attention_bwd_dq_ref`."""
    if not _build.on_card("flash_attention_bwd_dq", q):
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal,
                                          sm_scale, dropout_rate, seed,
                                          segment_ids)
    (dq,), seg = _bwd_launch("flash_attention_bwd_dq_launch", q, k, v, do,
                             lse, delta, causal, sm_scale, dropout_rate, seed,
                             segment_ids, (q,))
    _count(flash_attention_bwd_dq, dropout_rate, seg)
    return dq


for _fn in (flash_attention_fwd, flash_attention_bwd_dkv,
            flash_attention_bwd_dq):
    _fn.launches = _fn.dropout_launches = _fn.segment_launches = 0
pack_lse.launches = 0


def _bwd_call(res, g, causal, sm_scale, delta=None, dropout_rate=0.0,
              seed=0, segment_ids=None):
    """The JAX ``_bwd_call``: (dq, dk, dv) from the forward's residuals
    ``(q, k, v, o, lse)`` and the output cotangent ``g``, under the
    forward's dropout mask (rate and seed) and segments when it had them.
    delta = rowsum(g * o) in f32 unless the caller passes it; 3-D
    [BH, S, 1] stats are packed first."""
    q, k, v, o, lse = res
    b, s_q, hq, _ = q.shape
    if delta is None:
        delta = (g.float() * o.float()).sum(dim=-1) \
            .permute(0, 2, 1).reshape(b * hq, s_q)
    if lse.dim() == 3:
        lse = pack_lse(lse)
    if delta.dim() == 3:
        delta = pack_lse(delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal,
                                     sm_scale, dropout_rate, seed,
                                     segment_ids)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal, sm_scale,
                                dropout_rate, seed, segment_ids)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX ``_make_op`` custom VJP: the forward saves (q, k, v, o, lse)
    and, under dropout, the rate and the seed, and the segment ids; the
    backward runs the two backward kernels on them, which rebuild the mask
    — the forward is never rerun and the mask is never stored.  The segment
    ids are not differentiable (their gradient is None)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, dropout_rate, seed, segment_ids):
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale, dropout_rate,
                                     seed, segment_ids)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.dropout_rate, ctx.seed = dropout_rate, seed
        ctx.segment_ids = segment_ids
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_call((q, k, v, o, lse), g.contiguous(), ctx.causal,
                               ctx.sm_scale, dropout_rate=ctx.dropout_rate,
                               seed=ctx.seed, segment_ids=ctx.segment_ids)
        return dq, dk, dv, None, None, None, None


def _draw_seed(generator):
    """A 64-bit dropout seed from a host ``torch.Generator`` (a CPU draw:
    the step never waits for the card)."""
    if generator is None or generator.device.type != "cpu":
        raise ValueError("attention dropout draws its seed from an explicit "
                         "host (CPU) torch.Generator; got "
                         f"{None if generator is None else generator.device}")
    return int(torch.empty((), dtype=torch.int64).random_(
        generator=generator))


def _pad_to_tile(q, k, v, segment_ids):
    """The JAX ``_pad_to_tile``: q, k, v [B, S, H, D] padded with zero rows
    to the next multiple of 128, and the segment ids (zeros when None) as
    f32 [B, S_padded] with the padding in segment -1, which no real id
    takes, so real rows never attend it.  Returns (q, k, v, segment ids,
    S)."""
    s = q.shape[1]
    pad = (-s) % 128
    qp, kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                  for x in (q, k, v))
    seg = torch.zeros((q.shape[0], s), dtype=torch.float32, device=q.device) \
        if segment_ids is None else segment_ids.float()
    segp = torch.nn.functional.pad(seg, (0, pad), value=-1.0)
    return qp, kp, vp, segp, s


def flash_attention(q, k, v, causal=False, segment_ids=None,
                    dropout_rate=0.0, dropout_seed=None, generator=None):
    """[B, S, H, D] flash attention (GQA when k/v carry fewer heads);
    returns ``None`` for shapes the JAX package does not send to its kernel
    (:func:`_supported`), so that the caller runs plain attention.  An
    untileable S = s_q = s_k of at least 384 is padded to the 128 tile
    (:func:`_pad_to_tile`) and the output cut back to S.

    ``segment_ids`` [B, S] (any numeric dtype) keeps attention within equal
    ids, the varlen mask; it needs s_q == s_k (else ``None``).

    ``dropout_rate`` > 0 drops attention probabilities inside the kernels
    under :func:`dropout_keep` of ``dropout_seed`` (an int; ``None`` draws
    one from ``generator``, a host ``torch.Generator``, so that every call
    gets a fresh mask, as JAX's draws a fresh seed); a rate of 1 or more
    returns zeros, as JAX's does."""
    drop = float(dropout_rate or 0.0)
    if drop >= 1.0:
        return torch.zeros_like(q)
    unpad_to = None
    if not _supported(q.shape, k.shape, causal):
        s_q, s_k = q.shape[1], k.shape[1]
        # the JAX rule: pad only long sequences; at short S its padded
        # kernel lost to plain attention
        tileable = (s_q == s_k and s_q % 128 != 0 and s_q >= 384
                    and _supported(q.shape[:1] + (128,) + q.shape[2:],
                                   k.shape[:1] + (128,) + k.shape[2:],
                                   causal))
        if not tileable:
            return None
        q, k, v, segment_ids, unpad_to = _pad_to_tile(q, k, v, segment_ids)
    if segment_ids is not None:
        if q.shape[1] != k.shape[1]:
            return None
        segment_ids = segment_ids.float()
    seed = 0
    if drop > 0.0:
        seed = _draw_seed(generator) if dropout_seed is None \
            else int(dropout_seed)
    out = _FlashAttention.apply(q, k, v, bool(causal), drop, seed,
                                segment_ids)
    return out if unpad_to is None else out[:, :unpad_to]
