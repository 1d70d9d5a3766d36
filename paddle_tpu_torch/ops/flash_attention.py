"""Flash attention, forward and backward (port of
``paddle_tpu/ops/pallas/flash_attention.py``).

Layout: ``[B, S, H, D]`` at every public function, as in the JAX package.
The per-row statistics ``lse`` and ``delta`` are compact ``[B*Hq, S_q]``
f32, which on the card is byte for byte the TPU's packed
``[B*Hq, S_q/128, 128]`` layout.

Each kernel has a wrapper that launches the hand-written CUDA kernel of
``csrc/flash_attention.cu`` for CUDA tensors and adds one to its
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
the caller runs plain attention, as the JAX dispatch does.  Segment ids,
in-kernel dropout and the pad-to-tile path of the JAX op are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["NEG_INF", "flash_attention", "flash_attention_ref",
           "flash_attention_fwd", "flash_attention_fwd_ref",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_ref",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_ref",
           "pack_lse", "pack_lse_ref"]

NEG_INF = -1e30

_HEAD_DIMS = (64, 128)


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


def _scores(q, k, causal, sm_scale):
    """f32 scores [B*Hq, S_q, S_k] with masked entries at NEG_INF."""
    hq = q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", _heads_first(q),
                     _heads_first(_rep_kv(k, hq))) * sm_scale
    if causal:
        s = torch.where(_mask(q.shape[1], k.shape[1], q.device), s,
                        torch.full_like(s, NEG_INF))
    return s


# -- plain versions ----------------------------------------------------------
def flash_attention_fwd_ref(q, k, v, causal, sm_scale):
    """The forward kernel's function in plain PyTorch: o [B, S_q, Hq, D] in
    q's dtype and lse [B*Hq, S_q] f32, with the kernel's finalize rules
    (o = acc / l where l > 0, lse = m + log(max(l, 1e-30)))."""
    b, _, hq, _ = q.shape
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqk,bkd->bqd", p, _heads_first(_rep_kv(v, hq)))
    o = torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(acc))
    lse = (m + torch.log(l.clamp(min=1e-30)))[..., 0]
    return _seq_first(o, b, hq, q.dtype), lse.contiguous()


def pack_lse_ref(lse3):
    """[BH, S, 1] -> compact [BH, S] f32 (the TPU's packed layout)."""
    return lse3[..., 0].float().contiguous()


def _p_and_ds(q, k, v, do, lse, delta, causal, sm_scale):
    """The backward's recomputed p = exp(s - lse) and
    ds = p * (dp - delta) * sm_scale, [B*Hq, S_q, S_k] f32."""
    hq = q.shape[2]
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", _heads_first(do),
                      _heads_first(_rep_kv(v, hq)))
    return p, p * (dp - delta[..., None]) * sm_scale


def _sum_groups(x, b, hq, hkv):
    """[B*Hq, S, D] -> [B*Hkv, S, D], summing the q heads of each kv
    head."""
    _, s, d = x.shape
    return x.reshape(b, hkv, hq // hkv, s, d).sum(dim=2).reshape(b * hkv, s, d)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal, sm_scale):
    """dK and dV (FA2 formulas from the saved lse and delta, summed over the
    GQA group) in k's and v's dtypes, [B, S_k, Hkv, D]."""
    b, _, hq, _ = q.shape
    hkv = k.shape[2]
    p, ds = _p_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
    dv = _sum_groups(torch.einsum("bqk,bqd->bkd", p, _heads_first(do)),
                     b, hq, hkv)
    dk = _sum_groups(torch.einsum("bqk,bqd->bkd", ds, _heads_first(q)),
                     b, hq, hkv)
    return _seq_first(dk, b, hkv, k.dtype), _seq_first(dv, b, hkv, v.dtype)


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal, sm_scale):
    """dQ (FA2 formula from the saved lse and delta) in q's dtype."""
    b, _, hq, _ = q.shape
    _, ds = _p_and_ds(q, k, v, do, lse, delta, causal, sm_scale)
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
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported by the kernel "
                         f"(one of {_HEAD_DIMS})")
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


def _call(fn_name, ptrs, strides, ints, sm_scale, dev):
    _build.launch("flash_attention", fn_name,
                  [ctypes.c_void_p] * (len(ptrs) + 1)
                  + [ctypes.c_int] * len(ints) + [ctypes.c_float],
                  [*ptrs, ctypes.cast(strides, ctypes.c_void_p), *ints,
                   float(sm_scale)], dev)


def flash_attention_fwd(q, k, v, causal, sm_scale):
    """q [B, S_q, Hq, D], k/v [B, S_k, Hkv, D] -> (o [B, S_q, Hq, D] in q's
    dtype, lse [B*Hq, S_q] f32).  CUDA tensors (f32 or bf16, D in
    {64, 128}) launch ``flash_attention_fwd_launch`` and add one to
    ``flash_attention_fwd.launches``; CPU tensors run
    :func:`flash_attention_fwd_ref`."""
    if not _build.on_card("flash_attention_fwd", q):
        return flash_attention_fwd_ref(q, k, v, causal, sm_scale)
    q, k, v = _as_rows(q), _as_rows(k), _as_rows(v)
    dev = _check("flash_attention_fwd", (q, k, v))
    b, hq, hkv, s_q, s_k, d = _geometry(q, k)
    o = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((b * hq, s_q), dtype=torch.float32, device=dev)
    _call("flash_attention_fwd_launch",
          [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr()], _strides(q, k, v, o),
          [b, hq, hkv, s_q, s_k, d, _build.DTYPE_CODE[q.dtype],
           int(bool(causal))],
          sm_scale, dev)
    flash_attention_fwd.launches += 1
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


def _bwd_launch(fn_name, q, k, v, do, lse, delta, causal, sm_scale, outs):
    q, k, v, do = (_as_rows(t) for t in (q, k, v, do))
    dev = _check(fn_name, (q, k, v, do))
    b, hq, hkv, s_q, s_k, d = _geometry(q, k)
    lse = _stats(lse, b * hq, s_q, "lse")
    delta = _stats(delta, b * hq, s_q, "delta")
    grads = [torch.empty(like.shape, dtype=like.dtype, device=dev)
             for like in outs]
    _call(fn_name,
          [t.data_ptr() for t in (q, k, v, do, lse, delta, *grads)],
          _strides(q, k, v, do, *grads),
          [b, hq, hkv, s_q, s_k, d, _build.DTYPE_CODE[q.dtype],
           int(bool(causal))],
          sm_scale, dev)
    return grads


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    """(dk, dv) [B, S_k, Hkv, D] from the saved lse and
    ``delta = rowsum(do * o)`` (both [B*Hq, S_q] f32).  CUDA tensors launch
    ``flash_attention_bwd_dkv_launch`` and add one to
    ``flash_attention_bwd_dkv.launches``; CPU tensors run
    :func:`flash_attention_bwd_dkv_ref`."""
    if not _build.on_card("flash_attention_bwd_dkv", q):
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                           sm_scale)
    dk, dv = _bwd_launch("flash_attention_bwd_dkv_launch", q, k, v, do, lse,
                         delta, causal, sm_scale, (k, v))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale):
    """dq [B, S_q, Hq, D]; arguments as :func:`flash_attention_bwd_dkv`.
    CUDA tensors launch ``flash_attention_bwd_dq_launch`` and add one to
    ``flash_attention_bwd_dq.launches``; CPU tensors run
    :func:`flash_attention_bwd_dq_ref`."""
    if not _build.on_card("flash_attention_bwd_dq", q):
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal,
                                          sm_scale)
    (dq,) = _bwd_launch("flash_attention_bwd_dq_launch", q, k, v, do, lse,
                        delta, causal, sm_scale, (q,))
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_fwd.launches = 0
pack_lse.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


def _bwd_call(res, g, causal, sm_scale, delta=None):
    """The JAX ``_bwd_call``: (dq, dk, dv) from the forward's residuals
    ``(q, k, v, o, lse)`` and the output cotangent ``g``.  delta =
    rowsum(g * o) in f32 unless the caller passes it; 3-D [BH, S, 1] stats
    are packed first."""
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
                                     sm_scale)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal, sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX ``_make_op`` custom VJP: the forward saves (q, k, v, o, lse)
    and the backward runs the two backward kernels on them — the forward
    is never rerun."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_call((q, k, v, o, lse), g.contiguous(), ctx.causal,
                               ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=False, segment_ids=None,
                    dropout_rate=0.0):
    """[B, S, H, D] flash attention (GQA when k/v carry fewer heads);
    returns ``None`` for shapes the JAX package does not send to its kernel
    (:func:`_supported`), so that the caller runs plain attention."""
    if segment_ids is not None or dropout_rate:
        raise NotImplementedError(
            "flash_attention: segment ids and in-kernel dropout are not "
            "ported yet")
    if not _supported(q.shape, k.shape, causal):
        s_q, s_k = q.shape[1], k.shape[1]
        if s_q == s_k and s_q % 128 and s_q >= 384 and _supported(
                q.shape[:1] + (128,) + q.shape[2:],
                k.shape[:1] + (128,) + k.shape[2:], causal):
            raise NotImplementedError(
                "flash_attention: padding an untileable sequence to the "
                "128-row tile is not ported yet")
        return None
    return _FlashAttention.apply(q, k, v, bool(causal))
