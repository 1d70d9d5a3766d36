"""Ring attention and Ulysses attention over a sequence-parallel group
(port of ``paddle_tpu/parallel/ring_attention.py``).

Each rank holds its shard of the sequence, ``[B, S / n, H, D]``, of a
sequence sharded in rank order over the group of mesh axis ``axis``
(``distributed.topology.axis_group(axis, mesh)``; the default mesh's when
``mesh`` is None).  Every rank of the group calls the function alike.

* :func:`ring_attention` — blockwise attention with an online softmax in
  plain PyTorch; the K/V shards rotate one hop a step around the ring (a
  batched send to rank r + 1 and receive from rank r - 1, through
  ``communication.batch_isend_irecv``; a hop to the rank itself is a
  handoff).  Differentiable: a hop's backward sends the gradient the other
  way.
* :func:`ulysses_attention` — two all-to-alls swap the sequence shard of
  every head for the whole sequence of a head group, dense attention runs
  locally (in f32), and the inverse swap returns the sequence shard.  Requires the head count divisible by the group size.  Differentiable (each swap's
  backward is the inverse swap).
* :func:`ring_flash_attention` — the ring where every hop runs the port's
  flash attention forward (``ops.flash_attention.flash_attention_fwd``,
  row 3: the CUDA kernel on CUDA tensors, its plain version on CPU
  tensors) and the hops' (o, lse) pairs merge through ``logaddexp`` of the
  lse.  Its backward (a ``torch.autograd.Function``) keeps only the local
  q, k, v, out and lse, re-rotates the local K/V and runs the backward
  kernels (rows 5 / 6) once a hop with the GLOBAL lse and delta, which
  makes each hop's share exact; the dK / dV sums travel with the K/V and
  reach their owner after the full cycle.  With ``causal``, a hop holding a
  later shard than this rank's is skipped (no launch), the diagonal hop
  runs the causal kernel and the earlier ones the full kernel (JAX's
  ``hop_kind_of``).  GQA rides the kernels' KV-head mapping.
"""
from __future__ import annotations

import math

import torch

from ..distributed.communication.collectives import (P2POp, all_to_all_single,
                                                     batch_isend_irecv, irecv,
                                                     isend)
from ..distributed.topology import axis_group
from ..ops.flash_attention import _bwd_call, flash_attention_fwd

__all__ = ["ring_attention", "ulysses_attention", "ring_flash_attention"]


def _shift_start(tensors, group, step=1):
    """Issue :func:`_shift`'s exchange over a group of more than one rank
    and return at once: (the receive buffers, the tasks to wait on before
    they are read)."""
    n, r = group.nranks, group.rank
    dst, src = group.ranks[(r + step) % n], group.ranks[(r - step) % n]
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops += [P2POp(isend, t.contiguous(), dst, group),
                P2POp(irecv, o, src, group)]
    return outs, batch_isend_irecv(ops)


def _shift(tensors, group, step=1):
    """Each tensor of ``tensors`` moved ``step`` places along ``group``'s
    ring: this rank sends to rank r + step and receives from rank r - step
    (one batched exchange for all of them).  With one rank the tensors come
    back as they are."""
    if group.nranks == 1:
        return list(tensors)
    outs, tasks = _shift_start(tensors, group, step)
    for task in tasks:
        task.wait()
    return outs


class _RingHop(torch.autograd.Function):
    """One hop of the ring: forward to rank r + 1, the gradient back to
    rank r - 1."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_shift(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        # autograd materializes a missing gradient as zeros
        return (None, *_shift(grads, ctx.group, -1))


def _block_attn_lse(q, k, v, scale, mask=None):
    """Dense block attention: (unnormalised out [B, Sq, H, D] f32, row max
    m [B, H, Sq, 1], row sum l [B, H, Sq, 1]) for the online merge."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o.float(), m, l


def ring_attention(q, k, v, axis: str = "sep", causal: bool = False,
                   mesh=None):
    """q, k, v: this rank's shards ``[B, S_local, H, D]``; returns this
    rank's output shard ``[B, S_local, H, D]`` in q's dtype."""
    group = axis_group(axis, mesh)
    n, r = group.nranks, max(group.rank, 0)
    b, s_local, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    o = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_local, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local, 1), dtype=torch.float32, device=q.device)
    rows = torch.arange(s_local, device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        src = (r - t) % n          # whose K/V shard this rank holds now
        mask = None
        if causal:
            mask = ((r * s_local + rows)[:, None]
                    >= (src * s_local + rows)[None, :])[None, None]
        o_t, m_t, l_t = _block_attn_lse(q, k_cur, v_cur, scale, mask)
        m_new = torch.maximum(m, m_t)
        a_old, a_new = torch.exp(m - m_new), torch.exp(m_t - m_new)
        o = o * a_old.transpose(1, 2) + o_t * a_new.transpose(1, 2)
        l = l * a_old + l_t * a_new
        m = m_new
        if t != n - 1:
            k_cur, v_cur = _RingHop.apply(group, k_cur, v_cur)
    return (o / torch.clamp(l.transpose(1, 2), min=1e-30)).to(q.dtype)


def _seq_to_head(x, group):
    """[B, S/n, H, D] -> [B, S, H/n, D]: rank j gets every rank's sequence
    shard of head group j, in rank order."""
    n = group.nranks
    b, s_local, h, d = x.shape
    inp = x.reshape(b, s_local, n, h // n, d).permute(2, 0, 1, 3, 4) \
        .contiguous()
    out = torch.empty_like(inp)
    all_to_all_single(out, inp, group=group)
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s_local, h // n, d)


def _head_to_seq(x, group):
    """[B, S, H/n, D] -> [B, S/n, H, D], the inverse of
    :func:`_seq_to_head`."""
    n = group.nranks
    b, s, hl, d = x.shape
    inp = x.reshape(b, n, s // n, hl, d).permute(1, 0, 2, 3, 4).contiguous()
    out = torch.empty_like(inp)
    all_to_all_single(out, inp, group=group)
    return out.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_head(x, group)

    @staticmethod
    def backward(ctx, g):
        return _head_to_seq(g.contiguous(), ctx.group), None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _head_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_head(g.contiguous(), ctx.group), None


def ulysses_attention(q, k, v, axis: str = "sep", causal: bool = False,
                      mesh=None):
    """All-to-all attention (DeepSpeed-Ulysses): q, k, v this rank's shards
    ``[B, S_local, H, D]`` with H divisible by the group size; returns this
    rank's output shard."""
    group = axis_group(axis, mesh)
    if q.shape[2] % group.nranks:
        raise ValueError(f"ulysses_attention: {q.shape[2]} heads do not "
                         f"split over {group.nranks} ranks")
    qh, kh, vh = (_SeqToHead.apply(x, group) for x in (q, k, v))
    # in f32 throughout, the output cast back: JAX's einsums round the
    # scores and the probabilities to the input dtype (bf16 on the card)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) \
        / math.sqrt(q.shape[-1])
    if causal:
        S = s.shape[-1]
        tril = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(tril, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vh.float()).to(q.dtype)
    return _HeadToSeq.apply(o, group)


def _hop_kinds(n, r, causal):
    """Per hop t: None (skip: a later shard than this rank's), True (the
    diagonal: causal) or False (full), JAX's ``hop_kind_of``."""
    kinds = []
    for t in range(n):
        src = (r - t) % n
        kinds.append(False if not causal
                     else None if src > r else src == r)
    return kinds


def _lse_rows(x, b, h):
    """[B*H, S] per-row stats -> [B, S, H, 1], the output's layout."""
    return x.view(b, h, -1).transpose(1, 2)[..., None]


class _RingFlash(torch.autograd.Function):
    """The ring of flash hops; residuals are the local q, k, v, out and
    lse only (JAX's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n, r = group.nranks, max(group.rank, 0)
        b, s_local, hq, d = q.shape
        scale = 1.0 / math.sqrt(d)
        kinds = _hop_kinds(n, r, causal)
        # hop 0 (this rank's own shard) is never skipped: it starts the
        # merge, which JAX starts from zeros and -inf (the same values)
        o = lse = None
        k_cur, v_cur = k, v
        for t, kind in enumerate(kinds):
            if kind is not None:
                o_t, lse_t = flash_attention_fwd(q, k_cur, v_cur, kind, scale)
                if o is None:
                    o, lse = o_t.float(), lse_t
                else:
                    lse_new = torch.logaddexp(lse, lse_t)
                    o = o * _lse_rows(torch.exp(lse - lse_new), b, hq) \
                        + o_t.float() * _lse_rows(torch.exp(lse_t - lse_new),
                                                  b, hq)
                    lse = lse_new
            if t != n - 1:
                k_cur, v_cur = _shift((k_cur, v_cur), group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.kinds, ctx.scale = group, kinds, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, kinds = ctx.group, ctx.kinds
        n = group.nranks
        b, s_local, hq, _ = q.shape
        g = g.to(out.dtype).contiguous()
        # delta = rowsum(do * o) is the same for every hop
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2) \
            .reshape(b * hq, s_local).contiguous()

        def add(acc, x):
            # f32 sums over the hops (every rank's in the same dtype, as the
            # dK / dV sums travel)
            x = x.float()
            return x if acc is None else acc + x

        dq = dk = dv = None
        k_cur, v_cur = k, v
        for t, kind in enumerate(kinds):
            if kind is not None:
                dq_t, dk_t, dv_t = _bwd_call((q, k_cur, v_cur, out, lse), g,
                                             kind, ctx.scale, delta=delta)
                dq, dk, dv = add(dq, dq_t), add(dk, dk_t), add(dv, dv_t)
            # the dK / dV sums rotate the full cycle, home to their owner;
            # the K/V need only the first n - 1 hops
            if t != n - 1:
                k_cur, v_cur = _shift((k_cur, v_cur), group)
            dk, dv = _shift((dk, dv), group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_flash_attention(q, k, v, axis: str = "sep", causal: bool = False,
                         interpret: bool = False, mesh=None):
    """Ring attention whose hops run the flash attention kernels (module
    docstring): q ``[B, S_local, Hq, D]``, k / v ``[B, S_local, Hkv, D]``
    this rank's shards; returns this rank's output shard in q's dtype.
    ``interpret`` is JAX's Pallas switch and has no counterpart: CPU
    tensors run the kernels' plain versions."""
    return _RingFlash.apply(q, k, v, axis_group(axis, mesh), bool(causal))
