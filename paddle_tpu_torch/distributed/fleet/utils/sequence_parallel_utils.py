"""Megatron sequence parallelism (port of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``;
reference fleet/utils/sequence_parallel_utils.py — ScatterOp / GatherOp /
AllGatherOp / ReduceScatterOp :85-250, ColumnSequenceParallelLinear /
RowSequenceParallelLinear :336-564, SPInnerOverlapLinear :257).

Activations in a sequence-parallel region are split along the sequence
axis (axis 0, ``[S, B, H]``) over the tensor-parallel group: ``mp_group``,
or this rank's ``mp`` group of the default mesh, or this rank alone.  The
JAX package gets the collectives from ``shard_map`` (or from sharding
constraints under GSPMD); here each op is a ``torch.autograd.Function``
over the group, with the reference's backward:

  ScatterOp        own slice of axis     | all-gather along axis
  GatherOp         all-gather along axis | own slice
  AllGatherOp      all-gather along axis | reduce-scatter along axis
  ReduceScatterOp  reduce-scatter        | all-gather along axis

Parameters a sequence-parallel region replicates (the norms, the row
layer's bias) see only their rank's sequence shard, so their gradients are
partial; :func:`mark_as_sequence_parallel_parameter` marks them and
:func:`create_fused_allreduce_gradient_hooks` sums them over the group.
"""
from __future__ import annotations

import torch
from torch import nn

from .... import resolve_device
from ...communication.collectives import (ReduceOp, all_gather, all_reduce,
                                          reduce_scatter)
from ....parallel.ring_attention import _shift_start
from ..meta_parallel.mp_layers import _cut, _group, _param, _uniform

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "mark_as_sequence_parallel_parameter",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "SPInnerOverlapLinear",
           "create_fused_allreduce_gradient_hooks"]


def _slice(x, axis, group):
    n, r = group.nranks, max(group.rank, 0)
    per = x.shape[axis] // n
    return x.narrow(axis, r * per, per).contiguous()


def _gather(x, axis, group):
    parts = all_gather(None, x.contiguous(), group)          # [n, ...]
    return torch.cat(parts.unbind(0), dim=axis)


def _reduce_scatter(x, axis, group):
    n = group.nranks
    parts = x.movedim(axis, 0)
    per = parts.shape[0] // n
    chunks = parts.reshape((n, per) + parts.shape[1:]).contiguous()
    out = torch.empty(chunks.shape[1:], dtype=x.dtype, device=x.device)
    reduce_scatter(out, chunks, ReduceOp.SUM, group)
    return out.movedim(0, axis)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _slice(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.axis, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _reduce_scatter(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.group), None, None


class ScatterOp:
    """This rank's slice of the sequence axis (reference :85)."""

    @staticmethod
    def apply(x, axis=0, group=None):
        return _Scatter.apply(x, axis, _group(group))


class GatherOp:
    """The inverse of :class:`ScatterOp` (reference :~120)."""

    @staticmethod
    def apply(x, axis=0, group=None):
        return _Gather.apply(x, axis, _group(group))


class AllGatherOp:
    """All-gather along the sequence axis in the forward, reduce-scatter
    in the backward (reference :176)."""

    @staticmethod
    def apply(x, axis=0, group=None):
        return _AllGather.apply(x, axis, _group(group))


class ReduceScatterOp:
    """Reduce-scatter along the sequence axis in the forward, all-gather in
    the backward."""

    @staticmethod
    def apply(x, axis=0, group=None):
        return _ReduceScatter.apply(x, axis, _group(group))


def mark_as_sequence_parallel_parameter(param):
    param.sequence_parallel = True


class ColumnSequenceParallelLinear(nn.Module):
    """The output features split over the group, the input split along the
    sequence: the sequence all-gathered, then ``x @ W[:, r]`` (+ this
    rank's bias columns).  The full weight is drawn from ``seed`` on every
    rank and cut, as ``meta_parallel.ColumnParallelLinear``'s."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.group = _group(mp_group)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        full = _uniform((in_features, out_features), gen, dev, dtype)
        self.weight = _param(_cut(full, self.group, 1), True)
        self.bias = _param(torch.zeros(self.weight.shape[1], dtype=dtype,
                                       device=dev), True) \
            if has_bias in (True, None) else None

    def forward(self, x):
        y = AllGatherOp.apply(x, 0, self.group) @ self.weight
        return y if self.bias is None else y + self.bias


class RowSequenceParallelLinear(nn.Module):
    """The input features split over the group: ``x[..., r] @ W[r]``,
    reduce-scattered along the sequence, plus the replicated bias (marked
    sequence-parallel: its gradient is this rank's sequence shard's)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 dtype=torch.float32, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.group = _group(mp_group)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        full = _uniform((in_features, out_features), gen, dev, dtype)
        self.weight = _param(_cut(full, self.group, 0), True)
        self.bias = None
        if has_bias:
            self.bias = _param(torch.zeros(out_features, dtype=dtype,
                                           device=dev), False)
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        y = ReduceScatterOp.apply(x @ self.weight, 0, self.group)
        return y if self.bias is None else y + self.bias


class _RingAllGatherMatmul(torch.autograd.Function):
    """The ring of :func:`_ring_allgather_matmul`.  Forward: at each of n
    steps the hop of the chunk this rank holds to rank r + 1 is issued,
    the chunk is multiplied while it travels, and the hop is waited on
    after the product.  Backward, the same ring the other way round: the
    partial dX of sequence chunk c starts at rank c + 1 and travels r + 1,
    r + 2, ... home to rank c, each rank adding its share ``dY[c] @ W^T``,
    computed while the sum is in flight; dW is local (the gathered chunks,
    kept from the forward, against dY)."""

    @staticmethod
    def forward(ctx, x_local, w, group):
        n, r = group.nranks, max(group.rank, 0)
        chunks, parts = [None] * n, [None] * n
        chunk = x_local.contiguous()
        for i in range(n):
            src = (r - i) % n           # chunk i came from rank r - i
            if i != n - 1:
                (nxt,), tasks = _shift_start((chunk,), group)
            chunks[src], parts[src] = chunk, chunk @ w
            if i != n - 1:
                for task in tasks:
                    task.wait()
                chunk = nxt
        ctx.save_for_backward(torch.cat(chunks, dim=0), w)
        ctx.group = group
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, dy):
        x_full, w = ctx.saved_tensors
        group = ctx.group
        n, r = group.nranks, max(group.rank, 0)
        dw = x_full.reshape(-1, x_full.shape[-1]).t() \
            @ dy.reshape(-1, dy.shape[-1])
        per = dy.shape[0] // n

        def share(c):
            return dy.narrow(0, c * per, per) @ w.t()
        acc = share((r - 1) % n)        # chunk r - 1's sum starts here
        for i in range(1, n):
            (nxt,), tasks = _shift_start((acc,), group)
            mine = share((r - 1 - i) % n)
            for task in tasks:
                task.wait()
            acc = nxt + mine
        return acc, dw, None


def _ring_allgather_matmul(x_local, w, axis="mp", group=None):
    """The sequence all-gather and the column product overlapped as a ring
    (reference SPInnerOverlapLinear :257): at each of n steps this rank
    multiplies the sequence chunk it holds while the next one arrives
    (:class:`_RingAllGatherMatmul`).  ``x_local [S_local, ..., H_in]``,
    ``w [H_in, out_local]`` -> ``[S, ..., out_local]``, sequence-major in
    rank order.  The group is ``group``, or this rank's group along
    ``axis`` of the default mesh."""
    from ...topology import axis_group
    group = group if group is not None else axis_group(axis)
    return _RingAllGatherMatmul.apply(x_local, w, group)


class SPInnerOverlapLinear(ColumnSequenceParallelLinear):
    """:class:`ColumnSequenceParallelLinear` whose sequence all-gather is a
    ring of hops, each chunk multiplied while the next one is in flight
    (:func:`_ring_allgather_matmul`)."""

    def forward(self, x):
        y = _ring_allgather_matmul(x, self.weight, group=self.group)
        return y if self.bias is None else y + self.bias


def create_fused_allreduce_gradient_hooks(model, accumulation_steps=1,
                                          mp_group=None):
    """Sum the gradients of ``model``'s sequence-parallel parameters
    (:func:`mark_as_sequence_parallel_parameter`) over the group once they
    are accumulated, every ``accumulation_steps``-th backward (the
    reference's fused hooks); returns the hook handles (none over one
    rank, where JAX's returns none)."""
    group = _group(mp_group)
    if group.nranks <= 1:
        return []
    every = max(1, int(accumulation_steps))
    seen = {}

    def hook(p):
        seen[id(p)] = seen.get(id(p), 0) + 1
        if seen[id(p)] % every == 0:
            all_reduce(p.grad, ReduceOp.SUM, group)

    return [p.register_post_accumulate_grad_hook(hook)
            for p in model.parameters()
            if getattr(p, "sequence_parallel", False) is True]
