"""The differentiated collectives: ``torch.autograd.Function``s whose
backward is the conjugate collective (reference
fleet/layers/mpu/mp_ops.py:40, :239 — Megatron's f and g; in the JAX
package autodiff transposes ``lax.psum`` / ``all_gather`` inside
``shard_map``).

  copy_to_group      identity         | all-reduce    before column-parallel
                                                      products
  reduce_from_group  all-reduce       | identity      after row-parallel
                                                      products (JAX's
                                                      ``_mp_reduce``)
  gather_from_group  all-gather on    | own slice     ``gather_output``
                     the last axis
  scatter_to_group   own slice of     | all-gather    ``input_is_parallel``
                     the last axis                    = False
  gather_flat_leaves all-gather of    | reduce-scatter ZeRO-3's
                     flat buckets                     just-in-time params

``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
again on the way back, which is wrong for ``reduce_from_group``: the loss
after it is replicated, so each rank's gradient is already the whole one.
Every collective goes through :mod:`.collectives` and is counted there.
"""
from __future__ import annotations

import torch

from .collectives import (ReduceOp, all_gather, all_gather_into_tensor,
                          all_reduce, reduce_scatter)

__all__ = ["copy_to_group", "reduce_from_group", "gather_from_group",
           "scatter_to_group", "gather_flat_leaves"]


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, ReduceOp.SUM, ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        all_reduce(out, ReduceOp.SUM, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _own_slice(x, group):
    n = group.nranks
    w = x.shape[-1] // n
    r = max(group.rank, 0)
    return x[..., r * w:(r + 1) * w].contiguous()


def _gather_last(x, group):
    parts = all_gather(None, x.contiguous(), group)     # [n, ..., w]
    return torch.cat(parts.unbind(0), dim=-1)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group), None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group):
    return _GatherFromGroup.apply(x, group)


def scatter_to_group(x, group):
    return _ScatterToGroup.apply(x, group)


class _GatherFlatLeaves(torch.autograd.Function):
    """Forward: every buffer's local slice all-gathered into a full flat
    buffer, returned as the views of its leaves.  Backward: the leaves'
    gradients laid into one f32 flat buffer a bucket, reduce-scattered
    back to the local slices (summed over the group)."""

    @staticmethod
    def forward(ctx, lay, *slices):
        ctx.lay = lay
        ctx.device = slices[0].device
        ctx.set_materialize_grads(False)
        full = {}
        for k, s in zip(lay.keys, slices):
            buf = torch.empty(lay.padded[k], dtype=s.dtype, device=s.device)
            full[k] = all_gather_into_tensor(buf, s, lay.group)
        return tuple(lay.views(full))

    @staticmethod
    def backward(ctx, *grads):
        lay = ctx.lay
        full = lay.flatten(grads, ctx.device, torch.float32)
        out = []
        for k in lay.keys:
            f = full.get(k)
            if f is None:
                f = torch.zeros(lay.padded[k], dtype=torch.float32,
                                device=ctx.device)
            loc = torch.empty(lay.chunk[k], dtype=torch.float32,
                              device=ctx.device)
            reduce_scatter(loc, f.view(lay.n, -1), ReduceOp.SUM, lay.group)
            out.append(loc)
        return (None, *out)


def gather_flat_leaves(lay, slices):
    """ZeRO-3's gather (``parallel.sharded``): ``lay`` the step's
    ``FlatLayout``, ``slices`` the local flat slices in ``lay.keys``
    order; returns the leaves' views, differentiable back to the slices
    (the gradient of a slice is the group's SUM of the leaves' gradients on
    it, in f32)."""
    return _GatherFlatLeaves.apply(lay, *slices)
