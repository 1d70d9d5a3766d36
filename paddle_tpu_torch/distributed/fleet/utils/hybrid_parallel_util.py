"""Hybrid-parallel helpers (port of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``; reference
fleet/utils/hybrid_parallel_util.py — fused_allreduce_gradients :262,
broadcast_*_parameters)."""
from __future__ import annotations

import torch

from ...communication.collectives import ReduceOp, all_reduce, broadcast

__all__ = ["fused_allreduce_gradients", "broadcast_mp_parameters",
           "broadcast_dp_parameters", "broadcast_sharding_parameters",
           "broadcast_sep_parameters"]


def fused_allreduce_gradients(parameter_list, hcg):
    """The gradients' mean over the dp group, fused: one flat buffer and
    one all-reduce a dtype, the means copied back into ``.grad``."""
    group = hcg.get_data_parallel_group() if hcg is not None else None
    n = group.nranks if group is not None else 1
    if n <= 1:
        return
    by_dtype = {}
    for p in parameter_list:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    for params in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        all_reduce(flat, ReduceOp.SUM, group)
        flat.mul_(1.0 / n)
        off = 0
        for p in params:
            k = p.grad.numel()
            p.grad.copy_(flat[off:off + k].view_as(p.grad))
            off += k


def broadcast_mp_parameters(model, hcg):
    _broadcast_params(model, hcg.get_model_parallel_group())


def broadcast_dp_parameters(model, hcg):
    _broadcast_params(model, hcg.get_data_parallel_group())


def broadcast_sharding_parameters(model, hcg):
    _broadcast_params(model, hcg.get_sharding_parallel_group())


def broadcast_sep_parameters(model, hcg):
    _broadcast_params(model, hcg.get_sep_parallel_group())


def _broadcast_params(model, group, skip_distributed=False):
    if group is None or group.nranks <= 1:
        return
    for p in model.parameters():
        if skip_distributed and getattr(p, "is_distributed", False) is True:
            continue
        broadcast(p.data, src=group.ranks[0], group=group)
