"""The MoE capacity helpers (port of ``paddle_tpu.incubate.distributed.
models.moe.utils``; reference paddle/phi/kernels/number_count_kernel.h,
assign_pos_kernel.h, limit_by_capacity_kernel.h,
prune_gate_by_capacity_kernel.h, random_routing_kernel.h).

The JAX functions compute these counts with one-hot + cumsum; here they are
the same integer one-hot + cumsum in torch, so the results are exact and
equal to JAX's.  An index of -1 (a dropped choice) counts nowhere."""
from __future__ import annotations

import torch

__all__ = ["number_count", "assign_pos", "limit_by_capacity",
           "prune_gate_by_capacity", "random_routing", "count_by_gate"]


def _one_hot(idx, n):
    """int32 one-hot of ``idx`` over ``n`` classes; -1 gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)) \
        .to(torch.int32)


def number_count(gate_idx, upper_range):
    """Tokens routed to each expert: int32 [upper_range]."""
    return _one_hot(gate_idx.reshape(-1), upper_range).sum(
        0, dtype=torch.int32)


def assign_pos(gate_idx, num_expert):
    """Each token's position in its expert's queue, in flat order (int32,
    ``gate_idx``'s shape)."""
    flat = gate_idx.reshape(-1).long()
    pos = _one_hot(flat, num_expert).cumsum(0, dtype=torch.int32) - 1
    # -1 reads the last expert's column, as JAX's take_along_axis wraps it
    return pos.gather(1, (flat % num_expert)[:, None])[:, 0] \
        .reshape(gate_idx.shape)


def limit_by_capacity(expert_count, capacity, n_worker=1):
    """Per-expert counts clamped to ``capacity * n_worker``."""
    cap = torch.as_tensor(capacity, device=expert_count.device)
    return torch.minimum(expert_count, cap * n_worker)


def prune_gate_by_capacity(gate_idx, expert_count, n_expert, n_worker=1):
    """``gate_idx`` with the tokens past their expert's count set to -1."""
    pos = assign_pos(gate_idx, n_expert)
    cap = expert_count[gate_idx.reshape(-1).long()].reshape(gate_idx.shape)
    return torch.where(pos < cap, gate_idx, torch.full_like(gate_idx, -1))


def random_routing(topk_idx, topk_value, prob, topk=2):
    """For top-2, each token's second expert kept where ``prob`` < twice its
    gate value, else -1 (``prob``: one uniform draw a token, which the
    caller passes)."""
    if topk != 2:
        return topk_idx
    keep = prob < topk_value[..., 1] * 2.0
    second = torch.where(keep, topk_idx[..., 1],
                         torch.full_like(topk_idx[..., 1], -1))
    return torch.stack([topk_idx[..., 0], second], dim=-1)


def count_by_gate(gate_idx, num_expert, n_worker=1):
    """(expert count, each token's position) as the dispatcher uses them."""
    return number_count(gate_idx, num_expert), assign_pos(gate_idx,
                                                          num_expert)
