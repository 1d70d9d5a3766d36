"""MoE gates (port of ``paddle_tpu.incubate.distributed.models.moe.gate``;
reference gate/naive_gate.py NaiveGate, gshard_gate.py GShardGate,
switch_gate.py SwitchGate over base_gate.py BaseGate).

:func:`top_k_gating` is JAX's GShard top-k capacity gating with its four
outputs — combine weights ``[T, E, C]``, the dispatch mask ``[T, E, C]``,
the balance loss and an info dict — and the same rules: slots are k-major
(every first choice queues before any second choice), the balance loss
takes the first choice's fraction only, the kept weights are normalised
per token, and a choice past its expert's C slots is dropped.

Both are built from :func:`route`, which keeps the routing in the form the
MoE layers move tokens by: for each (choice, token) the flat slot ``e * C
+ c`` it landed in (``E * C``, a sink, where it was dropped) and its
weight.  The dispatch and combine of ``moe_layer`` gather and scatter rows
by those slots, where JAX multiplies one-hot ``[T, E, C]`` masks; the
values are the same (the dispatch bit for bit, the combine up to the order
of its ≤ k terms), and nothing of size T × E × C is made."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.autograd.profiler import record_function

from ..... import resolve_device
from . import utils

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate",
           "top_k_gating", "compute_capacity", "route", "Routing"]


def compute_capacity(num_tokens, num_experts, top_k, capacity_factor):
    """C = ceil(k T / E * factor), at least 1."""
    return max(1, int(math.ceil(top_k * num_tokens / num_experts
                                * capacity_factor)))


class Routing(NamedTuple):
    """Where one batch of T tokens goes: ``dest`` [k * T] (k-major) the flat
    slot ``e * C + c`` of each (choice, token), ``E * C`` where the choice
    was dropped; ``weight`` [k, T] f32 its combine weight (0 where
    dropped); ``aux`` the balance loss; ``probs`` [T, E], ``top_idx`` [T,
    k] (-1 where random routing dropped the second choice) and ``within``
    [k, T, E] as JAX's info dict holds them."""
    dest: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor
    probs: torch.Tensor
    top_idx: torch.Tensor
    within: torch.Tensor
    num_experts: int
    capacity: int

    @property
    def top_k(self):
        return self.weight.shape[0]

    def kept(self):
        """The number of (choice, token) pairs that got a slot (a 0-d
        tensor)."""
        return (self.dest < self.num_experts * self.capacity).sum()

    def combine_weights(self):
        """JAX's ``combine`` [T, E, C] (f32): each kept choice's weight at
        its slot.  A slot holds at most one choice, and a token's choices
        go to different experts, so each entry is one weight or 0."""
        k, T = self.weight.shape
        n = self.num_experts * self.capacity
        out = self.weight.new_zeros(T, n + 1)
        out = out.scatter(1, self.dest.view(k, T).t(), self.weight.t())
        return out[:, :n].reshape(T, self.num_experts, self.capacity)


def route(logits, top_k, capacity, *, normalize=True,
          balance_loss_weight=1.0, uniform=None):
    """The routing of ``logits`` [T, E] into ``capacity`` slots an expert
    (:class:`Routing`).  ``uniform`` [T], one uniform draw a token, turns on
    random routing for top-2 (``utils.random_routing``: the second choice
    kept where the draw is below twice its probability)."""
    with record_function("moe_route"):
        T, E = logits.shape
        C = int(capacity)
        probs = torch.softmax(logits.float(), dim=-1)
        topv, topi = torch.topk(probs, top_k, dim=-1)
        if uniform is not None and top_k == 2:
            topi = utils.random_routing(topi, topv, uniform, topk=2)
        experts = torch.arange(E, device=logits.device)
        kmask = topi.t()[..., None] == experts                  # [k, T, E]
        # queue positions: k-major, so first choices claim slots first
        # (the running count along each expert's row of the transpose: a
        # scan over the contiguous axis)
        flat = kmask.reshape(top_k * T, E).t().to(torch.int32).contiguous()
        pos = (flat.cumsum(1, dtype=torch.int32) - flat).t() \
            .reshape(top_k, T, E)
        within = (pos < C) & kmask
        me = probs.mean(0)
        ce = kmask[0].float().mean(0)
        aux = (me * ce).sum() * E * balance_loss_weight
        gate_w = topv.t()[..., None] * within                   # [k, T, E]
        if normalize:
            denom = gate_w.sum(dim=(0, 2), keepdim=True)
            gate_w = gate_w / torch.clamp(denom, min=1e-9)
        e = topi.t().clamp(min=0).long()                        # [k, T]
        kept = within.gather(2, e[..., None])[..., 0]
        slot = pos.gather(2, e[..., None])[..., 0].long()
        dest = torch.where(kept, e * C + slot, E * C).reshape(-1)
        weight = gate_w.gather(2, e[..., None])[..., 0]
    return Routing(dest, weight, aux, probs, topi, within, E, C)


def top_k_gating(logits, top_k, capacity, *, normalize=True,
                 balance_loss_weight=1.0, prng=None,
                 random_routing_prob=False):
    """JAX's ``top_k_gating``: ``(combine [T, E, C] f32, dispatch [T, E, C]
    bool, aux, info)`` for ``logits`` [T, E].  With ``random_routing_prob``
    and top-2, ``prng`` (a ``torch.Generator`` on the logits' device, where
    JAX takes a key) draws one uniform a token for random routing."""
    uniform = None
    if random_routing_prob and top_k == 2 and prng is not None:
        uniform = torch.rand(logits.shape[0], generator=prng,
                             device=logits.device)
    r = route(logits, top_k, capacity, normalize=normalize,
              balance_loss_weight=balance_loss_weight, uniform=uniform)
    combine = r.combine_weights()
    info = {"probs": r.probs, "top_idx": r.top_idx,
            "within_capacity": r.within}
    return combine, combine > 0, r.aux, info


class BaseGate(nn.Module):
    """Expert counts and the loss slot (reference gate/base_gate.py)."""

    def __init__(self, num_expert, n_worker=1):
        super().__init__()
        self.num_expert = num_expert
        self.n_worker = n_worker
        self.tot_expert = num_expert * n_worker
        self.loss = None

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


class NaiveGate(BaseGate):
    """Top-k softmax gate, without capacity unless ``capacity_factor`` is
    given (reference naive_gate.py).  ``gate_weight`` [d_model,
    tot_expert] is Xavier-uniform from ``generator`` (JAX's
    ``create_parameter`` default; not its draws)."""

    random_routing = False

    def __init__(self, d_model, num_expert, n_worker=1, topk=2,
                 capacity_factor=None, eval_capacity_factor=None,
                 balance_loss_weight=1.0, *, dtype=torch.float32,
                 device=None, generator=None):
        super().__init__(num_expert, n_worker)
        dev = resolve_device(device)
        self.top_k = topk
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.balance_loss_weight = balance_loss_weight
        bound = math.sqrt(6.0 / (d_model + self.tot_expert))
        w = torch.rand((d_model, self.tot_expert), generator=generator,
                       device=dev) * (2 * bound) - bound
        self.gate_weight = nn.Parameter(w.to(dtype))

    def capacity_for(self, num_tokens, training=True):
        f = self.capacity_factor if training else \
            (self.eval_capacity_factor or self.capacity_factor)
        if f is None:
            return num_tokens          # no drops: any token fits anywhere
        return compute_capacity(num_tokens, self.tot_expert, self.top_k, f)

    def forward(self, x):
        return x @ self.gate_weight.to(x.dtype)


def _split_capacity(capacity):
    if isinstance(capacity, (tuple, list)):
        return capacity[0], capacity[1] if len(capacity) > 1 else capacity[0]
    return capacity, capacity


class GShardGate(NaiveGate):
    """Top-2 gate with capacity, balance loss and random routing (reference
    gshard_gate.py; ``capacity`` the train / eval factors)."""

    def __init__(self, d_model, num_expert, n_worker=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True,
                 balance_loss_weight=1.0, group=None, gate_weight=None, *,
                 dtype=torch.float32, device=None, generator=None):
        cf, ef = _split_capacity(capacity)
        super().__init__(d_model, num_expert, n_worker, topk=topk,
                         capacity_factor=cf, eval_capacity_factor=ef,
                         balance_loss_weight=balance_loss_weight,
                         dtype=dtype, device=device, generator=generator)
        self.random_routing = random_routing


class SwitchGate(NaiveGate):
    """Top-1 switch gate with capacity (reference switch_gate.py)."""

    def __init__(self, d_model, num_expert, n_worker=1, topk=1,
                 capacity=(1.2, 2.4), balance_loss_weight=1.0, group=None,
                 gate_weight=None, *, dtype=torch.float32, device=None,
                 generator=None):
        cf, ef = _split_capacity(capacity)
        super().__init__(d_model, num_expert, n_worker, topk=1,
                         capacity_factor=cf, eval_capacity_factor=ef,
                         balance_loss_weight=balance_loss_weight,
                         dtype=dtype, device=device, generator=generator)
