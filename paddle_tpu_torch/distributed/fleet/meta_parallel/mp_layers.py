"""Tensor-parallel layers (port of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``; reference
python/paddle/distributed/fleet/layers/mpu/mp_layers.py —
VocabParallelEmbedding :49, ColumnParallelLinear :336, RowParallelLinear
:543, ParallelCrossEntropy :744).

Each layer holds its rank's shard of the weight as an ``nn.Parameter``
marked ``is_distributed = True`` and issues the Megatron collectives of
the JAX layers' explicit (``shard_map``) mode through
:mod:`..communication.differentiable`: the identity / all-reduce pair
around column- and row-parallel products, an all-gather for
``gather_output``.  The group is ``mp_group``, or this rank's ``mp`` group
of the default mesh (``fleet.init`` makes it), or — with neither — this
rank alone, where each layer is its dense counterpart.  The full weight
is drawn from ``seed`` on every rank and cut, so the layers over any
group size make one model.  Weights are ``[in, out]`` (``x @ W``), as the
JAX layers store them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ... import topology
from ...communication.differentiable import (copy_to_group,
                                             gather_from_group,
                                             reduce_from_group,
                                             scatter_to_group)
from .... import resolve_device

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


def _group(mp_group):
    return mp_group if mp_group is not None else topology.axis_group("mp")


def _cut(full, group, dim):
    n, r = group.nranks, max(group.rank, 0)
    if full.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split "
                         f"over {n} ranks")
    w = full.shape[dim] // n
    return full.narrow(dim, r * w, w).contiguous()


def _param(t, distributed):
    p = nn.Parameter(t)
    p.is_distributed = distributed
    return p


def _uniform(shape, gen, dev, dtype):
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen, device=dev) * (2 * bound)
            - bound).to(dtype)


class VocabParallelEmbedding(nn.Module):
    """The vocab rows split over the group (reference :49): a rank looks up
    the ids in its rows, zeros the others, and the group sums."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.group = _group(mp_group)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        full = (torch.randn((num_embeddings, embedding_dim), generator=gen,
                            device=dev) * 0.02).to(dtype)
        self.weight = _param(_cut(full, self.group, 0), True)
        self._num = num_embeddings

    def forward(self, x):
        per = self.weight.shape[0]
        lo = max(self.group.rank, 0) * per
        local = x.long() - lo
        ok = (local >= 0) & (local < per)
        emb = F.embedding(torch.where(ok, local, 0), self.weight)
        emb = emb * ok[..., None].to(emb.dtype)
        return reduce_from_group(emb, self.group)


class ColumnParallelLinear(nn.Module):
    """The output features split over the group (reference :336):
    ``y_r = x @ W[:, r]``; ``gather_output`` all-gathers the pieces."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.group = _group(mp_group)
        self.gather_output = gather_output
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        full = _uniform((in_features, out_features), gen, dev, dtype)
        self.weight = _param(_cut(full, self.group, 1), True)
        self.bias = _param(torch.zeros(
            self.weight.shape[1], dtype=dtype, device=dev), True) \
            if has_bias in (True, None) else None

    def forward(self, x):
        y = copy_to_group(x, self.group) @ self.weight
        if self.bias is not None:
            y = y + self.bias
        return gather_from_group(y, self.group) if self.gather_output else y


class RowParallelLinear(nn.Module):
    """The input features split over the group (reference :543): ``y =
    sum_r x[..., r] @ W[r] + b``; without ``input_is_parallel`` the input is
    cut to this rank's features first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 dtype=torch.float32, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.group = _group(mp_group)
        self.input_is_parallel = input_is_parallel
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        full = _uniform((in_features, out_features), gen, dev, dtype)
        self.weight = _param(_cut(full, self.group, 0), True)
        self.bias = _param(torch.zeros(out_features, dtype=dtype,
                                       device=dev), False) \
            if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_group(x, self.group)
        y = reduce_from_group(x @ self.weight, self.group)
        return y if self.bias is None else y + self.bias


class ParallelCrossEntropy(nn.Module):
    """Softmax cross-entropy over logits whose class axis is split over the
    group (reference :744), without gathering them: the max and the
    exponentials' sum are reduced over the group.  Returns the loss per
    row with a trailing axis of 1; rows labelled ``ignore_index`` get 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = mp_group
        self.ignore_index = ignore_index

    def forward(self, input, label):
        from ...communication.collectives import ReduceOp, all_reduce
        group = _group(self.group)
        logits = input.float()
        per = logits.shape[-1]
        lo = max(group.rank, 0) * per
        lmax = logits.detach().amax(-1, keepdim=True)
        all_reduce(lmax, ReduceOp.MAX, group)
        denom = reduce_from_group(
            torch.exp(logits - lmax).sum(-1, keepdim=True), group)
        lse = torch.log(denom) + lmax
        lab = label.long()
        if lab.dim() == logits.dim():
            lab = lab[..., 0]
        local = lab - lo
        ok = (local >= 0) & (local < per)
        picked = torch.gather(logits, -1, torch.where(ok, local, 0)[..., None])
        picked = reduce_from_group(picked * ok[..., None], group)
        loss = lse - picked
        return torch.where((lab == self.ignore_index)[..., None],
                           torch.zeros_like(loss), loss)
