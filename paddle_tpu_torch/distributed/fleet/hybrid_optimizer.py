"""HybridParallelOptimizer (port of
``paddle_tpu/distributed/fleet/hybrid_optimizer.py``; reference
fleet/meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py:275):
the inner optimizer with its global-norm clip taken across the
model-parallel shards, and, under tensor parallelism with dp > 1, the
gradients all-reduced over the dp group before the step
(``TensorParallel`` adds no gradient hooks).
"""
from __future__ import annotations

import torch

from ...nn.clip import ClipGradByGlobalNorm, _need_clip
from ..communication.collectives import ReduceOp, all_reduce
from .utils.hybrid_parallel_util import fused_allreduce_gradients

__all__ = ["HybridParallelOptimizer"]


class _HybridClip(ClipGradByGlobalNorm):
    """Global-norm clip over a model whose mp-sharded parameters carry the
    attribute ``is_distributed = True`` (the mp layers and the TP LLaMA
    blocks set it; a tensor's own ``is_distributed`` method does not count;
    reference HybridParallelClipGrad): their squared norms are summed
    over the mp group (and pp, sharding), the replicated ones counted
    once, so the norm is the dense model's."""

    def __init__(self, inner_clip, hcg):
        super().__init__(inner_clip.clip_norm)
        self._hcg = hcg

    def _global_norm_sq(self, params_grads):
        dist_sq = repl_sq = None
        for p, g in params_grads:
            if g is None or not _need_clip(p):
                continue
            sq = torch.sum(torch.square(g.float()))
            if getattr(p, "is_distributed", False) is True:
                dist_sq = sq if dist_sq is None else dist_sq + sq
            else:
                repl_sq = sq if repl_sq is None else repl_sq + sq
        if dist_sq is None and repl_sq is None:
            return None
        dev = (dist_sq if dist_sq is not None else repl_sq).device
        dist_sq = torch.zeros((), device=dev) if dist_sq is None \
            else dist_sq.clone()
        hcg = self._hcg
        for n, group in ((hcg.get_model_parallel_world_size(),
                          hcg.get_model_parallel_group()),
                         (hcg.get_pipe_parallel_world_size(),
                          hcg.get_pipe_parallel_group()),
                         (hcg.get_sharding_parallel_world_size(),
                          hcg.get_sharding_parallel_group())):
            if n > 1:
                all_reduce(dist_sq, ReduceOp.SUM, group)
        return dist_sq if repl_sq is None else dist_sq + repl_sq


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        if isinstance(optimizer._grad_clip, ClipGradByGlobalNorm) \
                and hcg.get_model_parallel_world_size() > 1:
            optimizer._grad_clip = _HybridClip(optimizer._grad_clip, hcg)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        hcg = self._hcg
        if hcg.get_model_parallel_world_size() > 1 \
                and hcg.get_data_parallel_world_size() > 1:
            fused_allreduce_gradients(self._inner_opt._parameter_list, hcg)
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad
