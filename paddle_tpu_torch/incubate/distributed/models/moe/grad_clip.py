"""MoE-aware global-norm clipping (port of ``paddle_tpu.incubate.
distributed.models.moe.grad_clip``; reference moe/grad_clip.py:63
ClipGradForMOEByGlobalNorm).

Expert parameters are sharded over the expert-parallel group, so the
global norm sums their local squared norm over that group once; the
shared parameters' gradients are the same on every rank and are not
summed.  The group is ``moe_group``, else the ``ep_axis`` group of the
default mesh — this rank alone without a mesh or without that axis, where
the clip is the plain global-norm clip (JAX sums over ``ep`` only inside
``shard_map``)."""
from __future__ import annotations

import torch

from .....nn.clip import ClipGradByGlobalNorm, _need_clip

__all__ = ["ClipGradForMOEByGlobalNorm"]


def _is_expert_param(p):
    return getattr(p, "is_expert", False) or getattr(p, "no_sync", False)


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group", ep_axis="ep"):
        super().__init__(clip_norm, group_name)
        self.is_expert = is_expert_param_func or _is_expert_param
        self.moe_group = moe_group
        self.ep_axis = ep_axis

    def _global_norm_sq(self, params_grads):
        from .....distributed.communication.collectives import (ReduceOp,
                                                                 all_reduce)
        from .....distributed.topology import axis_group
        normal = expert = None
        for p, g in params_grads:
            if g is None or not _need_clip(p):
                continue
            sq = torch.sum(torch.square(g.float()))
            if self.is_expert(p):
                expert = sq if expert is None else expert + sq
            else:
                normal = sq if normal is None else normal + sq
        if normal is None and expert is None:
            return None
        like = normal if normal is not None else expert
        normal = torch.zeros_like(like) if normal is None else normal
        expert = torch.zeros_like(like) if expert is None else expert
        group = self.moe_group if self.moe_group is not None \
            else axis_group(self.ep_axis)
        all_reduce(expert, ReduceOp.SUM, group)
        return normal + expert
