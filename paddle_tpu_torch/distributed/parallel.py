"""DataParallel and its helpers (port of
``paddle_tpu/distributed/parallel.py``; reference
python/paddle/distributed/parallel.py:219, backed by the C++ EagerReducer,
reducer.h:88).

``DataParallel`` wraps a module for eager data-parallel training: when its
group has more than one rank, each trainable parameter gets a gradient
hook that all-reduces the gradient over the group and multiplies it by
1 / n, as the JAX hook does, so every rank steps with the mean gradient.
At construction the parameters and buffers are broadcast from the group's
first rank (the reference's ``sync_params_buffers``), so the ranks start
from one model.
"""
from __future__ import annotations

import os

from torch import nn

from .communication.collectives import ReduceOp, all_reduce, broadcast
from .env import get_rank, get_world_size, init_parallel_env  # noqa: F401

__all__ = ["DataParallel", "init_parallel_env", "get_rank", "get_world_size",
           "ParallelEnv", "spawn"]


class ParallelEnv:
    """The reference's view of the rank environment."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        from .env import current_device
        return current_device().index or 0

    @property
    def local_rank(self):
        from .utils import get_local_rank
        return get_local_rank()

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        r = get_rank()
        return eps[r] if r < len(eps) else ""

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")


class DataParallel(nn.Module):
    """``layers`` for data-parallel training (reference parallel.py:219).
    ``comm_buffer_size`` / ``last_comm_buffer_size`` are accepted: each
    gradient is reduced on its own as it materialises."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, process_group=None):
        super().__init__()
        self._layers = layers
        self._group = group or process_group
        self.find_unused_parameters = find_unused_parameters
        self._grad_hooks = []
        n = get_world_size(self._group)
        if n > 1:
            src = self._group.ranks[0] if self._group is not None else 0
            for t in list(layers.parameters()) + list(layers.buffers()):
                broadcast(t.data, src=src, group=self._group)
            for p in layers.parameters():
                if p.requires_grad:
                    self._grad_hooks.append(p.register_hook(
                        self._make_hook(n)))

    def _make_hook(self, n):
        group = self._group

        def hook(g):
            t = g.detach().clone().contiguous()
            all_reduce(t, op=ReduceOp.SUM, group=group)
            return t.mul_(1.0 / n)
        return hook

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        if hasattr(self._layers, "set_state_dict"):
            return self._layers.set_state_dict(state_dict, *a, **k)
        return self._layers.load_state_dict(state_dict, *a, **k)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    @property
    def _inner_layer(self):
        return self._layers


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """``paddle.distributed.spawn`` parity (reference spawn.py): one process
    per rank with the PADDLE_* environment; ``func(*args)`` runs in each."""
    import multiprocessing as mp
    from .launch.main import _free_port, _rank_env
    if nprocs == -1:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    ctx = mp.get_context("spawn")
    master = f"127.0.0.1:{_free_port()}"
    endpoints = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(nprocs))
    procs = []
    for rank in range(nprocs):
        env = _rank_env({}, rank=rank, local_rank=rank, world=nprocs,
                        master=master, endpoints=endpoints, nnodes=1,
                        node_rank=0)
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
    return procs


def _spawn_entry(func, args, env):
    os.environ.update(env)
    func(*args)
