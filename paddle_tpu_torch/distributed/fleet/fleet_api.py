"""fleet.init / distributed_model / distributed_optimizer (port of
``paddle_tpu/distributed/fleet/fleet_api.py``; reference
python/paddle/distributed/fleet/fleet.py init, model.py:33
distributed_model, optimizer.py distributed_optimizer ->
HybridParallelOptimizer hybrid_parallel_optimizer.py:275).
"""
from __future__ import annotations

from typing import Optional

from ..env import get_rank, get_world_size, init_parallel_env
from ..topology import CommunicateTopology, HybridCommunicateGroup
from .base.distributed_strategy import DistributedStrategy

_state = {"strategy": None, "hcg": None, "initialized": False}


def init(role_maker=None, is_collective=False,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO",
         device=None):
    """Join the world (``init_parallel_env(device)``) and build the hybrid
    topology and its mesh from ``strategy.hybrid_configs``: with every
    degree 1 the world is data parallel; otherwise dp is scaled so the
    degrees tile the world."""
    strategy = strategy or DistributedStrategy()
    init_parallel_env(device)
    hc = strategy.hybrid_configs
    dp = int(hc.get("dp_degree", 1))
    mp = int(hc.get("mp_degree", 1))
    pp = int(hc.get("pp_degree", 1))
    sharding = int(hc.get("sharding_degree", 1))
    sep = int(hc.get("sep_degree", 1))
    world = get_world_size()
    declared = dp * mp * pp * sharding * sep
    if declared != world and declared == 1:
        dp = world
    elif declared != world:
        rest = mp * pp * sharding * sep
        if world % rest:
            raise ValueError(f"hybrid degrees {hc} don't tile {world} ranks")
        dp = world // rest
    hcg = HybridCommunicateGroup(
        CommunicateTopology(dims=(dp, pp, sharding, sep, mp)))
    _state.update(strategy=strategy, hcg=hcg, initialized=True)


def _get_fleet():
    return _state


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _state["hcg"] is None:
        init(is_collective=True)
    return _state["hcg"]


def fleet_initialized():
    return _state["initialized"]


def worker_num():
    return get_world_size()


def worker_index():
    return get_rank()


def is_first_worker():
    return get_rank() == 0


def barrier_worker():
    from ..communication.group import barrier
    barrier()


def distributed_model(model):
    """reference model.py:33: ``TensorParallel`` when mp > 1,
    ``DataParallel`` over the dp group when dp > 1, else the model."""
    hcg = get_hybrid_communicate_group()
    from ..parallel import DataParallel
    from .meta_parallel import TensorParallel
    if hcg.get_pipe_parallel_world_size() > 1:
        raise NotImplementedError(
            "distributed_model: pipeline parallelism is not ported yet")
    if hcg.get_model_parallel_world_size() > 1:
        return TensorParallel(model, hcg, _state["strategy"])
    if hcg.get_data_parallel_world_size() > 1:
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    from .hybrid_optimizer import HybridParallelOptimizer
    hcg = get_hybrid_communicate_group()
    return HybridParallelOptimizer(optimizer, hcg,
                                   strategy or _state["strategy"])
