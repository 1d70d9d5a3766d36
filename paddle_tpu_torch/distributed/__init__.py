"""``paddle.distributed`` on ``torch.distributed`` (port of
``paddle_tpu/distributed``): one process per rank, started by the launch
CLI (``python -m paddle_tpu_torch.distributed.launch``); the environment
(``init_parallel_env``: nccl on the card, gloo on the CPU), process groups
and the collectives, counted by kind; the rank mesh (``topology``:
``DeviceMesh`` axes as groups); ``DataParallel``; ``fleet`` (the hybrid
groups, the tensor-parallel layers, the hybrid optimizer, the elastic
membership manager); ``sharding`` (eager ZeRO); and the crash-consistent
checkpoint at any world size (``checkpoint``).  The compiled-step
counterparts are ``paddle_tpu_torch.parallel.ShardedTrainStep`` and the
tensor-parallel ``models.llama.build_functional_llama(mp_axis=...)``.
Pipeline parallelism, ``auto_parallel`` and the quantized collectives are
not ported yet."""
from __future__ import annotations

from .env import init_parallel_env, get_rank, get_world_size, is_initialized
from .parallel import DataParallel, ParallelEnv, spawn
from .communication import (Group, new_group, get_group,
                            destroy_process_group, wait, barrier,
                            get_backend, all_reduce, all_gather,
                            all_gather_object, reduce, broadcast, scatter,
                            reduce_scatter, all_to_all, all_to_all_single,
                            send, recv, isend, irecv, batch_isend_irecv,
                            P2POp, gather, ReduceOp, collective_counts,
                            reset_collective_counts)
from . import topology
from . import fleet
from . import checkpoint
from .checkpoint.save_state_dict import save_state_dict
from .checkpoint.load_state_dict import load_state_dict
from . import sharding
from . import utils
from . import launch

__all__ = [
    "init_parallel_env", "get_rank", "get_world_size", "is_initialized",
    "DataParallel", "ParallelEnv", "spawn", "Group", "new_group", "get_group",
    "destroy_process_group", "wait", "barrier", "get_backend", "all_reduce",
    "all_gather", "all_gather_object", "reduce", "broadcast", "scatter",
    "reduce_scatter", "all_to_all", "all_to_all_single", "send", "recv",
    "isend", "irecv", "batch_isend_irecv", "P2POp", "gather", "ReduceOp",
    "fleet", "save_state_dict", "load_state_dict", "collective_counts",
    "reset_collective_counts",
]
