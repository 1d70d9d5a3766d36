"""Fleet orchestration of the port (port of
``paddle_tpu/distributed/fleet``; reference python/paddle/distributed/
fleet/ — fleet.init, distributed_model model.py:33,
HybridParallelOptimizer, topology.py HybridCommunicateGroup): the
hybrid-parallel API, the tensor-parallel layers, the pipeline layers and
``PipelineParallel``, ``recompute`` and the elastic membership manager
(:mod:`.elastic`)."""
from .base.distributed_strategy import DistributedStrategy
from .fleet_api import (init, distributed_model, distributed_optimizer,
                        get_hybrid_communicate_group, worker_num,
                        worker_index, is_first_worker, barrier_worker,
                        _get_fleet)  # noqa: F401
from . import meta_parallel
from .meta_parallel import (ColumnParallelLinear, RowParallelLinear,
                            VocabParallelEmbedding, ParallelCrossEntropy,
                            PipelineLayer, LayerDesc, SharedLayerDesc,
                            TensorParallel, PipelineParallel)
from .recompute import recompute, recompute_sequential
from .utils import hybrid_parallel_util  # noqa: F401

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "worker_num", "worker_index", "is_first_worker", "barrier_worker",
           "meta_parallel", "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "PipelineLayer",
           "LayerDesc", "SharedLayerDesc", "TensorParallel",
           "PipelineParallel", "recompute", "recompute_sequential"]
