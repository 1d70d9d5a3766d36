"""meta_parallel (port of ``paddle_tpu/distributed/fleet/meta_parallel``;
reference fleet/meta_parallel/): the tensor-parallel layers and the
``TensorParallel`` wrapper, the pipeline layer description
(``PipelineLayer``, ``LayerDesc``, ``SharedLayerDesc``, ``SegmentLayers``)
and the ``PipelineParallel`` runtime."""
from __future__ import annotations

from torch import nn

from .mp_layers import (VocabParallelEmbedding, ColumnParallelLinear,  # noqa: F401
                        RowParallelLinear, ParallelCrossEntropy)
from .pp_layers import (PipelineLayer, LayerDesc, SharedLayerDesc,  # noqa: F401
                        SegmentLayers)
from .pipeline_parallel import PipelineParallel  # noqa: F401
from ..utils.hybrid_parallel_util import _broadcast_params

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "TensorParallel",
           "PipelineLayer", "LayerDesc", "SharedLayerDesc", "SegmentLayers",
           "PipelineParallel"]


class TensorParallel(nn.Module):
    """reference meta_parallel/tensor_parallel.py:28: at construction the
    parameters that are not mp-sharded (no ``is_distributed``) are
    broadcast from the mp group's first rank, so the replicated ones agree
    across the group."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        if hcg is not None:
            _broadcast_params(layers, hcg.get_model_parallel_group(),
                              skip_distributed=True)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)
