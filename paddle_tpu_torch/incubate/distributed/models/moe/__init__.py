"""Expert-parallel MoE (port of ``paddle_tpu.incubate.distributed.models.
moe``; reference python/paddle/incubate/distributed/models/moe/)."""
from . import utils
from .gate import (BaseGate, GShardGate, NaiveGate, SwitchGate,
                   compute_capacity, top_k_gating)
from .grad_clip import ClipGradForMOEByGlobalNorm
from .moe_layer import (MoELayer, ep_all_to_all, ep_all_to_all_back,
                        moe_combine, moe_dispatch, moe_ffn)

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate", "top_k_gating",
           "compute_capacity", "MoELayer", "moe_dispatch", "moe_combine",
           "moe_ffn", "ep_all_to_all", "ep_all_to_all_back",
           "ClipGradForMOEByGlobalNorm", "utils"]
