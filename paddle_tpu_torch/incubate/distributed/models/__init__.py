"""paddle.incubate.distributed.models' port: the MoE layers."""
from . import moe

__all__ = ["moe"]
