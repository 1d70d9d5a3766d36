from .pipeline import _flatten, _unflatten  # noqa: F401
from .sharded import ShardedTrainStep, zero_stage_name
from .train_step import TrainStep, compile_train_step

__all__ = ["TrainStep", "compile_train_step", "ShardedTrainStep",
           "zero_stage_name"]
