from .pipeline import PipelineTrainStep, _flatten, _unflatten  # noqa: F401
from .pipeline_schedules import (Pipeline1F1BTrainStep,
                                 GenericPipeline1F1BTrainStep)
from .sharded import ShardedTrainStep, zero_stage_name
from .train_step import TrainStep, compile_train_step

__all__ = ["TrainStep", "compile_train_step", "ShardedTrainStep",
           "zero_stage_name", "PipelineTrainStep", "Pipeline1F1BTrainStep",
           "GenericPipeline1F1BTrainStep"]
