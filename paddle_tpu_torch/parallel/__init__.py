from .pipeline import _flatten, _unflatten  # noqa: F401
from .train_step import TrainStep, compile_train_step

__all__ = ["TrainStep", "compile_train_step"]
