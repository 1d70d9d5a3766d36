from . import lr
from .optimizers import Adam, AdamW, Momentum, Optimizer

__all__ = ["Adam", "AdamW", "Momentum", "Optimizer", "lr"]
