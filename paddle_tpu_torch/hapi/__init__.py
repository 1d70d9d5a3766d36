"""High-level API (port of ``paddle_tpu/hapi``: ``Model`` and the
callbacks; reference python/paddle/hapi/).  ``summary`` and ``flops`` are
not ported (ROADMAP A item 7)."""
from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
