"""Shape manipulation (port of ``paddle_tpu.tensor.manipulation``:
``flatten``)."""
from __future__ import annotations

__all__ = ["flatten"]


def flatten(x, start_axis=0, stop_axis=-1):
    """Axes ``start_axis`` to ``stop_axis`` (both included, negative from
    the end) merged into one (JAX ``manipulation.py:66``)."""
    return x.flatten(start_axis, stop_axis)
