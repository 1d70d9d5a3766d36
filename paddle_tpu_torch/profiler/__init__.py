"""Profiler bridge: host annotations in the ``torch.profiler`` timeline.

``host_annotation(name)`` is a ``torch.profiler.record_function`` scope, so
the serving engine's host spans (``Telemetry(profiler_bridge=True)``) land in
a ``torch.profiler`` trace around the kernels and graph replays they
launched.  Safe to enter with no profiler active."""
from __future__ import annotations

import torch

__all__ = ["host_annotation"]


def host_annotation(name: str):
    """Context manager that records a host span named ``name`` in any active
    ``torch.profiler`` trace (``record_function``)."""
    return torch.profiler.record_function(name)
