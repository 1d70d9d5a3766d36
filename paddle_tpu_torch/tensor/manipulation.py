"""Shape manipulation (port of ``paddle_tpu.tensor.manipulation``:
``flatten``, ``concat``, ``reshape``, ``transpose`` and ``squeeze``, with
Paddle's semantics as the JAX functions implement them)."""
from __future__ import annotations

import torch

__all__ = ["concat", "flatten", "reshape", "squeeze", "transpose"]


def flatten(x, start_axis=0, stop_axis=-1):
    """Axes ``start_axis`` to ``stop_axis`` (both included, negative from
    the end) merged into one (JAX ``manipulation.py:66``)."""
    return x.flatten(start_axis, stop_axis)


def concat(x, axis=0):
    """The tensors of the sequence ``x`` joined along ``axis`` (negative
    from the end; JAX ``manipulation.py:101``)."""
    return torch.cat(list(x), dim=int(axis))


def reshape(x, shape):
    """``x`` in ``shape`` (JAX ``manipulation.py:42``): an entry 0 copies
    the input's extent at that index, and one -1 is inferred."""
    shape = [int(s) for s in shape]
    return x.reshape([x.shape[i] if s == 0 and i < x.dim() else s
                      for i, s in enumerate(shape)])


def transpose(x, perm):
    """The axes of ``x`` in the order ``perm`` (JAX
    ``manipulation.py:459``)."""
    return x.permute([int(p) for p in perm])


def squeeze(x, axis=None):
    """``x`` without size-1 axes (JAX ``manipulation.py:76``): all of them
    when ``axis`` is None, else those listed in ``axis`` (an int or a
    list, negative from the end) that have size 1; a listed axis of
    another size stays, silently."""
    if axis is None:
        return x.squeeze()
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    keep = sorted({int(a) % x.dim() for a in axes
                   if x.shape[int(a) % x.dim()] == 1})
    return x.squeeze(tuple(keep)) if keep else x
