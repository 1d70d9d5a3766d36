"""Parameter-dict flattening (the dict part of
``paddle_tpu.parallel.pipeline._flatten`` / ``_unflatten``): the optimizer
updates ``{"a.b": tensor}`` maps, the model functions take nested dicts."""
from __future__ import annotations

__all__ = ["_flatten", "_unflatten"]


def _flatten(tree, prefix=""):
    """Nested dicts -> ``{"outer.inner": leaf}``; other leaves pass as they
    are (the port's parameters are dicts of tensors)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat, like):
    """The inverse of :func:`_flatten`, shaped like the nested dict
    ``like``."""
    out = {}
    for k, v in like.items():
        if isinstance(v, dict):
            sub = {kk[len(str(k)) + 1:]: vv for kk, vv in flat.items()
                   if kk.startswith(f"{k}.")}
            out[k] = _unflatten(sub, v)
        else:
            out[k] = flat[str(k)]
    return out
