"""``save`` / ``load`` (port of ``paddle_tpu/framework.py:96-115``;
reference python/paddle/framework/io.py save :773, load :1020).

A nested dict / list / tuple of tensors and plain values is pickled with
every tensor as the JAX package writes one — ``{"__paddle_tpu_tensor__":
True, "data": <numpy array>, "stop_gradient", "is_parameter", "name"}`` —
so a ``.pdparams`` / ``.pdopt`` file written by either package loads in
the other.  numpy has no bfloat16 of its own: a bf16 tensor is written as
its f32 values (exact), and a bf16 array the JAX package wrote (the
``ml_dtypes`` type) is read as f32; ``set_state_dict`` / ``Model.load``
cast each value to the dtype of the tensor it lands in.  ``load`` returns
CPU tensors (``return_numpy=True``: numpy arrays)."""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch import nn

__all__ = ["save", "load"]


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return {"__paddle_tpu_tensor__": True, "data": t.cpu().numpy(),
                "stop_gradient": not obj.requires_grad,
                "is_parameter": isinstance(obj, nn.Parameter),
                "name": getattr(obj, "name", None)}
    if isinstance(obj, np.ndarray):
        return {"__paddle_tpu_tensor__": True, "data": obj,
                "stop_gradient": True, "is_parameter": False, "name": None}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _host(data):
    data = np.asarray(data)
    if data.dtype.name == "bfloat16":
        data = data.astype(np.float32)
    return data


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__paddle_tpu_tensor__"):
            data = _host(obj["data"])
            if return_numpy:
                return data
            t = torch.from_numpy(np.ascontiguousarray(data))
            return nn.Parameter(t, requires_grad=not obj.get(
                "stop_gradient", False)) if obj.get("is_parameter") \
                and t.is_floating_point() else t
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """paddle.save parity (framework/io.py:773)."""
    if hasattr(path, "write"):
        pickle.dump(_to_saveable(obj), path, protocol=protocol)
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """paddle.load parity (framework/io.py:1020)."""
    if hasattr(path, "read"):
        obj = pickle.load(path)
    else:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    return _from_saveable(obj, return_numpy=return_numpy)
