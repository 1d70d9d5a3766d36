"""Activations (port of ``paddle_tpu.nn.functional.activation``: ``relu``,
``relu6``, ``gelu``, ``silu``, ``swiglu``, ``hardsigmoid``, ``hardswish``
and ``softmax`` with the ``softmax`` override of
``paddle_tpu/ops/pallas/__init__.py``).  JAX computes every one but the
softmax outside any Pallas kernel, so here they are torch ops."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu", "hardsigmoid", "hardswish", "relu", "relu6", "silu",
           "softmax", "softmax_", "swiglu"]


def relu(x):
    """max(x, 0) (JAX ``activation.py:22``, ``jax.nn.relu``)."""
    return F.relu(x)


def relu6(x):
    """min(max(x, 0), 6) (JAX ``activation.py:30``, ``jax.nn.relu6``)."""
    return F.relu6(x)


def gelu(x, approximate=False):
    """GELU, exact (erf) unless ``approximate`` (JAX ``jax.nn.gelu``)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    """SiLU, x * sigmoid(x) (JAX ``activation.py:42``, ``jax.nn.silu``),
    computed outside any kernel there as here."""
    return F.silu(x)


def swiglu(x, y=None, name=None):
    """silu(x) * y (JAX ``activation.py:205``, the reference's fused
    SwiGLU); without ``y``, x is split in half along the last axis."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def hardsigmoid(x):
    """clip(x * 0.1666667 + 0.5, 0, 1) (JAX ``activation.py:80``) with
    Paddle's rounded slope, which is not the exact 1/6 of
    ``torch.nn.functional.hardsigmoid``."""
    return torch.clamp(x * 0.1666667 + 0.5, 0.0, 1.0)


def hardswish(x):
    """x * clip(x + 3, 0, 6) / 6 (JAX ``activation.py:85``), the formula of
    ``torch.nn.functional.hardswish``."""
    return F.hardswish(x)


def softmax(x, axis=-1, dtype=None, kernels=True, norm_kernels=False):
    """Softmax over ``axis`` after the optional cast to ``dtype`` (JAX
    ``activation.py:142``).  With ``kernels`` and ``norm_kernels`` (the
    counterparts of the JAX flags ``use_pallas_kernels`` and
    ``use_pallas_norm_kernels``) the last axis of a shape whose rows tile
    goes to :func:`paddle_tpu_torch.ops.fused.softmax` — the CUDA kernels
    for CUDA tensors, forward and backward — as the JAX dispatch
    (``ops/pallas/__init__.py:32``) sends it to the Pallas kernel; every
    other case is ``torch.softmax``, the counterpart of ``jax.nn.softmax``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype.replace("paddle.", ""))
    if dtype is not None:
        x = x.to(dtype)
    if kernels and norm_kernels and axis in (-1, x.dim() - 1):
        from ...ops.fused import softmax as fused_softmax
        out = fused_softmax(x)
        if out is not None:
            return out
    return torch.softmax(x, dim=axis)


@torch.no_grad()
def softmax_(x, axis=-1, dtype=None, kernels=True, norm_kernels=False):
    """In-place :func:`softmax` (JAX ``activation.py:151``): ``x`` takes the
    softmax of its own values, outside autograd, and is returned; with
    ``dtype`` it takes that dtype too.  The knobs are :func:`softmax`'s, so
    with both on a tileable last axis goes through the softmax kernel."""
    out = softmax(x.detach(), axis, dtype, kernels=kernels,
                  norm_kernels=norm_kernels)
    if out.dtype == x.dtype:
        x.copy_(out)
    else:
        x.data = out
    return x
