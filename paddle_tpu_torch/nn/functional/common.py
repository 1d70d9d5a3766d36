"""Dropout (port of ``paddle_tpu.nn.functional.common.dropout``).

The keep mask comes from the ``torch.Generator`` the caller passes (on the
tensor's device), never from torch's global random state, so that a model
that owns its generator (``models.ernie``) draws the same masks from the
same seed; JAX draws its masks from ``jax.random`` keys instead, so the
bits differ and the tests compare distributions and the rate-0 and
inference paths.
"""
from __future__ import annotations

import torch

__all__ = ["dropout"]


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """JAX ``dropout`` (``nn/functional/common.py:32``): in training with
    ``p`` > 0, zero each element with probability ``p`` — along ``axis``
    (an int or a list) the mask has the tensor's extent and is broadcast
    over the other axes — and scale the kept ones by 1 / (1 - p) in
    ``upscale_in_train`` mode (``downscale_in_infer`` keeps them as they
    are); the result is in x's dtype.  Outside training, or at ``p`` = 0,
    x comes back unchanged (in both modes, as in JAX)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}: upscale_in_train or "
                         f"downscale_in_infer")
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training draws its mask from an "
                         "explicit torch.Generator on the tensor's device")
    if axis is None:
        shape = x.shape
    else:
        axes = {a % x.dim() for a in (axis if isinstance(axis, (list, tuple))
                                      else [axis])}
        shape = tuple(n if i in axes else 1 for i, n in enumerate(x.shape))
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(x.dtype)
