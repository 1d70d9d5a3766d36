"""Dropout and nearest interpolation (port of
``paddle_tpu.nn.functional.common.dropout`` and ``interpolate``).

The keep mask comes from the ``torch.Generator`` the caller passes (on the
tensor's device), never from torch's global random state, so that a model
that owns its generator (``models.ernie``) draws the same masks from the
same seed; JAX draws its masks from ``jax.random`` keys instead, so the
bits differ and the tests compare distributions and the rate-0 and
inference paths.
"""
from __future__ import annotations

import math

import torch

__all__ = ["dropout", "interpolate"]


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


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format=None):
    """Nearest-neighbour resize over the spatial axes (JAX ``common.py:161``
    in its ``nearest`` mode): an output size per axis from ``size``, or
    ``floor(in * scale_factor)``; output index i reads input index
    ``floor(i * in / out)``, or ``round(linspace(0, in - 1, out))[i]`` with
    ``align_corners``.  Channels are axis 1 (``NCW``, ``NCHW``, ``NCDHW``;
    the default for 3, 4 and 5 axes) or last (``NWC``, ``NHWC``,
    ``NDHWC``).  JAX computes it outside any kernel; the other modes of the
    JAX function have no counterpart here yet and raise."""
    if mode.lower() != "nearest":
        raise ValueError(f"interpolate: mode {mode!r} is not ported "
                         f"(nearest only)")
    nd = x.dim()
    df = data_format or {3: "NCW", 4: "NCHW", 5: "NCDHW"}[nd]
    channel_last = df in ("NWC", "NHWC", "NDHWC")
    if channel_last:
        x = x.movedim(-1, 1)
    in_sizes = list(x.shape[2:])
    if size is not None:
        out = [int(s) for s in (size if isinstance(size, (list, tuple))
                                else [size] * len(in_sizes))]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(in_sizes)
        out = [int(math.floor(i * float(s))) for i, s in zip(in_sizes, sf)]
    if not align_corners:
        # torch's nearest index at an explicit size is floor(i * in / out)
        y = torch.nn.functional.interpolate(x, size=out, mode="nearest")
    else:
        y = x
        for axis, (n_in, n_out) in enumerate(zip(in_sizes, out), start=2):
            idx = torch.linspace(0, n_in - 1, n_out, dtype=torch.float64,
                                 device=x.device).round().long()
            y = y.index_select(axis, idx.clamp(0, n_in - 1))
    return y.movedim(1, -1) if channel_last else y
