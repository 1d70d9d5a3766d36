"""Dropout and interpolation (port of
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

import numpy as np
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


def _linear_1d(x, n_out, axis, align_corners, align_mode):
    """JAX ``_resize_1d``'s linear branch along ``axis``: source positions
    ``linspace(0, in - 1, out)`` with ``align_corners``, ``i * in / out``
    with ``align_mode=1``, else half-pixel ``(i + 0.5) * in / out - 0.5``;
    clipped to [0, in - 1]; the two neighbours blended by the position's
    fraction (in x's dtype)."""
    n_in = x.shape[axis]
    if align_corners:
        pos = np.linspace(0.0, n_in - 1.0, n_out)
    elif align_mode == 1:
        pos = np.arange(n_out) * (n_in / n_out)
    else:
        pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.clip(lo + 1, 0, n_in - 1)
    shape = [1] * x.dim()
    shape[axis] = n_out
    w = torch.as_tensor(pos - lo, dtype=x.dtype).to(x.device).reshape(shape)
    lo_v = x.index_select(axis, torch.as_tensor(lo).to(x.device))
    hi_v = x.index_select(axis, torch.as_tensor(hi).to(x.device))
    return lo_v * (1 - w) + hi_v * w


def _cubic_weights(n_in, n_out):
    """``jax.image.resize(method="cubic")``'s weights along one axis
    (``compute_weight_mat`` with antialiasing): the Keys kernel at a =
    -0.5 between half-pixel centres, widened by in / out when the axis
    shrinks, each output's weights normalised to sum 1; [n_in, n_out] in
    f64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    d = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = ((1.5 * d - 2.5) * d) * d + 1.0
    w = np.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, w)
    w = np.where(d >= 2.0, 0.0, w)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _cubic_1d(x, n_out, axis):
    """x resampled along ``axis`` by :func:`_cubic_weights` (a product with
    the [in, out] weight matrix in x's dtype)."""
    w = torch.as_tensor(_cubic_weights(x.shape[axis], n_out),
                        dtype=x.dtype).to(x.device)
    return torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format=None):
    """Resize over the spatial axes (JAX ``common.py:161``): an output size
    per axis from ``size``, or ``floor(in * scale_factor)``.  Channels are
    axis 1 (``NCW``, ``NCHW``, ``NCDHW``; the default for 3, 4 and 5 axes)
    or last (``NWC``, ``NHWC``, ``NDHWC``).  JAX computes every mode
    outside any kernel; so do these torch ops.

    - ``nearest``: output index i reads input index ``floor(i * in /
      out)``, or ``round(linspace(0, in - 1, out))[i]`` with
      ``align_corners``;
    - ``linear`` / ``bilinear`` / ``trilinear``: one linear pass an axis
      (:func:`_linear_1d`; ``align_corners`` and ``align_mode`` place the
      source positions);
    - ``bicubic``: ``jax.image.resize(method="cubic")``, the Keys kernel
      at a = -0.5 at half-pixel centres, antialiased where an axis shrinks
      (:func:`_cubic_weights`); it ignores ``align_corners``.  This is not
      torch's ``bicubic`` (a = -0.75, no antialiasing);
    - ``area``: along an axis whose size the output's divides, the mean
      over each run of in / out inputs; along any other, the half-pixel
      linear pass (not torch's adaptive ``area``)."""
    mode = mode.lower()
    if mode not in ("nearest", "linear", "bilinear", "trilinear", "bicubic",
                    "area"):
        raise ValueError(f"interpolate: mode {mode!r} (nearest, linear, "
                         f"bilinear, trilinear, bicubic or area)")
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
    y = x
    if mode == "nearest" and not align_corners:
        # torch's nearest index at an explicit size is floor(i * in / out)
        y = torch.nn.functional.interpolate(x, size=out, mode="nearest")
    else:
        for axis, (n_in, n_out) in enumerate(zip(in_sizes, out), start=2):
            if mode == "nearest":
                idx = torch.linspace(0, n_in - 1, n_out, dtype=torch.float64,
                                     device=x.device).round().long()
                y = y.index_select(axis, idx.clamp(0, n_in - 1))
            elif mode == "bicubic":
                if n_in != n_out:
                    y = _cubic_1d(y, n_out, axis)
            elif mode == "area" and n_in % n_out == 0:
                y = y.unflatten(axis, (n_out, n_in // n_out)).mean(axis + 1)
            elif mode == "area":
                y = _linear_1d(y, n_out, axis, False, 0)
            else:
                y = _linear_1d(y, n_out, axis, align_corners, align_mode)
    return y.movedim(1, -1) if channel_last else y
