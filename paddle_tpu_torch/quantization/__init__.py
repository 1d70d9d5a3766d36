"""Symmetric absmax weight quantization (port of the weight quantizer in
``paddle_tpu/quantization/__init__.py``).  The serving engine's
``quantize=`` knob snaps its weights onto this grid through
``serving.quant.quantize_params``."""
from __future__ import annotations

import torch

__all__ = ["quantize_weight", "dequantize_weight"]


def quantize_weight(w, bits=8, axis=None):
    """-> (int values, scale): symmetric absmax quantization (int8 storage
    up to 8 bits, int32 above).  ``axis=None`` gives one per-tensor scale;
    an int or tuple of ints reduces the absmax over exactly those axes and
    keeps them as size-1 dims, so ``q * scale`` broadcasts back — for an
    ``[in, out]`` matmul weight ``axis=-2`` is one scale per output
    channel.  Rounding is half to even, as in the JAX version."""
    qmax = 2.0 ** (bits - 1) - 1
    if axis is None:
        absmax = w.abs().amax()
    else:
        absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = absmax.clamp(min=1e-8) / qmax
    idtype = torch.int8 if bits <= 8 else torch.int32
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(idtype)
    return q, scale


def dequantize_weight(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_weight`: ``scale`` is the per-tensor
    scalar or the keepdims per-channel tensor it returned."""
    return q.to(dtype) * torch.as_tensor(scale, device=q.device).to(dtype)
