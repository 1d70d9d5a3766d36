"""RMSNorm, LayerNorm, GroupNorm and BatchNorm (port of
``paddle_tpu.nn.functional.norm`` and of the ``layer_norm`` override in
``paddle_tpu/ops/pallas/__init__.py``)."""
from __future__ import annotations

import torch

__all__ = ["rms_norm_ref", "layer_norm_ref", "layer_norm", "group_norm",
           "batch_norm"]


def rms_norm_ref(v, w=None, epsilon=1e-6):
    """RMSNorm over the last axis with f32 statistics; the weight is applied
    in f32 and the result cast back to ``v.dtype`` — the same convention as
    the JAX package's ``rms_norm_ref``, which the paged serving path uses
    for every norm."""
    vf = v.float()
    ms = vf.square().mean(dim=-1, keepdim=True)
    out = vf * torch.rsqrt(ms + epsilon)
    if w is not None:
        out = out * w.float()
    return out.to(v.dtype)


def layer_norm_ref(v, w=None, b=None, n_axes=1, epsilon=1e-5):
    """LayerNorm over the last ``n_axes`` axes with f32 statistics (JAX
    ``layer_norm_ref``, ``norm.py:77``): the normalised value is cast to
    ``v.dtype`` first, then the weight and bias apply in that dtype."""
    dims = tuple(range(v.dim() - n_axes, v.dim()))
    vf = v.float()
    mean = vf.mean(dim=dims, keepdim=True)
    var = vf.var(dim=dims, unbiased=False, keepdim=True)
    out = ((v - mean) * torch.rsqrt(var + epsilon)).to(v.dtype)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               kernels=True, norm_kernels=False):
    """The public ``layer_norm`` (JAX ``norm.py:91``) with its dispatch
    (``ops/pallas/__init__.py:45``).  ``kernels`` and ``norm_kernels`` are
    the counterparts of the JAX flags ``use_pallas_kernels`` and
    ``use_pallas_norm_kernels``: with both on, an affine LayerNorm over one
    axis goes to :func:`paddle_tpu_torch.ops.fused.layer_norm` (the CUDA
    kernels for CUDA tensors), and to :func:`layer_norm_ref` where that
    declines the shape; otherwise it is :func:`layer_norm_ref`."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n_axes = len(tuple(normalized_shape))
    if weight is None and bias is not None:
        # the bias applies without a weight (paddle semantics)
        weight = torch.ones_like(bias)
    if kernels and norm_kernels and n_axes == 1 and weight is not None \
            and bias is not None:
        from ...ops.fused import layer_norm as fused_layer_norm
        out = fused_layer_norm(x, weight, bias, eps=epsilon)
        if out is not None:
            return out
    return layer_norm_ref(x, weight, bias, n_axes, epsilon)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW"):
    """GroupNorm (JAX ``norm.py:163``): the channels fall into
    ``num_groups`` groups, each normalised over its channels and every
    spatial position with the biased variance, then the per-channel weight
    and bias.  Channels are axis 1, or the last axis for a channel-last
    ``data_format`` (``NHWC``, ``NLC``, ``NDHWC``).  JAX computes it
    outside any Pallas kernel, so here it is
    ``torch.nn.functional.group_norm``."""
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    if channel_last:
        x = x.movedim(-1, 1)
    out = torch.nn.functional.group_norm(x, num_groups, weight, bias,
                                         epsilon)
    return out.movedim(1, -1) if channel_last else out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None):
    """BatchNorm over every axis but the channels (JAX ``norm.py:19``).
    With ``use_global_stats`` (default: not ``training``) it normalises
    with the running buffers.  Otherwise it normalises with the batch's
    mean and biased variance and updates the buffers in place with
    Paddle's convention: ``running = momentum * running + (1 - momentum) *
    batch``, from the unbiased variance (n / (n - 1)).
    ``torch.nn.functional.batch_norm`` weighs the batch by its
    ``momentum``, so it is handed ``1 - momentum``.  Channels are axis 1,
    or the last axis for a channel-last ``data_format``.  An affine weight
    and bias of another dtype than f32 buffers are cast to the buffers'
    dtype, the mixed form torch's kernels take (a bf16 input with f32
    statistics and affine); the output keeps the input's dtype.  JAX
    computes it outside any Pallas kernel, so here it is torch's."""
    if use_global_stats is None:
        use_global_stats = not training
    stats = running_mean if running_mean is not None else running_var
    if stats is not None:
        weight, bias = (t if t is None or t.dtype == stats.dtype
                        else t.to(stats.dtype) for t in (weight, bias))
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    if channel_last:
        x = x.movedim(-1, 1)
    out = torch.nn.functional.batch_norm(
        x, running_mean, running_var, weight, bias,
        training=not use_global_stats, momentum=1.0 - momentum,
        eps=epsilon)
    return out.movedim(1, -1) if channel_last else out
