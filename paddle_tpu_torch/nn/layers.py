"""Linear, Embedding, Dropout, LayerNorm, GroupNorm, BatchNorm2D, Conv2D,
the activations, the pooling layers and Flatten, with the JAX package's
parameter and buffer names, layouts and initialisers
(``paddle_tpu/nn/common.py`` ``Linear``, ``Embedding``, ``Dropout``,
``Flatten``; ``paddle_tpu/nn/norm.py`` ``LayerNorm``, ``GroupNorm``,
``BatchNorm2D``; ``paddle_tpu/nn/conv.py`` ``Conv2D``;
``paddle_tpu/nn/activation.py`` ``GELU``, ``ReLU``, ``ReLU6``,
``Hardswish``, ``Hardsigmoid``; ``paddle_tpu/nn/pooling.py``
``MaxPool2D``, ``AdaptiveAvgPool2D``).  ``Sequential`` is
``torch.nn.Sequential``: its children are named ``0``, ``1`` ... as in
JAX's ``nn/container.py:12``.

They are plain ``torch.nn.Module``s, not a port of the eager ``Layer``
framework.  Linear weights keep the ``[in, out]`` layout (``x @ W + b``), so
weights cross from JAX by name and value.  Initialisers draw from the
``torch.Generator`` the caller passes: Xavier-uniform Linear weights, zero
biases, N(0, 1) embeddings, norm weights 1 and biases 0, convolution
weights and biases uniform in +-sqrt(1 / fan_in) — the JAX package's
defaults, though not its ``jax.random`` draws.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..tensor.manipulation import flatten
from .functional.activation import (gelu, hardsigmoid, hardswish, relu,
                                    relu6)
from .functional.common import dropout
from .functional.norm import batch_norm, group_norm, layer_norm
from .functional.pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "GroupNorm",
           "BatchNorm2D", "Conv2D", "GELU", "ReLU", "ReLU6", "Hardswish",
           "Hardsigmoid", "MaxPool2D", "AdaptiveAvgPool2D", "Flatten",
           "Sequential"]

Sequential = nn.Sequential


class Linear(nn.Module):
    """y = x @ weight + bias, weight [in_features, out_features]; with
    ``bias=False`` (JAX ``bias_attr=False``) there is no bias parameter."""

    def __init__(self, in_features, out_features, bias=True, *, dtype,
                 device, generator):
        super().__init__()
        bound = math.sqrt(6.0 / (in_features + out_features))
        w = torch.rand((in_features, out_features), generator=generator,
                       device=device) * (2 * bound) - bound
        self.weight = nn.Parameter(w.to(dtype))
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=dtype, device=device)) if bias else None

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """weight [num_embeddings, embedding_dim] looked up by integer ids."""

    def __init__(self, num_embeddings, embedding_dim, *, dtype, device,
                 generator):
        super().__init__()
        w = torch.randn((num_embeddings, embedding_dim), generator=generator,
                        device=device)
        self.weight = nn.Parameter(w.to(dtype))

    def forward(self, ids):
        return self.weight[ids.long()]


class Dropout(nn.Module):
    """JAX ``Dropout`` (``nn/common.py:50``): :func:`~paddle_tpu_torch.nn.
    functional.common.dropout` in training mode, the identity in eval mode.
    ``generator`` (a ``torch.Generator`` on the device of the tensors)
    draws the masks; the model that owns the module passes its own.  It has
    no parameters."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode, generator=self.generator)


class LayerNorm(nn.Module):
    """Affine LayerNorm over the last axis through
    :func:`~paddle_tpu_torch.nn.functional.norm.layer_norm`; ``kernels``
    and ``norm_kernels`` are that function's knobs (the JAX flags
    ``use_pallas_kernels`` and ``use_pallas_norm_kernels``)."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, dtype, device,
                 kernels=True, norm_kernels=False):
        super().__init__()
        self.epsilon = epsilon
        self.kernels, self.norm_kernels = kernels, norm_kernels
        self.weight = nn.Parameter(torch.ones(normalized_shape, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(normalized_shape, dtype=dtype,
                                             device=device))

    def forward(self, x):
        return layer_norm(x, self.weight.shape, self.weight, self.bias,
                          self.epsilon, kernels=self.kernels,
                          norm_kernels=self.norm_kernels)


class GroupNorm(nn.Module):
    """JAX ``GroupNorm`` (``nn/norm.py:141``): affine GroupNorm over
    ``num_groups`` groups of the channels (axis 1) through
    :func:`~paddle_tpu_torch.nn.functional.norm.group_norm`; weight 1 and
    bias 0 of ``num_channels`` each."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5, *, dtype,
                 device):
        super().__init__()
        self.num_groups, self.epsilon = num_groups, epsilon
        self.weight = nn.Parameter(torch.ones(num_channels, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, dtype=dtype,
                                             device=device))

    def forward(self, x):
        return group_norm(x, self.num_groups, self.epsilon, self.weight,
                          self.bias)


class BatchNorm2D(nn.Module):
    """JAX ``BatchNorm2D`` (``nn/norm.py:17-38``) through
    :func:`~paddle_tpu_torch.nn.functional.norm.batch_norm`: weight 1 and
    bias 0 of ``num_features`` in ``dtype``, and the running buffers under
    JAX's own names, ``_mean`` (0) and ``_variance`` (1), in f32 whatever
    ``dtype`` is, so that the state dict's names are JAX's
    ``named_buffers()``.  Training mode normalises with the batch and
    updates the buffers (Paddle's ``momentum``); eval mode uses them."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, *, dtype,
                 device):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(num_features, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=dtype,
                                             device=device))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self.momentum, epsilon=self.epsilon)


class Conv2D(nn.Module):
    """JAX ``Conv2D`` (``nn/conv.py:78``) in NCHW: weight [out_channels,
    in_channels / groups, kh, kw] (Paddle's layout, which is also torch's)
    and, unless ``bias=False`` (JAX ``bias_attr=False``), bias
    [out_channels]; both uniform in +-sqrt(1 / fan_in), fan_in = in_channels
    / groups * kh * kw (``nn/conv.py:43-57``).  The convolution is
    ``torch.nn.functional.conv2d``: the JAX package leaves it to XLA,
    outside any kernel of its own."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, *, dtype,
                 device, generator):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else kernel_size
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        bound = math.sqrt(1.0 / max(in_channels // groups * kh * kw, 1))

        def uniform(*shape):
            u = torch.rand(shape, generator=generator, device=device)
            return nn.Parameter((u * (2 * bound) - bound).to(dtype))

        self.weight = uniform(out_channels, in_channels // groups, kh, kw)
        self.bias = uniform(out_channels) if bias else None

    def forward(self, x):
        return torch.nn.functional.conv2d(x, self.weight, self.bias,
                                          self.stride, self.padding,
                                          self.dilation, self.groups)


class GELU(nn.Module):
    """JAX ``GELU`` (``nn/activation.py:34``): the exact (erf) GELU through
    :func:`~paddle_tpu_torch.nn.functional.activation.gelu`."""

    def forward(self, x):
        return gelu(x, approximate=False)


class ReLU(nn.Module):
    """JAX ``ReLU``: :func:`~paddle_tpu_torch.nn.functional.activation.
    relu`."""

    def forward(self, x):
        return relu(x)


class ReLU6(nn.Module):
    """JAX ``ReLU6``: :func:`~paddle_tpu_torch.nn.functional.activation.
    relu6`."""

    def forward(self, x):
        return relu6(x)


class Hardswish(nn.Module):
    """JAX ``Hardswish``: :func:`~paddle_tpu_torch.nn.functional.
    activation.hardswish`."""

    def forward(self, x):
        return hardswish(x)


class Hardsigmoid(nn.Module):
    """JAX ``Hardsigmoid``: :func:`~paddle_tpu_torch.nn.functional.
    activation.hardsigmoid` at Paddle's default slope 0.1666667."""

    def forward(self, x):
        return hardsigmoid(x)


class MaxPool2D(nn.Module):
    """JAX ``MaxPool2D`` (``nn/pooling.py:53``): :func:`~paddle_tpu_torch.
    nn.functional.pooling.max_pool2d`."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, \
            padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return max_pool2d(x, self.kernel_size, self.stride, self.padding,
                          self.ceil_mode)


class AdaptiveAvgPool2D(nn.Module):
    """JAX ``AdaptiveAvgPool2D`` (``nn/pooling.py:74``):
    :func:`~paddle_tpu_torch.nn.functional.pooling.adaptive_avg_pool2d`."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size)


class Flatten(nn.Module):
    """JAX ``Flatten`` (``nn/common.py:116``): axes ``start_axis`` (1) to
    ``stop_axis`` (-1) merged into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)
