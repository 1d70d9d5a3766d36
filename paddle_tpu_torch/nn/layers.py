"""Linear, Embedding, Dropout, LayerNorm, GroupNorm, Conv2D and GELU
modules with the JAX package's parameter names, layouts and initialisers
(``paddle_tpu/nn/common.py`` ``Linear``, ``Embedding``, ``Dropout``;
``paddle_tpu/nn/norm.py`` ``LayerNorm``, ``GroupNorm``;
``paddle_tpu/nn/conv.py`` ``Conv2D``; ``paddle_tpu/nn/activation.py``
``GELU``).

They are plain ``torch.nn.Module``s, not a port of the eager ``Layer``
framework.  Linear weights keep the ``[in, out]`` layout (``x @ W + b``), so
weights cross from JAX by name and value.  Initialisers draw from the
``torch.Generator`` the caller passes: Xavier-uniform Linear weights, zero
biases, N(0, 1) embeddings, LayerNorm and GroupNorm weight 1 and bias 0,
convolution
weights and biases uniform in +-sqrt(1 / fan_in) — the JAX package's
defaults, though not its ``jax.random`` draws.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .functional.activation import gelu
from .functional.common import dropout
from .functional.norm import group_norm, layer_norm

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "GroupNorm",
           "Conv2D", "GELU"]


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


class Conv2D(nn.Module):
    """JAX ``Conv2D`` (``nn/conv.py:78``) in NCHW: weight [out_channels,
    in_channels, kh, kw] (Paddle's layout, which is also torch's) and bias
    [out_channels].  The convolution is ``torch.nn.functional.conv2d``: the
    JAX package leaves it to XLA, outside any kernel of its own."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, *, dtype, device, generator):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else kernel_size
        self.stride, self.padding = stride, padding
        bound = math.sqrt(1.0 / (in_channels * kh * kw))

        def uniform(*shape):
            u = torch.rand(shape, generator=generator, device=device)
            return nn.Parameter((u * (2 * bound) - bound).to(dtype))

        self.weight = uniform(out_channels, in_channels, kh, kw)
        self.bias = uniform(out_channels)

    def forward(self, x):
        return torch.nn.functional.conv2d(x, self.weight, self.bias,
                                          self.stride, self.padding)


class GELU(nn.Module):
    """JAX ``GELU`` (``nn/activation.py:34``): the exact (erf) GELU through
    :func:`~paddle_tpu_torch.nn.functional.activation.gelu`."""

    def forward(self, x):
        return gelu(x, approximate=False)
