"""Weight conversion from the JAX package's parameter layout."""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

__all__ = ["params_from_numpy", "ernie_params_from_numpy",
           "unet_params_from_numpy", "vision_params_from_numpy",
           "vit_params_from_numpy"]

# the running statistics of JAX's BatchNorm layers (``nn/norm.py:31-32``)
BN_BUFFERS = ("_mean", "_variance")


def _tensor(v, dev, dtype):
    # through float32, so that bfloat16 arrays convert too
    return torch.from_numpy(np.asarray(v, np.float32).copy()).to(
        device=dev, dtype=dtype)


def params_from_numpy(ep, bp, hp, device=None, dtype=torch.float32):
    """Turn ``(embed, block, head)`` dicts of numpy arrays (the JAX
    package's parameters passed through ``np.asarray``) into the port's
    dicts of tensors on ``device`` (``None``: the CUDA device, raising
    without one) in ``dtype``.  The two packages share leaf names, stacking
    and the ``[in, out]`` weight layout, so each leaf is a plain copy."""
    dev = resolve_device(device)
    return tuple({k: _tensor(v, dev, dtype) for k, v in tree.items()}
                 for tree in (ep, bp, hp))


def ernie_params_from_numpy(named, device=None, dtype=torch.float32):
    """``{name: np.ndarray}`` from the JAX ERNIE or ViT model's
    ``named_parameters()`` -> a state dict that the port's module of the
    same config loads with ``load_state_dict``: the names, the ``[in, out]``
    Linear layout and the ``[out, in, kh, kw]`` convolution layout are the
    same, so each entry is a plain copy, on ``device`` (``None``: the CUDA
    device, raising without one) in ``dtype``."""
    dev = resolve_device(device)
    return {name: _tensor(v, dev, dtype) for name, v in named.items()}


# ViT's names are the JAX model's too; a qkv projection without a bias
# (``qkv_bias=False``) has no ``qkv.bias`` on either side
vit_params_from_numpy = ernie_params_from_numpy


def unet_params_from_numpy(named, device=None, dtype=torch.float32):
    """``{name: np.ndarray}`` from the JAX ``UNet2DConditionModel``'s
    ``named_parameters()`` -> a state dict that the port's
    :class:`~paddle_tpu_torch.models.unet.UNet2DConditionModel` of the same
    config loads with ``load_state_dict``: the names (``down_res.0.conv1.
    weight``, ``up_attn.2.attn1.to_q.weight`` ...), the ``[in, out]`` Linear
    layout and the ``[out, in, kh, kw]`` convolution layout are the same,
    so each entry is a plain copy, on ``device`` (``None``: the CUDA device,
    raising without one) in ``dtype``."""
    return ernie_params_from_numpy(named, device, dtype)


def vision_params_from_numpy(named, device=None, dtype=torch.float32):
    """``{name: np.ndarray}`` from a JAX ResNet's or MobileNet's
    ``named_parameters()`` and ``named_buffers()`` -> a state dict that the
    port's model of the same config loads with ``load_state_dict``
    (strict): the names, the ``[in, out]`` Linear layout and the ``[out,
    in / groups, kh, kw]`` convolution layout are the same, so each entry
    is a plain copy, on ``device`` (``None``: the CUDA device, raising
    without one).  Parameters take ``dtype``; BatchNorm's running buffers
    (``..._mean``, ``..._variance``) stay f32, as ``BatchNorm2D`` keeps
    them."""
    dev = resolve_device(device)
    return {name: _tensor(v, dev, torch.float32
                          if name.rsplit(".", 1)[-1] in BN_BUFFERS else dtype)
            for name, v in named.items()}
