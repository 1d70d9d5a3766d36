"""The ResNet family (port of ``paddle_tpu.vision.models.resnet``:
``BasicBlock``, ``BottleneckBlock``, ``ResNet``, ``resnet18/34/50/101/152``,
``wide_resnet50_2/101_2`` and ``resnext50_32x4d/101_32x4d``).

``BASELINE.json`` config #1 is ResNet-50, trained single-device in
dygraph.  The modules are ``torch.nn.Module``s whose ``named_parameters()``
and ``named_buffers()`` are the JAX model's (``conv1.weight``,
``bn1._mean``, ``layer1.0.downsample.1._variance`` ...), so weights and
running statistics cross by name
(:func:`~paddle_tpu_torch.models.convert.vision_params_from_numpy`).
Convolution weights are drawn from a ``torch.Generator`` seeded with
``seed`` on ``device`` (``None``: the CUDA device, raising without one);
the BatchNorm buffers are f32 whatever ``dtype`` is.  Activations are
NCHW, as the JAX model's API is.  No Pallas kernel is on the JAX path:
convolution, BatchNorm, pooling and ReLU are torch ops here.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                          MaxPool2D, ReLU, Sequential)
from ...tensor.manipulation import flatten

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "resnext50_32x4d", "resnext101_32x4d", "BasicBlock",
           "BottleneckBlock"]

LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
          101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class BasicBlock(nn.Module):
    """Two 3 x 3 convolutions, each with a BatchNorm, and the shortcut
    (JAX ``resnet.py:18``; like JAX's it takes and ignores ``groups``,
    ``base_width`` and ``dilation``); ``dtype``, ``device`` and
    ``generator`` are the layers'."""
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, *, dtype, device, generator):
        super().__init__()
        mk = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias=False, **mk)
        self.bn1 = BatchNorm2D(planes, dtype=dtype, device=device)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias=False, **mk)
        self.bn2 = BatchNorm2D(planes, dtype=dtype, device=device)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    """1 x 1, 3 x 3 (``groups`` of ``base_width`` / 64 of ``planes`` each)
    and 1 x 1 convolutions to 4 ``planes``, each with a BatchNorm, and the
    shortcut (JAX ``resnet.py:43``); the arguments are
    :class:`BasicBlock`'s."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, *, dtype, device, generator):
        super().__init__()
        mk = dict(dtype=dtype, device=device, generator=generator)
        bn = dict(dtype=dtype, device=device)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias=False, **mk)
        self.bn1 = BatchNorm2D(width, **bn)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            dilation=dilation, groups=groups, bias=False,
                            **mk)
        self.bn2 = BatchNorm2D(width, **bn)
        self.conv3 = Conv2D(width, planes * self.expansion, 1, bias=False,
                            **mk)
        self.bn3 = BatchNorm2D(planes * self.expansion, **bn)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """JAX ``ResNet`` (``resnet.py:72``): images [B, 3, H, W] -> logits
    [B, num_classes]; the pooled features [B, C, 1, 1] when
    ``num_classes`` is 0, the last stage's map without ``with_pool``.  The
    stem is a 7 x 7 stride-2 convolution, BatchNorm, ReLU and a 3 x 3
    stride-2 max pool; four stages of ``block`` follow (``depth`` picks
    their lengths), a shortcut of a 1 x 1 convolution and a BatchNorm where
    the shape changes.  ``width`` and ``groups`` are the bottleneck's
    ``base_width`` and ``groups`` (wide ResNets, ResNeXt)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, dtype=torch.float32,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        mk = dict(dtype=dtype, device=dev, generator=torch.Generator(
            device=dev).manual_seed(int(seed)))
        layers = LAYERS[depth]
        self.groups, self.base_width = groups, width
        self.num_classes, self.with_pool = num_classes, with_pool
        self.inplanes = 64
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias=False, **mk)
        self.bn1 = BatchNorm2D(self.inplanes, dtype=dtype, device=dev)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], mk=mk)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, mk=mk)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, mk=mk)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, mk=mk)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **mk)

    def _make_layer(self, block, planes, blocks, stride=1, *, mk):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias=False, **mk),
                BatchNorm2D(planes * block.expansion, dtype=mk["dtype"],
                            device=mk["device"]))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, **mk)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **mk))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def resnet18(**kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(**kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(**kwargs):
    """ResNet-50: bottleneck stages of 3, 4, 6 and 3 blocks, 25,557,032
    parameters at 1,000 classes."""
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(**kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(**kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)


def wide_resnet50_2(**kwargs):
    return ResNet(BottleneckBlock, 50, width=128, **kwargs)


def wide_resnet101_2(**kwargs):
    return ResNet(BottleneckBlock, 101, width=128, **kwargs)


def resnext50_32x4d(**kwargs):
    return ResNet(BottleneckBlock, 50, width=4, groups=32, **kwargs)


def resnext101_32x4d(**kwargs):
    return ResNet(BottleneckBlock, 101, width=4, groups=32, **kwargs)
