"""MobileNet V1 / V2 / V3 (port of ``paddle_tpu.vision.models.mobilenet``:
``_make_divisible``, ``_conv_bn``, ``MobileNetV1``, ``InvertedResidual``,
``MobileNetV2``, ``SqueezeExcitation``, ``_V3Block``,
``MobileNetV3Small`` / ``Large`` and ``mobilenet_v1/v2/v3_small/
v3_large``).

The models are stacks of convolution + BatchNorm + activation units, as
ResNet's are, with depthwise convolutions (``groups`` = channels), ReLU6,
Hardswish, and a squeeze-excitation gated by Hardsigmoid.  Their
``named_parameters()`` and ``named_buffers()`` are the JAX model's
(``features.0.0.weight``, ``features.1.conv.0.1._mean`` ...), so weights
cross by name (:func:`~paddle_tpu_torch.models.convert.
vision_params_from_numpy`).  Weights are drawn from a ``torch.Generator``
seeded with ``seed`` on ``device`` (``None``: the CUDA device, raising
without one); the classifier's ``Dropout(0.2)`` draws its masks from the
model's own device generator (``dropout_generator``, seeded from
``seed + 1``), as ViT's does.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                          Hardsigmoid, Hardswish, Linear, ReLU, ReLU6,
                          Sequential)

__all__ = ["MobileNetV1", "MobileNetV2", "MobileNetV3Small",
           "MobileNetV3Large", "mobilenet_v1", "mobilenet_v2",
           "mobilenet_v3_small", "mobilenet_v3_large"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv_bn(cin, cout, k, stride=1, groups=1, act=ReLU, *, mk):
    """A k x k convolution without bias, a BatchNorm and ``act`` (none when
    ``None``), as ``Sequential`` children 0, 1, 2 (JAX ``mobilenet.py:24``);
    ``mk`` holds the layers' ``dtype``, ``device`` and ``generator``."""
    layers = [Conv2D(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                     groups=groups, bias=False, **mk),
              BatchNorm2D(cout, dtype=mk["dtype"], device=mk["device"])]
    if act is not None:
        layers.append(act())
    return Sequential(*layers)


def _parts(dtype, device, seed):
    """The layers' ``mk`` (the parameters' generator seeded with ``seed``)
    and the dropout generator, seeded apart from it."""
    dev = resolve_device(device)
    mk = dict(dtype=dtype, device=dev,
              generator=torch.Generator(device=dev).manual_seed(int(seed)))
    return mk, torch.Generator(device=dev).manual_seed(int(seed) + 1)


class _Classifier(nn.Module):
    """What the MobileNets share: features, the optional pool, and the head
    on the flattened features when ``num_classes`` > 0."""

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.head(x.reshape(x.shape[0], -1))
        return x


class MobileNetV1(_Classifier):
    """JAX ``MobileNetV1`` (``mobilenet.py:33``): a stride-2 stem and 13
    depthwise-separable units (a 3 x 3 depthwise ``_conv_bn`` and a 1 x 1
    one), widths times ``scale``; the head is ``fc``."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        mk, _ = _parts(dtype, device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool

        def dw_sep(cin, cout, stride):
            return Sequential(
                _conv_bn(cin, cin, 3, stride=stride, groups=cin, mk=mk),
                _conv_bn(cin, cout, 1, mk=mk))

        def s(c):
            return int(c * scale)
        cfg = [(s(32), s(64), 1), (s(64), s(128), 2), (s(128), s(128), 1),
               (s(128), s(256), 2), (s(256), s(256), 1), (s(256), s(512), 2)] \
            + [(s(512), s(512), 1)] * 5 + [(s(512), s(1024), 2),
                                           (s(1024), s(1024), 1)]
        blocks = [_conv_bn(3, s(32), 3, stride=2, mk=mk)]
        blocks += [dw_sep(a, b, st) for a, b, st in cfg]
        self.features = Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(s(1024), num_classes, **mk)

    def head(self, x):
        return self.fc(x)


class InvertedResidual(nn.Module):
    """The V2 block (JAX ``mobilenet.py:68``): a 1 x 1 expansion by
    ``expand_ratio`` (none at 1), a 3 x 3 depthwise unit, both ReLU6, and a
    linear 1 x 1 projection; the input is added where the shape stays."""

    def __init__(self, cin, cout, stride, expand_ratio, *, mk):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(cin, hidden, 1, act=ReLU6, mk=mk))
        layers += [_conv_bn(hidden, hidden, 3, stride=stride, groups=hidden,
                            act=ReLU6, mk=mk),
                   _conv_bn(hidden, cout, 1, act=None, mk=mk)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(_Classifier):
    """JAX ``MobileNetV2`` (``mobilenet.py:88``): a stride-2 stem, 17
    inverted residuals and a 1 x 1 unit to 1,280 channels, all ReLU6; the
    head is ``classifier``, ``Dropout(0.2)`` and a Linear."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        mk, self.dropout_generator = _parts(dtype, device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        cin = _make_divisible(32 * scale)
        last = _make_divisible(1280 * max(1.0, scale))
        feats = [_conv_bn(3, cin, 3, stride=2, act=ReLU6, mk=mk)]
        for t, c, n, s in cfg:
            cout = _make_divisible(c * scale)
            for i in range(n):
                feats.append(InvertedResidual(cin, cout, s if i == 0 else 1,
                                              t, mk=mk))
                cin = cout
        feats.append(_conv_bn(cin, last, 1, act=ReLU6, mk=mk))
        self.features = Sequential(*feats)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2, generator=self.dropout_generator),
                Linear(last, num_classes, **mk))

    def head(self, x):
        return self.classifier(x)


class SqueezeExcitation(nn.Module):
    """Channel gates (JAX ``mobilenet.py:124``): the pooled map through a
    1 x 1 convolution to ``squeeze`` channels, ReLU, a 1 x 1 convolution
    back (both with biases) and Hardsigmoid, times the input."""

    def __init__(self, channels, squeeze, *, mk):
        super().__init__()
        self.avg = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(channels, squeeze, 1, **mk)
        self.relu = ReLU()
        self.fc2 = Conv2D(squeeze, channels, 1, **mk)
        self.hsig = Hardsigmoid()

    def forward(self, x):
        return x * self.hsig(self.fc2(self.relu(self.fc1(self.avg(x)))))


class _V3Block(nn.Module):
    """The V3 block (JAX ``mobilenet.py:138``): a 1 x 1 expansion to
    ``hidden`` (none when equal), a k x k depthwise unit, both ``act``, the
    optional squeeze-excitation and a linear 1 x 1 projection; the input is
    added where the shape stays."""

    def __init__(self, cin, hidden, cout, k, stride, use_se, act, *, mk):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        layers = []
        if hidden != cin:
            layers.append(_conv_bn(cin, hidden, 1, act=act, mk=mk))
        layers.append(_conv_bn(hidden, hidden, k, stride=stride,
                               groups=hidden, act=act, mk=mk))
        if use_se:
            layers.append(SqueezeExcitation(
                hidden, _make_divisible(hidden // 4), mk=mk))
        layers.append(_conv_bn(hidden, cout, 1, act=None, mk=mk))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_V3_LARGE = [
    # k, exp, out, se, act, stride
    (3, 16, 16, False, ReLU, 1), (3, 64, 24, False, ReLU, 2),
    (3, 72, 24, False, ReLU, 1), (5, 72, 40, True, ReLU, 2),
    (5, 120, 40, True, ReLU, 1), (5, 120, 40, True, ReLU, 1),
    (3, 240, 80, False, Hardswish, 2), (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1), (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1), (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2), (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1),
]
_V3_SMALL = [
    (3, 16, 16, True, ReLU, 2), (3, 72, 24, False, ReLU, 2),
    (3, 88, 24, False, ReLU, 1), (5, 96, 40, True, Hardswish, 2),
    (5, 240, 40, True, Hardswish, 1), (5, 240, 40, True, Hardswish, 1),
    (5, 120, 48, True, Hardswish, 1), (5, 144, 48, True, Hardswish, 1),
    (5, 288, 96, True, Hardswish, 2), (5, 576, 96, True, Hardswish, 1),
    (5, 576, 96, True, Hardswish, 1),
]


class _MobileNetV3(_Classifier):
    """JAX ``_MobileNetV3`` (``mobilenet.py:179``): a Hardswish stem, the
    ``cfg`` blocks and a 1 x 1 unit to ``last_exp`` channels; the head is
    ``classifier``: Linear to 1,280 (Large) or 1,024 (Small), Hardswish,
    ``Dropout(0.2)`` and a Linear."""

    def __init__(self, cfg, last_exp, scale=1.0, num_classes=1000,
                 with_pool=True, *, dtype=torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        mk, self.dropout_generator = _parts(dtype, device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool
        cin = _make_divisible(16 * scale)
        feats = [_conv_bn(3, cin, 3, stride=2, act=Hardswish, mk=mk)]
        for k, exp, out, se, act, stride in cfg:
            hidden = _make_divisible(exp * scale)
            cout = _make_divisible(out * scale)
            feats.append(_V3Block(cin, hidden, cout, k, stride, se, act,
                                  mk=mk))
            cin = cout
        lastconv = _make_divisible(last_exp * scale)
        feats.append(_conv_bn(cin, lastconv, 1, act=Hardswish, mk=mk))
        self.features = Sequential(*feats)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            head = 1280 if last_exp == 960 else 1024
            self.classifier = Sequential(
                Linear(lastconv, head, **mk), Hardswish(),
                Dropout(0.2, generator=self.dropout_generator),
                Linear(head, num_classes, **mk))

    def head(self, x):
        return self.classifier(x)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_V3_LARGE, 960, scale, num_classes, with_pool, **kw)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_V3_SMALL, 576, scale, num_classes, with_pool, **kw)


def mobilenet_v1(scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_small(scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)
