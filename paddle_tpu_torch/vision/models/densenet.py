"""DenseNet, SqueezeNet, ShuffleNetV2, AlexNet and VGG (port of
``paddle_tpu.vision.models.densenet``: ``DenseNet`` and
``densenet121/161/169/201/264``, ``SqueezeNet`` and ``squeezenet1_0/1_1``,
``ShuffleNetV2`` and ``shufflenet_v2_x1_0``, ``AlexNet`` and ``alexnet``,
``VGG`` and ``vgg11/13/16/19``).

As the ResNets and MobileNets are, the models are ``torch.nn.Module``s
whose ``named_parameters()`` and ``named_buffers()`` are the JAX model's
(``features.0.conv1.weight``, ``stem.1._mean``, ``stages.3.branch2.4.
_variance`` ...), so weights cross by name (:func:`~paddle_tpu_torch.
models.convert.vision_params_from_numpy`).  Weights are drawn from a
``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: the CUDA
device, raising without one); the dropouts draw their masks from the
model's own device generator (``dropout_generator``, seeded from ``seed +
1``).  No Pallas kernel is on the JAX path: convolution, BatchNorm,
pooling, concatenation and the channel shuffle are torch ops here.
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                          Dropout, Linear, MaxPool2D, ReLU, Sequential)
from ...tensor import manipulation as manip
from .mobilenet import _parts

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264", "SqueezeNet", "squeezenet1_0",
           "squeezenet1_1", "ShuffleNetV2", "shufflenet_v2_x1_0",
           "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19"]


def _bn(c, mk):
    return BatchNorm2D(c, dtype=mk["dtype"], device=mk["device"])


def _no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")


# -- DenseNet ----------------------------------------------------------------
class _DenseLayer(nn.Module):
    """JAX ``_DenseLayer`` (``densenet.py:20``): BatchNorm, ReLU, a 1 x 1
    convolution to ``bn_size`` x ``growth_rate``, BatchNorm, ReLU, a 3 x 3
    convolution to ``growth_rate``, the optional dropout, and the input
    and that output concatenated on channels."""

    def __init__(self, cin, growth_rate, bn_size, dropout, *, mk, gen=None):
        super().__init__()
        self.bn1 = _bn(cin, mk)
        self.relu = ReLU()
        self.conv1 = Conv2D(cin, bn_size * growth_rate, 1, bias=False, **mk)
        self.bn2 = _bn(bn_size * growth_rate, mk)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3, padding=1,
                            bias=False, **mk)
        self.dropout = Dropout(dropout, generator=gen) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return manip.concat([x, out], axis=1)


class _Transition(nn.Module):
    """JAX ``_Transition`` (``densenet.py:39``): BatchNorm, ReLU, a 1 x 1
    convolution to ``cout`` and a 2 x 2 stride-2 average pool."""

    def __init__(self, cin, cout, *, mk):
        super().__init__()
        self.bn = _bn(cin, mk)
        self.relu = ReLU()
        self.conv = Conv2D(cin, cout, 1, bias=False, **mk)
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


_DENSE_CFG = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
              169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
              264: (6, 12, 64, 48)}


class DenseNet(nn.Module):
    """JAX ``DenseNet`` (``densenet.py:56``): a 7 x 7 stride-2 stem with
    BatchNorm, ReLU and a 3 x 3 stride-2 max pool, four dense blocks of
    ``_DENSE_CFG[layers]`` layers (growth 32, 48 for DenseNet-161) with a
    transition halving the channels between them, a last BatchNorm and
    ReLU, the pool and ``fc``."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, growth_rate=None, *, dtype=torch.float32,
                 device=None, seed: int = 0):
        super().__init__()
        if layers not in _DENSE_CFG:
            raise ValueError(f"supported layers: {sorted(_DENSE_CFG)}")
        mk, self.dropout_generator = _parts(dtype, device, seed)
        growth = growth_rate or (48 if layers == 161 else 32)
        init_ch = 2 * growth
        self.num_classes, self.with_pool = num_classes, with_pool
        self.stem = Sequential(
            Conv2D(3, init_ch, 7, stride=2, padding=3, bias=False, **mk),
            _bn(init_ch, mk), ReLU(), MaxPool2D(3, stride=2, padding=1))
        blocks = []
        ch = init_ch
        block_cfg = _DENSE_CFG[layers]
        for bi, n in enumerate(block_cfg):
            for _ in range(n):
                blocks.append(_DenseLayer(ch, growth, bn_size, dropout, mk=mk,
                                          gen=self.dropout_generator))
                ch += growth
            if bi != len(block_cfg) - 1:
                blocks.append(_Transition(ch, ch // 2, mk=mk))
                ch //= 2
        self.features = Sequential(*blocks)
        self.bn_final = _bn(ch, mk)
        self.relu = ReLU()
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(ch, num_classes, **mk)

    def forward(self, x):
        x = self.relu(self.bn_final(self.features(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(manip.reshape(x, [x.shape[0], -1]))
        return x


def _dn(layers):
    def fn(pretrained=False, **kwargs):
        _no_pretrained(pretrained)
        return DenseNet(layers=layers, **kwargs)
    fn.__name__ = f"densenet{layers}"
    return fn


densenet121 = _dn(121)
densenet161 = _dn(161)
densenet169 = _dn(169)
densenet201 = _dn(201)
densenet264 = _dn(264)


# -- SqueezeNet --------------------------------------------------------------
class _Fire(nn.Module):
    """JAX ``_Fire`` (``densenet.py:118``): a 1 x 1 squeeze with ReLU, then
    1 x 1 and 3 x 3 expands, each with ReLU, concatenated."""

    def __init__(self, cin, squeeze, e1, e3, *, mk):
        super().__init__()
        self.squeeze = Conv2D(cin, squeeze, 1, **mk)
        self.relu = ReLU()
        self.e1 = Conv2D(squeeze, e1, 1, **mk)
        self.e3 = Conv2D(squeeze, e3, 3, padding=1, **mk)

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return manip.concat([self.relu(self.e1(s)), self.relu(self.e3(s))],
                            axis=1)


class SqueezeNet(nn.Module):
    """JAX ``SqueezeNet`` (``densenet.py:132``), version ``"1.0"`` or
    ``"1.1"``: the features, then a classifier of dropout 0.5, a 1 x 1
    convolution to the classes, ReLU and the pool, flattened."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *,
                 dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        mk, self.dropout_generator = _parts(dtype, device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool

        def fire(*a):
            return _Fire(*a, mk=mk)
        if version == "1.0":
            feats = [Conv2D(3, 96, 7, stride=2, **mk), ReLU(),
                     MaxPool2D(3, stride=2),
                     fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                     fire(128, 32, 128, 128), MaxPool2D(3, stride=2),
                     fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                     fire(384, 48, 192, 192), fire(384, 64, 256, 256),
                     MaxPool2D(3, stride=2), fire(512, 64, 256, 256)]
        elif version == "1.1":
            feats = [Conv2D(3, 64, 3, stride=2, **mk), ReLU(),
                     MaxPool2D(3, stride=2),
                     fire(64, 16, 64, 64), fire(128, 16, 64, 64),
                     MaxPool2D(3, stride=2),
                     fire(128, 32, 128, 128), fire(256, 32, 128, 128),
                     MaxPool2D(3, stride=2),
                     fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                     fire(384, 64, 256, 256), fire(512, 64, 256, 256)]
        else:
            raise ValueError("version must be '1.0' or '1.1'")
        self.features = Sequential(*feats)
        self.classifier = Sequential(
            Dropout(0.5, generator=self.dropout_generator),
            Conv2D(512, num_classes, 1, **mk), ReLU(), AdaptiveAvgPool2D(1))

    def forward(self, x):
        x = self.classifier(self.features(x))
        return manip.reshape(x, [x.shape[0], -1])


def squeezenet1_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)


# -- ShuffleNetV2 ------------------------------------------------------------
def _channel_shuffle(x, groups):
    """JAX ``_channel_shuffle`` (``densenet.py:183``): the channels
    regrouped as [groups, c / groups], transposed and flattened back."""
    n, c, h, w = x.shape
    x = manip.reshape(x, [n, groups, c // groups, h, w])
    x = manip.transpose(x, [0, 2, 1, 3, 4])
    return manip.reshape(x, [n, c, h, w])


class _ShuffleUnit(nn.Module):
    """JAX ``_ShuffleUnit`` (``densenet.py:190``): at stride 1 the first
    half of the channels passes and the second goes through ``branch2``
    (1 x 1, depthwise 3 x 3, 1 x 1, each with BatchNorm); at stride 2 both
    ``branch1`` and ``branch2`` take the whole input; the halves are
    concatenated and shuffled in 2 groups."""

    def __init__(self, cin, cout, stride, *, mk):
        super().__init__()
        self.stride = stride
        branch = cout // 2

        def conv(a, b, k=1, s=1, g=1):
            return Conv2D(a, b, k, stride=s, padding=(k - 1) // 2, groups=g,
                          bias=False, **mk)
        if stride == 1:
            self.branch2 = Sequential(
                conv(cin // 2, branch), _bn(branch, mk), ReLU(),
                conv(branch, branch, 3, 1, branch), _bn(branch, mk),
                conv(branch, branch), _bn(branch, mk), ReLU())
            self.branch1 = None
        else:
            self.branch1 = Sequential(
                conv(cin, cin, 3, stride, cin), _bn(cin, mk),
                conv(cin, branch), _bn(branch, mk), ReLU())
            self.branch2 = Sequential(
                conv(cin, branch), _bn(branch, mk), ReLU(),
                conv(branch, branch, 3, stride, branch), _bn(branch, mk),
                conv(branch, branch), _bn(branch, mk), ReLU())

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            out = manip.concat([x[:, :c], self.branch2(x[:, c:])], axis=1)
        else:
            out = manip.concat([self.branch1(x), self.branch2(x)], axis=1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """JAX ``ShuffleNetV2`` (``densenet.py:229``): a stride-2 stem with
    BatchNorm, ReLU and a max pool, three stages of 4, 8 and 4 units (the
    first of each at stride 2), a 1 x 1 ``conv_last``, the pool and
    ``fc``; ``scale`` picks the widths.  Like JAX's, it takes ``act`` and
    always uses ReLU."""

    _CFG = {0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024),
            1.5: (176, 352, 704, 1024), 2.0: (244, 488, 976, 2048)}

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, dtype=torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        mk, _ = _parts(dtype, device, seed)
        c1, c2, c3, cout = self._CFG[scale]
        self.num_classes, self.with_pool = num_classes, with_pool
        self.stem = Sequential(
            Conv2D(3, 24, 3, stride=2, padding=1, bias=False, **mk),
            _bn(24, mk), ReLU(), MaxPool2D(3, stride=2, padding=1))
        stages = []
        cin = 24
        for cmid, reps in ((c1, 4), (c2, 8), (c3, 4)):
            stages.append(_ShuffleUnit(cin, cmid, 2, mk=mk))
            stages += [_ShuffleUnit(cmid, cmid, 1, mk=mk)
                       for _ in range(reps - 1)]
            cin = cmid
        self.stages = Sequential(*stages)
        self.conv_last = Sequential(Conv2D(cin, cout, 1, bias=False, **mk),
                                    _bn(cout, mk), ReLU())
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(cout, num_classes, **mk)

    def forward(self, x):
        x = self.conv_last(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(manip.reshape(x, [x.shape[0], -1]))
        return x


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ShuffleNetV2(scale=1.0, **kwargs)


# -- AlexNet and VGG ---------------------------------------------------------
class AlexNet(nn.Module):
    """JAX ``AlexNet`` (``densenet.py:279``): five convolutions with ReLU
    and three max pools, a 6 x 6 adaptive pool, and a classifier of two
    dropout-0.5 + 4,096-wide Linear + ReLU stages and the output
    Linear."""

    def __init__(self, num_classes=1000, *, dtype=torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        mk, self.dropout_generator = _parts(dtype, device, seed)
        gen = self.dropout_generator
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **mk), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2, **mk), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1, **mk), ReLU(),
            Conv2D(384, 256, 3, padding=1, **mk), ReLU(),
            Conv2D(256, 256, 3, padding=1, **mk), ReLU(),
            MaxPool2D(3, stride=2))
        self.pool = AdaptiveAvgPool2D(6)
        self.classifier = Sequential(
            Dropout(0.5, generator=gen), Linear(256 * 36, 4096, **mk), ReLU(),
            Dropout(0.5, generator=gen), Linear(4096, 4096, **mk), ReLU(),
            Linear(4096, num_classes, **mk))

    def forward(self, x):
        x = self.pool(self.features(x))
        return self.classifier(manip.reshape(x, [x.shape[0], -1]))


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


_VGG_CFG = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    """JAX ``VGG`` (``densenet.py:321``): 3 x 3 convolutions (each with a
    BatchNorm when ``batch_norm``) and ReLU, 2 x 2 max pools, a 7 x 7
    adaptive pool, and a classifier of two 4,096-wide Linear + ReLU +
    dropout-0.5 stages and the output Linear."""

    def __init__(self, layers=16, batch_norm=False, num_classes=1000, *,
                 dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        mk, self.dropout_generator = _parts(dtype, device, seed)
        gen = self.dropout_generator
        self.num_classes = num_classes
        feats = []
        cin = 3
        for v in _VGG_CFG[layers]:
            if v == "M":
                feats.append(MaxPool2D(2, stride=2))
                continue
            feats.append(Conv2D(cin, v, 3, padding=1, **mk))
            if batch_norm:
                feats.append(_bn(v, mk))
            feats.append(ReLU())
            cin = v
        self.features = Sequential(*feats)
        self.pool = AdaptiveAvgPool2D(7)
        self.classifier = Sequential(
            Linear(512 * 49, 4096, **mk), ReLU(), Dropout(0.5, generator=gen),
            Linear(4096, 4096, **mk), ReLU(), Dropout(0.5, generator=gen),
            Linear(4096, num_classes, **mk))

    def forward(self, x):
        x = self.pool(self.features(x))
        return self.classifier(manip.reshape(x, [x.shape[0], -1]))


def _vgg(layers):
    def fn(pretrained=False, batch_norm=False, **kwargs):
        _no_pretrained(pretrained)
        return VGG(layers=layers, batch_norm=batch_norm, **kwargs)
    fn.__name__ = f"vgg{layers}"
    return fn


vgg11 = _vgg(11)
vgg13 = _vgg(13)
vgg16 = _vgg(16)
vgg19 = _vgg(19)
