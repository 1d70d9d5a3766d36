"""LeNet, GoogLeNet and Inception-v3 (port of
``paddle_tpu.vision.models.inception``: ``LeNet``, ``GoogLeNet`` /
``googlenet`` and ``InceptionV3`` / ``inception_v3``).

These are the JAX package's models as it has them, not Paddle's upstream
ones: GoogLeNet's convolutions have no BatchNorm and no activation (one
ReLU follows each block's concatenation), its first auxiliary head has a
ReLU before its dropout and the second none, and it returns (out, aux1,
aux2); Inception-v3 keeps JAX's channel schedule, rectangular kernels and
``AvgPool2D(3, 1, 1, exclusive=False)`` branches.  Names of parameters and
buffers are the JAX model's, so weights cross by name
(:func:`~paddle_tpu_torch.models.convert.vision_params_from_numpy`);
weights come from a ``torch.Generator`` seeded with ``seed`` on ``device``
(``None``: the CUDA device, raising without one), the dropouts' masks
from the model's ``dropout_generator`` (``seed + 1``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.activation import relu
from ...nn.layers import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                          Dropout, LayerList, Linear, MaxPool2D, ReLU,
                          Sequential)
from ...tensor import manipulation as manip
from .mobilenet import _parts

__all__ = ["GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
           "LeNet"]


class LeNet(nn.Module):
    """JAX ``LeNet`` (``inception.py:25``): images [B, 1, 28, 28]; two
    convolutions with ReLU and 2 x 2 max pools, then three Linears (no
    activation between them, as in JAX) when ``num_classes`` > 0."""

    def __init__(self, num_classes=10, *, dtype=torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        mk, _ = _parts(dtype, device, seed)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **mk), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **mk), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(Linear(400, 120, **mk), Linear(120, 84, **mk),
                                 Linear(84, num_classes, **mk))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.fc(manip.flatten(x, 1))
        return x


# -- GoogLeNet ---------------------------------------------------------------
class _Conv(nn.Module):
    """JAX ``_Conv`` (``inception.py:46``): a k x k convolution without
    bias, padded by (k - 1) / 2; no BatchNorm, no activation."""

    def __init__(self, cin, cout, k, stride=1, *, mk):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                           bias=False, **mk)

    def forward(self, x):
        return self.conv(x)


class _InceptionV1Block(nn.Module):
    """JAX ``_InceptionV1Block`` (``inception.py:58``): 1 x 1, 1 x 1 then
    3 x 3, 1 x 1 then 5 x 5, and a 3 x 3 max pool then 1 x 1, concatenated
    on channels, then one ReLU."""

    def __init__(self, cin, f1, f3r, f3, f5r, f5, proj, *, mk):
        super().__init__()
        self.b1 = _Conv(cin, f1, 1, mk=mk)
        self.b3r = _Conv(cin, f3r, 1, mk=mk)
        self.b3 = _Conv(f3r, f3, 3, mk=mk)
        self.b5r = _Conv(cin, f5r, 1, mk=mk)
        self.b5 = _Conv(f5r, f5, 5, mk=mk)
        self.pool = MaxPool2D(3, stride=1, padding=1)
        self.proj = _Conv(cin, proj, 1, mk=mk)

    def forward(self, x):
        return relu(manip.concat(
            [self.b1(x), self.b3(self.b3r(x)), self.b5(self.b5r(x)),
             self.proj(self.pool(x))], axis=1))


class GoogLeNet(nn.Module):
    """JAX ``GoogLeNet`` (``inception.py:79``): returns (out, aux1, aux2),
    the main head on the pooled ``i5b`` map and the two auxiliary heads on
    ``i4a``'s and ``i4d``'s maps pooled 5 x 5 at stride 3 (3 x 3 maps from
    192 px up)."""

    def __init__(self, num_classes=1000, with_pool=True, *,
                 dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        mk, self.dropout_generator = _parts(dtype, device, seed)
        gen = self.dropout_generator
        self.num_classes, self.with_pool = num_classes, with_pool
        self.conv1 = _Conv(3, 64, 7, 2, mk=mk)
        self.pool = MaxPool2D(3, stride=2)
        self.conv2 = _Conv(64, 64, 1, mk=mk)
        self.conv3 = _Conv(64, 192, 3, mk=mk)

        def block(*a):
            return _InceptionV1Block(*a, mk=mk)
        self.i3a = block(192, 64, 96, 128, 16, 32, 32)
        self.i3b = block(256, 128, 128, 192, 32, 96, 64)
        self.i4a = block(480, 192, 96, 208, 16, 48, 64)
        self.i4b = block(512, 160, 112, 224, 24, 64, 64)
        self.i4c = block(512, 128, 128, 256, 24, 64, 64)
        self.i4d = block(512, 112, 144, 288, 32, 64, 64)
        self.i4e = block(528, 256, 160, 320, 32, 128, 128)
        self.i5a = block(832, 256, 160, 320, 32, 128, 128)
        self.i5b = block(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.gap = AdaptiveAvgPool2D(1)
            self.aux_pool = AvgPool2D(5, stride=3)
        if num_classes > 0:
            self.drop = Dropout(0.4, generator=gen)
            self.fc = Linear(1024, num_classes, **mk)
            self.aux1_conv = _Conv(512, 128, 1, mk=mk)
            self.aux1_fc = Linear(1152, 1024, **mk)
            self.aux1_drop = Dropout(0.7, generator=gen)
            self.aux1_out = Linear(1024, num_classes, **mk)
            self.aux2_conv = _Conv(528, 128, 1, mk=mk)
            self.aux2_fc = Linear(1152, 1024, **mk)
            self.aux2_drop = Dropout(0.7, generator=gen)
            self.aux2_out = Linear(1024, num_classes, **mk)

    def forward(self, x):
        x = self.pool(self.conv1(x))
        x = self.pool(self.conv3(self.conv2(x)))
        x = self.pool(self.i3b(self.i3a(x)))
        a4a = self.i4a(x)
        x = self.i4c(self.i4b(a4a))
        a4d = self.i4d(x)
        x = self.pool(self.i4e(a4d))
        out = self.i5b(self.i5a(x))
        out1, out2 = a4a, a4d
        if self.with_pool:
            out = self.gap(out)
            out1 = self.aux_pool(out1)
            out2 = self.aux_pool(out2)
        if self.num_classes > 0:
            out = self.fc(self.drop(manip.squeeze(out, axis=[2, 3])))
            out1 = self.aux1_fc(manip.flatten(self.aux1_conv(out1), 1))
            out1 = self.aux1_out(self.aux1_drop(relu(out1)))
            out2 = self.aux2_fc(manip.flatten(self.aux2_conv(out2), 1))
            out2 = self.aux2_out(self.aux2_drop(out2))
        return out, out1, out2


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return GoogLeNet(**kwargs)


# -- Inception-v3 ------------------------------------------------------------
class _ConvBN(nn.Module):
    """JAX ``_ConvBN`` (``inception.py:148``): a convolution without bias
    (square or rectangular kernel and padding), BatchNorm and ReLU."""

    def __init__(self, cin, cout, k, stride=1, padding=0, *, mk):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=padding,
                           bias=False, **mk)
        self.bn = BatchNorm2D(cout, dtype=mk["dtype"], device=mk["device"])

    def forward(self, x):
        return relu(self.bn(self.conv(x)))


def _avg_branch_pool():
    return AvgPool2D(3, stride=1, padding=1, exclusive=False)


class _IncA(nn.Module):
    """JAX ``_IncA`` (``inception.py:161``): 1 x 1; 1 x 1 then 5 x 5;
    1 x 1 then two 3 x 3; the 3 x 3 average pool then 1 x 1 to
    ``pool_features``; concatenated."""

    def __init__(self, cin, pool_features, *, mk):
        super().__init__()
        self.b1 = _ConvBN(cin, 64, 1, mk=mk)
        self.b5 = Sequential(_ConvBN(cin, 48, 1, mk=mk),
                             _ConvBN(48, 64, 5, padding=2, mk=mk))
        self.b3d = Sequential(_ConvBN(cin, 64, 1, mk=mk),
                              _ConvBN(64, 96, 3, padding=1, mk=mk),
                              _ConvBN(96, 96, 3, padding=1, mk=mk))
        self.pool = _avg_branch_pool()
        self.bp = _ConvBN(cin, pool_features, 1, mk=mk)

    def forward(self, x):
        return manip.concat([self.b1(x), self.b5(x), self.b3d(x),
                             self.bp(self.pool(x))], axis=1)


class _IncB(nn.Module):
    """JAX ``_IncB`` (``inception.py:176``): the stride-2 reduction to
    17 x 17 (at 299 px): 3 x 3 / 2; 1 x 1, 3 x 3, 3 x 3 / 2; max pool."""

    def __init__(self, cin, *, mk):
        super().__init__()
        self.b3 = _ConvBN(cin, 384, 3, stride=2, mk=mk)
        self.b3d = Sequential(_ConvBN(cin, 64, 1, mk=mk),
                              _ConvBN(64, 96, 3, padding=1, mk=mk),
                              _ConvBN(96, 96, 3, stride=2, mk=mk))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return manip.concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class _IncC(nn.Module):
    """JAX ``_IncC`` (``inception.py:188``): factorised 7 x 7 branches of
    1 x 7 and 7 x 1 convolutions at width ``c7``, a 1 x 1, and the average
    pool then 1 x 1; 192 channels each, concatenated."""

    def __init__(self, cin, c7, *, mk):
        super().__init__()

        def cbn(a, b, k, padding=0):
            return _ConvBN(a, b, k, padding=padding, mk=mk)
        self.b1 = cbn(cin, 192, 1)
        self.b7 = Sequential(cbn(cin, c7, 1),
                             cbn(c7, c7, (1, 7), (0, 3)),
                             cbn(c7, 192, (7, 1), (3, 0)))
        self.b7d = Sequential(cbn(cin, c7, 1),
                              cbn(c7, c7, (7, 1), (3, 0)),
                              cbn(c7, c7, (1, 7), (0, 3)),
                              cbn(c7, c7, (7, 1), (3, 0)),
                              cbn(c7, 192, (1, 7), (0, 3)))
        self.pool = _avg_branch_pool()
        self.bp = cbn(cin, 192, 1)

    def forward(self, x):
        return manip.concat([self.b1(x), self.b7(x), self.b7d(x),
                             self.bp(self.pool(x))], axis=1)


class _IncD(nn.Module):
    """JAX ``_IncD`` (``inception.py:210``): the stride-2 reduction to
    8 x 8: 1 x 1 then 3 x 3 / 2; 1 x 1, 1 x 7, 7 x 1, 3 x 3 / 2; max
    pool."""

    def __init__(self, cin, *, mk):
        super().__init__()
        self.b3 = Sequential(_ConvBN(cin, 192, 1, mk=mk),
                             _ConvBN(192, 320, 3, stride=2, mk=mk))
        self.b7 = Sequential(
            _ConvBN(cin, 192, 1, mk=mk),
            _ConvBN(192, 192, (1, 7), padding=(0, 3), mk=mk),
            _ConvBN(192, 192, (7, 1), padding=(3, 0), mk=mk),
            _ConvBN(192, 192, 3, stride=2, mk=mk))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return manip.concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _IncE(nn.Module):
    """JAX ``_IncE`` (``inception.py:225``): 1 x 1 to 320; 1 x 1 to 384
    split into 1 x 3 and 3 x 1; 1 x 1 and 3 x 3 to 384 split likewise; the
    average pool then 1 x 1 to 192; concatenated to 2,048."""

    def __init__(self, cin, *, mk):
        super().__init__()

        def cbn(a, b, k, padding=0):
            return _ConvBN(a, b, k, padding=padding, mk=mk)
        self.b1 = cbn(cin, 320, 1)
        self.b3_1 = cbn(cin, 384, 1)
        self.b3_2a = cbn(384, 384, (1, 3), (0, 1))
        self.b3_2b = cbn(384, 384, (3, 1), (1, 0))
        self.b3d_1 = Sequential(cbn(cin, 448, 1), cbn(448, 384, 3, 1))
        self.b3d_3a = cbn(384, 384, (1, 3), (0, 1))
        self.b3d_3b = cbn(384, 384, (3, 1), (1, 0))
        self.pool = _avg_branch_pool()
        self.bp = cbn(cin, 192, 1)

    def forward(self, x):
        b3 = self.b3_1(x)
        b3 = manip.concat([self.b3_2a(b3), self.b3_2b(b3)], axis=1)
        b3d = self.b3d_1(x)
        b3d = manip.concat([self.b3d_3a(b3d), self.b3d_3b(b3d)], axis=1)
        return manip.concat([self.b1(x), b3, b3d, self.bp(self.pool(x))],
                            axis=1)


class InceptionV3(nn.Module):
    """JAX ``InceptionV3`` (``inception.py:248``): the stem (five
    ``_ConvBN`` and two max pools), three ``_IncA``, ``_IncB``, four
    ``_IncC``, ``_IncD`` and two ``_IncE`` (``blocks``, a ``LayerList``),
    the pool, dropout 0.2 and ``fc`` on ``reshape(x, [-1, 2048])``.  Its
    smallest input is 75 x 75."""

    def __init__(self, num_classes=1000, with_pool=True, *,
                 dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        mk, self.dropout_generator = _parts(dtype, device, seed)
        self.num_classes, self.with_pool = num_classes, with_pool
        self.stem = Sequential(
            _ConvBN(3, 32, 3, stride=2, mk=mk), _ConvBN(32, 32, 3, mk=mk),
            _ConvBN(32, 64, 3, padding=1, mk=mk), MaxPool2D(3, stride=2),
            _ConvBN(64, 80, 1, mk=mk), _ConvBN(80, 192, 3, mk=mk),
            MaxPool2D(3, stride=2))
        blocks = [_IncA(cin, pf, mk=mk)
                  for cin, pf in zip([192, 256, 288], [32, 64, 64])]
        blocks.append(_IncB(288, mk=mk))
        blocks += [_IncC(768, c7, mk=mk) for c7 in (128, 160, 160, 192)]
        blocks.append(_IncD(768, mk=mk))
        blocks += [_IncE(1280, mk=mk), _IncE(2048, mk=mk)]
        self.blocks = LayerList(blocks)
        if with_pool:
            self.gap = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.2, generator=self.dropout_generator)
            self.fc = Linear(2048, num_classes, **mk)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        if self.with_pool:
            x = self.gap(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(manip.reshape(x, [-1, 2048])))
        return x


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return InceptionV3(**kwargs)
