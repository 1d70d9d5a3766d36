"""``CrossEntropyLoss`` (port of ``paddle_tpu/nn/loss.py:14``): the layer
over :func:`~paddle_tpu_torch.nn.functional.loss.cross_entropy`."""
from __future__ import annotations

from torch import nn

from .functional.loss import cross_entropy

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.kw = dict(ignore_index=ignore_index, reduction=reduction,
                       soft_label=soft_label, axis=axis,
                       use_softmax=use_softmax,
                       label_smoothing=label_smoothing)

    def forward(self, input, label):
        return cross_entropy(input, label, weight=self.weight, **self.kw)
