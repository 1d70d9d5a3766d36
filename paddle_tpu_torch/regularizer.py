"""Regularizers (port of ``paddle_tpu/regularizer.py``; reference
python/paddle/regularizer.py): ``L1Decay`` / ``L2Decay`` objects given to an
optimizer as its global ``weight_decay``, or set on one parameter as its
``regularizer`` attribute (``p.regularizer = L2Decay(1e-4)``, the
counterpart of ``ParamAttr(regularizer=...)``), which overrides the global
one for that parameter.  Each returns d(penalty)/d(param), which the
optimizer adds to the gradient before its update (a coupled decay)."""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    """Base class (reference regularizer.py:25)."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param_value):
        """Return d(penalty)/d(param) to add to the gradient."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """penalty = coeff * sum |w|  ->  grad += coeff * sign(w)
    (reference regularizer.py:60)."""

    def __call__(self, param_value):
        return self._coeff * torch.sign(param_value)


class L2Decay(WeightDecayRegularizer):
    """penalty = 0.5 * coeff * sum w^2  ->  grad += coeff * w
    (reference regularizer.py:141)."""

    def __call__(self, param_value):
        return self._coeff * param_value
