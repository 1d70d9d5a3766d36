"""Metrics (port of ``paddle_tpu/metric/__init__.py``; reference
python/paddle/metric/metrics.py).  They count on the host in numpy, as
JAX's do: a tensor from the card is copied over (bf16 as f32) when a
metric reads it, which is the sync ``fit`` pays once a batch."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``: ``compute`` marks whether each
    of the ``max(topk)`` best classes is the label, ``update`` counts."""

    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p, lab = _np(pred), _np(label)
        if lab.ndim == p.ndim and lab.shape[-1] == 1:
            lab = lab[..., 0]
        top = np.argsort(-p, axis=-1)[..., : self.maxk]
        return torch.from_numpy((top == lab[..., None]).astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        n = c.shape[0]
        res = []
        for i, k in enumerate(self.topk):
            hit = float(c[..., :k].sum())
            self.total[i] += hit
            self.count[i] += n
            res.append(hit / max(n, 1))
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res


class Precision(Metric):
    """Binary precision of ``preds > 0.5`` against the labels."""

    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        pred_pos = (_np(preds) > 0.5).reshape(-1)
        lab = _np(labels).reshape(-1).astype(bool)
        self.tp += int(np.sum(pred_pos & lab))
        self.fp += int(np.sum(pred_pos & ~lab))

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(Metric):
    """Binary recall of ``preds > 0.5`` against the labels."""

    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        pred_pos = (_np(preds) > 0.5).reshape(-1)
        lab = _np(labels).reshape(-1).astype(bool)
        self.tp += int(np.sum(pred_pos & lab))
        self.fn += int(np.sum(~pred_pos & lab))

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


def _trapezoid(y, x):
    fn = getattr(np, "trapezoid", None) or np.trapz
    return float(fn(y, x))


class Auc(Metric):
    """ROC AUC from ``num_thresholds + 1`` score buckets, trapezoidal over
    the thresholds in descending order."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        lab = _np(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, -1]
        idx = (p * self.num_thresholds).astype(np.int64).clip(
            0, self.num_thresholds)
        for i, y in zip(idx, lab):
            if y:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return _trapezoid(tpr, fpr)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` best classes, as a
    0-d f32 tensor."""
    p = _np(input)
    lab = _np(label).reshape(-1)
    top = np.argsort(-p, axis=-1)[:, :k]
    hit = (top == lab[:, None]).any(axis=1).mean()
    return torch.tensor(np.float32(hit))
