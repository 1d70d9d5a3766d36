"""``cross_entropy`` (port of ``paddle_tpu/nn/functional/loss.py:28``;
reference python/paddle/nn/functional/loss.py): hard or soft labels,
optional class weights, ``ignore_index``, label smoothing, any class
``axis``.  The log-softmax runs in f32 whatever the logits' dtype, as in
JAX; the other losses wait for ROADMAP A item 7."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def _reduce(v, reduction):
    if reduction == "mean":
        return torch.mean(v)
    if reduction == "sum":
        return torch.sum(v)
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    logits = input
    ax = axis % logits.dim()
    if use_softmax:
        logp = torch.log_softmax(logits.float(), dim=ax)
    else:
        logp = torch.log(torch.clamp(logits.float(), min=1e-30))
    n_classes = logits.shape[ax]
    bshape = [-1 if i == ax else 1 for i in range(logits.dim())]
    if soft_label:
        soft = label.float()
        if label_smoothing > 0.0:
            soft = (1 - label_smoothing) * soft + label_smoothing / n_classes
        loss = -torch.sum(soft * logp, dim=ax)
        if weight is not None:
            loss = loss * torch.sum(soft * weight.reshape(bshape), dim=ax)
        return _reduce(loss, reduction)
    ids = label.long()
    if ids.dim() == logits.dim():
        ids = ids.squeeze(ax)
    valid = ids != ignore_index
    safe = torch.where(valid, ids, 0)
    picked = torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0.0:
        nll = -(1 - label_smoothing) * picked \
            - label_smoothing * torch.mean(logp, dim=ax)
    else:
        nll = -picked
    zero = torch.zeros((), dtype=nll.dtype, device=nll.device)
    if weight is not None:
        wv = weight[safe]
        nll = torch.where(valid, nll * wv, zero)
        if reduction == "mean":
            denom = torch.sum(torch.where(valid, wv, zero))
            return torch.sum(nll) / torch.clamp(denom, min=1e-12)
        return _reduce(nll, reduction)
    nll = torch.where(valid, nll, zero)
    if reduction == "mean":
        denom = torch.clamp(torch.sum(valid.float()), min=1.0)
        return torch.sum(nll) / denom
    return _reduce(nll, reduction)
