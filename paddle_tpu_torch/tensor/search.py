"""Nucleus (top-p) masking (port of ``paddle_tpu.tensor.search``)."""
from __future__ import annotations

import torch

__all__ = ["_top_p_mask"]


def _top_p_mask(v, p):
    """Nucleus mask over the last axis: keep the smallest set of
    highest-probability entries whose cumulative probability reaches ``p``
    (always at least the argmax); everything else -> -inf.  ``p`` is a
    python scalar or a per-row tensor broadcastable to ``v.shape[:-1]``.

    When the cumulative sum never reaches ``p`` (``p >= 1`` under float
    rounding) the cutoff index clamps to the smallest logit, which keeps
    every entry — the same outcome as the JAX version's out-of-range fill."""
    pb = torch.as_tensor(p, dtype=torch.float32, device=v.device) \
        .broadcast_to(v.shape[:-1])
    sorted_logits = torch.sort(v, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_n = (cum < pb[..., None]).sum(dim=-1).clamp(max=v.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, keep_n[..., None])
    return torch.where(v < cutoff, torch.full_like(v, float("-inf")), v)
