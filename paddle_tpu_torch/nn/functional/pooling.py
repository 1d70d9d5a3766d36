"""Pooling (port of ``paddle_tpu.nn.functional.pooling``: ``max_pool2d``
and ``adaptive_avg_pool2d``).  JAX lowers both to ``lax.reduce_window`` or
means outside any Pallas kernel, so here they are torch's pooling ops."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["adaptive_avg_pool2d", "max_pool2d"]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == 2 else [v[0]] * 2))
    return (int(v),) * 2


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    """Max over windows of ``kernel_size`` on NCHW ``x`` (JAX
    ``pooling.py:93``): padded positions score -inf.  ``ceil_mode`` widens
    the high padding until the last partial window fits, as JAX's
    ``_pool`` does; a window that lies wholly in that padding gives -inf
    there too (torch's own ``ceil_mode`` would drop it).  A symmetric
    padding of at most half the window is torch's implicit -inf padding;
    any other is an explicit -inf pad first."""
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    pads = [(p, p) for p in _pair(padding)]
    if ceil_mode:
        pads = [(lo, hi + (-(n + lo + hi - ki)) % si)
                for (lo, hi), n, ki, si in zip(pads, x.shape[2:], k, s)]
    if all(lo == hi and 2 * lo <= ki for (lo, hi), ki in zip(pads, k)):
        return F.max_pool2d(x, k, s, [lo for lo, _ in pads])
    fill = float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    (hlo, hhi), (wlo, whi) = pads
    return F.max_pool2d(F.pad(x, (wlo, whi, hlo, hhi), value=fill), k, s)


def adaptive_avg_pool2d(x, output_size):
    """Mean over adaptive bins of NCHW ``x`` (JAX ``pooling.py:174``,
    ``_adaptive``): bin i of an axis runs from floor(i * in / out) to
    ceil((i + 1) * in / out), which is also torch's rule.
    ``output_size`` is an int or one per axis."""
    return F.adaptive_avg_pool2d(x, _pair(output_size))
