"""Pooling (port of ``paddle_tpu.nn.functional.pooling``: ``max_pool2d``,
``avg_pool2d`` and ``adaptive_avg_pool2d``).  JAX lowers them to
``lax.reduce_window`` or means outside any Pallas kernel, so here they are
torch's pooling ops."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "max_pool2d"]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == 2 else [v[0]] * 2))
    return (int(v),) * 2


def _ceil_pads(pads, sizes, k, s):
    """JAX ``_pool``'s ``ceil_mode``: each high pad widened until the last
    partial window fits."""
    return [(lo, hi + (-(n + lo + hi - ki)) % si)
            for (lo, hi), n, ki, si in zip(pads, sizes, k, s)]


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
        pads = _ceil_pads(pads, x.shape[2:], k, s)
    if all(lo == hi and 2 * lo <= ki for (lo, hi), ki in zip(pads, k)):
        return F.max_pool2d(x, k, s, [lo for lo, _ in pads])
    fill = float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    (hlo, hhi), (wlo, whi) = pads
    return F.max_pool2d(F.pad(x, (wlo, whi, hlo, hhi), value=fill), k, s)


def _window_pads(padding, sizes, k, s):
    """JAX ``_pads`` / ``lax.padtype_to_pads``: (lo, hi) per spatial axis
    from an int, a pair, four ints (h lo, h hi, w lo, w hi), ``"VALID"`` or
    ``"SAME"`` (``ceil(n / s)`` windows, the pad split low-half-first)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        if mode == "VALID":
            return [(0, 0) for _ in sizes]
        total = [max((-(-n // si) - 1) * si + ki - n, 0)
                 for n, ki, si in zip(sizes, k, s)]
        return [(t // 2, t - t // 2) for t in total]
    if isinstance(padding, (list, tuple)):
        flat = [int(p) for p in padding]
        if len(flat) == 2:
            return [(p, p) for p in flat]
        if len(flat) == 4:
            return [(flat[0], flat[1]), (flat[2], flat[3])]
    return [(int(padding), int(padding))] * 2


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """Mean over windows of ``kernel_size`` (JAX ``pooling.py:123``, through
    ``_pool``), on NCHW or (``data_format="NHWC"``) channel-last ``x``.

    The window sums are divided by ``divisor_override`` when it is given;
    else, with ``exclusive=False`` and numeric padding, by the whole window
    kh * kw, also for a window that ``ceil_mode`` extends past the padding
    (torch's own ``ceil_mode`` divides such a window by a clipped count, so
    it is not used); else by the count of input elements in the window.
    String padding (``"SAME"`` / ``"VALID"``) always counts the input
    elements, and ``ceil_mode`` does not apply to it, as in JAX.  A
    symmetric padding of at most half the window without a ``ceil_mode``
    extension is torch's own padded pool; any other is an explicit zero pad
    first."""
    if data_format == "NHWC":
        x = x.movedim(-1, 1)
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    pads = _window_pads(padding, x.shape[2:], k, s)
    whole = not exclusive and not isinstance(padding, str)
    if ceil_mode and not isinstance(padding, str):
        pads = _ceil_pads(pads, x.shape[2:], k, s)
    override = divisor_override or None
    if all(lo == hi and 2 * lo <= ki for (lo, hi), ki in zip(pads, k)) \
            and (override is None or isinstance(override, int)):
        out = F.avg_pool2d(x, k, s, [lo for lo, _ in pads],
                           count_include_pad=whole,
                           divisor_override=override)
    else:
        (hlo, hhi), (wlo, whi) = pads
        sums = F.avg_pool2d(F.pad(x, (wlo, whi, hlo, hhi)), k, s,
                            divisor_override=1)
        if override is not None:
            out = sums / override
        elif whole:
            out = sums / float(k[0] * k[1])
        else:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = sums / F.avg_pool2d(F.pad(ones, (wlo, whi, hlo, hhi)), k,
                                      s, divisor_override=1)
    return out.movedim(1, -1) if data_format == "NHWC" else out


def adaptive_avg_pool2d(x, output_size):
    """Mean over adaptive bins of NCHW ``x`` (JAX ``pooling.py:174``,
    ``_adaptive``): bin i of an axis runs from floor(i * in / out) to
    ceil((i + 1) * in / out), which is also torch's rule.
    ``output_size`` is an int or one per axis."""
    return F.adaptive_avg_pool2d(x, _pair(output_size))
