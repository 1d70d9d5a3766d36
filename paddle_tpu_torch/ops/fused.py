"""Fused RMSNorm, forward and backward (port of the RMSNorm part of
``paddle_tpu/ops/pallas/fused.py``).

Rows ``x [N, H]``; the forward saves ``inv = rsqrt(mean(x^2) + eps)`` [N]
f32 for a cheap backward.  Each kernel has a wrapper that launches the
hand-written CUDA kernel of ``csrc/rms_norm.cu`` for CUDA tensors and adds
one to its ``launches`` counter, and runs its plain PyTorch version
(``*_ref``) for CPU tensors:

  ``rms_norm_fwd``  -> (out, inv)   TPU ``_rms_fwd_kernel``
  ``rms_norm_bwd``  -> (dx, dw)     TPU ``_rms_bwd_kernel``

:func:`rms_norm` is the differentiable op; like the JAX one it returns
``None`` when the rows do not tile (H not a multiple of 128, or N not a
multiple of 8), and the caller then runs ``rms_norm_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_fwd", "rms_norm_fwd_ref", "rms_norm_bwd",
           "rms_norm_bwd_ref"]


def rms_norm_fwd_ref(x, w, eps):
    """out = x * inv * w (f32 math, cast to x's dtype) and inv [N] f32."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1) + eps)
    return (xf * inv[:, None] * w.float()).to(x.dtype), inv


def rms_norm_bwd_ref(x, w, inv, g):
    """dx = inv * (gw - xhat * mean(gw * xhat)) in x's dtype and
    dw = sum over rows of g * xhat (f32, cast to w's dtype)."""
    xhat = x.float() * inv[:, None]
    gf = g.float()
    gw = gf * w.float()
    m = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (inv[:, None] * (gw - xhat * m)).to(x.dtype)
    return dx, (gf * xhat).sum(dim=0).to(w.dtype)


def _check(x, w, *more):
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"want x [N, H] and w [H], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)) + more:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not {x.dtype, w.dtype} <= _build.DTYPE_CODE.keys():
        raise TypeError(f"the kernel takes float32 or bfloat16 x and w, got "
                        f"{x.dtype}, {w.dtype}")
    return x.contiguous(), w.contiguous()


def rms_norm_fwd(x, w, eps):
    """x [N, H], w [H] -> (out [N, H] in x's dtype, inv [N] f32).  CUDA
    tensors launch ``rms_norm_fwd_launch`` and add one to
    ``rms_norm_fwd.launches``; CPU tensors run :func:`rms_norm_fwd_ref`."""
    if not _build.on_card("rms_norm_fwd", x):
        return rms_norm_fwd_ref(x, w, eps)
    x, w = _check(x, w)
    n, h = x.shape
    out = torch.empty_like(x)
    inv = torch.empty((n,), dtype=torch.float32, device=x.device)
    _build.launch("rms_norm", "rms_norm_fwd_launch",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                  + [ctypes.c_float],
                  [x.data_ptr(), w.data_ptr(), out.data_ptr(), inv.data_ptr(),
                   n, h, _build.DTYPE_CODE[x.dtype],
                   _build.DTYPE_CODE[w.dtype], float(eps)], x.device)
    rms_norm_fwd.launches += 1
    return out, inv


def rms_norm_bwd(x, w, inv, g):
    """(dx [N, H] in x's dtype, dw [H] in w's dtype) from the forward's x,
    w, inv and the output cotangent g.  CUDA tensors launch
    ``rms_norm_bwd_launch`` (row pass with per-block dw partials, then an
    ordered sum of the partials) and add one to ``rms_norm_bwd.launches``;
    CPU tensors run :func:`rms_norm_bwd_ref`."""
    if not _build.on_card("rms_norm_bwd", x):
        return rms_norm_bwd_ref(x, w, inv, g)
    x, w = _check(x, w, ("inv", inv), ("g", g))
    n, h = x.shape
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g must match x: {g.dtype} {tuple(g.shape)}")
    if inv.shape != (n,) or inv.dtype != torch.float32:
        raise ValueError(f"inv must be f32 [N={n}]")
    g, inv = g.contiguous(), inv.contiguous()
    rows = _build.library("rms_norm").rms_norm_partial_rows()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty((-(-n // rows), h), dtype=torch.float32,
                          device=x.device)
    _build.launch("rms_norm", "rms_norm_bwd_launch",
                  [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4,
                  [x.data_ptr(), w.data_ptr(), inv.data_ptr(), g.data_ptr(),
                   dx.data_ptr(), dw.data_ptr(), partial.data_ptr(), n, h,
                   _build.DTYPE_CODE[x.dtype], _build.DTYPE_CODE[w.dtype]],
                  x.device)
    rms_norm_bwd.launches += 1
    return dx, dw


rms_norm_fwd.launches = 0
rms_norm_bwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    """The JAX ``_make_rms`` custom VJP over rows [N, H]: the forward saves
    (x, w, inv), the backward runs the backward kernel."""

    @staticmethod
    def forward(ctx, x, w, eps):
        out, inv = rms_norm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, inv)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, inv = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, inv, g.contiguous())
        return dx, dw, None


def rms_norm(x, weight, eps=1e-6):
    """RMSNorm over the last dim of x [..., H] with weight [H]; ``None``
    when the rows do not tile (the JAX op's rule), so the caller runs
    ``rms_norm_ref``."""
    h = x.shape[-1]
    if h % 128 != 0:
        return None
    n = x.numel() // h if h else 0
    if n % 8 != 0:
        return None
    out = _RMSNorm.apply(x.reshape(n, h), weight, float(eps))
    return out.reshape(x.shape)
