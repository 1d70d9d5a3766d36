"""Fused row and elementwise kernels: RMSNorm, LayerNorm, softmax and the
AdamW update (port of ``paddle_tpu/ops/pallas/fused.py``).

Each kernel has a wrapper that launches the hand-written CUDA kernel of
``csrc/<name>.cu`` for CUDA tensors and adds one to its ``launches``
counter, and runs its plain PyTorch version (``*_ref``) for CPU tensors:

  ``rms_norm_fwd``    -> (out, inv)       TPU ``_rms_fwd_kernel``
  ``rms_norm_bwd``    -> (dx, dw)         TPU ``_rms_bwd_kernel``
  ``layer_norm_fwd``  -> (out, mu, inv)   TPU ``_ln_fwd_kernel``
  ``layer_norm_bwd``  -> (dx, dw, db)     TPU ``_ln_bwd_kernel``
  ``softmax_fwd``     -> o                TPU ``_softmax_fwd_kernel``
  ``softmax_bwd``     -> dx               TPU ``_softmax_bwd_kernel``
  ``adamw_update``    -> (p, m, v)        TPU ``_adamw_kernel``

Rows are ``x [N, H]``; the norm forwards save f32 per-row statistics
[N] for a cheap backward.  :func:`rms_norm`, :func:`layer_norm` and
:func:`softmax` are the differentiable ops; like the JAX ones they return
``None`` when the rows do not tile (H not a multiple of 128, or N not a
multiple of 8), and the caller then runs its plain op.  The AdamW wrapper
updates ``p``, ``m`` and ``v`` in place; unlike the TPU wrapper it takes any
length, since the CUDA kernel has no ``(rows, 1024)`` tile.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_fwd", "rms_norm_fwd_ref", "rms_norm_bwd",
           "rms_norm_bwd_ref", "layer_norm", "layer_norm_fwd",
           "layer_norm_fwd_ref", "layer_norm_bwd", "layer_norm_bwd_ref",
           "softmax", "softmax_fwd", "softmax_fwd_ref", "softmax_bwd",
           "softmax_bwd_ref", "adamw_update", "adamw_update_ref"]


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
    ``rms_norm_bwd_launch`` (one row pass over a grid sized to the card,
    each block writing one dw partial row, then an ordered sum of the
    partials) and add one to ``rms_norm_bwd.launches``;
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
    with torch.cuda.device(x.device):
        parts = _build.library("rms_norm").rms_norm_bwd_partials(n)
    if parts < 1:
        raise RuntimeError(f"rms_norm_bwd_partials({n}) failed: {parts}")
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty((parts, h), dtype=torch.float32, device=x.device)
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
    n = _tiled_rows(x)
    if n is None:
        return None
    out = _RMSNorm.apply(x.reshape(n, x.shape[-1]), weight, float(eps))
    return out.reshape(x.shape)


def _tiled_rows(x):
    """N, the rows of x [..., H] seen as [N, H], when the JAX kernels take
    the shape (H a multiple of 128, N of 8, at least two dims); else None."""
    h = x.shape[-1]
    n = x.numel() // h if h else 0
    if x.dim() < 2 or h % 128 != 0 or n % 8 != 0:
        return None
    return n


# -- LayerNorm ----------------------------------------------------------------
def layer_norm_fwd_ref(x, w, b, eps):
    """out = (x - mu) * inv * w + b (f32 math, cast to x's dtype), and mu,
    inv = rsqrt(var + eps), each [N] f32."""
    xf = x.float()
    mu = xf.mean(dim=-1)
    xc = xf - mu[:, None]
    inv = torch.rsqrt((xc * xc).mean(dim=-1) + eps)
    out = xc * inv[:, None] * w.float() + b.float()
    return out.to(x.dtype), mu, inv


def layer_norm_bwd_ref(x, w, mu, inv, g):
    """dx = inv * (gw - mean(gw) - xhat * mean(gw * xhat)) in x's dtype,
    dw = sum over rows of g * xhat and db = sum over rows of g (f32, cast to
    w's dtype)."""
    xhat = (x.float() - mu[:, None]) * inv[:, None]
    gf = g.float()
    gw = gf * w.float()
    m1 = gw.mean(dim=-1, keepdim=True)
    m2 = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = (inv[:, None] * (gw - m1 - xhat * m2)).to(x.dtype)
    return dx, (gf * xhat).sum(dim=0).to(w.dtype), gf.sum(dim=0).to(w.dtype)


def _stats(name, t, n):
    if t.shape != (n,) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 [N={n}], got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def layer_norm_fwd(x, w, b, eps):
    """x [N, H], w and b [H] of one dtype -> (out [N, H] in x's dtype, mu,
    inv [N] f32).  CUDA tensors launch ``layer_norm_fwd_launch`` and add one
    to ``layer_norm_fwd.launches``; CPU tensors run
    :func:`layer_norm_fwd_ref`."""
    if not _build.on_card("layer_norm_fwd", x):
        return layer_norm_fwd_ref(x, w, b, eps)
    x, w = _check(x, w, ("b", b))
    if b.shape != w.shape or b.dtype != w.dtype:
        raise ValueError(f"b must match w: {b.dtype} {tuple(b.shape)}")
    b = b.contiguous()
    n, h = x.shape
    out = torch.empty_like(x)
    mu = torch.empty((n,), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mu)
    _build.launch("layer_norm", "layer_norm_fwd_launch",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                  + [ctypes.c_float],
                  [x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                   mu.data_ptr(), inv.data_ptr(), n, h,
                   _build.DTYPE_CODE[x.dtype], _build.DTYPE_CODE[w.dtype],
                   float(eps)], x.device)
    layer_norm_fwd.launches += 1
    return out, mu, inv


def layer_norm_bwd(x, w, mu, inv, g):
    """(dx [N, H] in x's dtype, dw [H], db [H] in w's dtype) from the
    forward's x, w, mu, inv and the output cotangent g.  CUDA tensors launch
    ``layer_norm_bwd_launch`` (one row pass over a grid sized to the card,
    each block writing one dw and one db partial row, then an ordered sum
    of the partials) and add one to ``layer_norm_bwd.launches``; CPU
    tensors run :func:`layer_norm_bwd_ref`."""
    if not _build.on_card("layer_norm_bwd", x):
        return layer_norm_bwd_ref(x, w, mu, inv, g)
    x, w = _check(x, w, ("mu", mu), ("inv", inv), ("g", g))
    n, h = x.shape
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g must match x: {g.dtype} {tuple(g.shape)}")
    mu, inv, g = _stats("mu", mu, n), _stats("inv", inv, n), g.contiguous()
    with torch.cuda.device(x.device):
        parts = _build.library("layer_norm").layer_norm_bwd_partials(n)
    if parts < 1:
        raise RuntimeError(f"layer_norm_bwd_partials({n}) failed: {parts}")
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = torch.empty_like(w)
    partial = torch.empty((2 * parts, h), dtype=torch.float32,
                          device=x.device)
    _build.launch("layer_norm", "layer_norm_bwd_launch",
                  [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4,
                  [x.data_ptr(), w.data_ptr(), mu.data_ptr(), inv.data_ptr(),
                   g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                   partial.data_ptr(), n, h, _build.DTYPE_CODE[x.dtype],
                   _build.DTYPE_CODE[w.dtype]], x.device)
    layer_norm_bwd.launches += 1
    return dx, dw, db


layer_norm_fwd.launches = 0
layer_norm_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):
    """The JAX ``_make_layer_norm`` custom VJP over rows [N, H]: the forward
    saves (x, w, mu, inv), the backward runs the backward kernel."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        out, mu, inv = layer_norm_fwd(x, w, b, eps)
        ctx.save_for_backward(x, w, mu, inv)
        ctx.b_dtype = b.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, mu, inv = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, w, mu, inv, g.contiguous())
        return dx, dw, db.to(ctx.b_dtype), None


def layer_norm(x, weight, bias, eps=1e-5):
    """Affine LayerNorm over the last dim of x [..., H] with weight and bias
    [H]; ``None`` when the rows do not tile (the JAX op's rule), so the
    caller runs ``layer_norm_ref``."""
    n = _tiled_rows(x)
    if n is None:
        return None
    h = x.shape[-1]
    return _LayerNorm.apply(x.reshape(n, h), weight, bias,
                            float(eps)).reshape(x.shape)


# -- softmax ------------------------------------------------------------------
def softmax_fwd_ref(x):
    """Softmax over the last axis of x [N, H] in f32, cast to x's dtype."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_bwd_ref(o, g):
    """dx = o * (g - sum(g * o)) with f32 math, in o's dtype."""
    of, gf = o.float(), g.float()
    s = (gf * of).sum(dim=-1, keepdim=True)
    return (of * (gf - s)).to(o.dtype)


def _check_rows(name, x, *more):
    if x.dim() != 2:
        raise ValueError(f"{name}: want rows [N, H], got {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for other, t in more:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: {other} must match in shape, dtype "
                             f"and device: {t.dtype} {tuple(t.shape)} "
                             f"{t.device}")
    return x.contiguous()


def softmax_fwd(x):
    """o = softmax of each row of x [N, H], in x's dtype.  CUDA tensors
    launch ``softmax_fwd_launch`` and add one to ``softmax_fwd.launches``;
    CPU tensors run :func:`softmax_fwd_ref`."""
    if not _build.on_card("softmax_fwd", x):
        return softmax_fwd_ref(x)
    x = _check_rows("softmax_fwd", x)
    n, h = x.shape
    o = torch.empty_like(x)
    _build.launch("softmax", "softmax_fwd_launch",
                  [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3,
                  [x.data_ptr(), o.data_ptr(), n, h,
                   _build.DTYPE_CODE[x.dtype]], x.device)
    softmax_fwd.launches += 1
    return o


def softmax_bwd(o, g):
    """dx [N, H] in o's dtype from the forward's output o and the output
    cotangent g.  CUDA tensors launch ``softmax_bwd_launch`` and add one to
    ``softmax_bwd.launches``; CPU tensors run :func:`softmax_bwd_ref`."""
    if not _build.on_card("softmax_bwd", o):
        return softmax_bwd_ref(o, g)
    o = _check_rows("softmax_bwd", o, ("g", g))
    g = g.contiguous()
    n, h = o.shape
    dx = torch.empty_like(o)
    _build.launch("softmax", "softmax_bwd_launch",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
                  [o.data_ptr(), g.data_ptr(), dx.data_ptr(), n, h,
                   _build.DTYPE_CODE[o.dtype]], o.device)
    softmax_bwd.launches += 1
    return dx


softmax_fwd.launches = 0
softmax_bwd.launches = 0


class _Softmax(torch.autograd.Function):
    """The JAX ``_make_softmax`` custom VJP over rows [N, H]: the forward
    saves its output, the backward runs the backward kernel on it."""

    @staticmethod
    def forward(ctx, x):
        o = softmax_fwd(x)
        ctx.save_for_backward(o)
        return o

    @staticmethod
    def backward(ctx, g):
        (o,) = ctx.saved_tensors
        return softmax_bwd(o, g.contiguous())


def softmax(x):
    """Softmax over the last axis of x [..., H]; ``None`` when the rows do
    not tile (the JAX op's rule), so the caller runs the plain op."""
    n = _tiled_rows(x)
    if n is None:
        return None
    return _Softmax.apply(x.reshape(n, x.shape[-1])).reshape(x.shape)


# -- AdamW --------------------------------------------------------------------
def _adamw_scalars(lr, beta1, beta2, eps, weight_decay):
    """The kernel's f32 scalars, with 1 - beta rounded in f32 as the kernel
    (and the TPU kernel) computes it."""
    f = np.float32
    b1, b2 = f(beta1), f(beta2)
    return (float(f(lr)), float(b1), float(b2), float(f(eps)),
            float(f(weight_decay)), float(f(1) - b1), float(f(1) - b2))


def _bias(step, beta, given, pow_):
    """1 - beta^t: given, or from the step, or (a 0-d f32 tensor) from the
    optimizer's beta^t state."""
    if pow_ is not None:
        return 1.0 - pow_
    if given is None:
        if step is None:
            raise ValueError("adamw_update: pass step, bias1/bias2 or "
                             "beta1_pow/beta2_pow")
        given = 1.0 - beta ** step
    return float(np.float32(given))


def adamw_update_ref(p, g, m, v, *, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                     weight_decay=0.01, step=None, bias1=None, bias2=None,
                     beta1_pow=None, beta2_pow=None):
    """The kernel's update in plain PyTorch, out of place: returns (p' in
    p's dtype, m', v' f32) with every operation rounded in f32 in the
    kernel's order, p' = p - lr * (m'/c1 / (sqrt(v'/c2) + eps) + wd * p)."""
    lr, b1, b2, eps, wd, one_b1, one_b2 = _adamw_scalars(
        lr, beta1, beta2, eps, weight_decay)
    # the corrections as f32 tensors on p's device: torch divides by a
    # Python number as a multiply by its reciprocal, the kernel truly
    c1, c2 = (torch.as_tensor(_bias(step, beta, given, pow_),
                              dtype=torch.float32, device=p.device)
              for beta, given, pow_ in ((beta1, bias1, beta1_pow),
                                        (beta2, bias2, beta2_pow)))
    pf, gf = p.float(), g.float()
    mn = m.float() * b1 + gf * one_b1
    vn = v.float() * b2 + (gf * one_b2) * gf
    upd = (mn / c1) / (torch.sqrt(vn / c2) + eps) + pf * wd
    return (pf - upd * lr).to(p.dtype), mn, vn


def adamw_update(p, g, m, v, *, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, step=None, bias1=None, bias2=None,
                 beta1_pow=None, beta2_pow=None):
    """One AdamW step on one tensor, IN PLACE: p (f32 or bf16) and g of p's
    shape and dtype, f32 moments m and v of the same size.  The bias
    corrections are ``bias1`` / ``bias2`` (= 1 - beta^t), or come from
    ``step``, or — the optimizer's way, with no wait for the card — from
    ``beta1_pow`` / ``beta2_pow``, the 0-d f32 beta^t state on p's device.
    Returns (p, m, v).  CUDA tensors launch ``adamw_launch`` and add one to
    ``adamw_update.launches``; CPU tensors run :func:`adamw_update_ref` and
    copy the result back."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, step=step, bias1=bias1, bias2=bias2,
              beta1_pow=beta1_pow, beta2_pow=beta2_pow)
    if not _build.on_card("adamw_update", p):
        np_, nm, nv = adamw_update_ref(p, g, m, v, **kw)
        p.copy_(np_)
        m.copy_(nm)
        v.copy_(nv)
        return p, m, v
    if p.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"adamw_update: p must be float32 or bfloat16, got "
                        f"{p.dtype}")
    if g.shape != p.shape or g.dtype != p.dtype:
        raise ValueError(f"adamw_update: g must match p: {g.dtype} "
                         f"{tuple(g.shape)} vs {p.dtype} {tuple(p.shape)}")
    g = g.contiguous()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError(f"adamw_update: {name} must be contiguous on "
                             f"{p.device} (p, m and v update in place)")
    for name, t in (("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.numel() != p.numel():
            raise ValueError(f"adamw_update: {name} must be f32 with "
                             f"{p.numel()} elements")
    lr, b1, b2, eps, wd, _, _ = _adamw_scalars(lr, beta1, beta2, eps,
                                               weight_decay)
    pows = (beta1_pow, beta2_pow)
    if (pows[0] is None) != (pows[1] is None):
        raise ValueError("adamw_update: pass both beta1_pow and beta2_pow")
    if pows[0] is not None:
        for t in pows:
            if t.numel() != 1 or t.dtype != torch.float32 \
                    or t.device != p.device:
                raise ValueError("adamw_update: beta*_pow must be one f32 "
                                 f"value on {p.device}")
        c1 = c2 = 0.0
        ptrs = [t.data_ptr() for t in pows]
    else:
        c1, c2 = _bias(step, beta1, bias1, None), _bias(step, beta2, bias2,
                                                          None)
        ptrs = [None, None]
    _build.launch("adamw", "adamw_launch",
                  [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                  + [ctypes.c_float] * 7 + [ctypes.c_void_p] * 2
                  + [ctypes.c_int],
                  [p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                   p.numel(), lr, b1, b2, eps, wd, c1, c2, *ptrs,
                   _build.DTYPE_CODE[p.dtype]], p.device)
    adamw_update.launches += 1
    return p, m, v


adamw_update.launches = 0
