"""Momentum, Adam and AdamW, functional form (port of
``paddle_tpu.optimizer.Optimizer.apply_gradients_functional`` /
``init_opt_state``, ``Momentum._update`` and ``Adam._adam_core``, both its
branches).

A ``weight_decay`` given to the base is coupled, as JAX's base applies it
(``optimizer.py:160``): the gradient becomes ``g + weight_decay * p``
before the update; AdamW decays the parameter instead.  Momentum's state
per parameter is an f32 ``velocity``; Adam's is f32 ``moment1`` /
``moment2`` of the parameter's shape and 0-d f32 ``beta1_pow`` /
``beta2_pow``.  The update runs in f32 and
casts the parameter back to its own dtype.  Unlike the pure JAX functions
it updates IN PLACE — the parameter tensors and the state tensors passed in
are overwritten and returned — so a step never holds a second copy of the
weights or of the moments.

``fused`` is the counterpart of the JAX flag ``use_pallas_adamw`` (off by
default, as there): with it on, every parameter tensor goes through
:func:`paddle_tpu_torch.ops.fused.adamw_update` — one CUDA kernel per
tensor on the card.  The JAX wrapper declines tensors whose size does not
tile its ``(rows, 1024)`` blocks and those take the eager update; the CUDA
kernel has no such tile, so here every tensor takes the kernel, which
computes the same function rounded once differently
(``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``).
"""
from __future__ import annotations

import torch

from .. import resolve_device

__all__ = ["Momentum", "Adam", "AdamW"]


class Optimizer:
    """What every optimizer shares: the learning rate, the coupled weight
    decay, the state's initialisation and the step over ``{name: tensor}``
    dicts.  A subclass gives ``_init_state(value, device)`` and
    ``_update(p, g, state, lr)``, which updates ``p`` and ``state`` in
    place and returns them."""

    def __init__(self, learning_rate, weight_decay=None):
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay

    def get_lr(self):
        return self._learning_rate

    def init_opt_state(self, params: dict, device=None) -> dict:
        """Zero state for every ``{name: tensor}`` entry, on ``device``
        (``None``: the CUDA device, raising without one)."""
        dev = resolve_device(device)
        return {name: self._init_state(v, dev) for name, v in params.items()}

    @torch.no_grad()
    def apply_gradients_functional(self, params: dict, grads: dict,
                                   opt_state: dict, lr=None):
        """One step over ``{name: tensor}`` dicts; returns
        ``(params, opt_state)`` — the same tensors, updated in place.
        Parameters without a gradient pass through; a missing or empty
        state is initialised on the parameter's device."""
        lr = self.get_lr() if lr is None else lr
        new_params, new_state = {}, {}
        for name, pv in params.items():
            gv = grads.get(name)
            if gv is None:
                new_params[name] = pv
                new_state[name] = opt_state.get(name, {})
                continue
            if self._weight_decay:
                gv = gv + float(self._weight_decay) * pv
            st = opt_state.get(name)
            if not st:
                st = self._init_state(pv, pv.device)
            new_params[name], new_state[name] = self._update(pv, gv, st, lr)
        return new_params, new_state


class Momentum(Optimizer):
    """JAX ``Momentum`` (``optimizers.py:29-47``): the f32 velocity ``v =
    momentum * v + g``, then ``p - lr * v``, or ``p - lr * (g + momentum *
    v)`` with ``use_nesterov``, the update cast to p's dtype first.
    ``weight_decay`` is the coupled L2 term of the base."""

    def __init__(self, learning_rate=0.001, momentum=0.9, use_nesterov=False,
                 weight_decay=None):
        super().__init__(learning_rate, weight_decay)
        self._momentum, self._nesterov = momentum, use_nesterov

    def _init_state(self, value, device):
        return {"velocity": torch.zeros(value.shape, dtype=torch.float32,
                                        device=device)}

    def _update(self, p, g, state, lr):
        g32 = g.float()
        v = state["velocity"].mul_(self._momentum).add_(g32)
        upd = g32 + self._momentum * v if self._nesterov else v
        p.sub_(lr * upd.to(p.dtype))
        return p, state


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=None, fused=False):
        super().__init__(learning_rate, weight_decay)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._fused = fused

    def _init_state(self, value, device):
        z = torch.zeros(value.shape, dtype=torch.float32, device=device)
        one = torch.ones((), dtype=torch.float32, device=device)
        return {"moment1": z, "moment2": z.clone(), "beta1_pow": one,
                "beta2_pow": one.clone()}

    @torch.no_grad()
    def _adam_core(self, p, g, state, lr, decoupled_wd=0.0):
        b1, b2 = self._beta1, self._beta2
        state["beta1_pow"].mul_(b1)
        state["beta2_pow"].mul_(b2)
        if self._fused:
            from ..ops.fused import adamw_update
            adamw_update(p, g, state["moment1"], state["moment2"], lr=lr,
                         beta1=b1, beta2=b2, eps=self._eps,
                         weight_decay=decoupled_wd,
                         beta1_pow=state["beta1_pow"],
                         beta2_pow=state["beta2_pow"])
            return p, state
        g32 = g.float()
        m1 = state["moment1"].mul_(b1).add_(g32 * (1 - b1))
        m2 = state["moment2"].mul_(b2).add_(g32 * g32 * (1 - b2))
        m1h = m1 / (1 - state["beta1_pow"])
        m2h = m2 / (1 - state["beta2_pow"])
        p32 = p.float()
        if decoupled_wd:
            p32 = p32 * (1 - lr * decoupled_wd)
        p.copy_(p32 - lr * m1h / (torch.sqrt(m2h) + self._eps))
        return p, state

    def _update(self, p, g, state, lr):
        return self._adam_core(p, g, state, lr)


class AdamW(Adam):
    """Decoupled weight decay: ``p32 * (1 - lr * weight_decay)`` before the
    Adam step (reference python/paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, fused=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, None, fused)
        self._wd = float(weight_decay)

    def _update(self, p, g, state, lr):
        return self._adam_core(p, g, state, lr, decoupled_wd=self._wd)
