"""The optimizer base and Momentum, Adam and AdamW (port of
``paddle_tpu/optimizer/optimizer.py`` ``Optimizer`` and of
``optimizers.py`` ``Momentum``, ``Adam._adam_core`` (both its branches) and
``AdamW``).

Two ways to step, as in JAX:

  * **functional** — ``apply_gradients_functional(params, grads,
    opt_state)`` over ``{name: tensor}`` dicts, the path of ``TrainStep``
    and of every train step ``chip_smoke.py`` drives.  It applies the
    coupled ``weight_decay`` (a float or an ``L1Decay`` / ``L2Decay``
    object) and ``lr_scales``, and — as JAX's does — neither ``grad_clip``
    nor ``apply_decay_param_fun`` nor a parameter's own ``regularizer``.
  * **eager** — ``Optimizer(parameters=...)`` then ``step()`` /
    ``clear_grad()`` over the parameters' ``.grad``: the clip first, then
    per parameter its ``regularizer`` attribute or the coupled global
    ``weight_decay``, and a learning rate scaled by the parameter's
    ``optimize_attr["learning_rate"]``.  ``step()`` does not advance an LR
    scheduler (the ``hapi.callbacks.LRScheduler`` callback does that in
    ``fit``, and ``finish_step()`` in ``TrainStep``).

Both update IN PLACE: the parameter tensors and the state tensors are
overwritten, so a step never holds a second copy of the weights or of the
moments.  Momentum's state per parameter is an f32 ``velocity``; Adam's is
f32 ``moment1`` / ``moment2`` of the parameter's shape and 0-d f32
``beta1_pow`` / ``beta2_pow``.  The update runs in f32 and casts the
parameter back to its own dtype.  The eager state lives in
``_accumulators`` keyed by ``id(p)``; ``state_dict()`` names it
``{name}.{key}`` (the name as below), with ``global_step`` and the
scheduler's state under ``LR_Scheduler``.

``parameters`` is an iterable of tensors, of ``(name, tensor)`` pairs
(``model.named_parameters()``) or of ``{"params": [...]}`` groups.  A
parameter's name — what ``apply_decay_param_fun`` receives and what
``state_dict`` keys hold — is its ``name`` attribute if it has one, else
the dotted name it was given with, else ``param_{i}``; JAX passes its own
generated ``p.name`` instead, which torch parameters do not have.

``fused`` is the counterpart of the JAX flag ``use_pallas_adamw`` (off by
default, as there): with it on, every parameter tensor goes through
:func:`paddle_tpu_torch.ops.fused.adamw_update` — one CUDA kernel per
tensor on the card, on either path, with the tensor's own decay (0 for a
tensor ``apply_decay_param_fun`` exempts).  The JAX wrapper declines
tensors whose size does not tile its ``(rows, 1024)`` blocks and those take
the eager update; the CUDA kernel has no such tile, so here every tensor
takes the kernel, which computes the same function rounded once
differently (``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``).  The
kernel takes a gradient of the parameter's dtype.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from .lr import LRScheduler

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]


def _grad_of(p, g):
    """A gradient in the parameter's dtype and on its device."""
    return g if g.dtype == p.dtype and g.device == p.device \
        else g.to(device=p.device, dtype=p.dtype)


class Optimizer:
    """What every optimizer shares: the learning rate (a float or an
    ``LRScheduler``), the coupled weight decay, the clip, the parameter list
    and its state, both steps and the state dict.  A subclass gives
    ``_init_state(value, device)`` and ``_update(p, g, state, lr)``, which
    updates ``p`` and ``state`` in place and returns them."""

    _decoupled_wd = False  # True for AdamW-style optimizers

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list, self._names = self._flatten_params(parameters)
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._accumulators: dict = {}
        self._global_step = 0

    @staticmethod
    def _flatten_params(parameters):
        """(tensors, {id: dotted name}) from tensors, (name, tensor) pairs
        or ``{"params": [...]}`` groups."""
        out, names = [], {}
        for p in parameters or ():
            group = p["params"] if isinstance(p, dict) else [p]
            for q in group:
                if isinstance(q, tuple):
                    names[id(q[1])] = q[0]
                    q = q[1]
                out.append(q)
        return out, names

    def _param_names(self):
        return {id(p): getattr(p, "name", None) or self._names.get(id(p))
                or f"param_{i}" for i, p in enumerate(self._parameter_list)}

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def finish_step(self):
        """Post-step bookkeeping of compiled train steps: advance the LR
        scheduler (if any) and the global step counter."""
        if isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.step()
        self._global_step += 1

    # -- state -------------------------------------------------------------
    def init_opt_state(self, params: dict, device=None) -> dict:
        """Zero state for every ``{name: tensor}`` entry, on ``device``
        (``None``: the CUDA device, raising without one)."""
        dev = resolve_device(device)
        return {name: self._init_state(v, dev) for name, v in params.items()}

    def _get_state(self, p):
        st = self._accumulators.get(id(p))
        if st is None:
            # keyed per parameter: bounded by the model, not steps
            st = self._accumulators[id(p)] = self._init_state(p, p.device)
        return st

    # -- the eager step ----------------------------------------------------
    def _eager_pairs(self):
        pairs = [(p, p.grad) for p in self._parameter_list
                 if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        return pairs

    def _decayed_grad(self, p, g):
        """The gradient plus the parameter's own regularizer, else the
        coupled global weight decay."""
        preg = getattr(p, "regularizer", None)
        if preg is not None and callable(preg):
            return g + preg(p)
        wd = self._weight_decay
        if wd is not None and not self._decoupled_wd:
            return g + (wd(p) if callable(wd) else float(wd) * p)
        return g

    @torch.no_grad()
    def step(self):
        """One update of every parameter with a gradient, in place."""
        lr = self.get_lr()
        for p, g in self._eager_pairs():
            if g is None:
                continue
            g = self._decayed_grad(p, g)
            plr = lr * getattr(p, "optimize_attr", {}).get("learning_rate",
                                                           1.0)
            self._update(p, _grad_of(p, g), self._get_state(p), plr)
        self._global_step += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- the functional step -----------------------------------------------
    @torch.no_grad()
    def apply_gradients_functional(self, params: dict, grads: dict,
                                   opt_state: dict, lr=None,
                                   lr_scales: dict | None = None):
        """One step over ``{name: tensor}`` dicts; returns
        ``(params, opt_state)`` — the same tensors, updated in place.
        Parameters without a gradient pass through; a missing or empty
        state is initialised on the parameter's device.  ``lr_scales``:
        ``{name: float}`` per-parameter multipliers of the learning rate."""
        lr = self.get_lr() if lr is None else lr
        wd = self._weight_decay
        new_params, new_state = {}, {}
        for name, pv in params.items():
            gv = grads.get(name)
            if gv is None:
                new_params[name] = pv
                new_state[name] = opt_state.get(name, {})
                continue
            if wd is not None and not self._decoupled_wd:
                gv = gv + (wd(pv) if callable(wd) else float(wd) * pv)
            st = opt_state.get(name)
            if not st:
                st = self._init_state(pv, pv.device)
            plr = lr * lr_scales[name] if lr_scales and name in lr_scales \
                else lr
            new_params[name], new_state[name] = self._update(
                pv, _grad_of(pv, gv), st, plr)
        return new_params, new_state

    # -- checkpointing -----------------------------------------------------
    def state_dict(self):
        """``{name}.{key}`` for every state tensor (references, as torch's
        optimizers give), ``global_step``, and the scheduler's state under
        ``LR_Scheduler``."""
        sd = {}
        names = self._param_names()
        for p in self._parameter_list:
            state = self._accumulators.get(id(p))
            if state is None:
                continue
            for k, v in state.items():
                sd[f"{names[id(p)]}.{k}"] = v
        sd["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """The inverse of :meth:`state_dict`: every state tensor a key names
        is copied in (numpy arrays or tensors), the rest start at zero."""
        names = self._param_names()
        for p in self._parameter_list:
            state = self._init_state(p, p.device)
            for k, t in state.items():
                v = state_dict.get(f"{names[id(p)]}.{k}")
                if v is not None:
                    t.copy_(torch.as_tensor(v).to(t.dtype))
            self._accumulators[id(p)] = state
        self._global_step = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict \
                and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(
                dict(state_dict["LR_Scheduler"]))

    set_dict = set_state_dict


class Momentum(Optimizer):
    """JAX ``Momentum`` (``optimizers.py:29-47``): the f32 velocity ``v =
    momentum * v + g``, then ``p - lr * v``, or ``p - lr * (g + momentum *
    v)`` with ``use_nesterov``, the update cast to p's dtype first.
    ``weight_decay`` is the coupled term of the base (a float or an
    ``L2Decay``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
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
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None,
                 fused=False):
        if amsgrad:
            raise NotImplementedError(
                "Adam(amsgrad=True) is not ported (ROADMAP A item 7)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
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
    Adam step (reference python/paddle/optimizer/adamw.py).  The eager
    ``step()`` gives a parameter decay 0 where ``apply_decay_param_fun(name)``
    is false (the name as in the module docstring); ``lr_ratio`` is
    accepted and, as in JAX, not applied."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None, fused=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name, fused=fused)
        self._wd = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, p, g, state, lr):
        return self._adam_core(p, g, state, lr, decoupled_wd=self._wd)

    @torch.no_grad()
    def step(self):
        if self._apply_decay_param_fun is None:
            return super().step()
        fn = self._apply_decay_param_fun
        names = self._param_names()
        lr = self.get_lr()
        for p, g in self._eager_pairs():
            wd = self._wd if fn(names[id(p)]) else 0.0
            self._adam_core(p, _grad_of(p, g), self._get_state(p), lr,
                            decoupled_wd=wd)
        self._global_step += 1
