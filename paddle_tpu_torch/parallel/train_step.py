"""TrainStep: one call = forward + backward + optimizer update (port of
``paddle_tpu/parallel/train_step.py``).

JAX traces the step into one executable over functional state; here the
model's own parameters and buffers are the state and every update is in
place, so ``sync_to_model`` has nothing to copy but the optimizer's
accumulators.  The gradients come from ``torch.autograd.grad`` (zeros for a
parameter the loss does not reach, as ``jax.value_and_grad`` gives), so no
``.grad`` is ever written and none leaks into the next call.

``grad_accum=A`` splits every batch tensor's leading axis into A
microbatches, runs forward and backward on each in turn — the model's
buffers (BatchNorm running statistics) chain from one microbatch to the
next — and sums the gradients in f32; the loss and the gradients are the
means, and there is ONE optimizer update per call.  The averaged gradient
goes to the update in the parameter's dtype (the fused AdamW kernel takes
a gradient of its parameter's dtype; JAX keeps it in f32).

Non-finite guard (``nonfinite_guard=M``): the loss and every gradient are
reduced to one device flag, read on the host once a step (the one sync
JAX's guard costs too), BEFORE the update — the in-place update cannot be
undone afterwards.  A bad step is skipped and counted: parameters,
moments, buffers (snapshotted before the forward, only under the guard),
the LR schedule and ``global_step`` stay bit-identical.
``FloatingPointError`` comes after M consecutive bad steps.  An attached
``GradScaler`` keeps its books (``update()`` after a good step,
``notify_nonfinite()`` after a bad one); the loss is never scaled.  The
``train.nonfinite`` fault point (``resilience/faults.py``) poisons a step's
loss and gradients with NaN on demand.

``in_shardings`` is accepted and ignored, as JAX's ``TrainStep`` ignores
it (the sharded step is ``parallel.ShardedTrainStep``).

The step runs on ``device`` (``None``: the CUDA device, raising without
one), where the model's parameters must be; batches (tensors or numpy
arrays) are moved there.  The optimizer's learning rate is read each call
and its scheduler advances through ``finish_step()`` on good steps only.
An optimizer built without ``parameters=`` gets the model's trainable
parameters as its parameter list, so ``CheckpointManager(optimizer=...)``
sees the state this step updates.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import on_device, resolve_device
from ..observability.train import batch_samples

__all__ = ["TrainStep", "compile_train_step"]


def _to_device(b, dev):
    if isinstance(b, np.ndarray) or np.isscalar(b):
        b = torch.as_tensor(b)
    return b.to(dev, non_blocking=True) if isinstance(b, torch.Tensor) \
        else b


class TrainStep:
    """``step(*batch) -> loss`` over ``model`` with ``opt``; ``loss_fn(model,
    *batch)`` returns the scalar loss."""

    def __init__(self, model: nn.Module, opt, loss_fn: Callable,
                 donate: bool = True, in_shardings=None, with_amp=False,
                 amp_dtype="bfloat16", grad_accum: int = 1,
                 nonfinite_guard: Optional[int] = None, scaler=None,
                 telemetry=None, device=None):
        if with_amp:
            raise NotImplementedError(
                "TrainStep(with_amp=True): amp.auto_cast is not ported "
                "(ROADMAP A item 7)")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if nonfinite_guard is not None and nonfinite_guard < 1:
            raise ValueError(
                f"nonfinite_guard must be >= 1, got {nonfinite_guard}")
        self.device = resolve_device(device)
        self.model = model
        self.opt = opt
        self.loss_fn = loss_fn
        self.telemetry = telemetry
        self.grad_accum = int(grad_accum)
        self.nonfinite_guard = nonfinite_guard
        self.scaler = scaler
        self.step_count = 0
        self.skipped_steps = 0
        self.consecutive_bad = 0
        self.last_step_good = True
        named = list(model.named_parameters())
        for n, p in named:
            if not on_device(p, self.device):
                raise ValueError(f"TrainStep on {self.device}: parameter {n} "
                                 f"is on {p.device}")
        self.params = {n: p for n, p in named if p.requires_grad}
        self._lr_scales = {
            n: float(p.optimize_attr.get("learning_rate", 1.0))
            for n, p in self.params.items()
            if getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            != 1.0}
        self.buffers = dict(model.named_buffers())
        if not opt._parameter_list:
            opt._parameter_list = list(self.params.values())
            opt._names = {id(p): n for n, p in self.params.items()}
        self.opt_state   # the optimizer's state, made now on the device

    @property
    def opt_state(self) -> dict:
        """The optimizer's accumulators by parameter name: they ARE the
        step's state (updated in place), so ``state_dict`` and
        ``CheckpointManager`` read, and a restore writes, what the next
        step uses."""
        acc, out = self.opt._accumulators, {}
        for n, p in self.params.items():
            st = acc.get(id(p))
            if not st:
                st = acc[id(p)] = self.opt._init_state(p, self.device)
            out[n] = st
        return out

    def _grads(self, batch):
        """(mean loss, mean gradients by name) over the microbatches."""
        params = list(self.params.values())
        a = self.grad_accum
        if a == 1:
            loss = self.loss_fn(self.model, *batch)
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
            return loss.detach(), dict(zip(self.params, grads))
        for b in batch:
            if isinstance(b, torch.Tensor) and b.shape[0] % a:
                raise ValueError(f"batch dim {b.shape[0]} not divisible by "
                                 f"grad_accum={a}")
        loss_sum, acc = None, None
        for i in range(a):
            mb = [b.narrow(0, i * (b.shape[0] // a), b.shape[0] // a)
                  if isinstance(b, torch.Tensor) else b for b in batch]
            lv = self.loss_fn(self.model, *mb)
            g = torch.autograd.grad(lv, params, allow_unused=True,
                                    materialize_grads=True)
            lv = lv.detach().float()
            if acc is None:
                loss_sum, acc = lv, [x.float() for x in g]
            else:
                loss_sum = loss_sum + lv
                torch._foreach_add_(acc, [x.float() for x in g])
        # true division, as JAX's: torch divides by a Python number as a
        # multiply by its reciprocal
        div = torch.tensor(float(a), device=self.device)
        grads = {n: (gi / div).to(p.dtype)
                 for (n, p), gi in zip(self.params.items(), acc)}
        return loss_sum / div, grads

    @staticmethod
    def _finite(loss, grads):
        flags = [torch.isfinite(loss).all()]
        flags += [torch.isfinite(g).all() for g in grads.values()]
        return bool(torch.stack(flags).all())

    def __call__(self, *batch):
        from ..resilience.faults import fault_point
        tel = self.telemetry
        t0 = tel.clock() if tel is not None else 0.0
        vals = [_to_device(b, self.device) for b in batch]
        poison = fault_point("train.nonfinite",
                             step=self.step_count) is not None
        guard = self.nonfinite_guard is not None
        saved = [b.clone() for b in self.buffers.values()] if guard else None
        loss, grads = self._grads(vals)
        if poison:
            loss = loss + float("nan")
            grads = {n: g + float("nan") for n, g in grads.items()}
        good = self._finite(loss, grads) if guard else True
        if good:
            self.opt.apply_gradients_functional(
                self.params, grads, self.opt_state, lr=self.opt.get_lr(),
                lr_scales=self._lr_scales or None)
        else:
            with torch.no_grad():
                for b, s in zip(self.buffers.values(), saved):
                    b.copy_(s)
        self.step_count += 1
        if not guard:
            self.opt.finish_step()
            if tel is not None:
                tel.step(tel.clock() - t0, samples=batch_samples(vals))
            return loss
        self.last_step_good = good
        if tel is not None:
            # the guard's flag fetch above synchronised with the card, so
            # this is the step's device latency, not its dispatch time
            tel.step(tel.clock() - t0, samples=batch_samples(vals),
                     good=good)
        if good:
            # the schedule ticks only on real progress
            self.opt.finish_step()
            self.consecutive_bad = 0
            if self.scaler is not None:
                self.scaler.update()
            return loss
        self.skipped_steps += 1
        self.consecutive_bad += 1
        if tel is not None:
            tel.nonfinite_skip(self.step_count - 1, self.consecutive_bad)
        if self.scaler is not None:
            # count only actual backoffs (the decay runs every
            # decr_every_n_nan_or_inf-th bad step)
            scale_before = self.scaler._scale
            self.scaler.notify_nonfinite()
            if tel is not None and self.scaler._scale != scale_before:
                tel.scaler_backoff(self.step_count - 1)
        if self.consecutive_bad >= self.nonfinite_guard:
            if tel is not None:
                tel.nonfinite_raise(self.step_count - 1, self.consecutive_bad,
                                    self.skipped_steps)
            raise FloatingPointError(
                f"non-finite loss/gradients for {self.consecutive_bad} "
                f"consecutive steps (step {self.step_count - 1}, "
                f"{self.skipped_steps} skipped total) — the run has "
                f"diverged; restore a checkpoint or lower the learning rate")
        return loss

    def sync_to_model(self):
        """Nothing to copy: the parameters, the buffers and the optimizer's
        accumulators are this step's state already (kept for the JAX
        API)."""


def compile_train_step(model, opt, loss_fn, **kw) -> TrainStep:
    """loss_fn(model, *batch_tensors) -> scalar tensor."""
    return TrainStep(model, opt, loss_fn, **kw)
