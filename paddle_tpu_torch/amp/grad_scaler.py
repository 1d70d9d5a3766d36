"""GradScaler (port of ``paddle_tpu/amp/grad_scaler.py``; reference
python/paddle/amp/grad_scaler.py:657).

Dynamic loss scaling for float16; with bfloat16 scaling is mathematically
unnecessary.  The eager pattern is the reference's: ``scale(loss).
backward()``, ``step(opt)`` (unscale the ``.grad`` of the optimizer's
parameters in place, skip the update when one is not finite), then
``update()`` once per iteration.  ``TrainStep`` never scales its loss: under
its non-finite guard the scaler only keeps its books — ``update()`` after a
good step, ``notify_nonfinite()`` after a bad one.  The scale is a host
float, so the books cost no device sync; ``unscale_`` reads one flag per
optimizer from the card.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # per-optimizer state machine (INIT -> UNSCALED -> STEPPED), so
        # `unscale_(opt); clip; step(opt)` divides by the scale once
        self._opt_states: dict[int, str] = {}
        self._opt_found_inf: dict[int, bool] = {}

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        oid = id(optimizer)
        if self._opt_states.get(oid) == "UNSCALED":
            raise RuntimeError(
                "unscale_() has already been called on this optimizer since "
                "the last step()/update(); calling it twice would divide "
                "gradients by the loss scale twice.")
        inv = 1.0 / self._scale
        flags = []
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            p.grad.mul_(inv)
            flags.append(torch.isfinite(p.grad.float()).all())
        found = bool(flags) and not bool(torch.stack(flags).all())
        self._opt_found_inf[oid] = found
        self._found_inf = self._found_inf or found
        self._opt_states[oid] = "UNSCALED"

    def step(self, optimizer):
        """Unscale (if not already done) and apply the optimizer step.
        Like the reference, step() does NOT update the loss scale — call
        update() once per iteration after all optimizers have stepped."""
        if not self._enable:
            optimizer.step()
            return
        oid = id(optimizer)
        if self._opt_states.get(oid) != "UNSCALED":
            self.unscale_(optimizer)
        if not self._opt_found_inf.get(oid, False):
            optimizer.step()
        self._opt_states[oid] = "STEPPED"

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._opt_states.clear()
        self._opt_found_inf.clear()
        if not (self._enable and self._dynamic):
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def notify_nonfinite(self):
        """Backoff hook for train loops with a non-finite guard: count a bad
        step and run the dynamic-loss-scale decay."""
        self._found_inf = True
        self.update()

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_count": self._good_steps,
                "decr_count": self._bad_steps,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("incr_count", 0)
        self._bad_steps = sd.get("decr_count", 0)

    set_state_dict = load_state_dict


AmpScaler = GradScaler
