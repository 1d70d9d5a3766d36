"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``; reference
python/paddle/nn/clip.py).

A clipper maps a list of ``(param, grad)`` pairs to a new list with the
clipped gradients (new tensors; the inputs are left as they are) and is
given to an optimizer as ``grad_clip=``.  Only the eager
``Optimizer.step()`` applies it, as in the JAX package: the functional
``apply_gradients_functional`` (``TrainStep``'s path) does not.  Norms are
summed in f32 and the scaled gradient is cast back to its own dtype, as
JAX's ``g * scale`` promotes a bf16 gradient to f32 before the cast.  A
parameter with ``need_clip = False`` is left out of the global norm and
of the scaling."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _need_clip(p):
    return getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    """Every gradient element clipped into [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by min(clip_norm / max(||g||, 1e-12), 1)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, (g.float() * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by clip_norm / max(global_norm, clip_norm),
    the global norm over every gradient whose parameter needs clipping.
    ``last_scale`` keeps the last call's scale (a 0-d f32 tensor on the
    gradients' device) for callers that check the clip acted."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.last_scale = None

    def scale_for(self, global_norm):
        """The factor every clipped gradient is multiplied by."""
        return self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)

    def _global_norm_sq(self, params_grads):
        total = None
        for p, g in params_grads:
            if g is None or not _need_clip(p):
                continue
            sq = torch.sum(torch.square(g.float()))
            total = sq if total is None else total + sq
        return total

    def _clip(self, params_grads):
        total = self._global_norm_sq(params_grads)
        if total is None:
            return list(params_grads)
        scale = self.scale_for(torch.sqrt(total))
        self.last_scale = scale
        out = []
        for p, g in params_grads:
            if g is None or not _need_clip(p):
                out.append((p, g))
                continue
            out.append((p, (g.float() * scale).to(g.dtype)))
        return out
