"""Activation recomputation (port of ``paddle_tpu/distributed/fleet/
recompute.py``; reference fleet/recompute/recompute.py — recompute() :463,
recompute_sequential :630, the non-reentrant path :327, the RNG tracker
replay :116).

``recompute(function, *args)`` runs ``function`` keeping none of its
intermediates and runs it again in the backward
(``torch.utils.checkpoint``, non-reentrant).  The recompute draws the
forward's random numbers: ``checkpoint`` replays the default CPU generator
and the CUDA generators of the inputs' devices, and the ``torch.Generator``s
held by the modules of ``function`` (the function itself, the module it is
a bound method of, the modules of its closure) are replayed too — JAX's
RNG-state replay, done as ``ShardedTrainStep(remat=)`` does it.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["recompute", "recompute_sequential"]


def _modules_of(function):
    """The ``nn.Module``s ``function`` runs: itself, the module it is bound
    to, and the modules its closure holds (alone or in a list)."""
    out = []
    if isinstance(function, nn.Module):
        out.append(function)
    owner = getattr(function, "__self__", None)
    if isinstance(owner, nn.Module):
        out.append(owner)
    for cell in getattr(function, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:          # an empty cell
            continue
        items = v if isinstance(v, (list, tuple)) else (v,)
        out.extend(m for m in items if isinstance(m, nn.Module))
    return out


def _generators_of(function):
    """The ``torch.Generator``s the modules of ``function`` hold, once
    each."""
    from ...parallel.sharded import _module_generators
    seen = {}
    for m in _modules_of(function):
        for g in _module_generators(m):
            seen.setdefault(id(g), g)
    return list(seen.values())


def recompute(function, *args, **kwargs):
    """reference recompute.py:463: ``function(*args, **kwargs)`` with its
    activations recomputed in the backward.  ``preserve_rng_state`` (default
    True) replays the generators; ``use_reentrant`` is accepted and the
    non-reentrant path always runs (the reentrant one drops the gradients
    of inputs that do not require them, which Paddle's does not)."""
    from torch.utils.checkpoint import checkpoint

    from ...parallel.sharded import _replay
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    extra = {}
    gens = _generators_of(function) if preserve else []
    if gens:
        extra["context_fn"] = _replay(gens)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **extra, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """reference recompute.py:630: the layers of ``functions`` (a
    ``Sequential`` or a list) cut into ``ctx["segments"]`` runs of equal
    length, each recomputed on its own."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    fns = list(functions.children()) if isinstance(functions, nn.Module) \
        else list(functions)
    n = len(fns)
    per = max(n // segments, 1)

    def seg_forward(part):
        def run(*inp):
            out = inp[0] if len(inp) == 1 else inp
            for f in part:
                out = f(out) if not isinstance(out, tuple) else f(*out)
            return out
        return run

    out = args
    i = 0
    while i < n:
        hi = min(i + per, n)
        out = recompute(seg_forward(fns[i:hi]),
                        *(out if isinstance(out, tuple) else (out,)),
                        **kwargs)
        i = hi
    return out
