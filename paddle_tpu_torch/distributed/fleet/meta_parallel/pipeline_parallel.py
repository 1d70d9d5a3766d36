"""The pipeline-parallel runtime (port of ``paddle_tpu/distributed/fleet/
meta_parallel/pipeline_parallel.py``; reference fleet/meta_parallel/
pipeline_parallel.py — PipelineParallel :242, train_batch :940).

``train_batch`` on a ``PipelineLayer`` with a ``loss_fn``, when the default
mesh has a ``pp`` axis of more than one rank, hands the batch to
``parallel.GenericPipeline1F1BTrainStep`` (this rank runs its stage; the
activations and cotangents hop between ranks).  Otherwise it runs JAX's
micro-batch gradient accumulation over the whole model with the eager
optimizer.  JAX falls back on any exception from building its compiled
step; here only a stage-activation contract the 1F1B step cannot carry
(``ActivationContractError``) falls back, with a warning, so a fault of
the card or of a kernel is never swallowed.
"""
from __future__ import annotations

import warnings

import torch
from torch import nn

__all__ = ["PipelineParallel"]


class PipelineParallel(nn.Module):
    def __init__(self, layers, hcg, strategy):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        hc = getattr(strategy, "hybrid_configs", None) or {}
        pp_cfg = hc.get("pp_configs") or {}
        self._accumulate_steps = int(pp_cfg.get("accumulate_steps", 1) or 1)
        self._step = None
        self._fallback = False

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _pipeline_step(self, data, optimizer):
        """The 1F1B step over the default mesh's pp axis, built on the
        first call; ``None`` where the model or the mesh has no pipeline."""
        from ...topology import get_default_mesh
        from ....parallel.pipeline import _axis_size
        from ....parallel.pipeline_schedules import (
            ActivationContractError, GenericPipeline1F1BTrainStep)
        from .pp_layers import PipelineLayer
        if self._fallback or not isinstance(self._layers, PipelineLayer) \
                or self._layers.loss_fn is None:
            return None
        mesh = get_default_mesh()
        pp = _axis_size(mesh, "pp") if mesh is not None else 1
        if pp <= 1:
            return None
        if self._step is None:
            x, _ = data
            device = next(self._layers.parameters()).device
            try:
                self._step = GenericPipeline1F1BTrainStep(
                    mesh, self._layers, optimizer,
                    n_micro=max(self._accumulate_steps, pp),
                    example_input=x, device=device)
            except ActivationContractError as e:
                warnings.warn(
                    f"PipelineParallel: the 1F1B pipeline cannot carry this "
                    f"model ({e}); falling back to micro-batch gradient "
                    "accumulation WITHOUT stage partitioning — every rank "
                    "runs the full model. Use paddle_tpu_torch.parallel."
                    "Pipeline1F1BTrainStep for the scalable path.")
                self._fallback = True
                return None
        return self._step

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None,
                    loss_fn_idx=0):
        """reference pipeline_parallel.py:940: one step on ``data = (x,
        y)`` (the global batch); returns the loss."""
        if scaler is None:
            step = self._pipeline_step(data, optimizer)
            if step is not None:
                loss = step(data)
                step.sync_to_model()
                if lr_scheduler is not None:
                    lr_scheduler.step()
                return loss
        x, y = data
        bs = x.shape[0]
        mbs = max(bs // self._accumulate_steps, 1)
        n_micro = bs // mbs
        total = None
        loss_fn = getattr(self._layers, "loss_fn", None)
        for i in range(n_micro):
            xm, ym = x[i * mbs:(i + 1) * mbs], y[i * mbs:(i + 1) * mbs]
            out = self._layers(xm)
            loss = loss_fn(out, ym) if loss_fn is not None else out
            scaled = loss * (1.0 / n_micro)
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            total = scaled.detach() if total is None \
                else total + scaled.detach()
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        x, y = data
        out = self._layers(x)
        if compute_loss and getattr(self._layers, "loss_fn", None) \
                is not None:
            return self._layers.loss_fn(out, y)
        return out
