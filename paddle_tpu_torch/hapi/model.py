"""hapi.Model (port of ``paddle_tpu/hapi/model.py``; reference
python/paddle/hapi/model.py — fit :1472, evaluate, predict, save/load).

The network is a ``torch.nn.Module`` on ``device`` (``None``: the CUDA
device, raising without one); every batch, which the ``DataLoader`` hands
out on the CPU, is moved there before the forward.  ``train_batch`` is the
eager step: forward, ``loss.backward()``, ``optimizer.step()`` and
``clear_grad()``; with ``fit(accumulate_grad_batches=k)`` the ``.grad``
of k batches add up before one update (the JAX package accepts the
argument and steps on every batch).  ``fit`` with ``ckpt=`` resumes from
the newest intact snapshot and replays the loader up to the restored step;
with ``telemetry=`` it splits each step into data wait and compute.
"""
from __future__ import annotations

import contextlib
import os
import warnings

import torch

from .. import framework, on_device, resolve_device
from ..io import DataLoader, Dataset
from ..observability.train import batch_samples
from .callbacks import CallbackList, ProgBarLogger

__all__ = ["Model"]


def _on(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    if isinstance(x, (list, tuple)):
        return type(x)(_on(v, dev) for v in x)
    return torch.as_tensor(x).to(dev)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None, device=None):
        self.device = resolve_device(device)
        for n, p in network.named_parameters():
            if not on_device(p, self.device):
                raise ValueError(f"Model on {self.device}: parameter {n} is "
                                 f"on {p.device}")
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._inputs = inputs if isinstance(inputs, (list, tuple)) else \
            ([inputs] if inputs is not None else None)
        self._scaler = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            raise NotImplementedError(
                "Model.prepare(amp_configs=...): amp.auto_cast / decorate "
                "are not ported (ROADMAP A item 7)")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics is not None else [])
        return self

    def _to_loader(self, data, batch_size, shuffle, num_workers=0):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers)
        return data

    def _metric_updates(self, outputs, labels):
        return [m.update(m.compute(outputs, *_as_list(labels)))
                for m in self._metrics]

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = _on(_as_list(inputs), self.device)
        labels = None if labels is None else _on(labels, self.device)
        outputs = self.network(*inputs)
        losses = []
        if self._loss is not None and labels is not None:
            loss = self._loss(outputs, *_as_list(labels))
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
            losses.append(float(loss.detach()))
        metrics = self._metric_updates(outputs, labels) \
            if labels is not None else []
        return (losses, metrics) if metrics else losses

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = _on(_as_list(inputs), self.device)
        labels = None if labels is None else _on(labels, self.device)
        outputs = self.network(*inputs)
        losses = []
        if self._loss is not None and labels is not None:
            losses.append(float(self._loss(outputs, *_as_list(labels))))
        metrics = self._metric_updates(outputs, labels) \
            if labels is not None else []
        return (losses, metrics) if metrics else losses

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        return self.network(*_on(_as_list(inputs), self.device))

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, telemetry=None,
            ckpt=None):
        """``telemetry``: an ``observability.TrainTelemetry`` (or None =
        off): each iteration's host wall time split into data wait (the
        ``next(loader)`` call) and compute (``train_batch``, whose
        ``float(loss)`` sync makes it device time) lands in
        ``train.step_s`` / ``train.data_s`` / ``train.compute_s``, and each
        ``save_dir`` checkpoint gets a ``ckpt.save`` span.

        ``ckpt``: a ``resilience.CheckpointManager`` (or None = off).  fit
        first resumes from the newest intact snapshot, restoring the model,
        optimizer, scheduler, scaler and rng plane in place, and consumes
        the loader's batches up to the restored iteration without
        training them; then saves every ``ckpt.save_interval`` iterations.
        A relaunched fit with the same arguments and a deterministic batch
        order (``shuffle=False``, or a loader with a ``generator``, whose
        state the snapshot holds) continues the loss trajectory bit for
        bit.  Manager slots left as None (model, optimizer, scaler,
        data_loader) are attached from this Model."""
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       num_workers)
        eval_loader = self._to_loader(eval_data, batch_size, False,
                                      num_workers)
        cbks = CallbackList(callbacks
                            or [ProgBarLogger(log_freq, verbose=verbose)])
        cbks.set_model(self)
        cbks.on_begin("train", {"epochs": epochs,
                                "steps": _safe_len(train_loader),
                                "metrics": self._metric_names()})
        # a previous fit stopped by a callback must not stop this one
        self.stop_training = False
        tel = telemetry
        accum = max(1, int(accumulate_grad_batches))
        start_it = 0
        if ckpt is not None:
            if isinstance(train_data, Dataset) and shuffle:
                warnings.warn(
                    "fit(ckpt=...) with shuffle=True: auto-resume needs a "
                    "DETERMINISTIC batch order to reproduce the "
                    "uninterrupted trajectory — pass shuffle=False or a "
                    "DataLoader with a generator", RuntimeWarning,
                    stacklevel=2)
            if ckpt.model is None:
                ckpt.model = self.network
            if ckpt.optimizer is None:
                ckpt.optimizer = self._optimizer
            if ckpt.scaler is None:
                ckpt.scaler = self._scaler
            if ckpt.data_loader is None and isinstance(train_loader,
                                                       DataLoader):
                ckpt.data_loader = train_loader
            start_it = ckpt.restore() or 0
        it = 0
        logs = {}
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            logs = {}
            data_iter = iter(train_loader)
            step = -1
            with contextlib.closing(data_iter) if hasattr(data_iter, "close") \
                    else contextlib.nullcontext():
                while True:
                    t_d0 = tel.clock() if tel is not None else 0.0
                    try:
                        batch = next(data_iter)
                    except StopIteration:
                        break
                    if it < start_it:
                        # resume fast-forward: trained before the restart
                        it += 1
                        if num_iters is not None and it >= num_iters:
                            break
                        continue
                    t_d1 = tel.clock() if tel is not None else 0.0
                    step += 1
                    cbks.on_batch_begin("train", step, logs)
                    x, y = self._split_batch(batch)
                    res = self.train_batch(x, y,
                                           update=(it + 1) % accum == 0)
                    if tel is not None:
                        t_c1 = tel.clock()
                        tel.step(t_c1 - t_d0, data_s=t_d1 - t_d0,
                                 compute_s=t_c1 - t_d1,
                                 samples=batch_samples(x))
                    logs = self._pack_logs(res)
                    cbks.on_batch_end("train", step, logs)
                    it += 1
                    if ckpt is not None:
                        ckpt.maybe_save(it)
                    if self.stop_training:
                        break
                    if num_iters is not None and it >= num_iters:
                        break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size, verbose=0)
            if save_dir is not None and (epoch + 1) % save_freq == 0:
                target = f"{save_dir}/epoch_{epoch}"
                if tel is not None:
                    with tel.span("ckpt.save", epoch=epoch):
                        self.save(target)
                    tel.saved(epoch, target)
                else:
                    self.save(target)
            if self.stop_training or (num_iters is not None
                                      and it >= num_iters):
                break
        cbks.on_end("train", logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._to_loader(eval_data, batch_size, False, num_workers)
        for m in self._metrics:
            m.reset()
        logs = {}
        for step, batch in enumerate(loader):
            x, y = self._split_batch(batch)
            logs = self._pack_logs(self.eval_batch(x, y))
            if num_iters is not None and step + 1 >= num_iters:
                break
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._to_loader(test_data, batch_size, False, num_workers)
        return [self.predict_batch(self._split_batch(b, labeled=False)[0])
                for b in loader]

    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with an
        optimizer, ``path.pdopt`` (its state dict), in the format both
        packages read (``framework.save``)."""
        if not training:
            raise NotImplementedError(
                "Model.save(training=False) exports a jit inference artifact "
                "in the JAX package; not ported (ROADMAP A item 7)")
        framework.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            framework.save(self._optimizer.state_dict(), path + ".pdopt")

    @torch.no_grad()
    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Copy ``path.pdparams`` into the network's tensors by name (each
        cast to its tensor's dtype) and, unless ``reset_optimizer``,
        ``path.pdopt`` into the optimizer."""
        sd = framework.load(path + ".pdparams")
        for name, t in self.network.state_dict().items():
            v = sd.get(name)
            if v is None:
                continue
            if tuple(v.shape) != tuple(t.shape):
                if skip_mismatch:
                    continue
                raise ValueError(f"{name}: saved shape {tuple(v.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(v.to(t.dtype))
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(framework.load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        raise NotImplementedError(
            "Model.summary (hapi.summary) is not ported (ROADMAP A item 7)")

    def _split_batch(self, batch, labeled=True):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return batch[0], batch[1] if labeled else None
        return batch, None

    def _metric_names(self):
        return ["loss"] + [m.name() for m in self._metrics]

    def _pack_logs(self, res):
        logs = {}
        if isinstance(res, tuple):
            losses, metrics = res
            if losses:
                logs["loss"] = losses[0]
            for m, v in zip(self._metrics, metrics):
                logs[m.name()] = v
        elif isinstance(res, list) and res:
            logs["loss"] = res[0]
        return logs


def _safe_len(loader):
    try:
        return len(loader)
    except Exception:  # noqa: BLE001 — an iterable without len
        return None
