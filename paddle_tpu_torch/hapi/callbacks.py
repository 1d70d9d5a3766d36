"""hapi callbacks (port of ``paddle_tpu/hapi/callbacks.py``; reference
python/paddle/hapi/callbacks.py): ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler`` (the callback that advances the
optimizer's scheduler in ``fit``) and ``ElasticRestart`` (over
``distributed.fleet.elastic.ElasticManager``)."""
from __future__ import annotations

import time

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "ElasticRestart",
           "EarlyStopping", "LRScheduler"]


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        pass

    def on_batch_end(self, mode, step, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, item):
        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, item)(*args, **kwargs)
        return call


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_begin(self, mode, logs=None):
        self._t0 = time.time()
        self._params = logs or {}

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._steps = 0

    def on_batch_end(self, mode, step, logs=None):
        self._steps += 1
        if self.verbose >= 2 and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"Epoch {getattr(self, 'epoch', 0)} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose >= 1:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"Epoch {epoch} done: {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_epoch_end(self, epoch, logs=None):
        v = (logs or {}).get(self.monitor)
        if v is None:
            return
        improved = self.best is None or \
            (v < self.best - self.min_delta if self.mode == "min"
             else v > self.best + self.min_delta)
        if improved:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_batch_end(self, mode, step, logs=None):
        if mode == "train" and self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class ElasticRestart(Callback):
    """The elastic gang-resume glue (ROADMAP smaller item): watch a
    ``distributed.fleet.elastic.ElasticManager`` during ``fit`` and stop
    training at the next batch boundary when gang membership CHANGEs (a
    node joined or left) or drops below ``np_min`` (EXIT).

    The relauncher — ``launch_gang``'s restart hook, or any loop around
    ``fit`` — then re-invokes ``fit(..., ckpt=manager)`` with the SAME
    :class:`~paddle_tpu_torch.resilience.CheckpointManager`: every surviving
    rank auto-resumes from the same ``find_latest_complete()`` snapshot
    (torn snapshots from the preemption are skipped), so the regrouped
    gang continues the loss trajectory bit-exactly from the last durable
    step instead of restarting from zero.  ``status`` holds the
    membership verdict that stopped training (None while stable)."""

    def __init__(self, manager, check_every: int = 1):
        self.manager = manager
        self.check_every = max(1, int(check_every))
        self.status = None
        self._n = 0

    def on_batch_end(self, mode, step, logs=None):
        if mode != "train":
            return
        self._n += 1
        if self._n % self.check_every:
            return
        from ..distributed.fleet.elastic import ElasticStatus
        st = self.manager.watch()
        if st != ElasticStatus.HOLD:
            self.status = st
            self.model.stop_training = True
