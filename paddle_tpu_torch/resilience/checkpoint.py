"""CheckpointManager: crash-consistent save / rotate / resume for train
loops (port of ``paddle_tpu/resilience/checkpoint.py``).

Sits on top of the staged, manifest-verified ``distributed.checkpoint``
writer and adds the job-level discipline a preemptible job needs:

  * ``maybe_save(step)`` — save every ``save_interval`` steps into
    ``root/step_XXXXXXXX`` (each an atomic rename-committed snapshot);
  * keep-last-N rotation (older snapshots deleted only after the new one is
    durable, so a crash mid-save always leaves an intact predecessor);
  * ``find_latest_complete()`` — newest snapshot that passes manifest
    verification; torn/corrupt snapshots from mid-write preemptions are
    skipped, never loaded, and a snapshot stranded at ``step_N.old`` by a
    crash in the commit's swap window is healed back first;
  * ``restore()`` — exact resume of the model's parameters and buffers, the
    optimizer's accumulators (keyed by position, ``p{i}.{k}``, so a rebuilt
    process maps them whatever its parameters are called), its
    ``global_step`` and scheduler, a separate ``lr_scheduler``, the
    ``GradScaler``, the rng plane and the step counter.  Tensors are
    written back IN PLACE, so a ``TrainStep`` built before the restore
    steps on from the restored state.

The rng plane is the state of every ``torch.Generator`` the run draws from:
the default CPU generator, the default CUDA generator of each initialised
card, every generator a module of the model holds as an attribute (ERNIE's
``dropout_generator`` on the card and ``attention_seed_generator`` on the
host), and the ``data_loader``'s sampler generator as it stood when the
epoch in progress drew its order (``fit`` replays that epoch's batches up
to the restored step).  Only the generators a snapshot holds are set, so
a snapshot the JAX package wrote (its rng is a JAX key) restores the rest.
:class:`EngineSnapshotManager` (``serving/snapshot.py``) puts serving-engine
snapshots on this chassis.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import torch

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _nest(flat: dict) -> dict:
    """Rebuild a nested dict from dotted flat keys (py-value metadata)."""
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        if isinstance(d, dict):
            d[parts[-1]] = v
    return out


def _read_meta(path) -> dict:
    with open(os.path.join(path, "metadata.json")) as f:
        return json.load(f)["tensors"]


def _read_py_values(path) -> dict:
    """Flat {dotted-name: value} for the non-tensor leaves a save recorded in
    metadata.json (step counters, LR-schedule scalars, scaler state)."""
    return {name: e.get("value") for name, e in _read_meta(path).items()
            if e.get("py")}


def model_generators(model) -> list:
    """Every ``torch.Generator`` a module of ``model`` holds as an
    attribute, once each, in module order."""
    seen, out = set(), []
    for m in model.modules():
        for v in vars(m).values():
            if isinstance(v, torch.Generator) and id(v) not in seen:
                seen.add(id(v))
                out.append(v)
    return out


class CheckpointManager:
    """Drives periodic crash-consistent checkpoints for one training job.

    Any of ``model`` / ``optimizer`` / ``lr_scheduler`` / ``scaler`` /
    ``data_loader`` may be None; only the supplied pieces are saved and
    restored.  ``extra_state`` passed to :meth:`save` (nested dicts of
    tensors, numpy arrays or plain values) rides along, and its plain
    values come back from :meth:`restore` in ``last_extra``.
    ``telemetry``: a ``TrainTelemetry`` (save / stage / commit / restore
    spans, saves, restores, torn snapshots), or any object with a
    ``torn_snapshot(path, error)`` hook, told of each snapshot that
    discovery rejects."""

    def __init__(self, root, model=None, optimizer=None, lr_scheduler=None,
                 scaler=None, save_interval: int = 1,
                 keep_last: int | None = 3, telemetry=None, data_loader=None):
        if save_interval < 1:
            raise ValueError("save_interval must be >= 1")
        if keep_last is not None and keep_last < 1:
            raise ValueError("keep_last must be >= 1 (or None to keep all)")
        self.root = os.fspath(root)
        self.model = model
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.scaler = scaler
        self.data_loader = data_loader
        self.save_interval = int(save_interval)
        self.keep_last = keep_last
        self.last_extra = None
        self.telemetry = telemetry
        os.makedirs(self.root, exist_ok=True)

    # -- discovery ---------------------------------------------------------
    def _step_dirs(self):
        """[(step, absolute path)] ascending; final (committed) dirs only.
        A snapshot stranded at ``step_N.old`` by a crash in the commit's
        swap window is healed back to ``step_N`` first, so discovery never
        silently skips the newest intact checkpoint."""
        from ..distributed.checkpoint.save_state_dict import (
            recover_interrupted_commit)
        for d in os.listdir(self.root):
            if d.endswith(".old") and _STEP_RE.match(d[:-4]):
                recover_interrupted_commit(os.path.join(self.root, d[:-4]))
        out = []
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d)
            full = os.path.join(self.root, d)
            if m and os.path.isdir(full):
                out.append((int(m.group(1)), full))
        return sorted(out)

    def find_latest_complete(self):
        """Newest snapshot passing manifest verification, or None.  Torn or
        corrupt snapshots (killed mid-write, bit-flipped files) are skipped —
        resume always lands on the previous intact checkpoint.  Each
        rejection goes to the telemetry's ``torn_snapshot`` hook, so a
        resume that skipped a snapshot leaves a trail saying which one and
        why."""
        from ..distributed.checkpoint import (CheckpointCorruptError,
                                              verify_checkpoint)
        for _, path in reversed(self._step_dirs()):
            try:
                verify_checkpoint(path)
                return path
            except CheckpointCorruptError as e:
                if self.telemetry is not None:
                    self.telemetry.torn_snapshot(path, e)
                continue
        return None

    @staticmethod
    def step_of(path) -> int | None:
        m = _STEP_RE.match(os.path.basename(os.fspath(path).rstrip("/")))
        return int(m.group(1)) if m else None

    # -- save --------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step % self.save_interval == 0

    def maybe_save(self, step: int, extra_state=None, async_save=False):
        if self.should_save(step):
            return self.save(step, extra_state=extra_state,
                             async_save=async_save)
        return None

    def wait(self):
        """Drain pending async saves, re-raising the first writer/commit
        failure (recorded to the telemetry first)."""
        from ..distributed.checkpoint import wait_async_save
        try:
            wait_async_save()
        except BaseException as e:
            if hasattr(self.telemetry, "async_save_failed"):
                self.telemetry.async_save_failed(e)
            raise

    def save(self, step: int, extra_state=None, async_save=False):
        """Write one crash-consistent snapshot for ``step`` and rotate.
        Entry first drains any pending async save, so a failed background
        write surfaces HERE instead of rotting in a thread.  With a
        ``TrainTelemetry`` the save is a ``ckpt.save`` span and the writer
        reports its ``ckpt.stage`` / ``ckpt.commit`` durations."""
        tel = self.telemetry
        if not hasattr(tel, "span"):
            return self._save_impl(step, extra_state, async_save, None)
        with tel.span("ckpt.save", step=int(step), async_save=async_save):
            path = self._save_impl(step, extra_state, async_save,
                                   tel.phase_event)
        tel.saved(int(step), path)
        return path

    def _opt_tensor_state(self):
        """The optimizer's accumulators keyed by position (``p{i}.{k}``),
        made (zero) for a parameter that has none yet."""
        opt = self.optimizer
        return {f"p{i}.{k}": v for i, p in enumerate(opt._parameter_list)
                for k, v in opt._get_state(p).items()}

    def _generators(self) -> dict:
        """{name: (get_state, set_state)} of the rng plane."""
        out = {"cpu": (torch.get_rng_state, torch.set_rng_state)}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                out[f"cuda{i}"] = (
                    lambda i=i: torch.cuda.get_rng_state(i),
                    lambda t, i=i: torch.cuda.set_rng_state(t, i))
        if self.model is not None:
            for j, g in enumerate(model_generators(self.model)):
                out[f"model{j}"] = (g.get_state, g.set_state)
        dl = self.data_loader
        if dl is not None and getattr(dl, "generator_state", None) \
                and dl.generator_state() is not None:
            out["loader"] = (dl.generator_state, dl.set_generator_state)
        return out

    def _save_impl(self, step, extra_state, async_save, on_phase):
        from ..distributed.checkpoint import save_state_dict
        from ..optimizer.lr import LRScheduler
        self.wait()
        state = {"step": int(step),
                 "rng_torch": {k: get() for k, (get, _) in
                               self._generators().items()}}
        if self.model is not None:
            state["model"] = dict(self.model.state_dict())
        if self.optimizer is not None:
            state["opt"] = self._opt_tensor_state()
            opt_meta = {"global_step": self.optimizer._global_step}
            if isinstance(self.optimizer._learning_rate, LRScheduler):
                opt_meta["lr_sched"] = \
                    self.optimizer._learning_rate.state_dict()
            state["opt_meta"] = opt_meta
        if self.lr_scheduler is not None:
            state["lr_sched"] = self.lr_scheduler.state_dict()
        if self.scaler is not None:
            state["scaler"] = self.scaler.state_dict()
        if extra_state is not None:
            state["extra"] = extra_state
        path = os.path.join(self.root, f"step_{step:08d}")
        save_state_dict(state, path, async_save=async_save,
                        on_phase=on_phase)
        self._rotate()
        return path

    def _rotate(self):
        if self.keep_last is None:
            return
        dirs = self._step_dirs()
        for step, path in dirs[:-self.keep_last]:
            shutil.rmtree(path, ignore_errors=True)
            shutil.rmtree(path + ".tmp", ignore_errors=True)
            # .old debris too, or _step_dirs' healing would resurrect the
            # rotated-away snapshot from it
            shutil.rmtree(path + ".old", ignore_errors=True)
        # sweep torn staging debris from crashed saves: any step_N.tmp with
        # N strictly below the newest COMMITTED step cannot be in flight
        # (saves are monotonic and pipelined via wait()), so it is an orphan
        if dirs:
            newest = dirs[-1][0]
            for d in os.listdir(self.root):
                if d.endswith(".tmp"):
                    m = _STEP_RE.match(d[:-4])
                    if m and int(m.group(1)) < newest:
                        shutil.rmtree(os.path.join(self.root, d),
                                      ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def restore(self, path=None) -> int | None:
        """Load ``path`` (default: :meth:`find_latest_complete`) back into the
        attached objects; returns the restored step, or None when no intact
        snapshot exists (fresh start)."""
        tel = self.telemetry
        if not hasattr(tel, "span"):
            return self._restore_impl(path)
        with tel.span("ckpt.restore"):
            step = self._restore_impl(path)
        if step is not None:
            tel.restored(step, str(path) if path is not None else "")
        return step

    def _restore_impl(self, path=None) -> int | None:
        from ..distributed.checkpoint import load_state_dict, verify_checkpoint
        from ..optimizer.lr import LRScheduler
        self.wait()  # never restore around an in-flight async save
        if path is None:
            path = self.find_latest_complete()  # already fully verified
            if path is None:
                return None
        else:
            verify_checkpoint(path)
        held = _read_meta(path)
        gens = {k: v for k, v in self._generators().items()
                if f"rng_torch.{k}" in held}
        template: dict = {"rng_torch": {k: torch.zeros_like(get())
                                        for k, (get, _) in gens.items()}}
        if self.model is not None:
            # the live tensors: the load writes parameters and buffers in
            # place
            template["model"] = dict(self.model.state_dict())
        if self.optimizer is not None:
            template["opt"] = self._opt_tensor_state()
        load_state_dict(template, path)
        py = _nest(_read_py_values(path))
        if self.optimizer is not None:
            meta = py.get("opt_meta", {})
            if "global_step" in meta:
                self.optimizer._global_step = int(meta["global_step"])
            if isinstance(self.optimizer._learning_rate, LRScheduler) \
                    and isinstance(meta.get("lr_sched"), dict):
                self.optimizer._learning_rate.set_state_dict(meta["lr_sched"])
        if self.lr_scheduler is not None and isinstance(py.get("lr_sched"),
                                                        dict):
            self.lr_scheduler.set_state_dict(py["lr_sched"])
        if self.scaler is not None and isinstance(py.get("scaler"), dict):
            self.scaler.load_state_dict(py["scaler"])
        for k, (_, set_) in gens.items():
            set_(template["rng_torch"][k])
        self.last_extra = py.get("extra")
        step = py.get("step")
        return int(step) if step is not None else self.step_of(path)
