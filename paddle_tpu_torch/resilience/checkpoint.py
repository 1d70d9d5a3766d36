"""CheckpointManager: crash-consistent save / rotate / discover.

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
  * ``restore()`` — the saved step and the ``extra_state`` that rode along.

The training loop's pieces (model, optimizer, LR schedule, scaler and the
rng state) ride with the train-loop exterior; :class:`EngineSnapshotManager`
(``serving/snapshot.py``) puts serving-engine snapshots on this chassis.
"""
from __future__ import annotations

import json
import os
import re
import shutil

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


def _read_py_values(path) -> dict:
    """Flat {dotted-name: value} for the non-tensor leaves a save recorded in
    metadata.json (step counters, extra state)."""
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    return {name: e.get("value") for name, e in meta["tensors"].items()
            if e.get("py")}


class CheckpointManager:
    """Drives periodic crash-consistent checkpoints under one root.

    ``extra_state`` passed to :meth:`save` (nested dicts of tensors, numpy
    arrays or plain values) rides along; :meth:`restore` returns the saved
    step and leaves the extra state's plain values in ``last_extra``.
    ``telemetry``: any object with a ``torn_snapshot(path, error)`` hook,
    told of each snapshot that discovery rejects."""

    def __init__(self, root, save_interval: int = 1,
                 keep_last: int | None = 3, telemetry=None):
        if save_interval < 1:
            raise ValueError("save_interval must be >= 1")
        if keep_last is not None and keep_last < 1:
            raise ValueError("keep_last must be >= 1 (or None to keep all)")
        self.root = os.fspath(root)
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
        failure."""
        from ..distributed.checkpoint import wait_async_save
        wait_async_save()

    def save(self, step: int, extra_state=None, async_save=False):
        """Write one crash-consistent snapshot for ``step`` and rotate.
        Entry first drains any pending async save, so a failed background
        write surfaces HERE instead of rotting in a thread."""
        from ..distributed.checkpoint import save_state_dict
        self.wait()
        state = {"step": int(step)}
        if extra_state is not None:
            state["extra"] = extra_state
        path = os.path.join(self.root, f"step_{step:08d}")
        save_state_dict(state, path, async_save=async_save)
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
        """Read ``path`` (default: :meth:`find_latest_complete`): returns the
        saved step, or None when no intact snapshot exists (fresh start);
        the extra state's plain values land in ``last_extra``."""
        from ..distributed.checkpoint import verify_checkpoint
        self.wait()  # never restore around an in-flight async save
        if path is None:
            path = self.find_latest_complete()  # already fully verified
            if path is None:
                return None
        else:
            verify_checkpoint(path)
        py = _nest(_read_py_values(path))
        self.last_extra = py.get("extra")
        step = py.get("step")
        return int(step) if step is not None else self.step_of(path)
