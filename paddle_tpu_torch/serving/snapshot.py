"""Durable ServingEngine snapshots through the checkpoint commit protocol.

`ServingEngine.snapshot()` (inference/paged.py) serializes the engine's
complete state — in-flight requests with emitted tokens, the generator
state, slot/page tables, PagePool refcounts, prefix-cache index, and (in
``full_kv`` mode) the referenced KV pages as numpy planes (bf16 pages as
their int16 bits, fp8 codes as their uint8 bits).  This module makes that
state DURABLE with exactly the discipline train checkpoints already have
(distributed/checkpoint/save_state_dict.py): staged ``<path>.tmp`` +
chunked fsync'd writes + per-file SHA-256 ``manifest.json`` + atomic
rename commit point.  A crash at any instant leaves the previous intact
snapshot; a torn or bit-rotted snapshot fails manifest verification and
``find_latest_complete()`` falls back to the previous intact one — the
same guarantee, now covering the serving plane.

Fault drills (resilience/faults.py catalog):

  * ``serve.snapshot`` — consulted once per :meth:`save_engine`.
    ``action="raise"`` kills the snapshot attempt before anything stages
    (the process died right as it decided to snapshot; the previous
    snapshot stays latest).  ``action="trigger"`` TEARS the freshly
    committed snapshot after the fact — one flipped byte in the data
    payload — modeling bit-rot or a storage layer that lied about
    durability: manifest verification must reject it.
  * ``ckpt.write`` / ``ckpt.commit`` — the staged writer's own fault
    points fire on this path too (engine snapshots go through the same
    writer), so mid-write and mid-commit crash windows are drilled by the
    existing checkpoint chaos machinery.
  * ``ckpt.dirsync`` — consulted just before the writer fsyncs the
    PARENT directory entry ahead of the atomic rename: fsyncing the staging dir alone persists its contents but
    not its *name*, so a host crash in this window could lose a
    fully-written snapshot.  ``action="raise"`` kills the commit there;
    ``find_latest_complete()`` must fall back to the previous intact
    snapshot.

The directory layout is the JAX package's, so a snapshot of an f32 or int8
pool written by either package verifies and restores in the other (the
``rng`` plane is each package's own generator state).
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..distributed.checkpoint import load_state_dict, verify_checkpoint
from ..distributed.checkpoint.save_state_dict import save_state_dict
from ..resilience.checkpoint import CheckpointManager
from ..resilience.faults import fault_point

__all__ = ["EngineSnapshotManager", "load_engine_snapshot"]


def load_engine_snapshot(path) -> dict:
    """Read a committed engine-snapshot directory back into the flat state
    dict :meth:`ServingEngine.restore` consumes: arrays as numpy arrays,
    py-values (the ``meta`` JSON string) as-is.  The caller is responsible
    for verification (``verify_checkpoint`` /
    ``find_latest_complete``) — ``load_state_dict`` still rejects torn
    shards it actually reads."""
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    template: dict = {}
    state: dict = {}
    for name, entry in meta["tensors"].items():
        if entry.get("py"):
            state[name] = entry.get("value")
            continue
        template[name] = np.zeros(tuple(entry["shape"]),
                                  dtype=np.dtype(entry["dtype"]))
    load_state_dict(template, path)
    state.update(template)
    return state


def _tear(path):
    """serve.snapshot ``action="trigger"``: flip one byte mid-file in the
    committed snapshot's data payload.  The manifest now lies about the
    content, so verification MUST reject the whole snapshot and discovery
    must fall back to the previous intact one."""
    fn = os.path.join(path, "rank0.data")
    size = os.path.getsize(fn)
    with open(fn, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1) or b"\x00"
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


class EngineSnapshotManager(CheckpointManager):
    """Engine-snapshot discipline on the :class:`CheckpointManager`
    chassis: step-numbered snapshot dirs under one root, keep-last-N
    rotation (older snapshots deleted only after the new one is durable),
    and the inherited :meth:`find_latest_complete` that skips torn
    snapshots, so restore always lands on the newest INTACT engine state.

    The payload is a :meth:`ServingEngine.snapshot` state dict instead of
    train state; use :meth:`save_engine` / :meth:`restore_engine` (the
    inherited train-shaped ``save``/``restore`` are not used here)."""

    def __init__(self, root, keep_last: int | None = 2, telemetry=None):
        super().__init__(root, keep_last=keep_last, telemetry=telemetry)

    def save_engine(self, engine, step: int | None = None,
                    mode: str = "full_kv") -> str:
        """Write one crash-consistent engine snapshot and rotate.  ``step``
        defaults to one past the newest existing snapshot (a private
        monotonic sequence — engine snapshots are ordered by recency, not
        by train step)."""
        if step is None:
            dirs = self._step_dirs()
            step = dirs[-1][0] + 1 if dirs else 0
        # serve.snapshot: "raise" dies HERE (nothing staged, previous
        # snapshot stays latest); a "trigger" spec tears the committed
        # snapshot below, after the writer swears it is durable.  The
        # engine name rides the ctx so a fleet drill targets one replica
        # (match={"engine": "r0"}).
        spec = fault_point("serve.snapshot", step=int(step), mode=mode,
                           engine=getattr(engine, "name", "engine"))
        state = engine.snapshot(mode=mode)
        path = os.path.join(self.root, f"step_{int(step):08d}")
        save_state_dict(state, path)
        self._rotate()
        if spec is not None:
            _tear(path)
        return path

    def restore_engine(self, engine, path=None):
        """Restore ``path`` (default: newest intact snapshot) into a
        freshly constructed engine.  Returns ``(path, applied_mode)``
        where ``applied_mode`` is ``"full_kv"`` (KV pages scattered back,
        decode continues) or ``"reprefill"`` (compact snapshot or
        geometry mismatch — requests requeued for re-prefill), or ``None``
        when no intact snapshot exists."""
        if path is None:
            path = self.find_latest_complete()  # already fully verified
            if path is None:
                return None
        else:
            verify_checkpoint(path)
        applied = engine.restore(load_engine_snapshot(path))
        return path, applied
