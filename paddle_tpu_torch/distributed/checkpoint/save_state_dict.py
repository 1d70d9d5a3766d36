"""Distributed-checkpoint save: per-rank shard files + a metadata file
recording global shapes, the layout the reference package writes.

This port runs one process: rank 0 of a world of 1, so every tensor is one
shard holding its whole extent and ``_barrier`` is a no-op.  Shard payloads
are keyed by (name, global extent), the rank writes a sidecar
``rank0.meta.json`` describing its extents, and the coordinator merges the
sidecars into the single ``metadata.json`` — the same on-disk layout the
JAX package writes, so each package's ``verify_checkpoint`` accepts the
other's directory.  Tensors land as numpy arrays in ``rank0.data`` (a
pickle); a bfloat16 tensor (numpy has no such type) is stored as its f32
values under the dtype name ``bfloat16``.

Crash consistency: every file is staged into ``<path>.tmp`` with chunked
writes + fsync, the coordinator records a per-file SHA-256
``manifest.json``, and the single commit point is the atomic rename of the
staging dir onto ``<path>``.  A crash at ANY instant — mid-file, between
files, before the manifest, before the rename — leaves either the previous
intact checkpoint or no final dir at all, never a load-able-but-wrong
snapshot.  The writer consults the ``ckpt.write`` / ``ckpt.dirsync`` /
``ckpt.commit`` fault points (resilience/faults.py) so all of those crash
windows are exercised in CPU tests.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import threading

import numpy as np
import torch

from ...resilience.faults import fault_point

__all__ = ["save_state_dict", "wait_async_save", "recover_interrupted_commit",
           "WRITE_CHUNK"]

# bytes written between ckpt.write fault-point consults (tests shrink this to
# tear tiny files mid-write)
WRITE_CHUNK = 1 << 20

_async_threads: list[threading.Thread] = []
_async_errors: list[BaseException] = []

# per-file SHA-256 recorded WHILE the bytes are written (_write_durable), so
# the manifest never needs a second synchronous read pass over the staged
# payload: {staging_dir: {basename: (hexdigest, size)}}.  Only fully written
# files are recorded — a write torn by an injected ckpt.write fault leaves no
# digest, and the manifest read-fallback (other ranks' files on a shared
# filesystem, which this process never wrote) keeps multi-host saves correct.
_staged_digests: dict[str, dict[str, tuple[str, int]]] = {}
_digest_lock = threading.Lock()


def _flat(state_dict, prefix=""):
    out = {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _barrier():
    """Cross-rank barrier; the port saves from one process (world 1)."""


def _host_array(v) -> np.ndarray:
    """A tensor or array as a host numpy array (bfloat16 as f32 values)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_durable(fn, data: bytes):
    """Chunked write + fsync, consulting the ckpt.write fault point before
    every chunk — an injected 'raise' tears the file at that byte offset,
    exactly like a preemption mid-write.  The SHA-256 is folded in while
    the chunks stream out and recorded ONLY once the file is complete, so
    the commit-time manifest costs no second read pass over the payload."""
    base = os.path.basename(fn)
    h = hashlib.sha256()
    with open(fn, "wb") as f:
        for off in range(0, len(data), WRITE_CHUNK) or (0,):
            fault_point("ckpt.write", file=base, offset=off)
            chunk = data[off:off + WRITE_CHUNK]
            f.write(chunk)
            h.update(chunk)
        f.flush()
        os.fsync(f.fileno())
    with _digest_lock:
        _staged_digests.setdefault(
            os.path.dirname(os.path.abspath(fn)), {})[base] = (
                h.hexdigest(), len(data))


def _sha256(fn):
    h = hashlib.sha256()
    with open(fn, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _write_manifest(staging):
    """Per-file SHA-256 manifest over everything staged so far; written last,
    so its presence certifies every other file landed completely.

    Digests come from the hash-while-writing record `_write_durable` kept
    (no second read pass over the payload — the old synchronous re-read
    doubled save-path IO); only files this process did NOT write (other
    ranks' shards on a shared filesystem) fall back to reading."""
    key = os.path.abspath(staging)
    with _digest_lock:
        recorded = dict(_staged_digests.get(key, {}))
    files = sorted(fn for fn in os.listdir(staging) if fn != "manifest.json")
    entries = {}
    for fn in files:
        full = os.path.join(staging, fn)
        size = os.path.getsize(full)
        rec = recorded.get(fn)
        if rec is not None and rec[1] == size:
            digest = rec[0]
        else:                          # not written by this process
            digest = _sha256(full)
        entries[fn] = {"sha256": digest, "size": size}
    man = {"version": 1, "files": entries}
    _write_durable(os.path.join(staging, "manifest.json"),
                   json.dumps(man).encode())
    with _digest_lock:
        _staged_digests.pop(key, None)


def wait_async_save():
    """Block until all pending async checkpoint writes are on disk; re-raises
    the first exception raised inside a writer thread (a silently dropped
    failed write would masquerade as a durable checkpoint)."""
    global _async_threads
    for t in _async_threads:
        t.join()
    _async_threads = []
    if _async_errors:
        first = _async_errors[0]
        _async_errors.clear()
        raise first


def recover_interrupted_commit(path):
    """A crash between the commit's two renames leaves the previous intact
    checkpoint stranded at ``<path>.old`` with ``<path>`` missing — restore
    it.  (When ``<path>`` exists, ``.old`` is just pre-rmtree debris.)
    Called by both the saver and the loader, so the window self-heals on the
    first touch after restart."""
    path = os.fspath(path)
    old = path + ".old"
    if not os.path.exists(path) and os.path.isdir(old):
        try:
            os.rename(old, path)
            return True
        except OSError:
            # several ranks can race this recovery on a shared filesystem —
            # losing the rename is fine as long as somebody healed it
            return os.path.exists(path)
    return False


def save_state_dict(state_dict, path, async_save=False):
    """Write ``state_dict`` (nested dicts of tensors / numpy arrays / plain
    python values) as one crash-consistent checkpoint directory ``path``.

    ``async_save=True`` copies every tensor to the host now and runs the
    serialization, file IO and commit on writer threads
    (:func:`wait_async_save` joins them and re-raises their first error)."""
    path = os.fspath(path)
    staging = path + ".tmp"
    rank = 0                     # one process: rank 0 of a world of 1
    recover_interrupted_commit(path)
    for stale in (staging, path + ".old"):
        shutil.rmtree(stale, ignore_errors=True)
    with _digest_lock:   # digests of a previous torn attempt are stale
        _staged_digests.pop(os.path.abspath(staging), None)
    _barrier()  # nobody writes into staging before the stale sweep
    os.makedirs(staging, exist_ok=True)
    flat = _flat(state_dict)
    # this rank's view of the metadata; merged by the coordinator at the end
    local_meta = {"version": 2, "tensors": {}}
    shards = {}
    for name, t in flat.items():
        if not isinstance(t, (torch.Tensor, np.ndarray)):
            local_meta["tensors"][name] = {"py": True, "value": t} \
                if isinstance(t, (int, float, str, bool, list)) \
                else {"py": True, "value": None}
            continue
        data = _host_array(t)
        dtype = "bfloat16" if isinstance(t, torch.Tensor) \
            and t.dtype == torch.bfloat16 else str(data.dtype)
        ext = tuple((0, int(d)) for d in data.shape)
        local_meta["tensors"][name] = {
            "shape": list(data.shape), "dtype": dtype,
            "shards": [{"index": [[a, b] for a, b in ext],
                        "file": f"rank{rank}.data"}]}
        shards[(name, ext)] = data

    def _write():
        _write_durable(os.path.join(staging, f"rank{rank}.data"),
                       pickle.dumps(shards, protocol=4))
        _write_durable(os.path.join(staging, f"rank{rank}.meta.json"),
                       json.dumps(local_meta, default=str).encode())

    def _commit():
        """Merge metadata, write the manifest, then the commit point: rename
        staging onto the final path (the previous checkpoint, if any, stays
        intact until after the new one is durable)."""
        _merge_metadata(staging)
        _write_manifest(staging)
        _fsync_dir(staging)
        # the PARENT directory entry for the staging dir must be durable
        # BEFORE the rename: fsyncing only the staging dir persists its
        # contents, not its own name — after a host crash the journal may
        # replay the rename against a directory entry that was never
        # written, losing a fully-written snapshot.  `ckpt.dirsync` lets
        # the chaos drills kill the commit exactly at this window.
        fault_point("ckpt.dirsync", path=path, phase="parent")
        _fsync_dir(os.path.dirname(os.path.abspath(staging)) or ".")
        fault_point("ckpt.commit", path=path, phase="pre")
        old = path + ".old"
        if os.path.exists(path):
            os.rename(path, old)
            # crash HERE strands the previous checkpoint at .old —
            # recover_interrupted_commit() restores it on the next touch
            fault_point("ckpt.commit", path=path, phase="swap")
        os.rename(staging, path)
        shutil.rmtree(old, ignore_errors=True)
        _fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")

    if not async_save:
        _write()
        _barrier()  # all ranks' sidecars must be on disk before the merge
        _commit()
        return
    # the host copies happened above; only the serialization and file IO
    # run in the background.  A failed write is never committed (torn
    # staging stays .tmp): the commit runs on its own thread strictly
    # AFTER the writer joins.
    err_box: list[BaseException] = []

    def _write_guarded():
        try:
            _write()
        except BaseException as e:  # noqa: BLE001 — re-raised on join
            err_box.append(e)
            _async_errors.append(e)

    def _finish():
        th.join()
        if err_box:
            return
        try:
            _commit()
        except BaseException as e:  # noqa: BLE001
            _async_errors.append(e)

    th = threading.Thread(target=_write_guarded, daemon=False)
    th.start()
    fin = threading.Thread(target=_finish, daemon=False)
    fin.start()
    _async_threads.extend((th, fin))


def _merge_metadata(path):
    """Merge the current world's rank sidecars into the global metadata.json,
    deduplicating replicated extents across ranks (keep the lowest-rank copy).
    Only ranks [0, world) are merged, and stale rank files from a previous
    larger-world save into the same directory are removed so a subsequent
    load cannot mix checkpoints."""
    import glob as _glob
    world = 1
    merged = {"version": 2, "tensors": {}}
    files = []
    for fn in _glob.glob(os.path.join(path, "rank*.meta.json")):
        r = int(os.path.basename(fn)[4:].split(".")[0])
        if r < world:
            files.append((r, fn))
        else:  # stale sidecar from an older, larger-world save
            for stale in (fn, os.path.join(path, f"rank{r}.data")):
                try:
                    os.remove(stale)
                except OSError:
                    pass
    files = [fn for _, fn in sorted(files)]
    for fn in files:
        with open(fn) as f:
            m = json.load(f)
        for name, entry in m["tensors"].items():
            if entry.get("py"):
                merged["tensors"].setdefault(name, entry)
                continue
            tgt = merged["tensors"].setdefault(
                name, {"shape": entry["shape"], "dtype": entry["dtype"],
                       "shards": []})
            have = {tuple(tuple(p) for p in s["index"]) for s in tgt["shards"]}
            for s in entry["shards"]:
                ext = tuple(tuple(p) for p in s["index"])
                if ext not in have:
                    have.add(ext)
                    tgt["shards"].append(s)
    _write_durable(os.path.join(path, "metadata.json"),
                   json.dumps(merged, default=str).encode())
