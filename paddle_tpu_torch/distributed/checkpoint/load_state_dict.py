"""Distributed-checkpoint load: reassembles global tensors from the shard
files a :func:`~.save_state_dict.save_state_dict` directory holds (this
package's or the JAX package's, at any world size: the layout is the same)
and writes them into the destination state dict's tensors in place; a
:class:`~.save_state_dict.ShardView` destination receives its extent of
the global tensor, so a rank loads its shard of a state another world
wrote.

Shard payloads are keyed by (name, global extent) so files from different
ranks never collide.

Crash consistency: checkpoints written by the staged writer carry a per-file
SHA-256 ``manifest.json``; :func:`verify_checkpoint` re-hashes every listed
file and :func:`load_state_dict` refuses manifest mismatches outright — a
torn or bit-flipped snapshot fails loudly instead of resuming from silently
wrong state.  Manifest-less directories still load.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from .save_state_dict import ShardView, _sha256, recover_interrupted_commit

__all__ = ["load_state_dict", "verify_checkpoint", "CheckpointCorruptError"]


class CheckpointCorruptError(RuntimeError):
    """The checkpoint directory fails manifest verification: files missing,
    truncated, or altered since the manifest was written."""


def _load_manifest(path):
    """Parse ``path``'s manifest; raises CheckpointCorruptError when absent
    or unreadable."""
    if not os.path.isdir(path):
        raise CheckpointCorruptError(f"{path}: not a checkpoint directory")
    man_fn = os.path.join(path, "manifest.json")
    if not os.path.exists(man_fn):
        raise CheckpointCorruptError(
            f"{path}: manifest.json missing — torn, uncommitted, or "
            "pre-manifest checkpoint")
    try:
        with open(man_fn) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable manifest.json ({e})") from e
    if "metadata.json" not in man.get("files", {}):
        raise CheckpointCorruptError(
            f"{path}: manifest does not cover metadata.json")
    return man


def _verify_file(path, fn, man):
    info = man.get("files", {}).get(fn)
    if info is None:
        raise CheckpointCorruptError(
            f"{path}: {fn} is not covered by the manifest")
    full = os.path.join(path, fn)
    if not os.path.exists(full):
        raise CheckpointCorruptError(
            f"{path}: {fn} listed in manifest but missing on disk")
    try:
        size = os.path.getsize(full)
        digest = _sha256(full)
    except OSError as e:  # unreadable counts as corrupt: discovery must
        raise CheckpointCorruptError(  # skip it, not crash on it
            f"{path}: {fn} unreadable ({e})") from e
    if size != info.get("size"):
        raise CheckpointCorruptError(
            f"{path}: {fn} size {size} != manifest {info.get('size')} "
            "(truncated or torn write)")
    if digest != info.get("sha256"):
        raise CheckpointCorruptError(
            f"{path}: {fn} sha256 mismatch vs manifest — shard data "
            "missing, torn, or altered")


def verify_checkpoint(path):
    """Verify EVERY manifest-listed file of ``path``; returns the manifest.

    Raises :class:`CheckpointCorruptError` when the manifest is absent,
    unreadable, or any listed file is missing / wrong size / wrong SHA-256 —
    i.e. for every torn-write shape the staged writer can leave behind short
    of a committed rename.  (load_state_dict verifies only the files it
    actually reads — this full pass is for snapshot discovery, e.g.
    CheckpointManager.find_latest_complete.)"""
    recover_interrupted_commit(path)
    man = _load_manifest(path)
    for fn in man.get("files", {}):
        _verify_file(path, fn, man)
    return man


def _flat_targets(state_dict, prefix=""):
    out = {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat_targets(v, key))
        else:
            out[key] = v
    return out


def load_state_dict(state_dict, path):
    """Fill ``state_dict``'s tensors (``torch.Tensor``, numpy arrays or
    ``ShardView`` s, nested dicts allowed) in place from the checkpoint at
    ``path``; keys the checkpoint lacks, and non-tensor leaves, are left
    as they are.  Returns ``state_dict``."""
    recover_interrupted_commit(path)
    # verify ONLY what this load reads (manifest-covered metadata + the
    # referenced shard files)
    man = None
    if os.path.exists(os.path.join(path, "manifest.json")):
        man = _load_manifest(path)
        _verify_file(path, "metadata.json", man)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    # read only the shard files metadata references (never stray rank files
    # left behind by an older save into the same directory)
    referenced = set()
    for entry in meta["tensors"].values():
        for s in entry.get("shards", []) if not entry.get("py") else []:
            referenced.add(s["file"])
    data = {}
    for base in sorted(referenced):
        if man is not None:
            _verify_file(path, base, man)  # reject torn/altered shards loudly
        fn = os.path.join(path, base)
        with open(fn, "rb") as f:
            payload = pickle.load(f)
        for key, arr in payload.items():
            data.setdefault(key, arr)  # replicated extents: first copy wins
    targets = _flat_targets(state_dict)
    for name, t in targets.items():
        entry = meta["tensors"].get(name)
        if entry is None or entry.get("py") \
                or not isinstance(t, (torch.Tensor, np.ndarray, ShardView)):
            continue
        np_dtype = entry["dtype"]
        if np_dtype == "bfloat16":
            np_dtype = "float32"  # assemble in f32, cast on the copy
        full = np.zeros(entry["shape"], dtype=np_dtype)
        filled = np.zeros(entry["shape"], dtype=bool) if entry["shape"] \
            else None
        for sid, shard in enumerate(entry["shards"]):
            ext = tuple(tuple(p) for p in shard["index"])
            arr = data.get((name, ext))
            if arr is None:
                # version-1 files keyed the payload by rank-local sid
                arr = data.get((name, sid))
            if arr is None:
                continue  # detected below by the completeness check
            idx = tuple(slice(a, b) for a, b in shard["index"])
            full[idx] = np.asarray(arr, dtype=full.dtype)
            if filled is not None:
                filled[idx] = True
        if filled is not None and not filled.all():
            raise RuntimeError(
                f"checkpoint shard(s) missing for '{name}': only "
                f"{int(filled.sum())}/{filled.size} elements present in "
                f"{path} — incomplete save or mismatched rank files")
        if isinstance(t, ShardView):
            if tuple(entry["shape"]) != t.global_shape:
                raise RuntimeError(
                    f"'{name}': checkpoint shape {entry['shape']} != the "
                    f"shard's global shape {list(t.global_shape)}")
            full = full[tuple(slice(a, b) for a, b in t.extent())]
            t = t.local
        if isinstance(t, torch.Tensor):
            with torch.no_grad():
                t.copy_(torch.from_numpy(full).to(t.dtype))
        else:
            t[...] = full
    return state_dict
