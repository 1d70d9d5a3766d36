"""Port parity: durable ServingEngine snapshots through the checkpoint
commit protocol (``paddle_tpu_torch.serving.EngineSnapshotManager``) on the
CPU.

A snapshot taken with a dispatch in flight round-trips through the manager
into a fresh engine, which continues bit-equal to an uninterrupted run, at
every KV dtype the port stores.  Each torn window — ``serve.snapshot``
(raise before staging, trigger tearing the committed snapshot),
``ckpt.write``, ``ckpt.dirsync`` and ``ckpt.commit`` (before the rename and
in the swap) — leaves the previous snapshot as the newest intact one, and
restoring it still continues exactly.  For f32 and int8 pools a directory
either package writes passes the other's ``verify_checkpoint``, and the
other package's engine restores it and continues exactly.  The one plane
that cannot cross is ``rng``, each package's own generator state (a
``jax.random`` key against a ``torch.Generator`` state): the restoring side
puts its own in its place; greedy streams never draw from it.  Weights:
``tests/test_torch_serving.py``'s margin-engineered ones."""
import os

import numpy as np
import pytest
import torch

from test_torch_observability import _recording_plan
from test_torch_serving import (_engines, _jax_plain_dispatch,  # noqa: F401
                                _models, _port_engines_stay_consistent,
                                _prompts)
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import snapshot as jsnap
from paddle_tpu_torch.distributed.checkpoint import verify_checkpoint
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.resilience import InjectedFault, inject
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import EngineSnapshotManager
from paddle_tpu_torch.serving import snapshot as tsnap

BASE = dict(num_slots=3, page_size=4, num_pages=48, prompt_bucket=16,
            decode_horizon=3)
PROMPTS = _prompts(4, 3, 20, seed=71)
PROMPTS[1] = np.concatenate([PROMPTS[0][:8], PROMPTS[1]])   # shares 2 pages
NEWS = [12, 10, 14, 9]
KV = {"f32": dict(), "int8": dict(kv_dtype="int8"),
      "fp8": dict(kv_dtype="fp8"), "bf16": dict(dtype=torch.bfloat16)}


def _port(**kw):
    _, tp, _, tcfg = _models(4)
    if kw.get("dtype") is not None:        # a bf16 engine takes bf16 weights
        tp = tuple({k: v.to(kw["dtype"]) for k, v in t.items()} for t in tp)
    return tpaged.ServingEngine(tp, tcfg, device="cpu", **dict(BASE, **kw))


def _submit(eng):
    return [eng.submit(p, max_new_tokens=m) for p, m in zip(PROMPTS, NEWS)]


def _uninterrupted(**kw):
    eng = _port(**kw)
    rids = _submit(eng)
    done = eng.run()
    return [done[r].generated for r in rids]


def _midflight(steps=3, **kw):
    """An overlapped engine with a dispatch in flight, and its rids."""
    eng = _port(overlap=True, **kw)
    rids = _submit(eng)
    for _ in range(steps):
        eng.step()
    assert eng.inflight_depth == 1
    return eng, rids


@pytest.mark.parametrize("mode,kv", [
    ("full_kv", "f32"), ("full_kv", "int8"), ("full_kv", "fp8"),
    ("full_kv", "bf16"), ("compact", "f32"), ("compact", "int8")])
def test_roundtrip_with_a_dispatch_in_flight(tmp_path, mode, kv):
    want = _uninterrupted(**KV[kv])
    eng, rids = _midflight(**KV[kv])
    mgr = EngineSnapshotManager(str(tmp_path))
    path = mgr.save_engine(eng, mode=mode)
    assert eng.inflight_depth == 0 and eng.quiesces == 1
    assert os.path.basename(path) == "step_00000000"
    assert verify_checkpoint(path) == jckpt.verify_checkpoint(path)
    fresh = _port(overlap=True, **KV[kv])
    got_path, applied = mgr.restore_engine(fresh)
    assert got_path == path
    assert applied == ("full_kv" if mode == "full_kv" else "reprefill")
    fresh.check_invariants()
    done = fresh.run()
    assert [done[r].generated for r in rids] == want
    done = eng.run()                        # the original finishes too
    assert [done[r].generated for r in rids] == want
    if mode == "full_kv":
        st = tsnap.load_engine_snapshot(path)
        plane = "kv_k_q" if kv in ("int8", "fp8") else "kv_k"
        assert st[plane].dtype == {"f32": np.float32, "int8": np.int8,
                                   "fp8": np.uint8, "bf16": np.int16}[kv]
        assert len(st["kv_pages"]) == st[plane].shape[2]


def test_rotation_and_default_steps(tmp_path):
    eng, _ = _midflight()
    mgr = EngineSnapshotManager(str(tmp_path), keep_last=2)
    paths = [mgr.save_engine(eng) for _ in range(3)]
    eng.step()
    paths.append(mgr.save_engine(eng, step=10))
    assert [os.path.basename(p) for p in paths] == [
        "step_00000000", "step_00000001", "step_00000002", "step_00000010"]
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000010"]
    assert mgr.find_latest_complete() == paths[-1]
    eng.run()


TORN = {
    "snapshot_raise": ({"serve.snapshot": dict(at=0)}, InjectedFault),
    "snapshot_tear": ({"serve.snapshot": dict(action="trigger", at=0)},
                      None),
    "write": ({"ckpt.write": dict(match={"file": "rank0.data"}, at=0)},
              InjectedFault),
    "dirsync": ({"ckpt.dirsync": dict(at=0)}, InjectedFault),
    "commit": ({"ckpt.commit": dict(match={"phase": "pre"}, at=0)},
               InjectedFault),
    "commit_swap": ({"ckpt.commit": dict(match={"phase": "swap"}, at=0)},
                    InjectedFault),
}


@pytest.mark.parametrize("window", sorted(TORN))
def test_torn_window_leaves_the_previous_snapshot_latest(tmp_path, window):
    """A second save killed (or torn) in ``window``: discovery falls back
    to the first snapshot, and an engine restored from it still continues
    exactly.  The swap window saves over the same step directory, so the
    first snapshot is stranded at ``.old`` and healed back."""
    specs, raises = TORN[window]
    want = _uninterrupted()
    eng, rids = _midflight()
    mgr = EngineSnapshotManager(str(tmp_path), keep_last=None)
    first = mgr.save_engine(eng, step=1)
    eng.step()
    eng.step()
    step = 1 if window == "commit_swap" else 2
    with inject(specs) as plan:
        if raises is None:
            torn = mgr.save_engine(eng, step=step)
            assert os.path.isdir(torn)
        else:
            with pytest.raises(raises):
                mgr.save_engine(eng, step=step)
    assert plan.fired() == 1
    assert mgr.find_latest_complete() == first
    fresh = _port(overlap=True)
    assert mgr.restore_engine(fresh) == (first, "full_kv")
    done = fresh.run()
    assert [done[r].generated for r in rids] == want
    done = eng.run()
    assert [done[r].generated for r in rids] == want


def test_snapshot_consults_match_jax(tmp_path):
    """save_engine consults serve.snapshot and the writer's points in the
    same order with the same ctx in both packages."""
    jeng, teng = _engines(**BASE)
    logs = []
    for eng, faults, snap in ((jeng, jfaults, jsnap), (teng, tfaults, tsnap)):
        _submit(eng)
        eng.step()
        mgr = snap.EngineSnapshotManager(str(tmp_path / faults.__name__))
        plan = _recording_plan(faults, {})
        with faults.inject(plan):
            mgr.save_engine(eng, mode="compact")
            mgr.save_engine(eng, mode="full_kv")
        logs.append([(p, {k: v for k, v in c.items() if k != "path"})
                     for p, c in plan.log])
        eng.run()
    assert logs[1] == logs[0]
    assert logs[1][0] == ("serve.snapshot",
                          {"step": 0, "mode": "compact", "engine": "engine"})


def _jax_key():
    import jax
    return np.asarray(jax.random.PRNGKey(0))


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_port_snapshot_restores_in_the_jax_engine(tmp_path, kv):
    jeng, _ = _engines(**dict(BASE, overlap=True, **KV[kv]))
    rids = _submit(jeng)
    want = [jeng.run()[r].generated for r in rids]
    eng, rids = _midflight(**KV[kv])
    path = EngineSnapshotManager(str(tmp_path)).save_engine(eng)
    jmgr = jsnap.EngineSnapshotManager(str(tmp_path))
    assert jmgr.find_latest_complete() == path
    jckpt.verify_checkpoint(path)
    state = jsnap.load_engine_snapshot(path)
    state["rng"] = _jax_key()                # the one package-own plane
    jfresh, _ = _engines(**dict(BASE, overlap=True, **KV[kv]))
    assert jfresh.restore(state) == "full_kv"
    done = jfresh.run()
    assert [done[r].generated for r in rids] == want
    eng.run()


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_jax_snapshot_restores_in_the_port_engine(tmp_path, kv):
    want = _uninterrupted(**KV[kv])
    jeng, _ = _engines(**dict(BASE, overlap=True, **KV[kv]))
    rids = _submit(jeng)
    for _ in range(3):
        jeng.step()
    path = jsnap.EngineSnapshotManager(str(tmp_path)).save_engine(jeng)
    mgr = EngineSnapshotManager(str(tmp_path))
    assert mgr.find_latest_complete() == path
    verify_checkpoint(path)
    state = tsnap.load_engine_snapshot(path)
    fresh = _port(overlap=True, **KV[kv])
    state["rng"] = fresh._gen.get_state().numpy()   # the package-own plane
    assert fresh.restore(state) == "full_kv"
    fresh.check_invariants()
    done = fresh.run()
    assert [done[r].generated for r in rids] == want
    jeng.run()
