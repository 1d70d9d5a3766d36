"""Port parity: paddle_tpu_torch's resilience layer against the JAX
package's on the CPU — the seeded fault plan, the crash-consistent
checkpoint writer and loader, the CheckpointManager, and the serving
engine's fault drills.

``FaultPlan`` keeps ``np.random.default_rng(seed)``, so on one consult
sequence the port's plan fires exactly where JAX's does.  The checkpoint
writer stages, hashes, fsyncs and renames as JAX's does, writes the same
directory layout (each package verifies and loads the other's) and tears at
the same ``ckpt.write`` / ``ckpt.dirsync`` / ``ckpt.commit`` windows.  The
engine drills of JAX's ``TestServingResilience`` and its serving chaos
sweep run on ``tests/test_torch_serving.py``'s engine pair under the same
seeded plans: the token streams, ``stats()`` and the consults (by name and
ctx) must be equal."""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_observability import _recording_plan
from test_torch_serving import (_engines, _jax_plain_dispatch,  # noqa: F401
                                _port_engines_stay_consistent, _prompts)
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.observability import Telemetry as JTelemetry
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch.distributed.checkpoint import (CheckpointCorruptError,
                                                     load_state_dict,
                                                     save_state_dict,
                                                     verify_checkpoint,
                                                     wait_async_save)
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.observability import Telemetry
from paddle_tpu_torch.resilience import (CheckpointManager, FaultPlan,
                                         FaultSpec, InjectedFault,
                                         active_plan, fault_point, inject)
from paddle_tpu_torch.resilience import faults as tfaults

rng = np.random.default_rng(21)
SAVE_MOD = "paddle_tpu_torch.distributed.checkpoint.save_state_dict"


# ---------------------------------------------------------------------------
# fault plan semantics
# ---------------------------------------------------------------------------
class TestFaultPlan:
    def test_no_plan_is_noop(self):
        assert active_plan() is None
        assert fault_point("ckpt.write", file="x", offset=0) is None

    def test_at_fires_exactly_once(self):
        plan = FaultPlan({"p": dict(action="trigger", at=2)})
        with inject(plan):
            fired = [fault_point("p") is not None for _ in range(6)]
        assert fired == [False, False, True, False, False, False]
        assert plan.fired("p") == 1 and plan.hits("p") == 6

    def test_after_count_window(self):
        with inject({"p": dict(action="trigger", after=1, count=3)}) as plan:
            fired = [fault_point("p") is not None for _ in range(6)]
        assert fired == [False, True, True, True, False, False]
        assert plan.fired() == 3

    def test_match_filters_ctx(self):
        with inject({"p": dict(action="trigger", match={"file": "a"},
                               count=None)}) as plan:
            assert fault_point("p", file="b") is None
            assert fault_point("p", file="a") is not None
        assert plan.hits() == 1

    def test_raise_action(self):
        with inject({"p": dict(at=0)}):
            with pytest.raises(InjectedFault, match="injected fault at 'p'"):
                fault_point("p")

    def test_seeded_prob_matches_jax(self):
        """The same seed draws the same fire pattern in both packages."""
        def pattern(faults, seed):
            with faults.inject({"p": dict(action="trigger", prob=0.5,
                                          count=None)}, seed=seed):
                return [faults.fault_point("p") is not None
                        for _ in range(32)]
        a, b = pattern(tfaults, 5), pattern(tfaults, 5)
        assert a == b and any(a) and not all(a)
        assert pattern(tfaults, 6) != a
        for seed in (0, 5, 6, 11):
            assert pattern(tfaults, seed) == pattern(jfaults, seed)

    def test_random_consult_streams_fire_like_jax(self):
        """Several specs at once (at / after / count / prob / match, both
        actions) over a random consult stream: every consult resolves to
        the same spec (or none) and every spec counts the same hits and
        fires."""
        r = np.random.default_rng(3)
        specs = [dict(point="a", action="trigger", prob=0.3, count=None),
                 dict(point="a", action="trigger", at=4),
                 dict(point="b", action="trigger", after=2, count=3,
                      match={"k": 1}),
                 dict(point="c", action="raise", prob=0.5, count=2)]
        stream = [(str(r.choice(["a", "b", "c"])),
                   {"k": int(r.integers(0, 2))}) for _ in range(200)]
        out = []
        for faults in (jfaults, tfaults):
            plan = faults.FaultPlan(
                [faults.FaultSpec(**dict(s, match=dict(s.get("match", {}))))
                 for s in specs], seed=9)
            got = []
            with faults.inject(plan):
                for point, ctx in stream:
                    try:
                        spec = faults.fault_point(point, **ctx)
                        got.append(None if spec is None
                                   else plan.specs.index(spec))
                    except faults.InjectedFault as e:
                        got.append(str(e))
            out.append((got, [(s.hits, s.fired) for s in plan.specs]))
        assert out[1] == out[0]
        assert any(isinstance(g, int) for g in out[1][0])

    def test_scoped_and_nested(self):
        outer = FaultPlan({"p": dict(action="trigger", count=None)})
        inner = FaultPlan()
        with inject(outer):
            assert fault_point("p") is not None
            with inject(inner):
                assert active_plan() is inner
                assert fault_point("p") is None
            assert fault_point("p") is not None
        assert active_plan() is None

    def test_spec_validation(self):
        with pytest.raises(ValueError, match="action"):
            FaultSpec(point="p", action="explode")

    def test_fault_context_matches_jax(self):
        """The active plan summarised for a postmortem (seed, specs, hit and
        fire counts), None outside a scope, as the JAX package's."""
        from paddle_tpu.observability import fault_context as jctx
        from paddle_tpu_torch.observability import fault_context as tctx
        assert tctx() is None
        out = []
        for faults, ctx in ((jfaults, jctx), (tfaults, tctx)):
            with faults.inject({"p": dict(action="trigger", after=1),
                                "q": dict(at=5)}, seed=3):
                for _ in range(3):
                    faults.fault_point("p")
                out.append(ctx())
        assert out[1] == out[0] == {"seed": 3, "specs": ["p:trigger",
                                                          "q:raise"],
                                    "hits": 3, "fired": 1}


# ---------------------------------------------------------------------------
# crash-consistent checkpointing
# ---------------------------------------------------------------------------
def _small_chunks(monkeypatch, nbytes=64):
    monkeypatch.setattr(sys.modules[SAVE_MOD], "WRITE_CHUNK", nbytes)


def _w(v, n=4):
    return torch.full((n,), float(v))


def _read(path, name, shape, dtype=torch.float32):
    t = torch.zeros(shape, dtype=dtype)
    load_state_dict({name: t}, path)
    return t


class TestCrashConsistentCheckpoint:
    def test_roundtrip_carries_manifest_and_crosses_packages(self, tmp_path):
        """A port-written directory passes JAX's verification and JAX's
        reader returns the same arrays; a JAX-written one loads here."""
        w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
        codes = torch.randint(-128, 127, (3, 5), dtype=torch.int8)
        p = str(tmp_path / "ck")
        save_state_dict({"w": w, "q": codes, "step": 3, "meta": "x"}, p)
        man = verify_checkpoint(p)
        assert "metadata.json" in man["files"] and "rank0.data" in man["files"]
        assert jckpt.verify_checkpoint(p) == man
        from paddle_tpu.serving.snapshot import load_engine_snapshot
        st = load_engine_snapshot(p)
        np.testing.assert_array_equal(st["w"], w.numpy())
        np.testing.assert_array_equal(st["q"], codes.numpy())
        assert st["step"] == 3 and st["meta"] == "x"
        t = _read(p, "w", (4, 4))
        np.testing.assert_array_equal(t.numpy(), np.arange(16).reshape(4, 4))
        pj = str(tmp_path / "jax")
        jckpt.save_state_dict({"w": w.numpy() * 2, "q": codes.numpy()}, pj)
        assert verify_checkpoint(pj) == jckpt.verify_checkpoint(pj)
        q = np.zeros((3, 5), np.int8)
        load_state_dict({"w": t, "q": q}, pj)
        np.testing.assert_array_equal(t.numpy(), w.numpy() * 2)
        np.testing.assert_array_equal(q, codes.numpy())

    def test_bf16_saves_as_f32_values_under_its_name(self, tmp_path):
        w = torch.randn(6, dtype=torch.bfloat16)
        p = str(tmp_path / "ck")
        save_state_dict({"w": w}, p)
        t = _read(p, "w", (6,), torch.bfloat16)
        assert torch.equal(t, w)
        import json
        meta = json.load(open(os.path.join(p, "metadata.json")))
        assert meta["tensors"]["w"]["dtype"] == "bfloat16"

    def test_manifest_hashes_while_writing_no_second_read(self, tmp_path,
                                                          monkeypatch):
        mod = sys.modules[SAVE_MOD]

        def _boom(fn):
            raise AssertionError(f"manifest re-read {fn}")

        monkeypatch.setattr(mod, "_sha256", _boom)
        w = torch.randn(8, 8)
        p = str(tmp_path / "ck")
        save_state_dict({"w": w, "step": 1}, p)
        monkeypatch.undo()
        assert "rank0.data" in verify_checkpoint(p)["files"]
        assert torch.equal(_read(p, "w", (8, 8)), w)

    def test_manifest_read_fallback_for_foreign_files(self, tmp_path):
        mod = sys.modules[SAVE_MOD]
        p = str(tmp_path / "ck")
        orig = mod._write_manifest

        def _clear_then_manifest(st):
            with mod._digest_lock:
                mod._staged_digests.pop(os.path.abspath(st), None)
            orig(st)

        try:
            mod._write_manifest = _clear_then_manifest
            save_state_dict({"w": _w(1)}, p)
        finally:
            mod._write_manifest = orig
        verify_checkpoint(p)

    @pytest.mark.parametrize("chunk_at", [0, 1, 3])
    def test_torn_write_never_commits(self, tmp_path, monkeypatch, chunk_at):
        _small_chunks(monkeypatch)
        w = torch.randn(16, 16)
        p = str(tmp_path / "ck")
        with pytest.raises(InjectedFault):
            with inject({"ckpt.write": dict(match={"file": "rank0.data"},
                                            at=chunk_at)}):
                save_state_dict({"w": w}, p)
        assert not os.path.exists(p)
        assert os.path.exists(p + ".tmp")
        with pytest.raises(CheckpointCorruptError):
            verify_checkpoint(p)

    def test_kill_between_files_never_commits(self, tmp_path):
        p = str(tmp_path / "ck")
        with pytest.raises(InjectedFault):
            with inject({"ckpt.write": dict(match={"file": "rank0.meta.json"},
                                            at=0)}):
                save_state_dict({"w": _w(1)}, p)
        assert not os.path.exists(p)

    @pytest.mark.parametrize("point", ["ckpt.commit", "ckpt.dirsync"])
    def test_kill_before_commit_point(self, tmp_path, point):
        """Fully staged, killed at the parent-directory fsync or just
        before the rename: no final dir; the retry commits."""
        p = str(tmp_path / "ck")
        with pytest.raises(InjectedFault):
            with inject({point: dict(at=0)}):
                save_state_dict({"w": _w(1)}, p)
        assert not os.path.exists(p)
        save_state_dict({"w": _w(1)}, p)
        verify_checkpoint(p)

    def test_commit_consults_match_jax(self, tmp_path):
        """One save consults the writer's points in the same order, with
        the same ctx, in both packages."""
        logs = []
        for faults, save in ((jfaults, jckpt.save_state_dict),
                             (tfaults, save_state_dict)):
            p = str(tmp_path / faults.__name__.split(".")[0] / "ck")
            os.makedirs(os.path.dirname(p))
            save({"w": np.ones(4, np.float32)}, p)     # a previous snapshot
            plan = _recording_plan(faults, {})
            with faults.inject(plan):
                save({"w": np.full(4, 2.0, np.float32), "s": 1}, p)
            logs.append([(pt, {k: v for k, v in c.items() if k != "path"})
                         for pt, c in plan.log])
        assert logs[1] == logs[0]
        assert [pt for pt, _ in logs[1]][-4:] == [
            "ckpt.write", "ckpt.dirsync", "ckpt.commit", "ckpt.commit"]

    def test_crash_between_commit_renames_recovers_previous(self, tmp_path):
        p = str(tmp_path / "ck")
        save_state_dict({"w": _w(1.0)}, p)
        with pytest.raises(InjectedFault):
            with inject({"ckpt.commit": dict(match={"phase": "swap"},
                                             at=0)}):
                save_state_dict({"w": _w(2.0)}, p)
        assert not os.path.exists(p) and os.path.isdir(p + ".old")
        assert torch.equal(_read(p, "w", (4,)), _w(1.0))   # self-heals
        assert os.path.isdir(p) and not os.path.exists(p + ".old")
        save_state_dict({"w": _w(2.0)}, p)
        assert torch.equal(_read(p, "w", (4,)), _w(2.0))

    def test_crashed_overwrite_keeps_previous_checkpoint(self, tmp_path):
        p = str(tmp_path / "ck")
        save_state_dict({"w": _w(1.0)}, p)
        with pytest.raises(InjectedFault):
            with inject({"ckpt.write": dict(match={"file": "rank0.data"},
                                            at=0)}):
                save_state_dict({"w": _w(2.0)}, p)
        verify_checkpoint(p)
        assert torch.equal(_read(p, "w", (4,)), _w(1.0))

    def test_bitflip_rejected_on_load(self, tmp_path):
        p = str(tmp_path / "ck")
        save_state_dict({"w": torch.ones(64)}, p)
        with open(os.path.join(p, "rank0.data"), "r+b") as f:
            f.seek(12)
            b = f.read(1)
            f.seek(12)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.raises(CheckpointCorruptError, match="sha256 mismatch"):
            _read(p, "w", (64,))
        with pytest.raises(jckpt.CheckpointCorruptError):
            jckpt.verify_checkpoint(p)

    def test_wait_async_save_reraises_writer_exception(self, tmp_path):
        p = str(tmp_path / "ck")
        with inject({"ckpt.write": dict(match={"file": "rank0.data"}, at=0)}):
            save_state_dict({"w": _w(1)}, p, async_save=True)
            with pytest.raises(InjectedFault):
                wait_async_save()
        assert not os.path.exists(p)
        wait_async_save()

    def test_async_save_happy_path(self, tmp_path):
        p = str(tmp_path / "ck")
        save_state_dict({"w": _w(7.0, 8)}, p, async_save=True)
        wait_async_save()
        verify_checkpoint(p)
        assert torch.equal(_read(p, "w", (8,)), _w(7.0, 8))


# ---------------------------------------------------------------------------
# CheckpointManager: rotation and discovery
# ---------------------------------------------------------------------------
class TestCheckpointManager:
    def test_rotation_keeps_last_n(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval=1, keep_last=2)
        for s in (1, 2, 3, 4, 5):
            mgr.save(s)
        assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                                "step_00000005"]

    def test_find_latest_skips_torn_and_corrupt(self, tmp_path, monkeypatch):
        _small_chunks(monkeypatch)
        mgr = CheckpointManager(str(tmp_path), keep_last=None)
        big = {"w": torch.randn(64)}
        mgr.save(4, extra_state=big)
        with pytest.raises(InjectedFault):
            with inject({"ckpt.write": dict(match={"file": "rank0.data"},
                                            at=1)}):
                mgr.save(8, extra_state=big)
        latest = mgr.find_latest_complete()
        assert latest is not None and latest.endswith("step_00000004")
        mgr.save(12, extra_state=big)
        with open(os.path.join(str(tmp_path), "step_00000012",
                               "rank0.data"), "r+b") as f:
            f.seek(6)
            f.write(b"\x00\x01\x02")
        assert mgr.find_latest_complete().endswith("step_00000004")
        assert mgr.restore() == 4
        # the JAX manager's discovery lands on the same snapshot
        from paddle_tpu.resilience import CheckpointManager as JManager
        assert JManager(str(tmp_path)).find_latest_complete() \
            == mgr.find_latest_complete()

    def test_find_latest_heals_stranded_old_snapshot(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=None)
        mgr.save(4)
        mgr.save(8)
        os.rename(os.path.join(str(tmp_path), "step_00000008"),
                  os.path.join(str(tmp_path), "step_00000008.old"))
        latest = mgr.find_latest_complete()
        assert latest is not None and latest.endswith("step_00000008")
        assert not os.path.exists(
            os.path.join(str(tmp_path), "step_00000008.old"))

    def test_extra_state_step_of_and_should_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval=4)
        assert [mgr.should_save(s) for s in (3, 4, 8)] == [False, True, True]
        assert mgr.maybe_save(3) is None
        path = mgr.maybe_save(8, extra_state={"tokens_seen": 12345})
        assert CheckpointManager.step_of(path) == 8
        assert CheckpointManager.step_of("/x/step_00000012/") == 12
        assert CheckpointManager.step_of("/x/other") is None
        assert mgr.restore() == 8
        assert mgr.last_extra == {"tokens_seen": 12345}
        mgr.save(12, async_save=True)
        mgr.wait()
        assert mgr.restore() == 12

    def test_empty_root_restores_none(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.find_latest_complete() is None
        assert mgr.restore() is None

    def test_rejects_bad_settings(self, tmp_path):
        with pytest.raises(ValueError, match="save_interval"):
            CheckpointManager(str(tmp_path), save_interval=0)
        with pytest.raises(ValueError, match="keep_last"):
            CheckpointManager(str(tmp_path), keep_last=0)


# ---------------------------------------------------------------------------
# the serving engine's fault drills, on both engines
# ---------------------------------------------------------------------------
DRILL = dict(num_slots=2, page_size=2, num_pages=40, max_pages_per_seq=16,
             prompt_bucket=8, decode_horizon=2)


def _drill_prompts(seed=31):
    return _prompts(3, 3, 8, seed=seed)


def _run_both(specs, prompts, max_new=8, seed=0, engine_kw=None,
              telemetry=False):
    """The same traffic under the same seeded plan on both engines:
    [(tokens, stats, consult log, plan, engine)] for JAX, then the port."""
    jeng, teng = _engines(**dict(DRILL, **(engine_kw or {})))
    out = []
    for eng, faults, tel in ((jeng, jfaults, JTelemetry),
                             (teng, tfaults, Telemetry)):
        if telemetry:
            eng.telemetry = tel()
            eng._clock = eng.telemetry.clock
        plan = _recording_plan(faults, specs, seed=seed)
        with faults.inject(plan):
            rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
            done = eng.run()
        out.append(([list(done[r].generated) for r in rids], eng.stats(),
                    plan.log, plan, eng))
    return out


def _same_stats(sj, st):
    common = set(sj) & set(st)
    assert {k: st[k] for k in common} == {k: sj[k] for k in common}


class TestServingResilience:
    def test_pool_capacity_error_is_typed_and_counted(self):
        _, teng = _engines(num_slots=2, page_size=4, num_pages=4,
                           max_pages_per_seq=8)
        with pytest.raises(tpaged.PoolCapacityError,
                           match=r"needs 5 pages.*only has 4"):
            teng.submit(np.ones((12,), np.int32), max_new_tokens=8)
        assert issubclass(tpaged.PoolCapacityError, ValueError)

    def test_admission_rejected_backpressure(self):
        jeng, teng = _engines(num_slots=1, page_size=8, num_pages=8,
                              max_queue=2)
        p = _prompts(1, 4, 5, seed=1)[0]
        for eng in (jeng, teng):
            eng.telemetry = Telemetry() if eng is teng else JTelemetry()
            eng.submit(p, max_new_tokens=4)
            eng.submit(p, max_new_tokens=4)
            with pytest.raises(Exception, match="queue full"):
                eng.submit(p, max_new_tokens=4)
            assert eng.rejections == 1
            assert len(eng.run()) == 2
            assert eng.telemetry.registry.snapshot()["serve.rejections"] == 1
        assert teng.stats()["rejections"] == jeng.stats()["rejections"]

    def test_deadline_retires_queued_and_running(self):
        jeng, teng = _engines(**dict(DRILL, page_size=8, num_pages=24))
        p = _prompts(1, 5, 6, seed=3)[0]
        outs = []
        for eng in (jeng, teng):
            r_dead = eng.submit(p, max_new_tokens=6, timeout=0.0)
            r_ok = eng.submit(p, max_new_tokens=6)
            eng.step()
            done = eng.run()
            assert done[r_dead].timed_out and done[r_dead].generated == []
            assert not done[r_ok].timed_out
            r_mid = eng.submit(p, max_new_tokens=32)
            eng.step()
            req = next(sl.req for sl in eng._slots if sl is not None)
            req.deadline = eng._clock() - 1.0
            done = eng.run()
            assert done[r_mid].timed_out and len(done[r_mid].generated) > 0
            assert eng.timeouts == 2
            outs.append([done[r].generated for r in (r_dead, r_ok, r_mid)])
        assert outs[1] == outs[0]

    @pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
    def test_injected_pool_pressure_completes_all_exactly(self, overlap):
        """Under injected exhaustion every request completes through
        preemption + re-prefill, with the same tokens, stats and consults
        on both engines, and every page comes back."""
        (tj, sj, lj, pj, _), (tt, st, lt, pt, teng) = _run_both(
            {"serve.pool_pressure": dict(action="trigger", after=1,
                                         count=3)},
            _drill_prompts(), engine_kw=dict(overlap=overlap))
        assert pt.fired("serve.pool_pressure") == 3 == pj.fired()
        assert tt == tj and all(len(t) == 8 for t in tt)
        assert st["preemptions"] >= 1
        _same_stats(sj, st)
        assert lt == lj
        teng.release_cache()
        assert teng.pool.num_free == teng.pool.num_pages

    def test_flight_recorder_ladder_order_under_pool_pressure(self):
        (tj, _, _, _, jeng), (tt, _, _, _, teng) = _run_both(
            {"serve.pool_pressure": dict(action="trigger", after=1,
                                         count=3)},
            _drill_prompts(), telemetry=True)
        assert tt == tj
        kinds = []
        for eng in (jeng, teng):
            tel = eng.telemetry
            fault_dumps = [d for d in tel.flight.dumps
                           if d["reason"] == "injected_fault"]
            assert fault_dumps, "pool-pressure window did not auto-dump"
            names = [e["event"] for e in fault_dumps[-1]["events"]]
            assert names.index("admit") < names.index("evict") \
                < names.index("preempt")
            assert any(e["event"] == "fault"
                       and e["point"] == "serve.pool_pressure"
                       for e in fault_dumps[-1]["events"])
            kinds.append([(e["event"], e.get("rid"), e.get("slot"))
                          for e in tel.flight.events()
                          if e["event"] != "compile"])
        assert kinds[1] == kinds[0]

    def test_pagepool_alloc_fault_point(self):
        pool = tpaged.PagePool(8, 16)
        with inject({"pagepool.alloc": dict(action="trigger", at=1)}):
            pool.alloc(2)
            with pytest.raises(RuntimeError, match=r"exhausted \(injected\)"):
                pool.alloc(2)
            a = pool.alloc(2)
        assert pool.num_allocated == 4
        pool.free(a)

    @pytest.mark.parametrize("action", ["raise", "trigger"])
    def test_pagepool_alloc_fault_during_admission(self, action):
        """An allocation fault in admission rolls the pinned prefix back
        (no reference leaks), raises the same error on both engines at the
        same consult, dumps the flight ring on an injected raise, and the
        engine serves on."""
        jeng, teng = _engines(**DRILL)
        p = _drill_prompts()
        outs = []
        for eng, faults, tel in ((jeng, jfaults, JTelemetry()),
                                 (teng, tfaults, Telemetry())):
            eng.telemetry, eng._clock = tel, tel.clock
            eng.submit(p[0], max_new_tokens=4)
            eng.run()                              # p[0] is now cached
            plan = _recording_plan(faults, {"pagepool.alloc": dict(
                action=action, at=0)})
            with faults.inject(plan):
                eng.submit(p[0], max_new_tokens=4)  # attaches the prefix
                with pytest.raises(RuntimeError) as exc:
                    eng.step()
            eng.check_invariants()
            assert isinstance(exc.value, faults.InjectedFault) \
                == (action == "raise")
            dumped = [d["extra"]["point"] for d in tel.flight.dumps
                      if d["reason"] == "injected_fault"]
            assert dumped == (["pagepool.alloc"] if action == "raise"
                              else [])
            done = eng.run()
            outs.append(([r.generated for r in done.values()], plan.log,
                         str(exc.value).split(" (hit")[0]))
        assert outs[1] == outs[0]

    @pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
    def test_serve_wedge_makes_no_progress(self, overlap):
        """A wedged step does no work at all and says so; the flight ring
        records the fault; once the window closes the streams finish as
        on the other engine."""
        specs = {"serve.wedge": dict(action="trigger", after=2, count=3,
                                     match={"engine": "engine"})}
        res = _run_both(specs, _drill_prompts(), telemetry=True,
                        engine_kw=dict(overlap=overlap))
        (tj, sj, lj, pj, jeng), (tt, st, lt, pt, teng) = res
        assert tt == tj and lt == lj and pt.fired() == 3 == pj.fired()
        _same_stats(sj, st)
        for eng in (jeng, teng):
            steps = [e for e in eng.telemetry.flight.events()
                     if e["event"] in ("fault", "step")]
            wedged = [i for i, e in enumerate(steps)
                      if e.get("point") == "serve.wedge"]
            assert len(wedged) == 3
            for i in wedged:                    # the step after the fault
                assert steps[i + 1]["event"] == "step" \
                    and not steps[i + 1]["progressed"] \
                    and steps[i + 1]["tokens"] == 0

    @pytest.mark.parametrize("phase,at", [("sched", 2), ("record", 3)])
    def test_serve_crash_raises_mid_step(self, phase, at):
        """serve.crash raises at the same step on both engines with the
        same host state behind it (a step boundary for the page
        accounting); driving on finishes the same streams."""
        jeng, teng = _engines(**DRILL)
        outs = []
        for eng, faults in ((jeng, jfaults), (teng, tfaults)):
            rids = [eng.submit(p, max_new_tokens=8)
                    for p in _drill_prompts()]
            with faults.inject({"serve.crash": dict(
                    at=at, match={"engine": "engine", "phase": phase})}):
                with pytest.raises(faults.InjectedFault,
                                   match="serve.crash"):
                    eng.run()
            eng.check_invariants()
            at_crash = (eng._step_seq, eng.stats()["tokens_generated"],
                        [list(r.generated) for r in
                         (eng.lookup(x) for x in rids)])
            done = eng.run()
            outs.append((at_crash, [done[r].generated for r in rids]))
        assert outs[1] == outs[0]


class TestChaosSweeps:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_serving_chaos(self, seed):
        """Randomised pool-pressure windows (seeded, prob 0.4, 6 fires):
        both engines complete every request with the same tokens, stats
        and consults, and return every page."""
        prompts = _prompts(3, 4, 10, seed=40)
        ref = _run_both({}, prompts, max_new=6)
        (tj, sj, lj, _, _), (tt, st, lt, _, teng) = _run_both(
            {"serve.pool_pressure": dict(action="trigger", prob=0.4,
                                         count=6)},
            prompts, max_new=6, seed=seed)
        assert tt == tj == ref[1][0] == ref[0][0]
        _same_stats(sj, st)
        assert lt == lj
        teng.release_cache()
        assert teng.pool.num_free == teng.pool.num_pages
