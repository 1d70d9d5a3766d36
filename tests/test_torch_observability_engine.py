"""Port parity of the serving engine's telemetry (split from
``test_torch_observability.py``, whose engine pair helpers it shares):
events, counters and fault consults equal to the JAX engine's on the same
traffic, every timestamp under one fake clock, the lifecycle trace, the
utilization and memory reports, and capture accounting."""
import json
import time

import pytest
import torch

from test_torch_observability import (_flight, _metric_counts, _port,
                                      _recording_plan, _tel_engines,
                                      _traffic)
from test_torch_serving import (_jax_plain_dispatch,  # noqa: F401
                                _port_engines_stay_consistent, _prompts,
                                _spec_prompts)
from paddle_tpu import observability as jobs
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.resilience import faults as tfaults


# ---------------------------------------------------------------------------
# the engines' telemetry against each other
# ---------------------------------------------------------------------------
PARITY_CASES = {
    "chunked": dict(prefill_chunk=8),
    "spec": dict(speculative=2),
    "tight_pool": dict(num_pages=12),
}


class TestEngineTelemetryParity:
    @pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
    @pytest.mark.parametrize("case", sorted(PARITY_CASES))
    def test_events_counters_and_consults_match_jax(self, case, overlap):
        """The same traffic under the same seeded fault plan (pool
        pressure from the second consult at probability 0.5): equal tokens, lifecycle event names
        per request, flight kinds with rid / slot, telemetry counters and
        histogram counts, stats_snapshot deltas and fault consults."""
        kw = dict(PARITY_CASES[case], overlap=overlap)
        jeng, teng, jt, tt = _tel_engines(**kw)
        specs = {"serve.pool_pressure": dict(action="trigger", after=1,
                                             prob=0.5, count=4)}
        res = []
        for eng, faults in ((jeng, jfaults), (teng, tfaults)):
            plan = _recording_plan(faults, specs, seed=5)
            s0 = eng.stats_snapshot()
            with faults.inject(plan):
                toks = _traffic(eng, seed=2, news=(9, 6))
            assert plan.fired("serve.pool_pressure") >= 1
            res.append((toks, plan.log, eng.stats_snapshot().delta(s0)))
        (tj, lj, dj), (tt_, lt, dt) = res
        assert tt_ == tj
        assert lt == lj and any(p == "serve.pool_pressure" for p, _ in lt)
        common = (set(dj) & set(dt)) - {"window_s"}
        assert {k: dt[k] for k in common} == {k: dj[k] for k in common}
        for rid in range(6):
            assert tt.tracer.get(rid).names() == jt.tracer.get(rid).names()
        assert _flight(tt) == _flight(jt)
        assert _metric_counts(tt) == _metric_counts(jt)
        if case == "tight_pool":
            assert teng.preemptions > 0
        # the utilization report lists the same phases the same number of
        # times (the JAX engine adds its dispatch-thread waits)
        pj = {k: v["count"] for k, v in
              jt.utilization_report()["per_phase"].items()
              if k != "overlap_join_sync"}
        pt = {k: v["count"] for k, v in
              tt.utilization_report()["per_phase"].items()}
        assert pt == pj

    @pytest.mark.parametrize("kw", [dict(prefill_chunk=8),
                                    dict(speculative=2, prefill_chunk=8)],
                             ids=["chunked", "spec"])
    def test_timestamps_match_jax_under_one_fake_clock(self, kw):
        """Synchronous engines read the clock at the same points: after
        the same warm-up (the JAX engine's compiles happen there), both
        clocks are set to one value and every recorded event, flight entry,
        memory row, histogram and report is equal, timestamps included."""
        jeng, teng, jt, tt = _tel_engines(clock=True, **kw)
        for eng in (jeng, teng):
            _traffic(eng, seed=2)
            eng.release_cache()
        for tel in (jt, tt):
            tel.reset_window()
        jt.clock.t = tt.clock.t = 1000.0
        since = {t: t.flight.events()[-1]["seq"] for t in (jt, tt)}
        toks = [_traffic(eng, seed=3) for eng in (jeng, teng)]
        assert toks[1] == toks[0]
        for rid in range(6, 12):
            assert tt.tracer.get(rid).events == jt.tracer.get(rid).events
        fj = [e for e in jt.flight.events() if e["seq"] > since[jt]]
        ft = [e for e in tt.flight.events() if e["seq"] > since[tt]]
        assert [{k: v for k, v in e.items() if k != "seq"} for e in ft] \
            == [{k: v for k, v in e.items() if k != "seq"} for e in fj]
        rows = lambda t: [{k: v for k, v in r.items() if k != "seq"}  # noqa
                          for r in t.memory.rows()]
        assert rows(tt) == rows(jt)
        sj, st = jt.registry.snapshot(), tt.registry.snapshot()
        for name in ("serve.ttft_s", "serve.tpot_s", "serve.e2e_s",
                     "serve.queue_s", "engine.phase.decode_dispatch_s",
                     "engine.phase.decode_sync_s", "engine.phase.sched_s"):
            assert st[name] == sj[name], name
        assert tt.slo_report(ttft_deadline_s=20.0, window_s=50.0) \
            == jt.slo_report(ttft_deadline_s=20.0, window_s=50.0)
        for rid in range(6, 12):
            assert tobs.attribute(tt, rid).to_dict(segments=True) \
                == jobs.attribute(jt, rid).to_dict(segments=True)


# ---------------------------------------------------------------------------
# request-lifecycle tracing and the profiler bridge
# ---------------------------------------------------------------------------
class TestLifecycleTrace:
    def test_event_order_dense_prefill(self):
        teng = _port(telemetry=True)
        tel = teng.telemetry
        rid = teng.submit(_prompts(1, 6, 7, seed=1)[0], max_new_tokens=6)
        teng.run()
        names = tel.tracer.get(rid).names()
        core = [n for n in names if n in ("submitted", "queued", "admitted",
                                          "prefill_dense", "first_token",
                                          "retired")]
        assert core == ["submitted", "queued", "admitted", "prefill_dense",
                        "first_token", "retired"]
        assert "decode_dispatch" in names
        ts = [t for _, t, _ in tel.tracer.get(rid).events]
        assert ts == sorted(ts)

    def test_profiler_bridge_wraps_dispatches(self, monkeypatch):
        """profiler_bridge=True enters host annotations around the
        engine's dispatch calls; off, nothing is entered."""
        import paddle_tpu_torch.profiler as profiler
        entered = []

        class _Rec:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                entered.append(self.name)
                return self

            def __exit__(self, *exc):
                return False

        monkeypatch.setattr(profiler, "host_annotation",
                            lambda name: _Rec(name))
        teng = _port(telemetry=tobs.Telemetry(profiler_bridge=True),
                     prefill_chunk=8)
        teng.submit(_prompts(1, 20, 21, seed=5)[0], max_new_tokens=6)
        teng.run()
        assert {"serve.prefill_chunk", "serve.decode_dispatch"} \
            <= set(entered)
        entered.clear()
        teng = _port(telemetry=tobs.Telemetry())
        teng.submit(_prompts(1, 6, 7, seed=6)[0], max_new_tokens=2)
        teng.run()
        assert entered == []

    def test_bridge_spans_enclose_dispatches_in_a_torch_profile(self):
        """With the bridge on, a torch.profiler trace holds the engine's
        host spans, and the decode spans hold the attention calls the
        dispatch made (the CPU runs the plain version)."""
        from torch.profiler import ProfilerActivity, profile
        teng = _port(telemetry=tobs.Telemetry(profiler_bridge=True))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            teng.submit(_prompts(1, 6, 7, seed=7)[0], max_new_tokens=9)
            teng.run()
        evs = prof.events()
        spans = [e for e in evs if e.name == "serve.decode_dispatch"]
        assert spans and any(e.name == "serve.prefill_dense" for e in evs)
        mm = [e for e in evs if e.name in ("aten::mm", "aten::matmul",
                                           "aten::bmm", "aten::einsum")]
        inside = [e for e in mm if any(
            s.time_range.start <= e.time_range.start
            and e.time_range.end <= s.time_range.end for s in spans)]
        assert inside, "no model product ran inside a decode span"


# ---------------------------------------------------------------------------
# utilization: the host / device step decomposition
# ---------------------------------------------------------------------------
class TestUtilization:
    @pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
    def test_decomposition_is_disjoint_and_complete(self, overlap):
        teng = _port(telemetry=True, prefill_chunk=8, overlap=overlap)
        tel = teng.telemetry
        teng.submit(_prompts(1, 13, 14, seed=15)[0], max_new_tokens=4)
        teng.run()
        tel.reset_window()
        t0 = time.perf_counter()
        for p, n in zip(_prompts(3, 5, 20, seed=16), (5, 4, 6)):
            teng.submit(p, max_new_tokens=n)
        teng.run()
        dt = time.perf_counter() - t0
        u = tel.utilization_report(window_s=dt)
        assert u["steps"] >= 1
        total = (u["host_busy_s"] + u["dispatch_s"] + u["device_wait_s"]
                 + u["gap_s"])
        assert total == pytest.approx(dt, rel=0.02)
        fsum = (u["host_busy_frac"] + u["dispatch_frac"]
                + u["device_wait_frac"] + u["gap_frac"])
        assert fsum == pytest.approx(1.0, abs=0.01)
        assert 0.0 <= u["device_idle_frac_est"] <= 1.0
        pre = "overlap" if overlap else "decode"
        assert {"sched", f"{pre}_dispatch", f"{pre}_sync", f"{pre}_record",
                "prefill_chunk"} <= set(u["per_phase"])
        assert "overlap_join_sync" not in u["per_phase"]
        assert u["per_phase"]["sched"]["count"] == u["steps"]
        phase_sum = sum(p["total_s"] for p in u["per_phase"].values())
        assert phase_sum == pytest.approx(
            u["host_busy_s"] + u["dispatch_s"] + u["device_wait_s"],
            abs=1e-4)

    def test_sched_subtracts_nested_prefill_dispatch(self):
        """A dense prefill runs inside admission: under a fake clock the
        sched histogram holds the span less the nested dispatch."""
        _, teng, _, tel = _tel_engines(clock=True)
        for p in _prompts(4, 9, 10, seed=17):
            teng.submit(p, max_new_tokens=2)
        teng.run()
        u = tel.utilization_report()
        spans = [(a, b, at) for n, a, b, at in tel.tracer._engine
                 if n == "sched"]
        nested = sum(at["nested_dispatch_s"] for _, _, at in spans)
        assert nested > 0
        assert u["per_phase"]["sched"]["total_s"] == pytest.approx(
            sum(b - a for a, b, _ in spans) - nested)

    def test_window_report_resets(self):
        teng = _port(telemetry=True)
        tel = teng.telemetry
        teng.submit(_prompts(1, 5, 6, seed=18)[0], max_new_tokens=3)
        teng.run()
        assert tel.utilization_report()["steps"] >= 1
        tel.reset_window()
        u = tel.utilization_report(window_s=1.0)
        assert u["steps"] == 0 and u["host_busy_s"] == 0.0
        assert u["gap_frac"] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the memory observatory
# ---------------------------------------------------------------------------
class TestMemoryObservatory:
    def test_per_step_series_and_report(self):
        teng = _port(telemetry=True, prefill_chunk=8)
        tel = teng.telemetry
        teng.submit(_prompts(1, 13, 14, seed=19)[0], max_new_tokens=4)
        teng.run()
        rows = tel.memory.rows()
        assert len(rows) == teng._step_seq
        for row in rows:
            assert 0.0 <= row["occupancy_frac"] <= 1.0
            assert 0.0 <= row["fragmentation_frac"] <= 1.0
            assert row["free_pages"] + row["allocated_pages"] \
                == row["total_pages"]
            assert row["referenced"] >= row["allocated_pages"]
            assert row["pool_capacity_bytes"] \
                == row["total_pages"] * teng.page_bytes
            assert "device_bytes_in_use" not in row   # the CPU: None
        assert rows[-1]["cache_page_refs"] > 0 and rows[-1]["active"] == 0
        rep = tel.memory_report(teng.stats())
        assert rep["samples"] == len(rows) and rep["last"] == rows[-1]
        assert rep["peak_occupancy_frac"] >= rows[-1]["occupancy_frac"]
        assert rep["min_free_pages"] <= rows[-1]["free_pages"]
        assert rep["prefix_cache"]["executed_tokens"] > 0
        snap = tel.registry.snapshot()
        assert snap["mem.pool_free_pages"] == rows[-1]["free_pages"]
        assert snap["mem.pool"]["count"] == len(rows)

    def test_device_bytes_is_the_allocator_counter_on_a_card_engine(
            self, monkeypatch):
        """A CUDA engine's rows carry torch.cuda.memory_allocated (an
        allocator counter: no sync); the CPU carries none."""
        tel = tobs.Telemetry()
        cpu = type("E", (), {"device": torch.device("cpu")})()
        card = type("E", (), {"device": torch.device("cuda", 0)})()
        monkeypatch.setattr(torch.cuda, "memory_allocated",
                            lambda dev=None: 12345)
        assert tel._device_bytes(cpu) is None
        assert tel._device_bytes(card) == 12345

    def test_pool_pressure_dump_includes_occupancy_ramp(self):
        teng = _port(telemetry=True)
        tel = teng.telemetry
        ps = _prompts(2, 5, 10, seed=20)
        teng.submit(ps[0], max_new_tokens=6)
        with tfaults.inject({"serve.pool_pressure": dict(action="trigger",
                                                         count=1)}):
            teng.submit(ps[1], max_new_tokens=4)
            teng.run()
        dump = next(d for d in tel.flight.dumps
                    if d["reason"] == "injected_fault")
        ramp = dump["extra"]["memory_ramp"]
        assert ramp and all("occupancy_frac" in r and "free_pages" in r
                            for r in ramp)
        assert [r["seq"] for r in ramp] == sorted(r["seq"] for r in ramp)
        json.dumps(dump)

    def test_chrome_export_has_counter_tracks(self):
        teng = _port(telemetry=True)
        teng.submit(_prompts(1, 6, 7, seed=21)[0], max_new_tokens=4)
        teng.run()
        data = teng.telemetry.tracer.to_chrome_trace()
        cevs = [e for e in data["traceEvents"] if e.get("ph") == "C"]
        assert {"pagepool.pages", "engine.load"} <= {e["name"] for e in cevs}
        pool = [e for e in cevs if e["name"] == "pagepool.pages"]
        assert len(pool) == teng._step_seq
        for e in pool:
            assert set(e["args"]) == {"used", "free", "cached"}
        json.dumps(data)

    def test_reset_window_drops_series(self):
        teng = _port(telemetry=True)
        tel = teng.telemetry
        teng.submit(_prompts(1, 5, 6, seed=22)[0], max_new_tokens=3)
        teng.run()
        assert tel.memory_report()["samples"] > 0
        tel.reset_window()
        rep = tel.memory_report()
        assert rep["samples"] == 0 and rep["last"] is None
        assert rep["peak_occupancy_frac"] is None


# ---------------------------------------------------------------------------
# compile accounting: a CUDA-graph capture is the port's compile
# ---------------------------------------------------------------------------
class _StandInGraph:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    dispatch function again (what replaying its capture does)."""

    def __init__(self, cap):
        self.cap = cap

    def replay(self):
        self.cap.out = self.cap.fn()


class TestCompileAccounting:
    def test_each_capture_recorded_once_then_steady_state_adds_none(
            self, monkeypatch):
        """With the capture stood in (the CPU has no CUDA graphs), each
        dispatch variant reports one compile with its wall seconds, the
        report agrees with jit_variants(), and the same traffic again
        captures nothing."""
        def capture(self):
            self.graph, self.out = _StandInGraph(self), None
            self.added = [0] * len(tpaged._COUNTED)

        monkeypatch.setattr(tpaged._Captured, "_capture", capture)
        teng = _port(succ=True, telemetry=True, speculative=2)
        teng._graph_pool = object()        # take the capturing path
        tel = teng.telemetry
        ps = _spec_prompts()
        ref = _port(succ=True, speculative=2)
        rids = [ref.submit(p, max_new_tokens=9) for p in ps]
        ref_toks = [ref.run()[r].generated for r in rids]
        rids = [teng.submit(p, max_new_tokens=9) for p in ps]
        done = teng.run()
        assert [done[r].generated for r in rids] == ref_toks
        rep = tel.compile_report()
        assert rep["per_fn"].keys() == {"decode_step", "verify_step"}
        assert rep["total_compiles"] == sum(teng.jit_variants().values()) \
            == 2
        assert rep["compile_s_total"] > 0.0
        compiles = [e for e in tel.flight.events() if e["event"] == "compile"]
        assert len(compiles) == rep["total_compiles"]
        assert all(e["dur_s"] > 0 for e in compiles)
        snap = tel.registry.snapshot()
        assert snap["engine.compiles"] == rep["total_compiles"]
        assert snap["engine.compile_s"]["count"] == rep["total_compiles"]
        for p in ps:
            teng.submit(p, max_new_tokens=9)
        teng.run()
        assert tel.compile_report()["total_compiles"] == 2

    def test_cpu_engine_captures_nothing(self):
        teng = _port(telemetry=True)
        teng.submit(_prompts(1, 5, 6, seed=23)[0], max_new_tokens=3)
        teng.run()
        assert teng.telemetry.compile_report()["total_compiles"] == 0
        assert teng.jit_variants()["decode_step"] == 1


