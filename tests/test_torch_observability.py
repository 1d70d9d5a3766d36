"""Port parity: paddle_tpu_torch's observability plane (metrics, gauge
series, EngineStats, the flight recorder, the Chrome-trace export, SLO
reports, the utilization and memory reports, capture accounting) and the
ServingEngine's telemetry, against the JAX package's on the CPU.

The metric primitives take the same observations in both packages and
must read out the same values.  The engines are
``tests/test_torch_serving.py``'s pair (margin-engineered weights, the JAX
engine with ``attention_impl="ref"``): on the same traffic, with and
without ``overlap``, they must record the same lifecycle events per
request, the same flight-recorder kinds with their ``rid`` / ``slot``
fields, the same telemetry counters and histogram counts, the same
``stats_snapshot().delta`` over the keys both engines have and the same
fault consults.  Under one injected fake clock, after both engines ran
the same warm-up traffic, the synchronous engines record every timestamp
equal too.  Two known differences are excluded by name: the JAX engine's
compile events (jit compile-cache misses; the port's counterpart is a
CUDA-graph capture, which the CPU never takes) and its
``overlap_join_sync`` phase (the wait on its dispatch thread, which the
port does not have)."""
import json
import time

import numpy as np
import pytest
import torch

from test_torch_serving import (_engines, _jax_plain_dispatch,  # noqa: F401
                                _models, _port_engines_stay_consistent,
                                _prompts, _spec_prompts)
from paddle_tpu import observability as jobs
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.resilience import faults as tfaults

rng = np.random.default_rng(17)
OBS = pytest.mark.parametrize("obs", [jobs, tobs], ids=["jax", "torch"])
# names only the JAX engine records (module docstring)
JAX_ONLY_FLIGHT = {"compile"}
JAX_ONLY_METRICS = {"engine.compile_s", "engine.compiles",
                    "engine.phase.overlap_join_sync_s"}


class _FakeClock:
    """Deterministic injectable clock: each call advances by `tick`."""

    def __init__(self, start=100.0, tick=0.5):
        self.t = start
        self.tick = tick

    def __call__(self):
        t = self.t
        self.t += self.tick
        return t


def _port(kv_heads=4, succ=False, **kw):
    """The port's engine of the pair alone."""
    _, tp, _, tcfg = _models(kv_heads, succ)
    return tpaged.ServingEngine(tp, tcfg, device="cpu", **dict(
        dict(num_slots=3, page_size=4, prompt_bucket=16, decode_horizon=4),
        **kw))


def _tel_engines(clock=False, **kw):
    """The engine pair with a Telemetry each (on a fake clock each when
    ``clock``)."""
    jt = jobs.Telemetry(clock=_FakeClock()) if clock else jobs.Telemetry()
    tt = tobs.Telemetry(clock=_FakeClock()) if clock else tobs.Telemetry()
    jeng, teng = _engines(**dict(kw, telemetry=None))
    for eng, tel in ((jeng, jt), (teng, tt)):
        eng.telemetry, eng._clock = tel, tel.clock
    return jeng, teng, jt, tt


def _traffic(eng, seed, n=6, news=(7, 5)):
    """Four requests, two steps, two more requests, run to completion."""
    ps = _prompts(n, 3, 30, seed=seed)
    rids = [eng.submit(p, max_new_tokens=news[0]) for p in ps[:4]]
    eng.step()
    eng.step()
    rids += [eng.submit(p, max_new_tokens=news[1]) for p in ps[4:]]
    done = eng.run()
    return [list(done[r].generated) for r in rids]


def _flight(tel, since=0):
    return [(e["event"], e.get("rid"), e.get("slot"))
            for e in tel.flight.events()
            if e["seq"] > since and e["event"] not in JAX_ONLY_FLIGHT]


def _metric_counts(tel):
    """{name: counter value or histogram count} over the registry, the
    JAX-only names left out."""
    out = {}
    for name, v in tel.registry.snapshot().items():
        if name in JAX_ONLY_METRICS or name == "at":
            continue
        out[name] = v["count"] if isinstance(v, dict) else v
    return out


class _Recording:
    """Mixin for a FaultPlan that logs every consult as (point, ctx)."""

    def consult(self, point, ctx):
        self.log.append((point, dict(ctx)))
        return super().consult(point, ctx)


def _recording_plan(faults, specs, seed=0):
    cls = type("RecordingPlan", (_Recording, faults.FaultPlan), {})
    plan = cls(specs, seed=seed)
    plan.log = []
    return plan


# ---------------------------------------------------------------------------
# metrics primitives
# ---------------------------------------------------------------------------
class TestMetrics:
    def test_counter_monotonic(self):
        c = tobs.Counter("x")
        c.inc()
        c.inc(3)
        assert c.value == 4
        with pytest.raises(ValueError, match="cannot decrease"):
            c.inc(-1)
        assert c.value == 4

    def test_gauge_last_value(self):
        g, gj = tobs.Gauge("g"), jobs.Gauge("g")
        for v in (3, 1.5):
            g.set(v)
            gj.set(v)
        assert g.to_value() == gj.to_value() == 1.5

    def test_histogram_quantiles_match_jax_and_numpy(self):
        """The same observations read out the same quantiles, sums and
        buckets in both packages, within the bucket width of numpy's."""
        vals = rng.lognormal(mean=-4.0, sigma=1.0, size=2000)
        hj, ht = jobs.Histogram("lat"), tobs.Histogram("lat")
        for v in vals:
            hj.observe(v)
            ht.observe(v)
        for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
            assert ht.quantile(q) == hj.quantile(q)
        for q in (50, 95, 99):
            want = float(np.percentile(vals, q))
            assert abs(ht.quantile(q / 100) - want) / want < 0.11
        assert ht.to_value() == hj.to_value()
        assert ht.cumulative_buckets() == hj.cumulative_buckets()
        assert ht.count == 2000
        assert ht.min == vals.min() and ht.max == vals.max()
        np.testing.assert_allclose(ht.total, vals.sum(), rtol=1e-9)

    def test_histogram_single_sample_is_exact(self):
        h = tobs.Histogram("one")
        h.observe(0.0421)
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert h.quantile(q) == pytest.approx(0.0421)
        d = h.to_value()
        assert d["count"] == 1 and d["p50"] == pytest.approx(0.0421)

    def test_histogram_empty_and_fraction_below(self):
        h, hj = tobs.Histogram("e"), jobs.Histogram("e")
        assert h.quantile(0.5) == 0.0
        assert h.fraction_below(1.0) == 0.0
        for v in (0.001, 0.01, 0.1, 1.0):
            h.observe(v)
            hj.observe(v)
        assert h.fraction_below(10.0) == 1.0
        assert h.fraction_below(1e-6) == 0.0
        assert 0.25 <= h.fraction_below(0.02) <= 0.75
        for x in (1e-6, 0.0005, 0.005, 0.02, 0.3, 1.0, 7.0):
            assert h.fraction_below(x) == hj.fraction_below(x)

    def test_histogram_merge_and_reset(self):
        a, b = tobs.Histogram("a"), tobs.Histogram("b")
        ja, jb = jobs.Histogram("a"), jobs.Histogram("b")
        for v in (0.1, 0.2, 0.4):
            a.observe(v)
            ja.observe(v)
        for v in (0.05, 3.0):
            b.observe(v)
            jb.observe(v)
        assert a.merge_from(b).to_value() == ja.merge_from(jb).to_value()
        with pytest.raises(ValueError, match="layouts differ"):
            a.merge_from(tobs.Histogram("c", growth=1.2))
        a.reset()
        assert a.count == 0 and a.quantile(0.5) == 0.0

    def test_registry_get_or_create_and_type_conflict(self):
        r = tobs.MetricsRegistry()
        c = r.counter("serve.x")
        assert r.counter("serve.x") is c
        with pytest.raises(TypeError, match="already registered"):
            r.gauge("serve.x")
        assert "serve.x" in r

    @OBS
    def test_registry_snapshot_with_injectable_clock(self, obs):
        clk = _FakeClock(start=50.0, tick=1.0)
        r = obs.MetricsRegistry(clock=clk)
        r.counter("c").inc(7)
        r.gauge("g").set(2.5)
        r.histogram("h").observe(0.25)
        snap = r.snapshot()
        assert snap["c"] == 7 and snap["g"] == 2.5
        assert snap["h"]["count"] == 1
        assert snap["at"] == 50.0           # first clock read, deterministic
        assert r.snapshot()["at"] == 51.0   # ticks advance

    def test_registry_freeze_refuses_new_metrics_off_the_main_thread(self):
        import threading
        r = tobs.MetricsRegistry()
        h = r.histogram("h")
        r.freeze()
        errs = []

        def worker():
            h.observe(1.0)                  # existing metrics stay legal
            try:
                r.counter("new")
            except RuntimeError as e:
                errs.append(str(e))

        th = threading.Thread(target=worker)
        th.start()
        th.join()
        assert errs and "frozen" in errs[0] and h.count == 1
        r.counter("main")                   # the main thread may still


# ---------------------------------------------------------------------------
# gauge time series
# ---------------------------------------------------------------------------
class TestGaugeSeries:
    def test_sampling_matches_jax_under_injectable_clock(self):
        rows = {}
        for obs in (jobs, tobs):
            clk = _FakeClock(start=10.0, tick=0.25)
            r = obs.MetricsRegistry(clock=clk)
            s = r.series("mem.pool", capacity=8)
            assert r.series("mem.pool") is s          # get-or-create
            for i in range(20):
                s.sample(clk(), free=64 - i, occupancy_frac=i / 64)
            assert len(s) == 8 and s.total_samples == 20
            rows[obs] = s.rows()
            s.reset()
            assert len(s) == 0 and s.sample(clk(), free=1)["seq"] == 21
            assert s.to_value()["count"] == 1
        assert rows[tobs] == rows[jobs]
        assert [r["seq"] for r in rows[tobs]] == list(range(13, 21))
        ts = [r["t"] for r in rows[tobs]]
        assert ts == sorted(ts)

    def test_value_normalization_and_minmax(self):
        s = tobs.GaugeSeries("m")
        s.sample(1.0, free=np.int32(7), occ=np.float64(0.5), flag=True,
                 label="x", none=None)
        row = s.last
        assert row["free"] == 7 and type(row["free"]) is int
        assert row["occ"] == 0.5 and type(row["occ"]) is float
        assert row["flag"] is True and row["label"] == "x"
        assert row["none"] is None
        json.dumps(row)                           # flight-dump JSON-safe
        s.sample(2.0, free=3, occ=0.9)
        assert s.field_minmax("free") == (3, 7)
        assert s.field_minmax("occ") == (0.5, 0.9)
        assert s.field_minmax("label") is None    # non-numeric
        assert s.tail(1) == [s.last] and s.tail(0) == []

    def test_registry_type_conflict(self):
        r = tobs.MetricsRegistry()
        r.series("x")
        with pytest.raises(TypeError, match="already registered"):
            r.histogram("x")


# ---------------------------------------------------------------------------
# EngineStats snapshot / delta
# ---------------------------------------------------------------------------
class TestEngineStats:
    @OBS
    def test_capture_flattens_nested(self, obs):
        s = obs.EngineStats.capture({"a": 1, "nested": {"x": 2, "y": 3},
                                     "rate": 0.5}, clock=lambda: 9.0)
        assert s["a"] == 1 and s["nested.x"] == 2 and s["rate"] == 0.5
        assert s.at == 9.0
        assert "rate" not in s.counters()     # ratios are not counters

    @pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
    def test_delta_matches_jax_per_window(self, overlap):
        jeng, teng = _engines(overlap=overlap)
        p = _prompts(2, 6, 12, seed=4)
        deltas = []
        for eng in (jeng, teng):
            eng.submit(p[0], max_new_tokens=5)
            eng.run()
            s1 = eng.stats_snapshot()
            eng.submit(p[0], max_new_tokens=7)
            eng.submit(p[1][:3], max_new_tokens=4)
            eng.run()
            s2 = eng.stats_snapshot()
            d = s2.delta(s1)
            assert d["tokens_generated"] == 7 + 4   # exactly this window
            assert d["window_s"] > 0
            assert all(v >= 0 for k, v in d.items() if k != "window_s")
            zero = s2.delta(s2)
            assert all(v == 0 for k, v in zero.items() if k != "window_s")
            deltas.append(d)
        dj, dt = deltas
        common = (set(dj) & set(dt)) - {"window_s"}
        assert {"tokens_generated", "decode_steps", "cache_hits",
                "prefill_tokens_executed", "overlap_steps"} <= common
        assert {k: dt[k] for k in common} == {k: dj[k] for k in common}

    def test_stats_monotonic_across_full_serving_trace(self):
        """Counters never decrease at any step boundary of a trace that
        exercises the prefix cache, chunked prefill and speculation."""
        _, tp, _, tcfg = _models(4, succ=True)
        eng = tpaged.ServingEngine(tp, tcfg, device="cpu", num_slots=2,
                                   page_size=4, prompt_bucket=8,
                                   decode_horizon=4, prefill_chunk=8,
                                   speculative=2)
        for t, n in ((14, 6), (9, 4), (22, 8), (14, 5)):
            eng.submit(rng.integers(1, 256, (t,)).astype(np.int32),
                       max_new_tokens=n)
        prev = eng.stats_snapshot()
        while eng.num_active or eng._queue:
            eng.step()
            cur = eng.stats_snapshot()
            pc = prev.counters()
            for k, v in cur.counters().items():
                assert v >= pc.get(k, 0), f"counter {k} decreased"
            prev = cur

    def test_delta_window_containing_preemption_and_reprefill(self):
        """A pool-pressure window preempts and re-prefills on both engines:
        the window's deltas agree and count the re-prefill."""
        kw = dict(num_slots=2, page_size=2, num_pages=40,
                  max_pages_per_seq=16, prompt_bucket=8, decode_horizon=2)
        jeng, teng = _engines(**kw)
        prompts = _prompts(3, 3, 8, seed=31)
        out = []
        for eng, faults in ((jeng, jfaults), (teng, tfaults)):
            s0 = eng.stats_snapshot()
            with faults.inject({"serve.pool_pressure": dict(
                    action="trigger", after=1, count=3)}):
                rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
                done = eng.run()
            s1 = eng.stats_snapshot()
            d = s1.delta(s0)
            assert d["preemptions"] == eng.preemptions >= 1
            fresh = sum(len(p) for p in prompts)
            assert d["prefill_tokens_executed"] + d["cached_prefix_tokens"] \
                > fresh
            assert d["tokens_generated"] == 8 * 3
            z = eng.stats_snapshot().delta(s1)
            assert all(v == 0 for k, v in z.items() if k != "window_s")
            out.append(([done[r].generated for r in rids], d))
        (gj, dj), (gt, dt) = out
        assert gt == gj
        common = (set(dj) & set(dt)) - {"window_s"}
        assert {k: dt[k] for k in common} == {k: dj[k] for k in common}


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
# Chrome-trace export
# ---------------------------------------------------------------------------
class TestChromeTrace:
    def test_export_valid_json_with_nested_spans(self, tmp_path):
        teng = _port(telemetry=True, prefill_chunk=8)
        tel = teng.telemetry
        for p, n in zip(_prompts(2, 6, 20, seed=8), (4, 5)):
            teng.submit(p, max_new_tokens=n)
        teng.run()
        out = tmp_path / "serve_trace.json"
        tel.tracer.export_chrome(str(out))
        data = json.loads(out.read_text())
        evs = data["traceEvents"]
        assert data["displayTimeUnit"] == "ms"
        assert any(e.get("ph") == "M" and e.get("name") == "process_name"
                   for e in evs)
        by_tid = {}
        for e in evs:
            if e.get("ph") == "X":
                by_tid.setdefault(e["tid"], []).append(e)
        req_tids = [tid for tid, es in by_tid.items()
                    if any(e["name"].startswith("request") for e in es)]
        assert len(req_tids) == 2
        eps = 0.01
        for tid in req_tids:
            spans = by_tid[tid]
            parent = next(e for e in spans
                          if e["name"].startswith("request"))
            p0, p1 = parent["ts"], parent["ts"] + parent["dur"]
            children = [e for e in spans if e is not parent]
            assert children
            for c in children:
                assert c["ts"] >= p0 - eps, (c["name"], c["ts"], p0)
                assert c["ts"] + c.get("dur", 0) <= p1 + eps, c["name"]
            phase_names = {c["name"] for c in children}
            assert "queued" in phase_names and "decode" in phase_names
        engine_spans = {e["name"] for e in by_tid.get(0, [])}
        assert "step" in engine_spans and "decode_dispatch" in engine_spans
        for e in evs:
            if e.get("ph") == "i":
                assert "ts" in e and e.get("s") == "t"

    def test_export_equals_jax_under_one_fake_clock(self):
        jeng, teng, jt, tt = _tel_engines(clock=True)
        p = _prompts(1, 6, 7, seed=9)[0]
        for eng in (jeng, teng):          # warm-up: the JAX compiles (a
            for _ in range(2):            # dense prefill, then a cache hit)
                eng.submit(p, max_new_tokens=6)
                eng.run()
        jt.clock.t = tt.clock.t = 500.0
        jt.tracer._engine.clear()
        tt.tracer._engine.clear()
        jt.tracer._counters.clear()
        tt.tracer._counters.clear()
        for eng in (jeng, teng):
            eng.submit(p, max_new_tokens=6)
            eng.run()

        def body(tel):
            return [e for e in tel.tracer.to_chrome_trace()["traceEvents"]
                    if e.get("name") != "process_name"
                    and e.get("args", {}).get("rid") not in (0, 1)
                    and e.get("tid") not in (1, 2)]
        assert body(tt) == body(jt)

    def test_inflight_request_exports_cleanly(self):
        teng = _port(telemetry=True)
        teng.submit(_prompts(1, 6, 7, seed=10)[0], max_new_tokens=8)
        teng.step()
        data = teng.telemetry.tracer.to_chrome_trace()
        assert any(e["name"].startswith("request")
                   for e in data["traceEvents"] if e.get("ph") == "X")
        teng.run()


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
class TestFlightRecorder:
    def test_ring_is_bounded_with_continuous_seq(self):
        dumps = []
        for obs in (jobs, tobs):
            fr = obs.FlightRecorder(capacity=8, clock=_FakeClock())
            for i in range(20):
                fr.record("e", i=i)
            assert len(fr) == 8
            assert [e["seq"] for e in fr.events()] == list(range(13, 21))
            d = fr.dump("test", note="x")
            assert d["total_events"] == 20 and len(d["events"]) == 8
            assert "note" in d["extra"]
            assert "flight-recorder dump: test" \
                in obs.FlightRecorder.format_dump(d)
            dumps.append((d, obs.FlightRecorder.format_dump(d)))
        assert dumps[1] == dumps[0]

    def test_dump_history_bounded_and_dump_path(self, tmp_path):
        path = tmp_path / "dumps.jsonl"
        fr = tobs.FlightRecorder(capacity=4, max_dumps=3,
                                 dump_path=str(path))
        for i in range(6):
            fr.record("e")
            fr.dump(f"r{i}")
        assert len(fr.dumps) == 3
        assert fr.last_dump()["reason"] == "r5"
        lines = path.read_text().splitlines()
        assert [json.loads(x)["reason"] for x in lines] \
            == [f"r{i}" for i in range(6)]

    def test_dump_fires_on_engine_stalled(self):
        """A never-clearing pool-pressure window stalls both engines; the
        EngineStalledError dump carries the no-progress steps."""
        jeng, teng, jt, tt = _tel_engines()
        out = []
        for eng, faults, tel in ((jeng, jfaults, jt), (teng, tfaults, tt)):
            with faults.inject({"serve.pool_pressure": dict(
                    action="trigger", count=None)}):
                eng.submit(_prompts(1, 5, 6, seed=11)[0], max_new_tokens=4)
                with pytest.raises(Exception, match="no engine progress"):
                    eng.run(max_stall_steps=5)
            dump = tel.flight.last_dump()
            assert dump["reason"] == "engine_stalled"
            assert dump["extra"]["stalled_steps"] == 5
            steps = [e for e in dump["events"] if e["event"] == "step"]
            assert steps and all(not s["progressed"] for s in steps)
            assert any(d["reason"] == "injected_fault"
                       for d in tel.flight.dumps)
            out.append([d["reason"] for d in tel.flight.dumps])
            eng.run()                   # the fault cleared: it completes
        assert out[1] == out[0]

    def test_dump_fires_on_preemption_storm(self):
        kw = dict(num_slots=2, page_size=2, num_pages=40,
                  max_pages_per_seq=16, prompt_bucket=8, decode_horizon=2)
        jeng, teng = _engines(**kw)
        reasons = []
        for eng, obs, faults in ((jeng, jobs, jfaults),
                                 (teng, tobs, tfaults)):
            tel = obs.Telemetry(storm_threshold=2, storm_window=32)
            eng.telemetry, eng._clock = tel, tel.clock
            with faults.inject({"serve.pool_pressure": dict(
                    action="trigger", after=1, count=4)}):
                for p in _prompts(3, 3, 8, seed=12):
                    eng.submit(p, max_new_tokens=8)
                eng.run()
            assert eng.preemptions >= 2
            storm = [d for d in tel.flight.dumps
                     if d["reason"] == "preemption_storm"]
            assert storm and storm[0]["extra"]["preemptions_in_window"] >= 2
            reasons.append([(d["reason"], d.get("extra", {}).get("step"))
                            for d in tel.flight.dumps])
        assert reasons[1] == reasons[0]


# ---------------------------------------------------------------------------
# telemetry off is a no-op
# ---------------------------------------------------------------------------
class TestTelemetryNoop:
    def test_off_by_default_and_tokens_equal_on_vs_off(self):
        off = _port()
        assert off.telemetry is None
        assert _port(telemetry=False).telemetry is None
        on = _port(telemetry=True)
        assert isinstance(on.telemetry, tobs.Telemetry)
        got = [_traffic(eng, seed=13) for eng in (off, on)]
        assert got[0] == got[1]
        assert on.jit_variants() == off.jit_variants()
        assert len(on.telemetry.tracer.traces()) == 6
        assert on.telemetry.registry.snapshot()[
            "serve.requests_retired"] == 6
        assert on.telemetry.flight.event_names()[0] == "submit"


# ---------------------------------------------------------------------------
# SLO report
# ---------------------------------------------------------------------------
class TestSLO:
    SUMMARIES = [
        {"rid": 0, "tokens": 10, "ttft_s": 0.05, "tpot_s": 0.01,
         "e2e_s": 0.2, "timed_out": False, "at": 1.0},
        {"rid": 1, "tokens": 20, "ttft_s": 0.50, "tpot_s": 0.01,
         "e2e_s": 0.8, "timed_out": False, "at": 2.0},
        {"rid": 2, "tokens": 5, "ttft_s": 0.01, "tpot_s": 0.02,
         "e2e_s": 0.1, "timed_out": True, "at": 3.0},
    ]

    def test_goodput_counts_only_on_time_requests(self):
        rep = tobs.slo_report(self.SUMMARIES, ttft_deadline_s=0.1,
                              window_s=2.0)
        assert rep == jobs.slo_report(self.SUMMARIES, ttft_deadline_s=0.1,
                                      window_s=2.0)
        assert rep["requests"] == 3 and rep["on_time_requests"] == 1
        assert rep["goodput_fraction"] == pytest.approx(1 / 3, abs=1e-4)
        assert rep["total_tokens"] == 35 and rep["goodput_tokens"] == 10
        assert rep["goodput_tokens_per_sec"] == pytest.approx(5.0)
        for block in ("ttft", "tpot", "e2e"):
            for f in ("p50_ms", "p95_ms", "p99_ms"):
                assert f in rep[block]

    def test_percentiles_and_burn_match_jax(self):
        vals = [0.010, 0.020, 0.030, 0.040, 0.100]
        out = tobs.latency_percentiles(vals)
        assert out == jobs.latency_percentiles(vals)
        assert set(out) == {"p50_ms", "p95_ms", "p99_ms"}
        assert 15.0 <= out["p50_ms"] <= 35.0
        for kw in (dict(window_s=1.5, now=3.0), dict(window_s=10.0, now=3.0)):
            assert tobs.windowed_burn(self.SUMMARIES, 0.1, slo_target=0.9,
                                      **kw) \
                == jobs.windowed_burn(self.SUMMARIES, 0.1, slo_target=0.9,
                                      **kw)
        assert tobs.burn_rate(0.2, 0.95) == jobs.burn_rate(0.2, 0.95)

    def test_engine_slo_report_end_to_end(self):
        teng = _port(telemetry=True)
        for p, n in zip(_prompts(2, 6, 10, seed=14), (4, 6)):
            teng.submit(p, max_new_tokens=n)
        teng.run()
        rep = teng.telemetry.slo_report(ttft_deadline_s=60.0, window_s=1.0)
        assert rep["requests"] == 2 and rep["goodput_fraction"] == 1.0
        assert rep["total_tokens"] == 10
        assert rep["step_latency"]["count"] >= 1


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


def test_the_isolation_scan_covers_the_slice_modules():
    """tests/test_torch_isolation.py's scan reaches this slice's modules
    (none of which imports JAX or the JAX package)."""
    from test_torch_isolation import FORBIDDEN, _imported_roots, _port_files
    mods = ("resilience/faults.py", "resilience/checkpoint.py",
            "resilience/__init__.py", "observability/metrics.py",
            "observability/flight.py", "observability/tracing.py",
            "observability/slo.py", "observability/attribution.py",
            "observability/train.py", "observability/telemetry.py",
            "observability/__init__.py", "profiler/__init__.py",
            "distributed/checkpoint/save_state_dict.py",
            "distributed/checkpoint/load_state_dict.py",
            "serving/snapshot.py", "inference/paged.py")
    for mod in mods:
        path = next(p for p in _port_files()
                    if p.as_posix().endswith(f"paddle_tpu_torch/{mod}"))
        assert not {r for r, _ in _imported_roots(path)} & FORBIDDEN, mod
