"""Port parity: paddle_tpu_torch.observability's health sentinel, live
export and fleet-wide trace stitching / metric aggregation against the JAX
package's on the CPU.

Equal inputs give equal outputs: the same reading series through each
rule type fire and clear at the same ticks with the same alert records;
a default-rules sentinel driven by one seeded traffic scenario fires the
same rules (and stays silent on calm traffic); the engine pair of
``tests/test_torch_serving.py`` with a sentinel attached through
``Telemetry(sentinel=...)`` fires the same alerts at the same steps under
one step clock; equal registries render byte-equal Prometheus text and
JSON; equal tracers stitch into equal Chrome traces; and equal registries
merge into equal fleet snapshots and SLO reports.  The port's exporter
serves ``/metrics``, ``/healthz`` (degraded-aware), ``/alerts`` and
``/slow`` over loopback.  The one rule description that names the device
mechanism (``recompile``: a CUDA-graph capture in the port, a jit
compile-cache miss in JAX) is compared by name only."""
import json
import threading
import urllib.request

import numpy as np
import pytest

from test_torch_serving import (_engines, _jax_plain_dispatch,  # noqa: F401
                                _port_engines_stay_consistent, _prompts)

from paddle_tpu import observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.observability import health as jhealth
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.observability import health as thealth

PKGS = ((jobs, jhealth, jserving), (tobs, thealth, tserving))


class _StepClock:
    """A clock that reads the same value until the test advances it."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _strip_descriptions(report):
    out = json.loads(json.dumps(report))
    for rule in out.get("rules", {}).values():
        rule.pop("description", None)
    return out


def _rules(health, probe):
    """One rule of every type over the readings the test feeds."""
    return [
        health.AlertRule("level", sample_fn=lambda c: probe["v"],
                         threshold=10.0, clear_threshold=6.0, window_s=3.0,
                         min_samples=3, fire_frac=0.6, cooldown_s=4.0),
        health.AlertRule("low", sample_fn=lambda c: probe["v"],
                         threshold=2.0, direction="below", window_s=2.0,
                         min_samples=2, cooldown_s=1.0, arm_above=5.0),
        health.TrendRule("trend", raw_fn=lambda c: probe["q"],
                         threshold=4.0, min_value=3.0, window_s=4.0,
                         min_samples=2, fire_frac=0.5, clear_threshold=1.0,
                         cooldown_s=0.0),
        health.DeltaRule("delta", counter_fn=lambda c: probe["n"],
                         threshold=1.0, window_s=2.0, fire_frac=0.01,
                         cooldown_s=3.0),
        health.RatioDeltaRule("ratio", num_fn=lambda c: probe["h"],
                              den_fn=lambda c: probe["d"], min_den=4.0,
                              threshold=0.3, direction="below",
                              window_s=5.0, min_samples=2, cooldown_s=2.0),
    ]


class TestSentinel:
    def test_every_rule_type_fires_and_clears_like_jax(self):
        r = np.random.default_rng(0)
        ticks = 160
        v = np.where(r.uniform(size=ticks) < 0.3, r.uniform(8, 16, ticks),
                     r.uniform(0, 9, ticks))
        v[100:112] = r.uniform(0, 1.5, 12)
        q = np.cumsum(r.integers(-2, 3, ticks)).clip(0)
        n = np.cumsum(r.uniform(size=ticks) < 0.15)
        d = np.cumsum(r.integers(1, 5, ticks))
        h = np.cumsum(r.integers(0, 3, ticks)).clip(max=d)
        logs = []
        for obs, health, _ in PKGS:
            probe = {}
            clk = _StepClock()
            tel = obs.Telemetry(clock=clk, tail_k=0)
            sent = health.HealthSentinel(rules=_rules(health, probe))
            tel.attach_sentinel(sent)
            log = []
            for i in range(ticks):
                clk.t = 0.5 * i
                probe.update(v=float(v[i]), q=float(q[i]), n=float(n[i]),
                             h=float(h[i]), d=float(d[i]))
                fired = sent.evaluate(tel)
                log.append(([a.to_dict() for a in fired],
                            sorted(a.rule for a in sent.active())))
            log.append(sent.report())
            log.append([(e["event"], e.get("rule"))
                        for e in tel.flight.events()])
            log.append(tel.registry.counter("health.alerts_fired").value)
            logs.append(log)
        assert logs[1] == logs[0]
        fires = logs[1][ticks]["rules"]
        assert all(fires[name]["fires"] >= 1 for name in fires), fires
        assert any(e == "alert_cleared" for e, _ in logs[1][ticks + 1])

    def test_burn_rate_rule_matches_jax(self):
        r = np.random.default_rng(1)
        rows = [{"ttft_s": float(r.uniform(0, 2)), "timed_out": False,
                 "at": float(t)} for t in np.cumsum(r.uniform(0, 1, 120))]
        out = []
        for obs, health, _ in PKGS:
            clk = _StepClock()
            tel = obs.Telemetry(clock=clk, tail_k=0)
            sent = health.HealthSentinel(rules=[health.BurnRateRule(
                "burn", slo_ttft_s=1.0, slo_target=0.9, fast_window_s=4.0,
                slow_window_s=12.0, min_requests=3, min_samples=2,
                cooldown_s=2.0)])
            tel.attach_sentinel(sent)
            seq = []
            for row in rows:
                clk.t = row["at"]
                tel.request_summaries.append(row)
                seq.append([a.to_dict() for a in sent.evaluate(tel)])
            out.append((seq, sent.report()))
        assert out[1] == out[0]
        assert out[1][1]["fired_total"] >= 1

    @pytest.mark.parametrize("case", ["bursty", "calm", "diurnal"])
    def test_default_rules_on_seeded_traffic_match_jax(self, case):
        """The queue / occupancy trajectory of one seeded scenario fed
        through a default-rules sentinel: the same fires in the same
        order, and none on calm traffic."""
        kw = dict(vocab=64, prompt_len=(4, 8), max_new=(4, 8))
        kw.update({
            "bursty": dict(n_requests=60, arrival="bursty",
                           mean_interarrival_s=1.0, burst_every_s=8.0,
                           burst_size=14, burst_spread_s=0.5),
            "calm": dict(n_requests=60, arrival="poisson",
                         mean_interarrival_s=2.0),
            "diurnal": dict(n_requests=80, arrival="diurnal",
                            mean_interarrival_s=0.7, diurnal_period_s=40.0,
                            diurnal_amplitude=0.95)}[case])
        res = []
        for obs, health, serving in PKGS:
            sc = serving.make_scenario(case, seed=5, **kw)
            clk = _StepClock()
            tel = obs.Telemetry(clock=clk, tail_k=0)
            sent = health.HealthSentinel(
                clock=clk, slo_ttft_s=1.0, queue_window_s=4.0,
                occupancy_window_s=4.0, cooldown_s=10.0)
            tel.attach_sentinel(sent)
            arrivals = [q.arrival_s for q in sc.requests]
            i, depth, t, names = 0, 0.0, 0.0, []
            while t < arrivals[-1] + 5.0:
                t += 0.5
                clk.t = t
                while i < len(arrivals) and arrivals[i] <= t:
                    depth += 1.0
                    i += 1
                depth = max(0.0, depth - 1.2 * 0.5)
                tel.memory.sample(t, queue_depth=depth,
                                  occupancy_frac=min(1.0, 0.3 + 0.08 * depth),
                                  cache_hit_tokens=0,
                                  prefill_tokens_executed=0)
                names += [(a.rule, a.fired_at) for a in sent.evaluate(tel)]
            res.append((names, _strip_descriptions(sent.report()),
                        [(e["event"], e.get("rule"), e.get("value"))
                         for e in tel.flight.events()]))
        assert res[1] == res[0]
        if case == "calm":
            assert res[1][0] == []
        else:
            assert res[1][0]

    def test_engine_sentinel_fires_like_jax_under_one_step_clock(self):
        """Telemetry(sentinel=...) on the engine pair: a queue that grows
        past a low threshold fires ``queue_growth`` at the same step in
        both packages, the alert lands in the flight record and the
        counters, and reset_window force-clears it."""
        out = []
        jeng, teng = _engines(num_slots=2)
        for (obs, health, _), eng in zip(PKGS, (jeng, teng)):
            clk = _StepClock(100.0)
            tel = obs.Telemetry(clock=clk, sentinel=health.HealthSentinel(
                queue_growth=2.0, queue_min_depth=2.0, queue_window_s=3.0,
                cooldown_s=5.0))
            eng.telemetry, eng._clock = tel, tel.clock
            fires = []
            for k, p in enumerate(_prompts(12, 3, 12, seed=41)):
                eng.submit(p, max_new_tokens=6)
                if k % 3 == 2:
                    clk.t += 1.0
                    eng.step()
                    fires += [(a.rule, a.fired_at)
                              for a in tel.sentinel.history]
            while eng.num_active or eng._queue:
                clk.t += 1.0
                eng.step()
            alerts = [(e["event"], e.get("rule"))
                      for e in tel.flight.events()
                      if e["event"].startswith("alert")]
            act = tel.registry.gauge("health.active_alerts").value
            tel.reset_window()
            out.append((sorted(set(fires)), alerts,
                        tel.registry.counter("health.alerts_fired").value,
                        act, tel.sentinel.health()))
        assert out[1] == out[0]
        assert ("queue_growth" in [r for r, _ in out[1][0]])
        assert out[1][4]["status"] == "ok"
        for eng in (jeng, teng):
            eng.release_cache()

    def test_aggregate_alerts_and_record_shape(self):
        res = []
        for obs, health, _ in PKGS:
            probe = {"v": 20.0}
            clk = _StepClock()
            bad = health.HealthSentinel(rules=_rules(health, probe)[:1],
                                        clock=clk)
            for i in range(4):
                clk.t = float(i)
                bad.evaluate(None)
            ok = health.HealthSentinel(rules=_rules(health, {"v": 0.0})[:1],
                                       clock=_StepClock())
            agg = health.aggregate_alerts({"r0": ok, "r1": bad})
            res.append(agg)
            assert agg["status"] == "degraded" and agg["active_alerts"] == 1
        assert res[1] == res[0]
        d = thealth.Alert(rule="r", severity="warn", value=1.0,
                          threshold=2.0, fired_at=3.0).to_dict()
        assert d == jhealth.Alert(rule="r", severity="warn", value=1.0,
                                  threshold=2.0, fired_at=3.0).to_dict()
        with pytest.raises(ValueError, match="duplicate"):
            thealth.HealthSentinel(rules=_rules(thealth, {})[:1] * 2)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------
def _registry(obs, seed=0):
    r = np.random.default_rng(seed)
    reg = obs.MetricsRegistry(clock=lambda: 12.5)
    h = reg.histogram("serve.ttft_s")
    for x in r.lognormal(-4.0, 1.0, 300):
        h.observe(float(x))
    reg.histogram("engine.step_host_s").observe(0.003)
    reg.counter("serve.requests_retired").inc(int(r.integers(1, 99)))
    reg.gauge("mem.pool_occupancy_frac").set(0.375)
    reg.gauge("weird-name 1").set(2)
    s = reg.series("mem.pool", capacity=8)
    for i in range(5):
        s.sample(float(i), free_pages=10 - i, occupancy_frac=0.1 * i,
                 flag=True)
    return reg


class TestExport:
    def test_renders_byte_equal_jax(self):
        for seed in range(3):
            snaps = [obs.export_snapshot(_registry(obs, seed))
                     for obs, _h, _s in PKGS]
            assert snaps[1] == snaps[0]
            bundles = [{"r0": obs.export_snapshot(_registry(obs, seed)),
                        "r1": obs.export_snapshot(_registry(obs, seed + 9)),
                        "router": obs.export_snapshot(
                            obs.MetricsRegistry(clock=lambda: 1.0))}
                       for obs, _h, _s in PKGS]
            for obs_pair in ((snaps[0], snaps[1]),
                             (bundles[0], bundles[1])):
                assert tobs.render_prometheus(obs_pair[1]) \
                    == jobs.render_prometheus(obs_pair[0])
                assert tobs.render_json(obs_pair[1]) \
                    == jobs.render_json(obs_pair[0])
        from paddle_tpu.observability.export import prom_escape_label as je
        from paddle_tpu_torch.observability.export import (
            prom_escape_label, prom_name)
        assert prom_name("9a.b-c") == "_9a_b_c"
        assert prom_escape_label('a"b\\c\n') == je('a"b\\c\n')

    def test_exporter_endpoints(self):
        probe = {"v": 20.0}
        clk = _StepClock()
        sent = thealth.HealthSentinel(rules=_rules(thealth, probe)[:1],
                                      clock=clk)
        for i in range(4):
            clk.t = float(i)
            sent.evaluate(None)
        reg = _registry(tobs)
        ex = tobs.MetricsExporter(
            lambda: {"e": tobs.export_snapshot(reg)},
            health_fn=sent.health,
            alerts_fn=lambda: thealth.aggregate_alerts({"engine": sent}),
            slow_fn=lambda: [{"rid": 7, "e2e_s": 1.5}],
            requests_fn=lambda: [{"rid": 1}]).start()
        try:
            def get(path):
                return urllib.request.urlopen(
                    f"{ex.url}{path}").read().decode()
            assert get("/metrics") == tobs.render_prometheus(
                {"e": tobs.export_snapshot(reg)})
            assert json.loads(get("/metrics.json"))["e"][
                "serve.requests_retired"]["type"] == "counter"
            hz = json.loads(get("/healthz"))
            assert hz["status"] == "degraded" and hz["active_alerts"] == 1
            al = json.loads(get("/alerts"))
            assert al["components"]["engine"]["active"][0]["rule"] \
                == "level"
            assert json.loads(get("/slow")) == [{"rid": 7, "e2e_s": 1.5}]
            assert json.loads(get("/requests")) == [{"rid": 1}]
            with pytest.raises(urllib.error.HTTPError) as err:
                get("/nope")
            assert err.value.code == 404
            assert ex.scrapes == 2
        finally:
            ex.stop()
        bare = tobs.MetricsExporter(lambda: {"at": 0.0}).start()
        try:
            hz = json.loads(urllib.request.urlopen(
                f"{bare.url}/healthz").read().decode())
            assert hz["status"] == "ok" and hz["active_alerts"] == 0
            assert json.loads(urllib.request.urlopen(
                f"{bare.url}/alerts").read().decode())["components"] == {}
        finally:
            bare.stop()

    def test_telemetry_freeze_refuses_new_metrics_off_the_main_thread(self):
        tel = tobs.Telemetry(sentinel=thealth.HealthSentinel())
        tel.freeze()
        assert tel.registry.frozen
        errors = []

        def writer():
            try:
                tel.registry.counter("brand.new")
            except Exception as exc:    # noqa: BLE001
                errors.append(exc)
            tel.registry.counter("health.alerts_fired").inc()
        th = threading.Thread(target=writer)
        th.start()
        th.join()
        assert len(errors) == 1
        assert tel.registry.counter("health.alerts_fired").value == 1
        assert tel.sentinel.clock is tel.clock


# ---------------------------------------------------------------------------
# stitching and aggregation
# ---------------------------------------------------------------------------
def _tracers(obs, tid):
    """frontend(rid 9) -> router(rid 5) -> r0(rid 0) -> r1(rid 0), one
    unrelated router request, and an engine span on r0."""
    fe, ro, r0, r1 = (obs.Tracer() for _ in range(4))
    fe.request_event(9, "submitted", t=1.0, trace_id=tid)
    fe.request_event(9, "retired", t=9.0)
    ro.request_event(5, "submitted", t=1.1, trace_id=tid)
    ro.request_event(5, "retired", t=8.9)
    ro.request_event(77, "submitted", t=2.0, trace_id=tid + 1000)
    ro.request_event(77, "retired", t=3.0)
    r0.request_event(0, "submitted", t=1.2, trace_id=tid)
    r0.engine_span("decode_dispatch", 1.5, 2.5, k=4)
    r0.request_event(0, "retired", t=4.0)
    r1.request_event(0, "submitted", t=4.5, trace_id=tid, restored=True)
    r1.request_event(0, "retired", t=8.0)
    return (obs.TraceStitcher().add("frontend", fe).add("router", ro)
            .add("r0", r0).add("r1", r1))


class TestStitchingAndAggregation:
    def test_stitched_trace_equals_jax(self):
        tid = tobs.new_trace_id()
        assert tobs.new_trace_id() > tid
        st = [_tracers(obs, 5) for obs, _h, _s in PKGS]
        assert st[1].to_chrome_trace() == st[0].to_chrome_trace()
        assert st[1].flow_chains() == st[0].flow_chains()
        summ = st[1].summary()
        assert summ == st[0].summary()
        assert summ["max_chain"] == ["frontend", "router", "r0", "r1"]
        assert summ["requests_stitched"] == 1 and summ["flow_events"] == 4
        comps = [list(s._components) for s in st]
        paths = [m.attribution.attribute_stitched(c, 5).to_dict(
            segments=True) for (m, _h, _s), c in zip(PKGS, comps)]
        assert paths[1] == paths[0]
        assert tobs.stitched_attribution_report(comps[1]) \
            == jobs.stitched_attribution_report(comps[0])

    def test_fleet_telemetry_merge_and_slo_equal_jax(self):
        out = []
        for obs, _h, _s in PKGS:
            regs = {f"r{i}": _registry(obs, i) for i in range(3)}
            fr = obs.MetricsRegistry(clock=lambda: 3.0)
            fr.counter("frontend.offered").inc(9)
            ft = obs.FleetTelemetry(regs, frontend=fr, clock=lambda: 4.0)
            merged = ft.merged_histograms()["serve.ttft_s"]
            out.append((ft.snapshot(), ft.slo_report(0.02),
                        merged.percentiles()))
        assert out[1] == out[0]
        assert out[1][0]["merged"]["serve.ttft_s"]["count"] == 900
        assert out[1][0]["merged"]["frontend.offered"] == 9

    def test_tail_dumps_merge_like_jax(self):
        rows = []
        for obs, _h, _s in PKGS:
            recs = []
            for k in range(2):
                rec = obs.TailRecorder(k=3)
                for i in range(4):
                    rec._heap.append((float(i + k), i,
                                      {"rid": i, "e2e_s": float(i + k)}))
                recs.append((f"r{k}", rec))
            rows.append(obs.merge_tail_dumps(recs, k=4))
        assert rows[1] == rows[0]
        assert [r["e2e_s"] for r in rows[1]] == [4.0, 3.0, 3.0, 2.0]
