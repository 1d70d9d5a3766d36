"""Port parity: disaggregated prefill / decode roles, the zero-loss drain
and the elastic fleet of paddle_tpu_torch.serving against the JAX
package's on the CPU.

The drills run in both packages on the same seeded inputs
(``tests/test_torch_fleet.py``'s engine pair and drill harness): a
``roles=["prefill", "decode"]`` fleet hands every request's KV pages from
the prefill replica to the decode replica (f32 pages, and int8 pages with
their scale planes), falls back to re-prefill when the decode
replica's geometry differs, drains a replica by live migration, and an
``ElasticFleet`` grows under queue growth and drains back when idle.  The
streams, fault consults, flight kinds, router decisions, ``stats()``
(handoff counts, pages and bytes moved included) and the scale-event
timelines must be equal in both packages."""
import numpy as np
import pytest

from test_torch_fleet import (PKGS, both, common_stats, drill, factory,
                              flight_kinds)
from test_torch_observability import _FakeClock
from test_torch_serving import (_jax_plain_dispatch,  # noqa: F401
                                _port_engines_stay_consistent, _prompts)

from paddle_tpu_torch import serving as tserving

ROLES = dict(num_replicas=2, roles=["prefill", "decode"])


# ---------------------------------------------------------------------------
# disaggregated roles
# ---------------------------------------------------------------------------
class TestDisaggFleet:
    def test_roles_validation_matches_jax(self):
        def boom(role="any"):
            raise AssertionError("factory must not run on invalid roles")
        for pkg in PKGS:
            fleet_cls = PKGS[pkg][0].ReplicaFleet
            with pytest.raises(ValueError, match="one entry per replica"):
                fleet_cls(boom, num_replicas=2, roles=["prefill"])
            with pytest.raises(ValueError, match="unknown replica roles"):
                fleet_cls(boom, num_replicas=2, roles=["prefill", "verif"])
            with pytest.raises(ValueError, match="decode-capable"):
                fleet_cls(boom, num_replicas=2, roles=["prefill", "prefill"])

    @pytest.mark.parametrize("kv_dtype", [None, "int8"])
    def test_handoffs_match_jax(self, kv_dtype):
        """Every request prefills on r0 and decodes on r1 after a KV
        handoff (int8 pages carry their scale planes): equal streams,
        decisions, stats and attribution segments in both packages."""
        ps = _prompts(5, 3, 20, seed=21)
        out = both(ps, router_cls="PrefixAffinityRouter", fleet_kw=ROLES,
                   engine_kw=dict(telemetry=True, kv_dtype=kv_dtype))
        fleet = out["torch"][0]
        st = fleet.stats()
        assert st["roles"] == {"r0": "prefill", "r1": "decode"}
        assert st["handoffs"] == len(ps)
        assert st["handoff_fallbacks"] == 0 and st["handoffs_pending"] == 0
        kv = st["kv_transfer"]
        assert kv["pages"] > 0 and kv["bytes"] > 0
        assert kv["rank_local_hit_rate"] == 1.0
        routed = fleet.router.stats()["routed_by_role"]
        assert routed["prefill"] >= len(ps) and routed["decode"] >= len(ps)
        rep = fleet.attribution_report(top_k=len(ps))
        assert rep["requests"] == rep["exact_requests"] == len(ps)
        assert rep["segments"]["kv_transfer"]["total_s"] > 0.0
        jrep = out["jax"][0].attribution_report(top_k=len(ps))
        assert set(rep["segments"]) == set(jrep["segments"])
        ev = [e["event"] for e in fleet.flight.events()]
        assert "handoff_export" in ev and "handoff" in ev

    def test_geometry_mismatch_falls_back_to_reprefill(self):
        """A decode replica with another page size refuses every packet
        (typed KVHandoffError): each request migrates by re-prefill and
        still ends on its greedy path."""
        ps = _prompts(4, 3, 16, seed=22)
        out = {pkg: drill(pkg, ps, fleet_kw=ROLES, fac=factory(
            pkg, per_role={"decode": dict(page_size=8)}))
            for pkg in PKGS}
        (jf, js, jl, _), (tf, ts, tl, _) = out["jax"], out["torch"]
        assert ts == js and tl == jl
        assert flight_kinds(tf) == flight_kinds(jf)
        st = tf.stats()
        assert st["handoffs"] == 0 and st["handoff_fallbacks"] == len(ps)
        assert st["migrations"] >= len(ps)
        fb = [e for e in tf.flight.events()
              if e["event"] == "handoff_fallback"]
        assert fb and "page_size" in fb[0]["reason"]
        a, b = common_stats(jf.stats(), st)
        assert b == a

    def test_chunked_prefill_and_speculative_decode_roles(self):
        """Chunked prefill on the prefill replica, speculation on the
        decode replica, on the successor model (the decode replica's
        n-gram drafts are accepted)."""
        ps = [np.concatenate([p, p]) for p in _prompts(3, 3, 8, seed=23)]
        out = {pkg: drill(pkg, ps, fleet_kw=ROLES, fac=factory(
            pkg, succ=True, per_role={"prefill": dict(prefill_chunk=4),
                                      "decode": dict(speculative=3)}))
            for pkg in PKGS}
        (jf, js, jl, _), (tf, ts, tl, _) = out["jax"], out["torch"]
        assert ts == js and tl == jl
        assert tf.stats()["handoffs"] == len(ps)
        a, b = common_stats(jf.stats(), tf.stats())
        assert b == a


# ---------------------------------------------------------------------------
# the zero-loss drain
# ---------------------------------------------------------------------------
def _drained(pkg, crash_cancel=False):
    serving = PKGS[pkg][0]
    fleet = serving.ReplicaFleet(factory(pkg, telemetry=True),
                                 num_replicas=2, clock=_FakeClock())
    ps = _prompts(6, 3, 16, seed=24)
    frids = [fleet.submit(p, max_new_tokens=14) for p in ps]
    fleet.step()
    fleet.step()
    assert fleet._assigned["r0"], "nothing in flight on r0 to drain"
    if crash_cancel:
        def boom(rid):
            raise RuntimeError("drain target crashed mid-migration")
        fleet._replicas[0].engine.cancel = boom
    retired = fleet.retire_replica("r0")
    done = fleet.run()
    assert len(done) == len(frids)
    return fleet, retired, [list(done[f].generated) for f in frids]


class TestDrain:
    @pytest.mark.parametrize("crash", [False, True],
                             ids=["drain", "target_crashes"])
    def test_drain_migrates_inflight_like_jax(self, crash):
        res = {pkg: _drained(pkg, crash) for pkg in PKGS}
        (jf, jr, js), (tf, tr, ts) = res["jax"], res["torch"]
        assert ts == js and tr == jr == (not crash)
        assert flight_kinds(tf) == flight_kinds(jf)
        st = tf.stats()
        if crash:
            assert st["failovers"] == 1 and st["scale_downs"] == 0
        else:
            assert st["drain_migrations"] >= 1
            assert st["scale_downs"] == st["replicas_retired"] == 1
            assert [rep.name for rep in tf._replicas] == ["r1"]
            names = [n for n, _t in tf.trace_components()]
            assert "r0 (retired)" in names
            assert "r0" in tf.fleet_hit_rate()["per_replica"]
            assert "r0 (retired)" in tf.stats_snapshot()["replica_names"]
        a, b = common_stats(jf.stats(), st)
        assert b == a

    def test_drain_refuses_last_replica_and_unknown(self):
        fleet = tserving.ReplicaFleet(factory("torch"), num_replicas=1)
        assert not fleet.retire_replica("r0")
        assert not fleet.retire_replica("zz")


# ---------------------------------------------------------------------------
# the elastic fleet
# ---------------------------------------------------------------------------
def _policy(serving, **kw):
    base = dict(min_replicas=1, max_replicas=3, queue_growth=2.0,
                queue_min_depth=3.0, growth_window_s=2.0,
                growth_fire_frac=0.34, idle_per_replica=1.0,
                idle_window_s=2.5, min_samples=3, scale_cooldown_s=1.5,
                dt_per_round=0.5)
    base.update(kw)
    return serving.AutoscalePolicy(**base)


class _StubSentinel:
    def __init__(self, *names):
        self._names = names

    def active(self):
        return [type("A", (), {"rule": n})() for n in self._names]


class _StubFleet:
    def __init__(self, routable):
        self._routable = routable

    def routable_replicas(self, role=None):
        return self._routable


class TestElastic:
    def test_policy_decisions_match_jax(self):
        cases = [((), 2, 10.0, 0.0), (("queue_growth",), 1, 10.0, 0.0),
                 (("queue_growth",), 3, 10.0, 0.0),
                 (("fleet_idle",), 2, 10.0, 0.0),
                 (("fleet_idle",), 1, 10.0, 0.0),
                 (("fleet_idle", "ttft_slo_burn"), 2, 10.0, 0.0),
                 (("queue_growth",), 1, 1.0, 0.0)]
        got = {}
        for pkg in PKGS:
            serving = PKGS[pkg][0]
            pol = _policy(serving)
            got[pkg] = [pol.decide(_StubSentinel(*names), _StubFleet(n),
                                   now, last).value
                        for names, n, now, last in cases]
            with pytest.raises(ValueError):
                serving.AutoscalePolicy(min_replicas=0)
            with pytest.raises(ValueError):
                serving.AutoscalePolicy(min_replicas=3, max_replicas=2)
        assert got["torch"] == got["jax"]
        assert got["torch"] == ["hold", "grow", "hold", "shrink", "hold",
                                "grow", "hold"]

    def test_grows_under_load_and_drains_when_idle_like_jax(self):
        """A ramp grows the fleet; a trickle lets the idle window fill and
        the drain shrinks it back to one replica: equal scale events,
        streams, flight kinds and stats in both packages."""
        res = {}
        for pkg in PKGS:
            serving = PKGS[pkg][0]
            vc = serving.VirtualClock(0.5)
            fleet = serving.ElasticFleet(
                factory(pkg, num_slots=2, decode_horizon=2),
                policy=_policy(serving), clock=vc)
            ps = _prompts(6, 3, 8, seed=25)
            frids = []
            for i, p in enumerate(ps * 2):
                frids.append(fleet.submit(p, max_new_tokens=6))
                if i % 2:
                    fleet.step()
            fleet.run()
            grew = fleet.stats()["scale_ups"]
            for _ in range(14):
                frids.append(fleet.submit(ps[0][:4], max_new_tokens=2))
                fleet.run()
                if len(fleet._alive()) == 1:
                    break
            done = fleet.results()
            res[pkg] = (grew, fleet.scale_events,
                        [list(done[f].generated) for f in frids],
                        flight_kinds(fleet), fleet)
        (jg, je, js, jk, jf), (tg, te, ts, tk, tf) = res["jax"], res["torch"]
        assert (tg, te, ts, tk) == (jg, je, js, jk)
        st = tf.stats()
        assert tg >= 1 and st["scale_downs"] >= 1
        assert st["replicas_alive"] == 1
        a, b = common_stats(jf.stats(), st)
        assert b == a
        assert set(st["autoscale"]["rule_fires"]) == {"queue_growth",
                                                      "fleet_idle"}

    def test_replay_on_the_virtual_clock_matches_jax(self):
        """replay_fleet of one seeded scenario on an elastic, prefix-affine
        fleet: the same scale-event timeline, replica-seconds, goodput
        report and streams in both packages."""
        res = {}
        for pkg in PKGS:
            serving = PKGS[pkg][0]
            sc = serving.make_scenario(
                "flood", seed=9, n_requests=12, vocab=256,
                arrival="poisson", mean_interarrival_s=0.2,
                prompt_len=(3, 8), max_new=(6, 10))
            vc = serving.VirtualClock(0.5)
            fleet = serving.ElasticFleet(
                factory(pkg, num_slots=2, decode_horizon=2),
                policy=_policy(serving), clock=vc,
                router=serving.PrefixAffinityRouter())
            out = serving.replay_fleet(fleet, sc, slo_ttft_s=5.0,
                                       virtual_clock=vc, collect_tokens=True)
            res[pkg] = (fleet.scale_events, out["replica_seconds"],
                        out["report"], out["records"])
        assert res["torch"] == res["jax"]
        assert any(e["action"] == "scale_up" for e in res["torch"][0])

    def test_role_policies_scale_independently(self):
        res = {}
        for pkg in PKGS:
            serving = PKGS[pkg][0]
            pol = dict(min_replicas=1, max_replicas=2, queue_min_depth=2.0,
                       growth_window_s=3.0, scale_cooldown_s=2.0)
            fleet = serving.ElasticFleet(
                factory(pkg, telemetry=True, num_slots=2, decode_horizon=2),
                role_policies={"prefill": serving.AutoscalePolicy(**pol),
                               "decode": serving.AutoscalePolicy(**pol)})
            ps = _prompts(4, 3, 10, seed=26) * 3
            frids = [fleet.submit(p, max_new_tokens=6) for p in ps]
            done = fleet.run()
            assert len(done) == len(frids)
            st = fleet.stats()
            assert st["handoffs"] >= 1
            assert set(st["autoscale"]["per_role"]) == {"prefill", "decode"}
            assert all(e["role"] in ("prefill", "decode")
                       for e in fleet.scale_events)
            res[pkg] = ([list(done[f].generated) for f in frids],
                        fleet.scale_events, st["autoscale"])
            with pytest.raises(TypeError, match="not both"):
                serving.ElasticFleet(
                    factory(pkg), policy=serving.AutoscalePolicy(),
                    role_policies={"any": serving.AutoscalePolicy()})
        assert res["torch"] == res["jax"]
