"""Port parity: paddle_tpu_torch.serving's ReplicaFleet and routers against
the JAX package's on the CPU.

Each drill runs twice on the same seeded inputs: the JAX fleet over JAX
engines (``attention_impl="ref"``) and the port's fleet over the port's
engines, both built from ``tests/test_torch_serving.py``'s margin-engineered
weights, each fleet on its own fake clock and each package with its own
fault-plan stack.  They must agree on the greedy streams, the ``on_token``
streams, every fault consult (point and ctx), every router decision (the
candidates offered and the order, kind and matched blocks returned), the
fleet flight record's event kinds in order, and ``stats()`` over the keys
both packages report.  The port's side must also pass the drill's own
checks: zero lost requests, no token emitted twice, the stitched trace
and its critical-path attribution exact, and a crashed replica's engine
released (no reference left to it, so its pools can go)."""
import gc
import weakref

import numpy as np
import pytest
import torch

from test_torch_observability import _FakeClock, _recording_plan
from test_torch_serving import (CFG, _jax_plain_dispatch,  # noqa: F401
                                _models, _port_engines_stay_consistent,
                                _prompts)

from paddle_tpu.inference.paged import ServingEngine as JEngine
from paddle_tpu import serving as jserving
from paddle_tpu.inference import paged as jpaged
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.resilience import faults as tfaults

PKGS = {"jax": (jserving, jfaults, jpaged), "torch": (tserving, tfaults,
                                                      tpaged)}
ENGINE_KW = dict(num_slots=3, page_size=4, prompt_bucket=16,
                 decode_horizon=4)


def factory(pkg, kv_heads=4, succ=False, per_role=None, **kw):
    """An engine factory for ``pkg`` ("jax" | "torch") over the pair's
    weights; ``per_role`` maps a role to extra engine kwargs."""
    jp, tp, jcfg, tcfg = _models(kv_heads, succ)
    base = dict(ENGINE_KW, **kw)

    def make(role="any"):
        ekw = dict(base, **(per_role or {}).get(role, {}))
        if pkg == "jax":
            return JEngine(jp, jcfg, attention_impl="ref", **ekw)
        return tpaged.ServingEngine(tp, tcfg, device="cpu", **ekw)
    return make


def record_router(router):
    """Log every ``decide`` call of ``router`` as (candidates, role, order,
    kind, target, matched_blocks)."""
    log = []
    inner = router.decide

    def decide(tokens, candidates, memo=None, role=None):
        d = inner(tokens, candidates, memo=memo, role=role)
        log.append((sorted(candidates), role, list(d.order), d.kind,
                    d.target, d.matched_blocks))
        return d
    router.decide = decide
    router.log = log
    return router


def flight_kinds(fleet):
    return [(e["event"], e.get("frid"), e.get("replica"), e.get("kind"))
            for e in fleet.flight.events()]


def common_stats(js, ts):
    """The two stats dicts over their common keys, each replica's engine
    stats over the keys both engines report."""
    keys = (set(js) & set(ts)) - {"per_replica"}
    a, b = {k: js[k] for k in keys}, {k: ts[k] for k in keys}
    for name in set(js.get("per_replica", {})) | set(ts.get("per_replica",
                                                              {})):
        pj = js["per_replica"].get(name)
        pt = ts["per_replica"].get(name)
        if pj is None or pt is None:
            a[name], b[name] = pj, pt
            continue
        ck = set(pj) & set(pt)
        a[name] = {k: pj[k] for k in ck}
        b[name] = {k: pt[k] for k in ck}
    return a, b


def drill(pkg, prompts, *, specs=None, router=None, news=8, fleet_kw=None,
          engine_kw=None, fac=None, waves=1, between=0):
    """Run one fleet drill in ``pkg``: submit ``prompts`` (in ``waves``
    equal waves, stepping ``between`` rounds after each but the last)
    under the fault ``specs``; returns (fleet, streams, on_token streams,
    consult log, plan)."""
    serving, faults, _ = PKGS[pkg]
    fac = fac or factory(pkg, **(engine_kw or {}))
    fleet = serving.ReplicaFleet(
        fac, router=router, clock=_FakeClock(start=10.0, tick=0.25),
        **dict(dict(num_replicas=2), **(fleet_kw or {})))
    plan = _recording_plan(faults, specs or {})
    got, frids = {}, []
    per = -(-len(prompts) // waves)
    with faults.inject(plan):
        for w in range(waves):
            for i in range(w * per, min(len(prompts), (w + 1) * per)):
                frids.append(fleet.submit(
                    prompts[i], max_new_tokens=news,
                    on_token=got.setdefault(i, []).append))
            if w + 1 < waves:
                for _ in range(between):
                    fleet.step()
        done = fleet.run()
    assert len(done) == len(frids), "lost requests"
    streams = [list(done[f].generated) for f in frids]
    assert [got[i] for i in range(len(frids))] == streams, \
        "on_token stream differs from the final record"
    root = (fleet_kw or {}).get("snapshot_root")
    log = [(p, {k: v.replace(root, "<root>") if root and isinstance(v, str)
                else v for k, v in ctx.items()}) for p, ctx in plan.log]
    return fleet, streams, log, plan


def both(prompts, router_cls=None, **kw):
    out = {}
    for pkg in PKGS:
        router = None
        if router_cls is not None:
            router = record_router(getattr(PKGS[pkg][0], router_cls)())
        out[pkg] = drill(pkg, prompts, router=router, **kw)
    (jf, js, jl, _), (tf, ts, tl, _) = out["jax"], out["torch"]
    assert ts == js
    assert tl == jl
    assert flight_kinds(tf) == flight_kinds(jf)
    a, b = common_stats(jf.stats(), tf.stats())
    assert b == a
    if router_cls is not None:
        assert tf.router.log == jf.router.log
        assert tf.router.stats() == jf.router.stats()
    return out


def shared_prompts(seed, n_pairs=3):
    """Two waves of ``n_pairs`` prompts: prompt i of the second wave shares
    a two-page prefix with prompt i of the first, then a fresh tail."""
    r = np.random.default_rng(seed)
    heads = [r.integers(1, CFG["vocab_size"], 9).astype(np.int32)
             for _ in range(n_pairs)]
    return [np.concatenate([h, r.integers(1, CFG["vocab_size"], int(
        r.integers(2, 6))).astype(np.int32)]) for _ in range(2)
        for h in heads]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
class TestRouting:
    def test_chain_hashes_and_cache_notify_match_jax(self):
        """prefix_chain_hashes is the digest chain both caches index, and
        the insert / evict notifications carry the same digests."""
        for n in (3, 4, 8, 11, 16):
            toks = np.arange(1, n + 1, dtype=np.int32)
            assert tpaged.prefix_chain_hashes(toks, 4) \
                == jpaged.prefix_chain_hashes(toks, 4)
        logs = {}
        for name, mod in (("jax", jpaged), ("torch", tpaged)):
            pool = mod.PagePool(8, 4)
            cache = mod.PrefixCache(pool, 4)
            log = logs[name] = []
            cache.notify = lambda kind, d, _l=log: _l.append((kind,
                                                             list(d)))
            pages = pool.alloc(3)
            cache.register(np.arange(1, 11, dtype=np.int32), pages,
                           with_partial=True)
            assert sorted(cache.chain_digests()) == sorted(
                tpaged.prefix_chain_hashes(np.arange(1, 11,
                                                     dtype=np.int32), 4))
            pool.free(pages)
            cache.evict(8)
        assert logs["torch"] == logs["jax"]
        assert [k for k, _ in logs["torch"]] == ["insert", "evict", "evict"]

    def test_router_decisions_match_jax_call_by_call(self):
        """The same feed of cached chains and placements gives the same
        decisions, counters and summaries in both packages."""
        r = np.random.default_rng(5)
        routers = [record_router(m.PrefixAffinityRouter(max_imbalance=2))
                   for m in (jserving, tserving)]
        for rt in routers:
            rt.configure(page_size=4)
            for name in ("r0", "r1", "r2"):
                rt.on_replica_added(name)
        for step in range(40):
            toks = r.integers(1, 8, int(r.integers(2, 20))).astype(np.int32)
            loads = [(f"r{i}", int(r.integers(0, 6))) for i in range(3)]
            op = r.integers(0, 4)
            chain = tpaged.prefix_chain_hashes(toks, 4)
            for rt in routers:
                if op == 0:
                    rt.note_cached(loads[0][0], chain)
                elif op == 1 and chain:
                    rt.note_evicted(loads[1][0], chain[-1:])
                elif op == 2 and step % 13 == 0:
                    rt.on_replica_removed("r2")
                    rt.on_replica_added("r2")
                rt.decide(toks, loads, memo={}, role="prefill"
                          if step % 3 else None)
        assert routers[1].log == routers[0].log
        assert routers[1].stats() == routers[0].stats()
        lls = [m.LeastLoadedRouter() for m in (jserving, tserving)]
        cands = [("r1", 2), ("r0", 2), ("r2", 1)]
        assert [rt.decide(None, cands).order for rt in lls] \
            == [["r2", "r0", "r1"]] * 2

    @pytest.mark.parametrize("router", ["LeastLoadedRouter",
                                        "PrefixAffinityRouter"])
    def test_two_waves_of_shared_prefixes(self, router):
        """Pairs of prompts that share a prefix, in two waves: equal
        streams, decisions and stats; under prefix affinity the second
        wave lands on the replica holding its chain and hits its cache."""
        ps = shared_prompts(3)
        out = both(ps, router_cls=router, waves=2, between=8,
                   engine_kw=dict(telemetry=True))
        fleet = out["torch"][0]
        hits = fleet.fleet_hit_rate()
        assert hits == out["jax"][0].fleet_hit_rate()
        if router == "PrefixAffinityRouter":
            assert fleet.router.affinity_hits == 3
            assert hits["hit_rate"] > 0
            for frid in range(3):
                assert fleet._requests[frid + 3].replica \
                    == fleet._requests[frid].replica


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------
class TestReplicaFleet:
    @pytest.mark.parametrize("phase", ["record", "sched"])
    def test_crash_migrates_like_jax(self, phase):
        """r0 dies mid-step; its requests migrate by re-prefill of prompt
        + streamed tokens: equal streams, consults, flight kinds and
        stats, with the merged failover dump, the stitched trace and an
        exact attribution of every request."""
        ps = _prompts(6, 3, 20, seed=11)
        out = both(ps, news=12, specs={"serve.crash": dict(
            match={"engine": "r0", "phase": phase}, at=1)},
            engine_kw=dict(telemetry=True))
        fleet, _, _, plan = out["torch"]
        jfleet = out["jax"][0]
        assert plan.fired("serve.crash") == 1
        st = fleet.stats()
        assert st["failovers"] == 1 and st["migrations"] >= 1
        assert st["recovery"]["count"] == 1
        dump = fleet.flight.last_dump()
        assert dump["reason"] == "failover"
        assert dump["extra"]["replica_ring"]
        assert any(e["event"] == "route" and e["replica"] == "r0"
                   for e in dump["extra"]["routing_decisions"])
        summ = fleet.stitcher().summary()
        jsumm = jfleet.stitcher().summary()
        for k in ("components", "requests_stitched", "max_chain",
                  "flow_events"):
            assert summ[k] == jsumm[k], k
        assert any("crashed" in c for c in summ["max_chain"])
        attr = fleet.attribution_report()
        assert attr["requests"] == attr["exact_requests"] == len(ps)
        assert set(attr["segments"]) == set(
            jfleet.attribution_report()["segments"])
        snap = fleet.stats_snapshot(ttft_deadline_s=60.0)
        assert snap["merged"]["serve.ttft_s"]["count"] \
            == jfleet.stats_snapshot()["merged"]["serve.ttft_s"]["count"]
        assert snap["alerts"]["status"] == "ok"

    def test_crashed_replica_engine_is_released(self):
        """The watchdog keeps a dead replica's tracer and counters, never
        its engine: once the failover is done nothing refers to the corpse
        (on a card, its KV pool and graph pool go back)."""
        fleet = tserving.ReplicaFleet(factory("torch", telemetry=True),
                                      num_replicas=2)
        corpse = weakref.ref(fleet._replicas[0].engine)
        with tfaults.inject({"serve.crash": dict(match={"engine": "r0"},
                                                 at=2)}):
            for p in _prompts(4, 3, 12, seed=2):
                fleet.submit(p, max_new_tokens=6)
            fleet.run()
        assert fleet.stats()["failovers"] == 1
        gc.collect()
        assert corpse() is None, gc.get_referrers(corpse())
        retired = weakref.ref(fleet._replicas[1].engine)
        assert fleet.retire_replica("r1")
        gc.collect()
        assert retired() is None

    def test_snapshot_restore_failover(self, tmp_path):
        """Full-KV snapshots every 2 rounds: r0 is revived from its newest
        intact snapshot and the requests it carries continue there."""
        out = {}
        for pkg in PKGS:
            out[pkg] = drill(pkg, _prompts(5, 3, 16, seed=4), news=12,
                             engine_kw=dict(decode_horizon=1, num_slots=2),
                             specs={"serve.crash": dict(
                                 match={"engine": "r0"}, at=8)},
                             fleet_kw=dict(
                                 snapshot_root=str(tmp_path / pkg),
                                 snapshot_every=2, snapshot_mode="full_kv"))
        (jf, js, jl, _), (tf, ts, tl, _) = out["jax"], out["torch"]
        assert ts == js and tl == jl
        assert flight_kinds(tf) == flight_kinds(jf)
        assert "restore" in [e["event"] for e in tf.flight.events()]
        a, b = common_stats(jf.stats(), tf.stats())
        assert b == a

    def test_torn_snapshot_rejected_falls_back_to_intact(self, tmp_path):
        out = {}
        for pkg in PKGS:
            out[pkg] = drill(
                pkg, _prompts(4, 3, 12, seed=6), news=14,
                engine_kw=dict(decode_horizon=1, num_slots=2),
                specs={"serve.snapshot": dict(action="trigger",
                                              match={"engine": "r0"}, at=2),
                       "serve.crash": dict(match={"engine": "r0"}, at=12)},
                fleet_kw=dict(snapshot_root=str(tmp_path / pkg),
                              snapshot_every=2, snapshot_keep_last=3))
        (jf, js, jl, _), (tf, ts, tl, plan) = out["jax"], out["torch"]
        assert ts == js and tl == jl
        assert flight_kinds(tf) == flight_kinds(jf)
        assert plan.fired("serve.snapshot") == 1
        assert tf.stats()["torn_snapshots"] >= 1
        torn = [e for e in tf.flight.events() if e["event"] == "torn_snapshot"]
        rest = [e for e in tf.flight.events() if e["event"] == "restore"]
        assert torn and torn[0]["fault_plan"] is not None
        assert rest and rest[0]["path"] < torn[0]["path"]

    def test_sampled_requests_migrate_from_streamed(self, tmp_path):
        """Sampled requests never resume from a stale snapshot: each
        final result is exactly what the router streamed (the draws are
        each package's own, so no stream is compared across packages)."""
        fleet = tserving.ReplicaFleet(
            factory("torch"), num_replicas=2,
            snapshot_root=str(tmp_path), snapshot_every=2)
        with tfaults.inject({"serve.crash": dict(match={"engine": "r0"},
                                                 at=4)}):
            frids = [fleet.submit(p, max_new_tokens=12, temperature=0.9,
                                  top_p=0.9)
                     for p in _prompts(4, 3, 12, seed=8)]
            done = fleet.run()
        assert len(done) == len(frids)
        for frid in frids:
            assert fleet._requests[frid].streamed \
                == [int(t) for t in done[frid].generated]
        assert fleet.stats()["failovers"] == 1

    def test_wedge_watchdog_quiesces_before_adopt(self):
        """A replica that stops making progress is condemned after
        ``stall_threshold`` heartbeats; its requests are cancelled on the
        corpse before any migration."""
        ps = _prompts(5, 3, 16, seed=9)
        out = both(ps, specs={"serve.wedge": dict(
            action="trigger", match={"engine": "r1"}, count=None)},
            fleet_kw=dict(stall_threshold=4))
        fleet = out["torch"][0]
        ev = fleet.flight.events()
        q = [i for i, e in enumerate(ev) if e["event"] == "wedge_quiesce"]
        f = [i for i, e in enumerate(ev) if e["event"] == "failover"]
        m = [i for i, e in enumerate(ev) if e["event"] == "migrate"]
        assert q and ev[q[0]]["cancelled"] >= 1
        assert f and m and q[0] < f[0] < min(m)
        assert ev[f[0]]["kind"] == "wedge"

    def test_ladder_route_queue_reject(self):
        """Replicas full -> the fleet queue -> typed rejection, in the same
        places in both packages; every accepted request completes."""
        res = {}
        for pkg in PKGS:
            serving = PKGS[pkg][0]
            fleet = serving.ReplicaFleet(
                factory(pkg, max_queue=1, num_slots=1), num_replicas=2,
                max_queue=2, clock=_FakeClock())
            ok, rejected = [], []
            for i, p in enumerate(_prompts(4, 3, 10, seed=12) * 3):
                try:
                    ok.append(fleet.submit(p, max_new_tokens=6))
                except PKGS[pkg][2].AdmissionRejected:
                    rejected.append(i)
            done = fleet.run()
            assert len(done) == len(ok) and rejected
            res[pkg] = ([list(done[f].generated) for f in ok], rejected,
                        flight_kinds(fleet), fleet.stats()["rejections"])
        assert res["torch"] == res["jax"]

    def test_rejected_submit_leaves_no_tracer_ghost(self):
        fleet = tserving.ReplicaFleet(factory("torch", max_queue=2),
                                      num_replicas=1, max_queue=0)
        with pytest.raises(ValueError):
            fleet.submit(np.ones(400, np.int32), max_new_tokens=8)
        assert fleet.tracer._live == {}
        ps = _prompts(3, 3, 10, seed=13)
        frids = [fleet.submit(p, max_new_tokens=4) for p in ps[:2]]
        with pytest.raises(tpaged.AdmissionRejected):
            fleet.submit(ps[2], max_new_tokens=4)
        assert set(fleet.tracer._live) <= set(fleet._requests)
        assert len(fleet.run()) == len(frids)

    def test_failover_budget_exhausted_raises(self):
        for pkg in PKGS:
            serving, faults, _ = PKGS[pkg]
            fleet = serving.ReplicaFleet(factory(pkg), num_replicas=1,
                                         max_failovers_per_replica=1)
            with faults.inject({"serve.crash": dict(count=None)}):
                fleet.submit(_prompts(1, 3, 8, seed=1)[0], max_new_tokens=4)
                with pytest.raises(serving.FleetFailedError):
                    fleet.run()


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------
class TestFleetStreaming:
    def test_fleet_cancel(self):
        res = {}
        for pkg in PKGS:
            serving = PKGS[pkg][0]
            fleet = serving.ReplicaFleet(factory(pkg), num_replicas=2,
                                         clock=_FakeClock())
            ps = _prompts(2, 3, 10, seed=14)
            keep = fleet.submit(ps[0], max_new_tokens=6)
            drop = fleet.submit(ps[1], max_new_tokens=40)
            fleet.step()
            fleet.step()
            assert fleet.cancel(drop) is True
            assert fleet.cancel(drop) is False
            assert fleet.cancel(99_999) is False
            done = fleet.run()
            assert drop not in done
            res[pkg] = (list(done[keep].generated), flight_kinds(fleet))
            for rep in fleet._replicas:
                rep.engine.release_cache()
                assert rep.engine.pool.num_free == rep.engine.pool.num_pages
        assert res["torch"] == res["jax"]

    def test_stream_disconnect_during_failover_migration(self):
        """A consumer of ``Request.stream()`` on a replica handle
        disconnects after its home replica crashed and the request was
        adopted elsewhere: the close frees the pages on the corpse, the
        fleet cancel lands on the adopted replica, and the survivors
        complete on their successor paths."""
        fleet = tserving.ReplicaFleet(factory("torch", succ=True),
                                      num_replicas=2)
        ps = _prompts(4, 3, 10, seed=15)
        emitted = []
        victim = fleet.submit(ps[0], max_new_tokens=24,
                              on_token=emitted.append)
        others = [fleet.submit(p, max_new_tokens=8) for p in ps[1:]]
        fr = fleet._requests[victim]
        for _ in range(60):
            fleet.step()
            if fr.handle is not None and len(fr.streamed) >= 2:
                break
        home = fr.replica
        corpse = next(r.engine for r in fleet._replicas if r.name == home)
        old = fr.handle
        gen = old.stream()
        assert next(gen) == fr.streamed[0]
        with tfaults.inject({"serve.crash": dict(match={"engine": home},
                                                 at=0)}):
            for _ in range(30):
                fleet.step()
                if fleet.stats()["failovers"] == 1 and fr.handle is not None:
                    break
        assert fr.handle is not None and fr.handle is not old
        adopted = next(r.engine for r in fleet._replicas
                       if r.name == fr.replica)
        n = len(emitted)
        free_before = corpse.pool.num_free
        gen.close()
        assert corpse.lookup(old.rid) is None
        corpse.release_cache()
        assert corpse.pool.num_free > free_before
        rid = fr.handle.rid
        assert fleet.cancel(victim) is True
        assert adopted.lookup(rid) is None
        done = fleet.run()
        assert victim not in done and len(emitted) == n
        succ = np.random.default_rng(0).permutation(CFG["vocab_size"])
        for f, p in zip(others, ps[1:]):
            path = [int(succ[p[-1]])]
            while len(path) < 8:
                path.append(int(succ[path[-1]]))
            assert list(done[f].generated) == path


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_two_replica_crash_drill_on_the_card():
    """On the card: a 2-replica fleet of kernel engines (captured decode
    graphs, pages of 8: the kernel's multiple) loses r0 mid-decode; every
    stream equals the CPU fleet's, and the fleet's device memory comes back
    once it is dropped."""
    ps = _prompts(6, 3, 20, seed=11)
    _jp, tp, _jcfg, tcfg = _models(4, False)
    tp_card = tuple({k: v.to("cuda") for k, v in t.items()} for t in tp)
    kw = dict(ENGINE_KW, page_size=8)

    def make():
        return tpaged.ServingEngine(tp_card, tcfg, device="cuda", **kw)
    streams = {}
    for name, fac in (("cpu", factory("torch", page_size=8)),
                      ("cuda", make)):
        fleet = tserving.ReplicaFleet(fac, num_replicas=2)
        with tfaults.inject({"serve.crash": dict(match={"engine": "r0"},
                                                 at=2)}) as plan:
            frids = [fleet.submit(p, max_new_tokens=8) for p in ps]
            done = fleet.run()
        assert plan.fired("serve.crash") == 1
        streams[name] = [list(done[f].generated) for f in frids]
        assert fleet.stats()["failovers"] == 1
        del fleet, done
    assert streams["cuda"] == streams["cpu"]
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    before = torch.cuda.memory_allocated()
    fleet = tserving.ReplicaFleet(make, num_replicas=2)
    fleet.submit(ps[0], max_new_tokens=4)
    fleet.run()
    del fleet
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    assert torch.cuda.memory_allocated() - before < 64 << 20
