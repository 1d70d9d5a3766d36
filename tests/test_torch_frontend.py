"""Port parity: paddle_tpu_torch.serving's async front end, SLO admission
and traffic harness against the JAX package's on the CPU.

The traffic layer is pure host code: ``make_scenario`` must fingerprint
equal (``Scenario.signature()``) and ``replay_sim`` return records, reports
and admission counters equal to the last float in both packages, and the
TTFT predictor / admission controller must decide alike on the same
views.  ``replay_engine`` drives each package's engine of
``tests/test_torch_serving.py``'s pair through one seeded scenario (token
time pacing, abandoning clients): equal streams and outcomes.

The asyncio transport runs over the port's engines (and a 2-replica port
fleet); every stream it delivers must equal the JAX engine's greedy
stream for the same prompt, disconnects (task cancel, ``async with``
exit, ``abandon``, a garbage-collected stream, a dropped SSE socket) must
cancel the request and give its pages back, and ``POST /generate``
answers over loopback with Server-Sent Events."""
import asyncio
import gc
import http.client
import json
import urllib.request

import numpy as np
import pytest

from test_torch_fleet import factory
from test_torch_serving import (_engines, _jax_plain_dispatch,  # noqa: F401
                                _port_engines_stay_consistent, _prompts)

from paddle_tpu import serving as jserving
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.observability import (MetricsExporter, Telemetry,
                                            TraceStitcher)

PROMPTS = _prompts(4, 3, 14, seed=31)
NEWS = [6, 9, 5, 7]
_REFS = []


def refs():
    """The JAX engine's greedy stream of each PROMPTS entry."""
    if not _REFS:
        jeng, _ = _engines()
        rids = [jeng.submit(p, max_new_tokens=n)
                for p, n in zip(PROMPTS, NEWS)]
        done = jeng.run()
        _REFS.extend(list(done[r].generated) for r in rids)
    return _REFS


def engine(**kw):
    return factory("torch", **kw)()


def leakfree(eng):
    eng.release_cache()
    assert eng.pool.num_free == eng.pool.num_pages
    eng.check_invariants()


# ---------------------------------------------------------------------------
# traffic and admission (pure host)
# ---------------------------------------------------------------------------
SCENARIOS = [
    dict(arrival="bursty", n_requests=300, shared_prefix_users=6,
         sampled_frac=0.2, long_context_frac=0.1, abandon_frac=0.2),
    dict(arrival="diurnal", n_requests=300, diurnal_period_s=30.0),
    dict(arrival="poisson", n_requests=200, slo_ttft_s=0.4,
         abandon_frac=0.5, abandon_range=(1, 30)),
]


class TestTraffic:
    @pytest.mark.parametrize("kw", SCENARIOS,
                             ids=[s["arrival"] for s in SCENARIOS])
    def test_scenarios_and_sim_replays_equal_jax(self, kw):
        for seed in (0, 7):
            scs = [m.make_scenario("s", seed=seed, vocab=256, **kw)
                   for m in (jserving, tserving)]
            assert scs[1].signature() == scs[0].signature()
            assert scs[1].offered_tokens() == scs[0].offered_tokens()
            for policy in ("predictive", "depth", "always"):
                sims = [m.replay_sim(sc, num_slots=4, prefill_rate_tps=900.0,
                                     step_s=0.05, decode_horizon=8,
                                     policy=policy, slo_ttft_s=0.5,
                                     max_queue_depth=6)
                        for m, sc in zip((jserving, tserving), scs)]
                assert sims[1] == sims[0], policy
        assert tserving.make_scenario("s", seed=1, vocab=256, **kw) \
            .signature() != scs[1].signature()

    def test_predictor_and_controller_decide_like_jax(self):
        r = np.random.default_rng(3)
        ctrls = [m.AdmissionController(policy="predictive", slo_ttft_s=0.3)
                 for m in (jserving, tserving)]
        depth = [m.AdmissionController(policy="depth", max_queue_depth=3)
                 for m in (jserving, tserving)]
        for _ in range(200):
            args = dict(
                free_slots=int(r.integers(0, 3)),
                active=[(int(r.integers(0, 40)), int(r.integers(1, 30)))
                        for _ in range(int(r.integers(0, 4)))],
                queued=[(int(r.integers(1, 60)), int(r.integers(1, 30)))
                        for _ in range(int(r.integers(0, 6)))],
                prefill_rate_tps=float(r.uniform(200, 4000)),
                step_s=float(r.uniform(0.005, 0.05)),
                decode_horizon=int(r.integers(1, 9)))
            n = int(r.integers(1, 80))
            outs = []
            for m, c, d in zip((jserving, tserving), ctrls, depth):
                view = m.AdmissionView(**args)
                row = [m.TTFTPredictor().predict(view, n)]
                for ctl in (c, d):
                    try:
                        row.append(ctl.decide(view, n))
                    except m.SLORejected:
                        row.append("slo")
                    except tpaged.AdmissionRejected:
                        row.append("depth")
                    except Exception as exc:   # the JAX package's class
                        row.append(type(exc).__name__)
                outs.append(row)
            outs[0] = ["depth" if x == "AdmissionRejected" else x
                       for x in outs[0]]
            assert outs[1] == outs[0]
        assert ctrls[1].report() == ctrls[0].report()
        assert depth[1].report() == depth[0].report()
        assert issubclass(tserving.SLORejected, tpaged.AdmissionRejected)

    def test_goodput_report_equal_jax(self):
        r = np.random.default_rng(4)
        recs = [{"idx": i, "rejected": bool(r.uniform() < 0.2),
                 "abandoned": bool(r.uniform() < 0.1),
                 "tokens": int(r.integers(0, 20)),
                 "ttft_s": float(r.uniform(0, 2)),
                 "tpot_s": float(r.uniform(0, 0.1)),
                 "e2e_s": float(r.uniform(1, 5)), "timed_out": False}
                for i in range(50)]
        assert tserving.goodput_report(recs, 0.8, window_s=20.0) \
            == jserving.goodput_report(recs, 0.8, window_s=20.0)

    @pytest.mark.parametrize("policy", ["always", "depth"])
    def test_engine_replay_equals_jax(self, policy):
        """One seeded bursty scenario with abandoning clients, paced in
        token time, through each package's engine: equal streams,
        rejections and abandons."""
        res = {}
        for name, (mod, eng) in zip(("jax", "torch"), (
                (jserving, _engines(num_slots=2)[0]),
                (tserving, engine(num_slots=2)))):
            sc = mod.make_scenario(
                "b", seed=6, n_requests=8, vocab=256, arrival="bursty",
                mean_interarrival_s=0.3, burst_every_s=1.0, burst_size=3,
                prompt_len=(3, 10), max_new=(6, 12), abandon_frac=0.25,
                abandon_range=(2, 4))
            ctl = mod.AdmissionController(policy=policy, max_queue_depth=1)
            out = mod.replay_engine(eng, sc, ctl, load_tps=5.0,
                                    slo_ttft_s=30.0, collect_tokens=True)
            res[name] = ([(r["rejected"], r["abandoned"], r["tokens"],
                           r.get("stream")) for r in out["records"]],
                         {k: v for k, v in out["admission"].items()
                          if not k.startswith("ttft_pred")})
        assert res["torch"] == res["jax"]
        if policy == "depth":
            assert res["torch"][1]["rejected_depth"] > 0
        assert any(a for _r, a, _t, _s in res["torch"][0])


# ---------------------------------------------------------------------------
# the asyncio transport
# ---------------------------------------------------------------------------
async def _clients(fe, idx):
    async def client(i):
        s = await fe.submit(PROMPTS[i], max_new_tokens=NEWS[i])
        toks = [t async for t in s]
        req = await s.result()
        return toks, list(req.generated)
    outs = await asyncio.gather(*[client(i) for i in idx])
    await fe.drain()
    return outs


class TestAsyncTransport:
    @pytest.mark.parametrize("overlap", [False, True])
    def test_concurrent_streams_equal_jax(self, overlap):
        eng = engine(overlap=overlap)

        async def main():
            async with tserving.AsyncFrontend(eng) as fe:
                return await _clients(fe, range(len(PROMPTS)))
        for i, (toks, gen) in enumerate(asyncio.run(main())):
            assert toks == gen == refs()[i]
        leakfree(eng)

    def test_backpressure_stalls_fanout_not_engine(self):
        eng = engine()

        async def main():
            async with tserving.AsyncFrontend(eng, stream_buffer=2) as fe:
                s = await fe.submit(PROMPTS[1], max_new_tokens=NEWS[1])
                req = await s.result()
                assert len(s._overflow) + s._q.qsize() >= len(req.generated)
                toks = []
                async for t in s:
                    await asyncio.sleep(0.002)
                    toks.append(t)
                return toks
        assert asyncio.run(main()) == refs()[1]
        leakfree(eng)

    def test_disconnect_paths_cancel_and_free_pages(self):
        """Task cancel inside the iterator, ``async with`` exit, explicit
        ``abandon`` beside live survivors, and a garbage-collected stream:
        each cancels its request, and the survivors stay on their paths."""
        eng = engine()

        async def main():
            async with tserving.AsyncFrontend(eng) as fe:
                s = await fe.submit(PROMPTS[0], max_new_tokens=48)
                started = asyncio.Event()

                async def consume():
                    async for _ in s:
                        started.set()
                task = asyncio.ensure_future(consume())
                await started.wait()
                task.cancel()
                with pytest.raises(asyncio.CancelledError):
                    await task
                assert (await s.result()) is None
                async with await fe.submit(PROMPTS[1],
                                           max_new_tokens=48) as s2:
                    assert isinstance(await s2.__anext__(), int)
                assert (await s2.result()) is None

                async def abandoner():
                    s3 = await fe.submit(PROMPTS[3], max_new_tokens=48)
                    got = []
                    async for t in s3:
                        got.append(t)
                        if len(got) == 2:
                            s3.abandon()
                            break
                    return got
                outs = await asyncio.gather(_clients(fe, [0, 2]),
                                            abandoner())
                s4 = await fe.submit(PROMPTS[2], max_new_tokens=48)
                rid = s4.rid
                del s4
                gc.collect()
                for _ in range(400):
                    if eng.lookup(rid) is None:
                        break
                    await asyncio.sleep(0.005)
                await fe.drain()
                return outs, rid
        (survivors, abandoned), rid = asyncio.run(main())
        assert [t for t, _g in survivors] == [refs()[0], refs()[2]]
        assert len(abandoned) == 2
        assert eng.lookup(rid) is None, "a collected stream did not cancel"
        leakfree(eng)

    def test_submit_before_start_and_restart(self):
        eng = engine()
        fe = tserving.AsyncFrontend(eng)
        with pytest.raises(RuntimeError, match="not started"):
            asyncio.run(fe.submit(PROMPTS[0]))

        async def main():
            out = []
            for i in (0, 1):
                async with fe:
                    s = await fe.submit(PROMPTS[i], max_new_tokens=4)
                    out.append([t async for t in s])
            return out
        assert asyncio.run(main()) == [refs()[0][:4], refs()[1][:4]]
        leakfree(eng)

    def test_fleet_wrapped_frontend_and_cancel(self):
        fleet = tserving.ReplicaFleet(factory("torch"), num_replicas=2)

        async def main():
            async with tserving.AsyncFrontend(fleet) as fe:
                outs = await _clients(fe, range(len(PROMPTS)))
                s = await fe.submit(PROMPTS[0], max_new_tokens=48)
                while s._q.qsize() == 0 and not s._done.is_set():
                    await asyncio.sleep(0.002)
                s.abandon()
                assert (await s.result()) is None
                await fe.drain()
                return outs
        for i, (toks, gen) in enumerate(asyncio.run(main())):
            assert toks == gen == refs()[i]
        for rep in fleet._replicas:
            leakfree(rep.engine)
        assert all(fr.result is not None
                   for fr in fleet._requests.values())


class TestSLOAdmission:
    def test_slo_rejected_typed_and_per_request_override(self):
        eng = engine(telemetry=True)

        async def main():
            async with tserving.AsyncFrontend(
                    eng, admission="predictive", slo_ttft_s=1e-9) as fe:
                with pytest.raises(tserving.SLORejected):
                    await fe.submit(PROMPTS[0], max_new_tokens=8)
                s = await fe.submit(PROMPTS[0], max_new_tokens=6,
                                    slo_ttft_s=30.0)
                assert s.predicted_ttft_s is not None \
                    and s.predicted_ttft_s >= 0.0
                toks = [t async for t in s]
                await fe.drain()
                return toks, fe.stats()
        toks, rep = asyncio.run(main())
        assert toks == refs()[0][:6]
        assert rep["offered"] == 2 and rep["rejected_slo"] == 1
        assert rep["ttft_pred_err_s"]["count"] == 1
        assert rep["fraction_sum"] == pytest.approx(1.0, abs=1e-3)
        leakfree(eng)

    def test_admission_view_from_live_engine_equals_jax(self):
        views = []
        for eng in (_engines(num_slots=2)[0], engine(num_slots=2)):
            for p in PROMPTS[:3]:
                eng.submit(p, max_new_tokens=8)
            eng.step()
            mod = jserving if eng.__module__.startswith("paddle_tpu.") \
                else tserving
            v = mod.admission_view(eng)
            views.append((v.free_slots, v.active, v.queued,
                          v.decode_horizon))
            eng.run()
        assert views[1] == views[0]
        assert views[1][0] == 0 and len(views[1][2]) == 1


# ---------------------------------------------------------------------------
# the live exporter and POST /generate
# ---------------------------------------------------------------------------
def _post(port, body, read_n=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    events, toks = [], []
    while read_n is None or len(toks) < read_n:
        raw = resp.fp.readline()
        if not raw:
            break
        line = raw.decode().strip()
        if line.startswith("event: "):
            events.append(line[7:])
        elif line.startswith("data: "):
            d = json.loads(line[6:])
            if "token" in d:
                toks.append(d["token"])
    conn.close()
    return resp.status, events, toks


class TestExporterAndSSE:
    def test_exporter_stitching_and_freeze(self):
        eng = engine(telemetry=Telemetry())

        async def main():
            async with tserving.AsyncFrontend(eng) as fe:
                ex = fe.start_exporter()
                streams = [await fe.submit(PROMPTS[i],
                                           max_new_tokens=NEWS[i])
                           for i in range(2)]
                outs = [[t async for t in s] for s in streams]
                await fe.drain()
                assert fe.controller.metrics.frozen
                assert eng.telemetry.registry.frozen

                def get(path):
                    return urllib.request.urlopen(
                        f"{ex.url}{path}").read().decode()
                body, js, hz = await asyncio.to_thread(
                    lambda: (get("/metrics"), json.loads(
                        get("/metrics.json")), json.loads(get("/healthz"))))
                return fe, streams, outs, body, js, hz
        fe, streams, outs, body, js, hz = asyncio.run(main())
        assert outs == refs()[:2]
        assert 'component="frontend"' in body \
            and 'component="engine"' in body
        assert "serve_ttft_s_bucket" in body
        assert js["frontend"]["frontend.offered"]["value"] == 2
        assert js["engine"]["serve.requests_submitted"]["value"] == 2
        assert hz["status"] == "ok" and hz["open_streams"] == 0
        summ = (TraceStitcher().add("frontend", fe.tracer)
                .add("engine", eng.telemetry.tracer)).summary()
        assert summ["requests_stitched"] == 2
        assert summ["max_chain"] == ["frontend", "engine"]
        leakfree(eng)

    def test_generate_streams_rejects_and_cancels_over_a_fleet(self):
        """Over a 2-replica fleet: concurrent ``POST /generate`` clients
        read their prompt's greedy stream, a client that hangs up after
        two tokens has its request cancelled and its pages freed, an
        impossible per-request SLO arrives as ``event: rejected``, a body
        without a prompt as ``event: error``, and ``/metrics`` carries
        the fleet's counters."""
        fleet = tserving.ReplicaFleet(factory("torch", telemetry=True),
                                      num_replicas=2)

        async def main():
            async with tserving.AsyncFrontend(
                    fleet, admission="predictive") as fe:
                ex = fe.start_exporter("127.0.0.1", 0)
                clients = [asyncio.to_thread(
                    _post, ex.port, {"prompt": PROMPTS[i].tolist(),
                                     "max_new_tokens": NEWS[i]})
                    for i in range(len(PROMPTS))]
                outs = await asyncio.gather(*clients)
                _s, _e, cut = await asyncio.to_thread(
                    _post, ex.port, {"prompt": PROMPTS[0].tolist(),
                                     "max_new_tokens": 60}, 2)
                for _ in range(200):
                    await asyncio.sleep(0.02)
                    if all(fr.result is not None
                           for fr in fleet._requests.values()):
                        break
                rej = await asyncio.to_thread(
                    _post, ex.port, {"prompt": PROMPTS[1].tolist(),
                                     "max_new_tokens": 4,
                                     "slo_ttft_s": 1e-9})
                bad = await asyncio.to_thread(
                    _post, ex.port, {"max_new_tokens": 4})
                metrics = await asyncio.to_thread(
                    lambda: urllib.request.urlopen(
                        f"{ex.url}/metrics").read().decode())
                hz = await asyncio.to_thread(
                    lambda: json.loads(urllib.request.urlopen(
                        f"{ex.url}/healthz").read().decode()))
                await fe.drain()
                return outs, cut, rej, bad, metrics, hz
        outs, cut, rej, bad, metrics, hz = asyncio.run(main())
        for i, (status, events, toks) in enumerate(outs):
            assert status == 200 and events == ["start", "done"]
            assert toks == refs()[i]
        assert cut == refs()[0][:2]
        assert rej[1] == ["rejected"] and rej[2] == []
        assert bad[1] == ["error"]
        assert 'fleet_requests_submitted_total{component="router"}' \
            in metrics
        assert 'component="r0"' in metrics and 'component="r1"' in metrics
        assert hz["status"] == "ok" and hz["worker_alive"] is True
        for rep in fleet._replicas:
            assert not rep.engine.num_active and not rep.engine._queue
            leakfree(rep.engine)

    def test_post_without_generate_fn_is_404(self):
        ex = MetricsExporter(lambda: {"at": 0.0}).start()
        try:
            assert _post(ex.port, {"prompt": [1]})[0] == 404
        finally:
            ex.stop()
