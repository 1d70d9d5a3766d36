"""Port parity: the double-buffered host loop (``overlap=True``) of
paddle_tpu_torch's ServingEngine against the port's synchronous engine and
against the JAX engine's ``overlap=True`` (``attention_impl="ref"``) on the
CPU.

The models are ``tests/test_torch_serving.py``'s margin-engineered weights,
so greedy streams must be EQUAL token for token, and since the port mirrors
the JAX scheduler, so must the scheduling counters — ``overlap_steps`` and
``quiesces`` included — across prefix caching, chunked prefill, EOS inside
a horizon, preemption under a tight pool and ``speculative=4`` (on the
successor model; the K = 2 random-prompt oracle of the JAX suite fails on
the JAX side alone).  Then the exactness point ``quiesce()``, the streaming
hook, ``Request.stream()``, and one card test: the captured CUDA graphs
against the eager horizon called directly."""
import numpy as np
import pytest
import torch

from test_torch_serving import (_chain, _jax_plain_dispatch,  # noqa: F401
                                _models, _port_engines_stay_consistent,
                                _prompts, _serve, _spec_prompts, SUCC)
from paddle_tpu.inference.paged import ServingEngine as JEngine
from paddle_tpu_torch.inference import paged as tpaged

BASE = dict(num_slots=3, page_size=4, prompt_bucket=32, decode_horizon=4)
COUNTERS = ("steps_run", "overlap_steps", "quiesces", "preemptions",
            "cache_hits", "verify_steps", "tokens_generated",
            "fused_sample_steps")


def _engine(pkg, succ=False, **kw):
    jp, tp, jcfg, tcfg = _models(4, succ)
    kw = dict(BASE, **kw)
    if pkg == "jax":
        return JEngine(jp, jcfg, attention_impl="ref", **kw)
    return tpaged.ServingEngine(tp, tcfg, device="cpu", **kw)


def _traffic(feature):
    """(engine kwargs, request batches, request kwargs, successor model)."""
    ps = _prompts(6, 3, 20, seed=31)
    # the fifth request extends the first one's prompt and arrives after
    # it retired, so it attaches cached pages
    ps[4] = np.concatenate([ps[0], ps[4][:5]])
    news = [9, 5, 12, 7, 6, 10]
    batches = [[(p, {"max_new_tokens": m}) for p, m in zip(ps[:3], news)],
               [(p, {"max_new_tokens": m}) for p, m in
                zip(ps[3:], news[3:])]]
    if feature == "default":
        return {}, batches, {}, False
    if feature == "cache_off":
        return dict(prefix_cache=False), batches, {}, False
    if feature == "chunked":
        long = _prompts(2, 17, 40, seed=37)
        return (dict(prefill_chunk=8), [batches[0] + [(long[0], {})],
                                        batches[1] + [(long[1], {})]],
                {}, False)
    if feature == "eos":
        # on the successor model, request 2 emits its path from
        # SUCC[last prompt token]: stop it at the 7th token, inside its
        # second horizon
        eos = _chain(SUCC[ps[2][-1]], 12)[6]
        return {}, batches, {"eos_token_id": int(eos)}, True
    if feature == "preempt":
        ps = _prompts(4, 8, 12, seed=5)
        return (dict(num_pages=12), [[(p, {}) for p in ps]],
                {"max_new_tokens": 20}, False)
    assert feature == "speculative"
    ps = _spec_prompts()
    return (dict(speculative=4), [[(p, {}) for p in ps]],
            {"max_new_tokens": 12}, True)


@pytest.mark.parametrize("feature", ["default", "cache_off", "chunked",
                                     "eos", "preempt", "speculative"])
def test_overlap_matches_sync_and_jax_overlap(feature):
    """One traffic per feature through the JAX engine and the port's, both
    ``overlap=True``, and the port's synchronous engine: equal greedy
    streams; equal scheduling counters between the two overlapped
    engines."""
    kw, batches, req, succ = _traffic(feature)
    jeng = _engine("jax", succ, overlap=True, **kw)
    teng = _engine("torch", succ, overlap=True, **kw)
    sync = _engine("torch", succ, **kw)
    want = _serve(jeng, batches, **req)
    got = _serve(teng, batches, **req)
    assert got == want
    assert _serve(sync, batches, **req) == got
    assert teng.inflight_depth == 0          # run() drains the pipeline
    for k in COUNTERS:
        assert getattr(teng, k) == getattr(jeng, k), k
    assert teng.overlap_steps > 0, "the pipeline never double-buffered"
    assert sync.overlap_steps == 0 and sync.quiesces == 0
    if feature == "eos":
        assert got[2][-1] == req["eos_token_id"] and len(got[2]) == 7
    if feature == "preempt":
        assert teng.preemptions > 0
    if feature == "speculative":
        assert teng.verify_steps > 0 and teng.quiesces > 0
        for (p, _), g in zip(batches[0], got):
            assert g == _chain(SUCC[p[-1]], 12)
    if feature in ("default", "chunked"):
        assert teng.cache_hits > 0


def _host_state(eng):
    return ([None if sl is None else
             (sl.req.rid, list(sl.req.generated), sl.pending, sl.prefill_pos)
             for sl in eng._slots], eng._lengths.tolist(),
            [r.rid for r in eng._queue])


def test_quiesce_leaves_exact_host_state():
    """Two steps leave a dispatch in flight; quiesce() drains it to the
    same host state (slots, generated tokens, pendings, lengths, queue) as
    the JAX engine's quiesce() after the same steps, with no deferred
    device token left; a second quiesce() has nothing to do."""
    ps = _prompts(5, 3, 20, seed=41)
    engs = [_engine(pkg, overlap=True) for pkg in ("jax", "torch")]
    for eng in engs:
        for p in ps:
            eng.submit(p, max_new_tokens=9)
        eng.step()
        eng.step()
        assert eng.inflight_depth == 1
        assert eng.quiesce() is True
        assert eng.inflight_depth == 0
        for sl in eng._slots:
            if sl is not None and sl.prefill_pos is None:
                assert sl.pending_dev is None
                assert isinstance(sl.pending, int)
        eng.check_invariants()
        assert eng.quiesce() is False
    assert _host_state(engs[1]) == _host_state(engs[0])
    assert engs[1].quiesces == engs[0].quiesces == 1
    done = [eng.run() for eng in engs]
    assert {r: q.generated for r, q in done[1].items()} \
        == {r: q.generated for r, q in done[0].items()}


def test_sync_engine_quiesce_is_noop():
    eng = _engine("torch")
    eng.submit(_prompts(1, 5, 6, seed=3)[0], max_new_tokens=4)
    eng.step()
    assert eng.inflight_depth == 0 and eng.quiesce() is False
    eng.run()


@pytest.mark.parametrize("overlap", [False, True])
def test_on_token_equals_final_record(overlap):
    ps = _prompts(5, 3, 20, seed=43)
    eng = _engine("torch", overlap=overlap)
    got = {}
    rids = [eng.submit(p, max_new_tokens=m,
                       on_token=got.setdefault(i, []).append)
            for i, (p, m) in enumerate(zip(ps, (10, 7, 12, 9, 1)))]
    done = eng.run()
    for i, r in enumerate(rids):
        assert got[i] == done[r].generated
    assert [len(got[i]) for i in range(5)] == [10, 7, 12, 9, 1]


def test_request_stream_drives_engine_and_replays_after_retirement():
    ps = _prompts(2, 5, 12, seed=47)
    eng = _engine("torch", overlap=True)
    rid = eng.submit(ps[0], max_new_tokens=10)
    other = eng.submit(ps[1], max_new_tokens=7)
    req = eng.lookup(rid)
    streamed = list(req.stream())          # drives the engine itself
    done = eng.run()                       # finishes the ride-along
    assert streamed == done[rid].generated and len(streamed) == 10
    assert len(done[other].generated) == 7
    assert list(done[rid].stream()) == streamed
    sync = _engine("torch")
    assert _serve(sync, [[(ps[0], {})]], max_new_tokens=10)[0] == streamed


def test_request_lifecycle_times():
    eng = _engine("torch", overlap=True)
    rid = eng.submit(_prompts(1, 6, 7, seed=5)[0], max_new_tokens=6,
                     trace_id=77)
    r = eng.run()[rid]
    assert r.trace_id == 77 and r.retire_time == r.finish_time > 0
    assert r.ttft == pytest.approx(r.queue_time + r.prefill_time)
    assert r.tpot > 0 and len(r.output_ids) == len(r.prompt) + 6


def test_jit_variants_count_dispatch_variants():
    """One decode variant per (K, greedy) and one verify step per engine,
    as the JAX engine's executables."""
    ps = _spec_prompts()
    eng = _engine("torch", succ=True, speculative=4)
    eng.submit(ps[0], max_new_tokens=12)
    eng.submit(ps[2], max_new_tokens=12, temperature=1.0)
    eng.run()
    assert eng.jit_variants() == {"decode_step": 1, "verify_step": 1}
    assert (4, False) in eng._horizon_runs


@pytest.mark.cuda
def test_captured_graphs_match_the_eager_horizon_on_card():
    """On the card the engine replays captured CUDA graphs; its greedy
    stream and the attention kernel's launch count (replays included)
    equal the eager horizon called directly, with and without overlap;
    a sampled request repeats under one seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from paddle_tpu_torch.models.llama import (build_llama_paged_decode,
                                               make_paged_decode_horizon)
    from paddle_tpu_torch.ops.paged_attention import ragged_paged_attention
    _, tp, _, tcfg = _models(4)
    prompt = _prompts(1, 20, 21, seed=53)[0]
    n, K, L = 17, 4, tcfg.num_hidden_layers
    # the eager reference: dense prefill, then horizons called directly
    init, prefill, _, decode_step, _ = build_llama_paged_decode(
        tcfg, page_size=8, num_pages=16, device="cuda")
    pages = init()
    params = tuple({k: v.cuda() for k, v in t.items()} for t in tp)
    row = torch.arange(16, dtype=torch.int32, device="cuda")
    ids = torch.zeros((1, 32), dtype=torch.int32, device="cuda")
    ids[0, :len(prompt)] = torch.from_numpy(prompt)
    logits, _, _ = prefill(params, ids, len(prompt), row, pages["k"],
                           pages["v"])
    horizon = make_paged_decode_horizon(decode_step)
    want = [int(torch.argmax(logits))]
    c = lambda *v: torch.tensor(v, device="cuda")  # noqa: E731
    gen = torch.Generator(device="cuda")
    ragged_paged_attention.launches = 0
    while len(want) < n:
        out, *_ = horizon(
            params, c(want[-1]).int(), c(len(prompt) + len(want) - 1).int(),
            row[None], pages["k"], pages["v"], c(True), gen, c(0.0),
            c(1.0), c(n - len(want)).int(), c(-1).int(), c(False),
            K=K, greedy=True)
        want += out[0].tolist()[:n - len(want)]
    eager_launches = ragged_paged_attention.launches
    for overlap in (False, True):
        eng = tpaged.ServingEngine(tp, tcfg, num_slots=2, page_size=8,
                                   num_pages=16, prompt_bucket=32,
                                   decode_horizon=K, overlap=overlap)
        ragged_paged_attention.launches = 0
        rid = eng.submit(prompt, max_new_tokens=n)
        got = eng.run()[rid].generated
        assert got == want
        assert ragged_paged_attention.launches == eager_launches \
            == L * eng.decode_model_steps
        assert eng._horizon_runs[K, True].graph is not None
        eng.check_invariants()

    def sampled(seed):
        eng = tpaged.ServingEngine(tp, tcfg, num_slots=2, page_size=8,
                                   num_pages=16, decode_horizon=K, seed=seed)
        rid = eng.submit(prompt, max_new_tokens=n, temperature=1.0)
        out = eng.run()[rid].generated
        assert eng._horizon_runs[K, False].graph is not None
        return out

    assert sampled(5) == sampled(5)
