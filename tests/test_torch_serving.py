"""Port parity: paddle_tpu_torch.inference.paged.ServingEngine against the JAX
package's ServingEngine(attention_impl="ref") on the CPU.

Both engines serve the same traffic with the same margin-engineered weights
(block weights x 0.15, LM head tied to 4 x the embedding transpose, as
bench.py builds them): greedy argmax margins then sit far above the f32
noise between the two frameworks, so the greedy token streams must be
EQUAL, token for token — and since the port mirrors the scheduler, so must
the scheduling counters.  After every test each port engine must pass
``check_invariants()`` and ``release_cache()`` must return every page.

The same holds for the int8 / fp8 page stores (``kv_dtype``), quantized
weights (``quantize=8``) and speculative decoding (``speculative=4``, whose
verify and draft counters must equal JAX's too).  Traffic for speculation
repeats a segment, so the n-gram index proposes drafts; the K = 2
random-prompt scenario of the JAX suite, which fails on the JAX side
alone, is not used as an oracle."""
import numpy as np
import pytest
import torch

import jax

from paddle_tpu.inference.paged import ServingEngine as JEngine
from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     build_functional_llama)
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig as TConfig

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=128)
_PARAMS = {}


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops, as on a CPU where no Pallas
    override is registered, even after an earlier test on this worker
    registered them (``paddle_tpu.ops.pallas.register_all(force=True)``):
    a registered override would call a Pallas kernel outside interpret
    mode."""
    import paddle_tpu
    prev = paddle_tpu.get_flags(["use_pallas_kernels"])
    paddle_tpu.set_flags({"use_pallas_kernels": False})
    yield
    paddle_tpu.set_flags(prev)


@pytest.fixture(autouse=True)
def _port_engines_stay_consistent():
    yield
    for eng in list(tpaged._LIVE_ENGINES):
        eng.check_invariants()
        if not eng.num_active and not eng._queue:
            eng.release_cache()
            assert eng.pool.num_free == eng.pool.num_pages
        tpaged._LIVE_ENGINES.discard(eng)


# the successor model's LM head: greedy decoding maps token t to SUCC[t]
SUCC = np.random.default_rng(0).permutation(CFG["vocab_size"])


def _models(kv_heads, succ=False):
    """(jax params, port params, jax config, port config), margin-engineered
    from one seed.  ``succ``: the LM head is the embedding of the token
    permuted by SUCC's inverse, so the greedy continuation of t is SUCC[t]
    with a wide margin — traffic can then be built whose drafts are
    accepted or rejected on purpose."""
    if (kv_heads, succ) not in _PARAMS:
        cfg = dict(CFG, num_key_value_heads=kv_heads)
        jcfg = JConfig(**cfg)
        ep, bp, hp, *_ = build_functional_llama(
            jcfg, n_micro=1, key=jax.random.PRNGKey(7))
        bp = {k: (v * 0.15 if k.startswith("w") else v)
              for k, v in bp.items()}
        tok = ep["tok"][np.argsort(SUCC)] if succ else ep["tok"]
        hp = dict(hp, lm=(tok.T * 4.0).astype(hp["lm"].dtype))
        tparams = params_from_numpy(
            *[{k: np.asarray(v) for k, v in t.items()} for t in (ep, bp, hp)],
            device="cpu")
        _PARAMS[kv_heads, succ] = ((ep, bp, hp), tparams, jcfg,
                                   TConfig(**cfg))
    return _PARAMS[kv_heads, succ]


def _engines(kv_heads=4, succ=False, **kw):
    jp, tp, jcfg, tcfg = _models(kv_heads, succ)
    kw = dict(dict(num_slots=3, page_size=4, prompt_bucket=16,
                   decode_horizon=4), **kw)
    return (JEngine(jp, jcfg, attention_impl="ref", **kw),
            tpaged.ServingEngine(tp, tcfg, device="cpu", **kw))


def _prompts(n, lo, hi, seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, CFG["vocab_size"], int(t)).astype(np.int32)
            for t in r.integers(lo, hi, n)]


def _serve(eng, batches, between=2, **req):
    """Submit each batch, stepping ``between`` times after all but the
    last; run to completion; return the token lists in submission order."""
    rids = []
    for i, batch in enumerate(batches):
        for p, kw in batch:
            rids.append(eng.submit(p, **dict(req, **kw)))
        if i + 1 < len(batches):
            for _ in range(between):
                eng.step()
    done = eng.run()
    return [list(done[r].generated) for r in rids]


def _same(jeng, teng, batches, counters=(), **req):
    want = _serve(jeng, batches, **req)
    got = _serve(teng, batches, **req)
    assert got == want
    js, ts = jeng.stats(), teng.stats()
    for k in counters:
        assert ts[k] == js[k], k
    return got, ts


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_staggered_continuous_batching(kv_heads):
    """Three requests start, two engine steps run, three more join the
    running batch (queueing for the three slots)."""
    jeng, teng = _engines(kv_heads)
    ps = _prompts(6, 3, 20, seed=kv_heads)
    news = [5, 9, 3, 7, 4, 6]
    batches = [[(p, {"max_new_tokens": m}) for p, m in
                zip(ps[:3], news[:3])],
               [(p, {"max_new_tokens": m}) for p, m in
                zip(ps[3:], news[3:])]]
    got, _ = _same(jeng, teng, batches,
                   counters=("tokens_generated", "decode_steps",
                             "prefill_tokens_executed", "cache_hits"))
    assert [len(g) for g in got] == news


def test_eos_retires_early():
    jeng0, teng0 = _engines()
    ps = _prompts(3, 4, 12, seed=3)
    free = _serve(teng0, [[(p, {}) for p in ps]], max_new_tokens=10)
    eos = free[1][3]                  # a token request 1 emits mid-stream
    jeng, teng = _engines()
    got, _ = _same(jeng, teng, [[(p, {}) for p in ps]],
                   counters=("tokens_generated",), max_new_tokens=10,
                   eos_token_id=int(eos))
    assert got[1][-1] == eos and len(got[1]) <= 4


def test_tight_pool_stalls_and_preempts():
    """A 12-page pool cannot hold three 8-page requests: the engines walk
    the ladder (cache eviction, stall, preemption + re-prefill) the same
    way and still emit the same tokens."""
    jeng, teng = _engines(num_pages=12)
    ps = _prompts(4, 8, 12, seed=5)
    _, ts = _same(jeng, teng, [[(p, {}) for p in ps]],
                  counters=("preemptions", "cache_evictions",
                            "tokens_generated"),
                  max_new_tokens=20)
    assert ts["preemptions"] > 0


def test_prefix_cache_hit_with_copy_on_write():
    """Request A retires into the cache with a partial tail page; request B
    extends A's prompt + output, attaches A's full pages and copies the
    partial one before its suffix prefill writes the tail."""
    ps = _prompts(1, 10, 11, seed=9)
    jeng, teng = _engines(num_slots=2)
    got_a, _ = _same(jeng, teng, [[(ps[0], {})]], max_new_tokens=5)
    # A's cached context: prompt + 4 of its 5 tokens = 14 tokens = 3 full
    # pages + a 2-token partial page at page_size 4
    b = np.concatenate([ps[0], np.asarray(got_a[0][:3], np.int32),
                        np.array([77, 78, 79], np.int32)])
    got, ts = _same(jeng, teng, [[(b, {})]],
                    counters=("cache_hits", "cached_prefix_tokens",
                              "cow_copies", "prefill_tokens_executed"),
                    max_new_tokens=6)
    assert ts["cache_hits"] >= 1 and ts["cow_copies"] >= 1


def test_chunked_prefill():
    jeng, teng = _engines(prefill_chunk=8)
    ps = _prompts(4, 17, 40, seed=11)
    _same(jeng, teng, [[(ps[0], {}), (ps[1], {})], [(ps[2], {}),
                                                    (ps[3], {})]],
          counters=("prefill_tokens_executed", "tokens_generated"),
          max_new_tokens=6)


def test_sampled_output_is_seeded_and_top_p_zero_is_greedy():
    """Sampled output cannot match JAX (different generators): it must
    repeat under one seed, and a vanishing nucleus must equal greedy."""
    ps = _prompts(3, 4, 12, seed=13)
    _, tp, _, tcfg = _models(4)

    def run(seed, **req):
        eng = tpaged.ServingEngine(tp, tcfg, device="cpu", num_slots=3,
                                   page_size=4, prompt_bucket=16,
                                   decode_horizon=4, seed=seed)
        return _serve(eng, [[(p, {}) for p in ps]], max_new_tokens=8, **req)

    hot = dict(temperature=1.5, top_p=0.95)
    assert run(1, **hot) == run(1, **hot)
    assert run(2, temperature=1.0, top_p=1e-9) == run(2)


def test_serve_requests_one_shot():
    _, tp, _, tcfg = _models(2)
    ps = _prompts(3, 4, 12, seed=17)
    reqs, eng = tpaged.serve_requests(
        tp, tcfg, [ps[0], (ps[1], {"max_new_tokens": 3}), ps[2]],
        device="cpu", num_slots=2, page_size=4, max_new_tokens=5)
    assert [len(r.generated) for r in reqs] == [5, 3, 5]
    assert all(r.ttft > 0 and r.finish_time > 0 for r in reqs)
    assert eng.stats()["tokens_generated"] == 13


def test_prefix_chain_hashes_match_jax():
    from paddle_tpu.inference.paged import prefix_chain_hashes as jhash
    toks = _prompts(1, 37, 38, seed=19)[0]
    assert tpaged.prefix_chain_hashes(toks, 4) == jhash(toks, 4)
    assert len(tpaged.prefix_chain_hashes(toks, 4)) == 9


def test_submit_validation_and_backpressure():
    _, tp, _, tcfg = _models(4)
    eng = tpaged.ServingEngine(tp, tcfg, device="cpu", num_slots=1,
                               page_size=4, num_pages=6, max_pages_per_seq=8,
                               max_queue=1)
    with pytest.raises(ValueError):
        eng.submit([], max_new_tokens=2)
    with pytest.raises(tpaged.PoolCapacityError):   # 9 pages > the row
        eng.submit(np.ones(30, np.int32), max_new_tokens=8)
    with pytest.raises(tpaged.PoolCapacityError):   # 7 pages > the pool
        eng.submit(np.ones(20, np.int32), max_new_tokens=8)
    eng.submit(np.ones(5, np.int32), max_new_tokens=2)
    with pytest.raises(tpaged.AdmissionRejected):
        eng.submit(np.ones(5, np.int32), max_new_tokens=2)
    assert eng.stats()["rejections"] == 1
    eng.run()


def test_page_pool_refuses_double_free():
    pool = tpaged.PagePool(4, 4)
    a, b = pool.alloc(2)
    pool.share([a])
    with pytest.raises(tpaged.PageDoubleFreeError):
        pool.free([b, b])
    pool.free([a, b])
    assert pool.refcount(a) == 1 and pool.num_free == 3
    with pytest.raises(tpaged.PageDoubleFreeError):
        pool.free([b])


def _chain(t, n):
    """n tokens of the successor model's greedy path from t."""
    out = [int(t)]
    for _ in range(n - 1):
        out.append(int(SUCC[out[-1]]))
    return out


def _spec_prompts():
    """Traffic for the successor model.  Prompt 0 holds a stretch of the
    greedy path and ends on its start, so drafts copied from it are
    accepted until the stretch runs into junk; prompt 1 holds the token it
    will emit first followed by junk, so its first drafts are rejected;
    prompt 2 gives the n-gram index nothing to match at first."""
    r = np.random.default_rng(23)
    x, z = (int(t) for t in r.integers(1, CFG["vocab_size"], 2))
    junk = [int(t) for t in r.integers(1, CFG["vocab_size"], 4)]
    return [np.array(_chain(x, 9) + junk[:3] + [x], np.int32),
            np.array([int(SUCC[z])] + junk + [z], np.int32),
            r.integers(1, CFG["vocab_size"], 9).astype(np.int32)]


SPEC_COUNTERS = ("tokens_generated", "decode_steps", "verify_steps",
                 "draft_tokens_proposed", "draft_tokens_accepted")


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_kv_engine_matches_jax(kv_dtype):
    """int8 / fp8 page stores, GQA, chunked prefill, staggered arrivals."""
    jeng, teng = _engines(2, kv_dtype=kv_dtype, prefill_chunk=8)
    ps = _prompts(5, 3, 30, seed=21)
    batches = [[(p, {}) for p in ps[:3]], [(p, {}) for p in ps[3:]]]
    _same(jeng, teng, batches,
          counters=("tokens_generated", "decode_steps",
                    "prefill_tokens_executed", "cache_hits"),
          max_new_tokens=8)
    assert teng._pages_k["q"].dtype == {"int8": torch.int8,
                                        "fp8": torch.float8_e4m3fn}[kv_dtype]
    assert teng._pages_v["s"].dtype == torch.float32
    assert teng.page_bytes == jeng.page_bytes


def test_quantized_kv_prefix_hit_with_copy_on_write():
    """Copy-on-write under an int8 store: the copied page carries its codes
    and its scales, so the suffix prefill after the hit matches JAX."""
    ps = _prompts(1, 10, 11, seed=9)
    jeng, teng = _engines(num_slots=2, kv_dtype="int8")
    got_a, _ = _same(jeng, teng, [[(ps[0], {})]], max_new_tokens=5)
    b = np.concatenate([ps[0], np.asarray(got_a[0][:3], np.int32),
                        np.array([77, 78, 79], np.int32)])
    _, ts = _same(jeng, teng, [[(b, {})]],
                  counters=("cache_hits", "cached_prefix_tokens",
                            "cow_copies", "prefill_tokens_executed"),
                  max_new_tokens=6)
    assert ts["cache_hits"] >= 1 and ts["cow_copies"] >= 1


def test_quantized_weights_engine_matches_jax():
    """quantize=8 snaps the weights to the per-channel int8 grid, here with
    an int8 page store."""
    jeng, teng = _engines(4, quantize=8, kv_dtype="int8")
    ps = _prompts(3, 4, 20, seed=29)
    _same(jeng, teng, [[(p, {}) for p in ps]],
          counters=("tokens_generated",), max_new_tokens=8)
    assert teng.quantize_bits == 8


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_speculative_engine_matches_jax_and_spec_off(kv_dtype):
    """speculative=4: the same streams and verify / draft counters as the
    JAX speculative engine, and the same streams as the port's engine
    without speculation."""
    ps = _spec_prompts()
    jeng, teng = _engines(4, succ=True, speculative=4, kv_dtype=kv_dtype)
    got, ts = _same(jeng, teng, [[(p, {}) for p in ps]],
                    counters=SPEC_COUNTERS, max_new_tokens=12)
    assert 0 < ts["draft_tokens_accepted"] < ts["draft_tokens_proposed"]
    assert ts["decode_steps"] + ts["verify_steps"] == teng.steps_run
    for p, g in zip(ps, got):
        assert g == _chain(SUCC[p[-1]], 12)
    _, tp, _, tcfg = _models(4, succ=True)
    off = tpaged.ServingEngine(tp, tcfg, device="cpu", num_slots=3,
                               page_size=4, prompt_bucket=16,
                               decode_horizon=4, kv_dtype=kv_dtype)
    assert _serve(off, [[(p, {}) for p in ps]], max_new_tokens=12) == got
    assert off.stats()["verify_steps"] == 0


def test_speculative_eos_budget_and_preemption_match_jax():
    """An EOS inside an accepted run, budgets that end mid-run, and a tight
    pool that preempts and re-prefills a speculating slot: streams,
    counters and per-request acceptance equal to JAX."""
    ps = _spec_prompts()
    # prompt 0's first verify accepts drafts 2..5 of its path: stop at 4
    eos = _chain(SUCC[ps[0][-1]], 12)[3]
    jeng, teng = _engines(4, succ=True, speculative=4, num_pages=10)
    batch = [(ps[0], {"eos_token_id": eos}),
             (ps[1], {"max_new_tokens": 7}), (ps[2], {}),
             (np.concatenate([ps[2][:4], ps[0]]), {})]
    got, ts = _same(jeng, teng, [batch],
                    counters=SPEC_COUNTERS + ("preemptions",),
                    max_new_tokens=14)
    assert got[0][-1] == eos and len(got[0]) == 4 and len(got[1]) == 7
    assert ts["preemptions"] > 0
    for rid in range(len(batch)):
        assert teng._finished[rid].draft_accepted \
            == jeng._finished[rid].draft_accepted


def test_speculative_with_sampled_ride_along():
    """A sampled request rides verify dispatches as a one-token lane drawn
    from the position-0 logits: seeded, and the greedy requests' streams
    equal the engine's without speculation."""
    ps = _spec_prompts()
    _, tp, _, tcfg = _models(4, succ=True)
    reqs = [[(ps[0], {}), (ps[1], {"temperature": 1.0, "top_p": 0.9}),
             (ps[2], {})]]

    def run(spec, seed=3):
        eng = tpaged.ServingEngine(tp, tcfg, device="cpu", num_slots=3,
                                   page_size=4, prompt_bucket=16,
                                   decode_horizon=4, seed=seed,
                                   speculative=spec)
        out = _serve(eng, reqs, max_new_tokens=10)
        return out, eng.stats()

    a, st = run(4)
    assert run(4)[0] == a and st["verify_steps"] > 0
    off, _ = run(None)
    assert [a[0], a[2]] == [off[0], off[2]]
    assert len(a[1]) == 10


@pytest.mark.parametrize("max_n", [1, 3])
def test_ngram_draft_matches_jax(max_n):
    """The n-gram proposer on token streams with heavy repetition (a
    4-token alphabet): every proposal along the stream equals JAX's, for
    incremental appends and a rebuild from the whole stream."""
    from paddle_tpu.inference.paged import _NgramDraft as JDraft
    r = np.random.default_rng(max_n)
    toks = [int(t) for t in r.integers(0, 4, 80)]
    jd, td = JDraft(toks[:10], max_n=max_n), tpaged._NgramDraft(
        toks[:10], max_n=max_n)
    for t in toks[10:]:
        jd.append(t)
        td.append(t)
        for k in (0, 1, 4, 7):
            assert td.propose(k) == jd.propose(k)
    assert tpaged._NgramDraft(toks, max_n=max_n).propose(6) == jd.propose(6)
