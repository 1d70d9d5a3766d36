"""Port parity: cancellation, deadlines and ``Request.stream()`` early exit
of paddle_tpu_torch's ServingEngine against the JAX engine
(``attention_impl="ref"``) on the CPU.

Each case of ``tests/test_cancel_stream.py`` (and the deadline case of
``tests/test_overlap.py``) runs as one scenario function on both engines —
the port mirrors the JAX engine's names, so the same code drives either —
and the outcomes must be equal: which requests finished, their greedy
streams (margin-engineered weights, ``tests/test_torch_serving.py``), the
timed-out flags and the counters.  Survivors must also equal an
uninterrupted run, and every page must come back."""
import gc

import numpy as np
import pytest

from test_torch_serving import (_jax_plain_dispatch,  # noqa: F401
                                _models, _port_engines_stay_consistent,
                                _prompts, _spec_prompts)
from paddle_tpu.inference.paged import ServingEngine as JEngine
from paddle_tpu_torch.inference import paged as tpaged

PROMPTS = _prompts(4, 3, 13, seed=23)
PROMPTS[3] = _prompts(1, 12, 13, seed=29)[0]          # 12 tokens: 3 chunks
BASE = dict(num_slots=2, page_size=4, num_pages=64, prompt_bucket=16,
            decode_horizon=3)


_PAIRS = {}


def _both(scenario, succ=False, **kw):
    """Run ``scenario(engine)`` on a JAX and a port engine of the same
    configuration; the outcomes must be equal.  Returns the port's.  One
    pair per configuration serves every scenario (the JAX engine compiles
    once): both start each scenario idle with an empty prefix cache and
    the same submission history, so rids agree."""
    key = (succ,) + tuple(sorted(kw.items()))
    if key not in _PAIRS:
        jp, tp, jcfg, tcfg = _models(4, succ)
        kw = dict(BASE, **kw)
        _PAIRS[key] = (JEngine(jp, jcfg, attention_impl="ref", **kw),
                       tpaged.ServingEngine(tp, tcfg, device="cpu", **kw))
    jeng, teng = _PAIRS[key]
    for eng in (jeng, teng):
        _leakfree(eng)
    want, got = scenario(jeng), scenario(teng)
    assert got == want
    for eng in (jeng, teng):
        _leakfree(eng)
    return got


def _leakfree(eng):
    eng.release_cache()
    assert eng.pool.num_free == eng.pool.num_pages, \
        f"leaked pages: {eng.pool.num_pages - eng.pool.num_free}"
    eng.check_invariants()


def _alone(prompt, n, succ=False):
    """The uninterrupted greedy stream of one request."""
    _, tp, _, tcfg = _models(4, succ)
    eng = tpaged.ServingEngine(tp, tcfg, device="cpu", **BASE)
    rid = eng.submit(prompt, max_new_tokens=n)
    return eng.run()[rid].generated


def _finished(done):
    return {r: (q.generated, q.timed_out) for r, q in done.items()}


def test_cancel_mid_chunked_prefill():
    """Cancel a 12-token prompt after its first 4-token chunk: the slot's
    pages free exactly, and the same prompt submitted again decodes as an
    uninterrupted run would."""
    def scenario(eng):
        rid = eng.submit(PROMPTS[3], max_new_tokens=8)
        eng.step()
        slot = next(sl for sl in eng._slots if sl is not None)
        assert slot.prefill_pos is not None     # genuinely mid-prefill
        assert eng.cancel(rid) is True
        assert eng.lookup(rid) is None and eng.num_active == 0
        eng.check_invariants()
        rid2 = eng.submit(PROMPTS[3], max_new_tokens=8)
        return _finished(eng.run()), rid2, eng.cache_hits

    done, rid2, _ = _both(scenario, prefill_chunk=4)
    assert done[rid2][0] == _alone(PROMPTS[3], 8)


def test_cancel_mid_speculation():
    """Cancel a drafting slot between verify dispatches; the survivor
    keeps its lossless stream."""
    ps = _spec_prompts()

    def scenario(eng):
        ra = eng.submit(ps[0], max_new_tokens=16)
        rb = eng.submit(ps[1], max_new_tokens=16)
        for _ in range(3):
            eng.step()
        assert eng.verify_steps >= 1
        victim = next(sl for sl in eng._slots
                      if sl is not None and sl.req.rid == ra)
        assert victim.draft is not None
        assert eng.cancel(ra) is True
        done = eng.run()
        assert ra not in done
        return _finished(done), rb, eng.verify_steps

    done, rb, _ = _both(scenario, succ=True, speculative=4)
    assert done[rb][0] == _alone(ps[1], 16, succ=True)


def test_cancel_overlap_inflight_dispatch():
    """Cancel a request riding the in-flight dispatch: cancel quiesces
    first, then frees; the survivor's stream is untouched."""
    def scenario(eng):
        ra = eng.submit(PROMPTS[0], max_new_tokens=40)
        rb = eng.submit(PROMPTS[1], max_new_tokens=10)
        eng.step()
        eng.step()
        assert eng.inflight_depth == 1
        assert any(ln.slot.req.rid == ra for ln in eng._inflight.lanes)
        assert eng.cancel(ra) is True
        assert eng.inflight_depth == 0
        done = eng.run()
        assert ra not in done
        return _finished(done), rb, eng.quiesces

    done, rb, _ = _both(scenario, overlap=True)
    assert done[rb][0] == _alone(PROMPTS[1], 10)


def test_cancel_detached_predicted_retirement():
    """A budget-predicted retirement rides the in-flight dispatch detached
    from the slot table; cancelling it drains and frees exactly."""
    def scenario(eng):
        ra = eng.submit(PROMPTS[0], max_new_tokens=5)
        rb = eng.submit(PROMPTS[1], max_new_tokens=40)
        detached = None
        for _ in range(12):
            eng.step()
            if eng._inflight is None:
                continue
            eng._detach_predicted()
            retiring = [ln for ln in eng._inflight.lanes if ln.retiring]
            if retiring:
                detached = retiring[0].slot.req.rid
                break
        assert detached == ra
        assert eng.lookup(ra) is not None       # detached but still live
        eng.check_invariants()                  # the lane holds its pages
        assert eng.cancel(ra) is True
        assert eng.lookup(ra) is None and eng.inflight_depth == 0
        eng.check_invariants()
        assert eng.cancel(rb) is True
        done = eng.run()
        assert ra not in done and rb not in done
        return _finished(done), eng.quiesces

    _both(scenario, overlap=True)


def test_cancel_queued_finished_and_unknown():
    def scenario(eng):
        ra = eng.submit(PROMPTS[0], max_new_tokens=4)
        rb = eng.submit(PROMPTS[1], max_new_tokens=4)
        rq = eng.submit(PROMPTS[2], max_new_tokens=4)    # queued: 2 slots
        assert eng.cancel(rq) is True
        done = eng.run()
        assert rq not in done
        assert eng.cancel(ra) is True                    # finished record
        assert eng.lookup(ra) is None
        return (_finished(done), eng.cancel(ra), eng.cancel(10_000),
                rb in done)

    assert _both(scenario)[1:] == (False, False, True)


@pytest.mark.parametrize("overlap", [False, True])
def test_deadline_and_cancel_act_on_exact_state(overlap):
    """A request already overdue when the sweep runs retires with
    ``timed_out`` (a dispatch in flight is drained first), a cancelled one
    records nothing, and the rest finish."""
    def scenario(eng):
        rids = [eng.submit(p, max_new_tokens=12) for p in PROMPTS[:3]]
        late = eng.submit(PROMPTS[3], max_new_tokens=12, timeout=0.0)
        eng.step()
        eng.step()
        assert eng.cancel(rids[0]) is True
        assert eng.inflight_depth == 0
        done = eng.run()
        assert rids[0] not in done and done[late].timed_out
        eng.check_invariants()
        return (_finished(done), eng.stats()["timeouts"],
                {r: done[r].generated == _alone(PROMPTS[i], 12)
                 for i, r in enumerate(rids[1:], 1)})

    got = _both(scenario, num_slots=3, overlap=overlap)
    assert got[1] == 1 and all(got[2].values())


class TestStreamEarlyExit:
    def test_break_cancels_request(self):
        def scenario(eng):
            rid = eng.submit(PROMPTS[0], max_new_tokens=24)
            got = []
            for tok in eng.lookup(rid).stream():
                got.append(tok)
                if len(got) == 3:
                    break
            assert eng.lookup(rid) is None, "break did not cancel"
            eng.run()
            return got

        assert _both(scenario) == _alone(PROMPTS[0], 24)[:3]

    def test_gc_cancels_request(self):
        def scenario(eng):
            rid = eng.submit(PROMPTS[1], max_new_tokens=24)
            it = eng.lookup(rid).stream()
            first = next(it)
            del it
            gc.collect()
            assert eng.lookup(rid) is None, "a dropped stream did not cancel"
            eng.run()
            return first

        _both(scenario)

    def test_opt_out_keeps_request_running(self):
        def scenario(eng):
            rid = eng.submit(PROMPTS[2], max_new_tokens=8)
            for i, _ in enumerate(eng.lookup(rid).stream(
                    cancel_on_close=False)):
                if i == 1:
                    break
            assert eng.lookup(rid) is not None
            return eng.run()[rid].generated

        assert _both(scenario) == _alone(PROMPTS[2], 8)

    def test_normal_exhaustion_does_not_cancel(self):
        def scenario(eng):
            rid = eng.submit(PROMPTS[0], max_new_tokens=6)
            toks = list(eng.lookup(rid).stream())
            req = eng.lookup(rid)
            assert req is not None and req.finish_time
            assert toks == req.generated
            return toks

        _both(scenario)

    def test_early_exit_mid_overlap(self):
        """Early exit while the pipeline is double-buffered: cancel
        quiesces, the survivor keeps decoding unchanged."""
        def scenario(eng):
            ra = eng.submit(PROMPTS[0], max_new_tokens=40)
            rb = eng.submit(PROMPTS[1], max_new_tokens=10)
            for i, _ in enumerate(eng.lookup(ra).stream()):
                if i == 2:
                    break
            assert eng.lookup(ra) is None
            return _finished(eng.run()), rb

        done, rb = _both(scenario, overlap=True)
        assert done[rb][0] == _alone(PROMPTS[1], 10)


def test_adopt_continues_mid_flight():
    """``adopt`` resumes a request with tokens already emitted elsewhere:
    the continuation equals the uninterrupted stream."""
    full = _alone(PROMPTS[0], 10)

    def scenario(eng):
        rid = eng.submit(PROMPTS[0], max_new_tokens=10)
        eng.step()
        eng.cancel(rid)
        rid2 = eng.adopt(PROMPTS[0], full[:4], max_new_tokens=10)
        return eng.run()[rid2].generated

    assert _both(scenario, overlap=True) == full
    with pytest.raises(ValueError):
        _, tp, _, tcfg = _models(4)
        tpaged.ServingEngine(tp, tcfg, device="cpu").adopt(
            PROMPTS[0], full, max_new_tokens=10)


def test_serve_requests_passes_request_kwargs():
    _, tp, _, tcfg = _models(4)
    seen = []
    reqs, eng = tpaged.serve_requests(
        tp, tcfg, [PROMPTS[0], (PROMPTS[1], {"on_token": seen.append,
                                             "trace_id": 5})],
        device="cpu", overlap=True, max_new_tokens=5, timeout=60.0,
        num_slots=2, page_size=4, decode_horizon=2)
    assert seen == reqs[1].generated and reqs[1].trace_id == 5
    assert all(r.deadline is not None and not r.timed_out for r in reqs)
    assert eng.stats()["overlap_steps"] > 0
    assert np.array_equal(reqs[0].output_ids[:len(PROMPTS[0])], PROMPTS[0])
