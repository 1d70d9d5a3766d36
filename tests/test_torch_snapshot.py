"""Port parity: snapshot / restore and the KV handoff (``export_kv`` /
``import_kv``) of paddle_tpu_torch's ServingEngine, on the CPU.

A snapshot taken mid-flight from an overlapped engine (a dispatch in
flight) restores into a fresh engine, in both modes and at every KV dtype,
and the continuation is bit-equal to an uninterrupted run.  A handoff
packet crosses between the JAX engine (``attention_impl="ref"``) and the
port in both directions at f32 and int8 (fp8 packets carry the codes'
uint8 bits, which the JAX side cannot read, so fp8 round-trips within the
port), and the greedy continuation equals the source engine's
uninterrupted streams.  Restore and import write into the existing page
pool: no pool tensor moves (captured CUDA graphs hold their addresses).
Weights: ``tests/test_torch_serving.py``'s margin-engineered ones."""
import numpy as np
import pytest

from test_torch_serving import (_jax_plain_dispatch,  # noqa: F401
                                _models, _port_engines_stay_consistent,
                                _prompts, _serve)
from paddle_tpu.inference.paged import ServingEngine as JEngine
from paddle_tpu_torch.inference import paged as tpaged

BASE = dict(num_slots=3, page_size=4, num_pages=48, prompt_bucket=16,
            decode_horizon=3)
PROMPTS = _prompts(5, 3, 20, seed=61)
PROMPTS[1] = np.concatenate([PROMPTS[0][:8], PROMPTS[1]])   # shares 2 pages
NEWS = [12, 10, 14, 9, 11]


def _port(**kw):
    _, tp, _, tcfg = _models(4)
    return tpaged.ServingEngine(tp, tcfg, device="cpu", **dict(BASE, **kw))


def _leaves(eng):
    out = []
    for store in (eng._pages_k, eng._pages_v):
        out += list(store.values()) if isinstance(store, dict) else [store]
    return out


def _ptrs(eng):
    return [t.data_ptr() for t in _leaves(eng)]


def _batch():
    return [[(p, {"max_new_tokens": m}) for p, m in zip(PROMPTS, NEWS)]]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("mode", ["full_kv", "compact"])
def test_snapshot_midflight_restore_continues_bit_exact(mode, kv_dtype):
    want = _serve(_port(kv_dtype=kv_dtype), _batch())
    eng = _port(kv_dtype=kv_dtype, overlap=True)
    rids = [eng.submit(p, max_new_tokens=m) for p, m in zip(PROMPTS, NEWS)]
    for _ in range(3):
        eng.step()
    assert eng.inflight_depth == 1
    state = eng.snapshot(mode=mode)
    assert eng.inflight_depth == 0            # the snapshot quiesced first
    assert eng.quiesces == 1
    fresh = _port(kv_dtype=kv_dtype, overlap=True)
    ptrs = _ptrs(fresh)
    assert fresh.restore(state) == ("full_kv" if mode == "full_kv"
                                    else "reprefill")
    assert _ptrs(fresh) == ptrs
    fresh.check_invariants()
    done = fresh.run()
    assert [done[r].generated for r in rids] == want
    assert fresh.stats()["quiesces"] >= 1     # counters ride the snapshot
    with pytest.raises(RuntimeError):
        fresh.restore(state)                   # only into a fresh engine
    done = eng.run()                           # the original still finishes
    assert [done[r].generated for r in rids] == want
    if mode == "full_kv":
        planes = {"int8": ("kv_k_q", np.int8), "fp8": ("kv_k_q", np.uint8),
                  None: ("kv_k", np.float32)}[kv_dtype]
        assert state[planes[0]].dtype == planes[1]
        assert len(state["kv_pages"]) == state[planes[0]].shape[2]


def test_full_kv_snapshot_into_another_pool_reprefills():
    """A full-KV snapshot restored into a pool of another size takes the
    re-prefill path; finished requests ride the snapshot."""
    want = _serve(_port(), _batch())
    eng = _port(overlap=True)
    rids = [eng.submit(p, max_new_tokens=m) for p, m in zip(PROMPTS, NEWS)]
    for _ in range(4):
        eng.step()
    state = eng.snapshot()
    small = _port(num_pages=40)
    assert small.restore(state) == "reprefill"
    done = small.run()
    assert [done[r].generated for r in rids] == want
    eng.run()


def _handoff(src, dst, prompts, news, steps=2):
    """Submit to ``src``, step it until every request has decoded past its
    first token, export the slot-resident requests, cancel them there,
    import into ``dst`` and run it; returns {prompt index: stream}."""
    rids = [src.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    for _ in range(steps):
        src.step()
    assert all(src.handoff_ready(r) for r in rids)
    assert all(len(src.lookup(r).generated) > 1 for r in rids)
    packet = src.export_kv(rids)
    for r in rids:
        src.cancel(r)
    ptrs = None if isinstance(dst, JEngine) else _ptrs(dst)
    mapping = dst.import_kv(packet)
    if ptrs is not None:
        assert _ptrs(dst) == ptrs
    done = dst.run()
    return {i: done[mapping[r]].generated for i, r in enumerate(rids)}, \
        packet


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_kv_handoff_crosses_between_jax_and_port(kv_dtype):
    """JAX engine -> port engine and port engine -> JAX engine, two
    requests that share cached prefix pages, mid-decode: each continuation
    equals the JAX engine's uninterrupted streams."""
    jp, _, jcfg, _ = _models(4)
    jeng = JEngine(jp, jcfg, attention_impl="ref", kv_dtype=kv_dtype,
                   **BASE)
    prompts, news = PROMPTS[:2], NEWS[:2]
    want = _serve(jeng, [[(p, {"max_new_tokens": m})
                          for p, m in zip(prompts, news)]])
    got, packet = _handoff(jeng, _port(kv_dtype=kv_dtype), prompts, news)
    assert [got[0], got[1]] == want
    assert packet["kv_dtype"] == kv_dtype and packet["tp"] == 1
    teng = _port(kv_dtype=kv_dtype, overlap=True)
    got, packet = _handoff(teng, jeng, prompts, news)
    assert [got[0], got[1]] == want
    assert teng.stats()["kv_exports"] == 1
    assert teng.stats()["kv_pages_exported"] == len(packet["kv_pages"])
    teng.check_invariants()


def test_kv_handoff_fp8_round_trips_within_the_port():
    want = _serve(_port(kv_dtype="fp8"), [[(PROMPTS[2], {})]],
                  max_new_tokens=14)
    dst = _port(kv_dtype="fp8", overlap=True)
    got, packet = _handoff(_port(kv_dtype="fp8"), dst, PROMPTS[2:3], [14])
    assert got[0] == want[0]
    assert packet["planes"]["kv_k_q"].dtype == np.uint8
    assert packet["planes"]["kv_v_s"].dtype == np.float32
    assert dst.stats()["kv_imports"] == 1
    assert dst.stats()["kv_pages_imported"] == len(packet["kv_pages"])


def test_kv_handoff_mismatch_raises():
    src = _port()
    rid = src.submit(PROMPTS[0], max_new_tokens=8)
    src.step()
    assert src.handoff_ready(rid)
    packet = src.export_kv([rid])
    with pytest.raises(KeyError):
        src.export_kv([rid + 999])
    for dst, field, val, needle in [
            (_port(page_size=8), None, None, "page_size"),
            (_port(kv_dtype="int8"), None, None, "kv_dtype"),
            (_port(), "version", 0, "version"),
            (_port(), "tp", 2, "mp degree")]:
        bad = packet if field is None else dict(packet, **{field: val})
        with pytest.raises(tpaged.KVHandoffError, match=needle):
            dst.import_kv(bad)
        assert dst.num_active == 0 and dst.pool.num_free == \
            dst.pool.num_pages
    src.cancel(rid)
    dst = _port()
    rid2 = dst.import_kv(packet)[rid]          # the packet still splices
    assert dst.run()[rid2].generated \
        == _serve(_port(), [[(PROMPTS[0], {})]], max_new_tokens=8)[0]
