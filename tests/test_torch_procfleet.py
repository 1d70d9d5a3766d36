"""Port parity: paddle_tpu_torch.serving.ProcessFleet, the cross-process
serving fleet, under the JAX suite's drills (tests/test_procfleet.py) at its
``SPEC`` geometry (2 slots, pages of 4, decode horizon 2).

Real worker processes (``python -m paddle_tpu_torch.serving.worker``, on
the CPU here) under real signals: SIGKILL mid-decode (crash), SIGSTOP
(wedge: heartbeat timeouts, then the supervisor's SIGKILL), SIGTERM (the
zero-loss drain ladder), the retire ladder and the cross-process leak
guard.  The workers load an npz of ``test_torch_serving._models``'
margin-engineered weights; the oracle is the JAX package's uninterrupted
single ``ServingEngine(attention_impl="ref")`` on the same weights and
prompts.  Acceptance: zero requests lost, greedy streams equal to the
oracle's, no token emitted twice, and every spawned worker generation
files a passing invariants report.

The round trip and the SIGKILL drill stay in the fast lane (a worker
boots in a few seconds here: no JAX, no compile); the other drills are
marked ``slow`` as JAX's file is — the SIGTERM drill signals the test
process itself."""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.inference.paged import ServingEngine as JEngine
from paddle_tpu_torch.serving import procfleet
from paddle_tpu_torch.serving.procfleet import ProcessFleet
from paddle_tpu_torch.serving.worker import save_weights_npz
from test_torch_serving import CFG, _jax_plain_dispatch, _models  # noqa: F401

ENGINE = dict(num_slots=2, page_size=4, num_pages=40, max_pages_per_seq=16,
              prompt_bucket=8, decode_horizon=2)
N_NEW = 12
rng = np.random.default_rng(7)
PROMPTS = [rng.integers(1, 64, (t,)).astype(np.int32)
           for t in (5, 7, 3, 6, 4, 6)]
_REF = {}


@pytest.fixture(autouse=True)
def _no_port_worker_leak():
    """The cross-process leak guard over the port's fleets (the suite's
    conftest watches the JAX package's): every worker generation a test
    spawned must have filed a final invariants report that holds —
    directly at teardown, or through its replacement's post-restore check
    — and a fleet left running is force-killed and fails the test."""
    yield
    problems = []
    for fl in list(procfleet._LIVE_FLEETS):
        procfleet._LIVE_FLEETS.discard(fl)
        if not fl.closed:
            fl.shutdown(drain=False, force=True)
            problems.append("test leaked a running ProcessFleet "
                            "(never shut down; workers force-killed)")
            continue
        try:
            fl.assert_worker_invariants()
        except AssertionError as e:
            problems.append(str(e))
    assert not problems, "; ".join(problems)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """The workers' spec: the margin-engineered MHA model's weights as an
    npz, on the CPU, at JAX's SPEC engine geometry."""
    _, tparams, _, _ = _models(4)
    path = str(tmp_path_factory.mktemp("weights") / "weights.npz")
    save_weights_npz(tparams, path)
    return {"device": "cpu",
            "model": {"config": dict(CFG, num_key_value_heads=4),
                      "dtype": "float32", "weights": {"npz": path}},
            "engine": dict(ENGINE)}


def _refs():
    """The JAX engine's uninterrupted streams of PROMPTS."""
    if not _REF:
        jparams, _, jcfg, _ = _models(4)
        eng = JEngine(jparams, jcfg, attention_impl="ref", **ENGINE)
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=N_NEW)
        _REF.update({i: list(r.generated)
                     for i, r in sorted(eng.run().items())})
        eng.release_cache()
    return _REF


def _fleet(spec, tmp_path, **kw):
    kw.setdefault("num_workers", 2)
    kw.setdefault("heartbeat_timeout", 2.0)
    kw.setdefault("snapshot_every", 3)
    return ProcessFleet(spec, workdir=str(tmp_path / "fleet"), **kw)


def _check_bitexact(frids, results):
    ref = _refs()
    assert len(results) == len(frids), "request lost"
    for i, f in enumerate(frids):
        assert list(results[f].generated) == ref[i], f"request {i} diverged"


def test_bitexact_and_clean_teardown(spec, tmp_path):
    want = _refs()
    fl = _fleet(spec, tmp_path)
    frids = [fl.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    res = fl.run()
    _check_bitexact(frids, res)
    st = fl.stats()
    assert st["workers_alive"] == 2 and st["failovers"] == 0
    assert st["rpc"]["calls"] > 0
    assert st["spawns"] == 2 and len(fl.spawn_s) == 2
    # on the CPU every worker ran the plain version, never a kernel
    for key, ws in fl.worker_stats().items():
        k = ws["kernels"]
        assert k["launches"] == k["quant_launches"] == 0, key
        assert k["plain_calls"] > 0, key
    assert sum(ws["tokens_generated"]
               for ws in fl.worker_stats().values()) \
        == sum(len(s) for s in want.values())
    fl.shutdown()
    fl.assert_worker_invariants()
    assert set(fl.final_reports) == {"w0#0", "w1#0"}
    assert all(r["invariants_ok"] for r in fl.final_reports.values())


@pytest.mark.slow
def test_leak_guard_requires_shutdown(spec, tmp_path):
    fl = _fleet(spec, tmp_path, num_workers=1)
    with pytest.raises(AssertionError, match="never shut down"):
        fl.assert_worker_invariants()
    fl.shutdown()
    fl.assert_worker_invariants()


def test_sigkill_zero_loss_bitexact_and_stream_once(spec, tmp_path):
    _refs()
    fl = _fleet(spec, tmp_path)
    streams: dict[int, list] = {}
    frids = []
    for p in PROMPTS:
        acc: list = []
        frid = fl.submit(p, max_new_tokens=N_NEW, on_token=acc.append)
        streams[frid] = acc
        frids.append(frid)
    while fl.tokens_streamed < 8:
        fl.step()
    victim = fl._workers[0]
    dead_key = victim.key()
    os.kill(victim.pid, signal.SIGKILL)       # real crash mid-decode
    res = fl.run()
    _check_bitexact(frids, res)
    st = fl.stats()
    assert st["failovers"] == 1
    assert st["worker_restarts"]["w0"] == 1
    assert st["recovery"]["count"] == 1
    assert st["recovery"]["p50_ms"] > 0.0     # wall-clock, not virtual
    assert len(fl.spawn_s) == 3               # two boots and a replacement
    # the fleet-level hook fired exactly once per position even though the
    # replacement re-decoded tokens the supervisor had already streamed
    for i, f in enumerate(frids):
        assert streams[f] == _refs()[i], "double-streamed token"
    fl.shutdown()
    fl.assert_worker_invariants()
    assert fl.final_reports[dead_key]["via"] == "replacement_restore"
    assert fl.final_reports[dead_key]["invariants_ok"] is True


@pytest.mark.slow
def test_stitched_trace_crosses_process_boundary(spec, tmp_path):
    _refs()
    fl = _fleet(spec, tmp_path, trace_every=2)
    frids = [fl.submit(p, max_new_tokens=N_NEW) for p in PROMPTS[:4]]
    while fl.tokens_streamed < 8:
        fl.step()
    os.kill(fl._workers[0].pid, signal.SIGKILL)
    res = fl.run()
    _check_bitexact(frids, res)
    summary = fl.stitcher().summary()
    # supervisor track + at least one worker-process track in a single
    # flow chain: the trace_id crossed the wire
    assert len(summary["max_chain"]) >= 2, summary
    comps = [n for n, _ in fl.trace_components()]
    assert "supervisor" in comps and len(comps) >= 2
    fl.shutdown()
    fl.assert_worker_invariants()


@pytest.mark.slow
def test_wedged_worker_is_killed_and_failed_over(spec, tmp_path):
    _refs()
    fl = _fleet(spec, tmp_path, heartbeat_timeout=0.5, wedge_heartbeats=2)
    frids = [fl.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    while fl.tokens_streamed < 8:
        fl.step()
    victim = fl._workers[1]
    os.kill(victim.pid, signal.SIGSTOP)       # wedged, not dead
    res = fl.run()
    _check_bitexact(frids, res)
    kinds = [e["kind"] for e in fl.flight.events()
             if e["event"] == "failover"]
    assert kinds == ["wedge"]
    assert fl.stats()["worker_restarts"]["w1"] == 1
    fl.shutdown()
    fl.assert_worker_invariants()


@pytest.mark.slow
def test_retire_worker_migrates_streams(spec, tmp_path):
    _refs()
    fl = _fleet(spec, tmp_path)
    frids = [fl.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    while fl.tokens_streamed < 4:
        fl.step()
    fl.retire_worker("w0")
    assert fl.final_reports["w0#0"]["kind"] == "retired"
    assert fl.final_reports["w0#0"]["invariants_ok"] is True
    res = fl.run()
    _check_bitexact(frids, res)
    assert fl.stats()["workers_alive"] == 1
    fl.shutdown()
    fl.assert_worker_invariants()


@pytest.mark.slow
def test_sigterm_drains_then_stops(spec, tmp_path):
    _refs()
    fl = _fleet(spec, tmp_path)
    frids = [fl.submit(p, max_new_tokens=N_NEW) for p in PROMPTS[:4]]
    threading.Timer(
        0.3, lambda: os.kill(os.getpid(), signal.SIGTERM)).start()
    fl.run()
    deadline = time.monotonic() + 60
    while not fl.closed and time.monotonic() < deadline:
        fl.run()
        time.sleep(0.05)
    assert fl.closed, "SIGTERM did not drain-shutdown the fleet"
    _check_bitexact(frids, fl.results())
    fl.assert_worker_invariants()


def test_spawns_the_port_worker_without_jax_platforms(spec, tmp_path,
                                                      monkeypatch):
    """The supervisor starts ``python -m paddle_tpu_torch.serving.worker``
    with the repo root first on PYTHONPATH and sets no JAX_PLATFORMS (the
    JAX fleet sets it to cpu for its workers); the worker serves its
    spec's warm-up before its hello, reports its boot stages in the hello
    and its kernel counters in ``stats``."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    seen = []
    real = procfleet.subprocess.Popen

    def popen(cmd, **kw):
        seen.append((list(cmd), dict(kw["env"])))
        return real(cmd, **kw)

    monkeypatch.setattr(procfleet.subprocess, "Popen", popen)
    fl = _fleet(dict(spec, warmup=[[5, 3], [9, 2]]), tmp_path,
                num_workers=1)
    (cmd, env), = seen
    assert cmd[1:3] == ["-m", "paddle_tpu_torch.serving.worker"]
    assert "JAX_PLATFORMS" not in env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == root
    assert env["PADDLE_TRAINERS_NUM"] == "1" and env["RANK"] == "0"
    ws = fl.worker_stats()["w0#0"]
    assert ws["kernels"]["launches"] == 0 and ws["kernels"]["plain_calls"]
    assert ws["tokens_generated"] == 5      # the warm-up, before any request
    (boot,) = fl.boot_s
    assert set(boot) == {"imports", "weights", "kernels", "engine", "warmup"}
    assert len(fl.spawn_s) == 1 and fl.spawn_s[0] >= sum(boot.values())
    fl.shutdown()
    fl.assert_worker_invariants()


def test_weights_npz_round_trip(tmp_path):
    """``save_weights_npz`` / ``load_weights_npz``: bf16 leaves travel as
    their uint16 bits and come back bit for bit, f32 leaves exactly, each
    cast to the spec's dtype; the loaded leaves are writable copies, not
    the file's pages; a compressed npz of the same names loads too."""
    from paddle_tpu_torch.serving.worker import load_weights_npz
    r = np.random.default_rng(0)
    bf = torch.from_numpy(r.standard_normal((3, 5)).astype(np.float32)) \
        .bfloat16()
    f32 = r.standard_normal((2, 4, 4)).astype(np.float32)
    path = str(tmp_path / "w.npz")
    save_weights_npz(({"tok": bf}, {"wq": torch.from_numpy(f32)},
                      {"lm": f32[0]}), path)
    z = np.load(path)
    assert sorted(z.files) == ["block/wq", "embed/tok", "head/lm"]
    assert z["embed/tok"].dtype == np.uint16
    ep, bp, hp = load_weights_npz(path, torch.device("cpu"), torch.bfloat16)
    assert torch.equal(ep["tok"], bf)
    assert torch.equal(bp["wq"], torch.from_numpy(f32).bfloat16())
    ep, bp, hp = load_weights_npz(path, torch.device("cpu"), torch.float32)
    assert torch.equal(ep["tok"], bf.float()) and hp["lm"].shape == (4, 4)
    assert np.array_equal(bp["wq"].numpy(), f32)
    ep["tok"].add_(1.0)                      # a copy, not the file's pages
    packed = str(tmp_path / "c.npz")
    np.savez_compressed(packed, **{"embed/tok": f32[1], "head/lm": f32[0]})
    ep, _, hp = load_weights_npz(packed, torch.device("cpu"), torch.float32)
    assert np.array_equal(ep["tok"].numpy(), f32[1])
