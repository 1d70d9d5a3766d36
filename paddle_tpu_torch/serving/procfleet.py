"""ProcessFleet: the replica boundary promoted from thread to OS process.

Port of ``paddle_tpu/serving/procfleet.py``.  Each replica is a real
``python -m paddle_tpu_torch.serving.worker`` process
hosting a full ServingEngine, spawned through the elastic-launch
machinery (``_free_port`` port assignment, ``_rank_env`` PADDLE_* env
contract, :class:`ElasticManager` membership accounting), its card's
attention kernels loaded before its ``hello``, and spoken to
over the :mod:`paddle_tpu_torch.serving.rpc` loopback wire.  The supervisor
keeps the same authoritative per-request token log the thread-based
:class:`~paddle_tpu_torch.serving.fleet.ReplicaFleet` keeps — the log only
ever EXTENDS, so `on_token` fires exactly once per position across any
number of process deaths — and recovers exactly the same way: newest
intact :class:`EngineSnapshotManager` snapshot first (greedy requests
reattach to the restored replacement), ``adopt`` re-prefill on surviving
workers otherwise, zombies pruned.  What changes is the failure model:

* **death detection** — SIGCHLD (when the supervisor owns the main
  thread) plus ``Popen.poll()`` reaping plus health-RPC heartbeat
  timeouts.  A worker that answers nothing for ``wedge_heartbeats``
  consecutive probes (a SIGSTOP'd process, a livelocked loop) is
  SIGKILLed and failed over — the thread fleet's stall watchdog, made
  honest against a process that cannot cooperate.
* **crash drills** — real ``SIGKILL`` mid-decode, not an injected
  exception: nothing in the worker runs after the kill, so recovery can
  only use what the durability story actually persisted.
* **drain** — SIGTERM (or :meth:`shutdown`) walks the drain ladder per
  worker: mark unroutable, migrate/complete the live streams, then
  ``stop`` which makes the worker release its cache, re-check PagePool /
  page-table / prefix-cache invariants, and report the verdict as its
  final RPC reply — the cross-process end of the tests' leak guard.

Supervisor-side wall-clock recovery times land in the
``proc.recovery_s`` histogram (these are REAL seconds — process spawn,
CUDA context, weights, the first graph captures and the snapshot restore —
not virtual-clock ticks), and per-worker restart counters ride
:meth:`stats`.  The workers of one fleet boot together (every process is
started before the first ``hello`` is awaited), so a fleet's spawn costs
about one worker's boot, not one per worker; a replacement boots alone.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass, field

import numpy as np

from ..distributed.fleet.elastic.manager import ElasticManager, MemoryStore
from ..distributed.launch.main import _free_port, _rank_env
from ..inference.paged import (AdmissionRejected, EngineStalledError,
                               PoolCapacityError, Request)
from ..observability.distributed import TraceStitcher, new_trace_id
from ..observability.flight import FlightRecorder
from ..observability.metrics import MetricsRegistry
from ..observability.tracing import Tracer, tracer_from_wire
from ..observability.train import fault_context
from .fleet import FleetFailedError
from .routing import LeastLoadedRouter
from .rpc import RpcClient, RpcError, RpcRemoteError, RpcTimeout

__all__ = ["ProcessFleet", "WorkerDiedError"]

# the tests' cross-process leak guard iterates this (weak — a collected
# fleet was either shut down or already failed its test)
_LIVE_FLEETS: "weakref.WeakSet[ProcessFleet]" = weakref.WeakSet()


class WorkerDiedError(RuntimeError):
    """A worker process died and could not be replaced."""


@dataclass
class _ProcRequest:
    frid: int
    prompt: np.ndarray
    kw: dict
    deadline: float | None
    submit_t: float
    on_token: object
    trace_id: int
    streamed: list = field(default_factory=list)
    worker: str | None = None
    rid: int | None = None          # worker-engine rid
    result: Request | None = None
    first_token_t: float | None = None
    retries: int = 0
    next_try_round: int = 0
    migrations: int = 0


@dataclass
class _Worker:
    name: str
    generation: int = 0
    proc: subprocess.Popen | None = None
    client: RpcClient | None = None
    port: int = 0
    pid: int = 0
    alive: bool = False
    routable: bool = False
    missed: int = 0                  # consecutive health-probe timeouts
    load: int = 0
    hb: int = 0
    log: object = None               # open log file handle
    trace_cache: dict | None = None  # last fetched wire-form tracer

    def key(self) -> str:
        return f"{self.name}#{self.generation}"


class ProcessFleet:
    """Spawn/reap/fail-over a fleet of worker processes; mirror the
    ReplicaFleet request surface (submit/cancel/step/run/results/stats
    plus stitched traces)."""

    def __init__(self, spec: dict, num_workers: int = 2, *,
                 workdir: str | None = None,
                 snapshot_every: int = 0,
                 snapshot_mode: str = "full_kv",
                 heartbeat_timeout: float = 2.0,
                 wedge_heartbeats: int = 3,
                 max_queue: int | None = None,
                 retry_backoff_rounds: int = 1,
                 max_backoff_rounds: int = 32,
                 max_restarts_per_worker: int = 4,
                 spawn_timeout: float = 180.0,
                 trace_every: int = 8,
                 router=None,
                 python: str | None = None,
                 install_sigchld: bool = True,
                 clock=time.time):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.spec = dict(spec)
        self.clock = clock
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.wedge_heartbeats = int(wedge_heartbeats)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.retry_backoff_rounds = int(retry_backoff_rounds)
        self.max_backoff_rounds = int(max_backoff_rounds)
        self.max_restarts_per_worker = int(max_restarts_per_worker)
        self.spawn_timeout = float(spawn_timeout)
        self.snapshot_every = int(snapshot_every)
        self.snapshot_mode = snapshot_mode
        self.trace_every = int(trace_every)
        self.router = router if router is not None else LeastLoadedRouter()
        self.python = python or sys.executable
        self.workdir = workdir or tempfile.mkdtemp(prefix="procfleet-")
        os.makedirs(self.workdir, exist_ok=True)
        self._spec_path = os.path.join(self.workdir, "spec.json")
        with open(self._spec_path, "w") as f:
            json.dump(self.spec, f)

        self.metrics = MetricsRegistry(clock=clock)
        self._c_failovers = self.metrics.counter("proc.failovers")
        self._c_migrations = self.metrics.counter("proc.migrations")
        self._c_restarts = self.metrics.counter("proc.restarts")
        self._c_spawns = self.metrics.counter("proc.spawns")
        self._c_submitted = self.metrics.counter("proc.requests_submitted")
        self._c_resolved = self.metrics.counter("proc.requests_resolved")
        # WALL-CLOCK failover recovery: detect -> replacement serving
        self._h_recovery = self.metrics.histogram("proc.recovery_s")
        self.flight = FlightRecorder(capacity=256, clock=clock)
        self.tracer = Tracer(clock=clock)
        self._dead_tracers: list[tuple[str, Tracer]] = []

        # membership accounting through the existing elastic machinery:
        # registered on spawn, heartbeaten on every healthy probe,
        # deregistered on death/retire — `members()` is the fleet roster
        self.elastic = ElasticManager(
            MemoryStore(), np_min=1, np_max=max(num_workers * 4, 8),
            heartbeat_timeout=max(30.0, heartbeat_timeout * 10))

        self._requests: dict[int, _ProcRequest] = {}
        self._assigned: dict[str, set[int]] = {}
        self._waiting: list[_ProcRequest] = []
        self._next_frid = 0
        self._round = 0
        self.tokens_streamed = 0
        self.restarts: dict[str, int] = {}
        # "name#generation" -> final invariants report; every spawned
        # generation must end up here with invariants_ok True (killed
        # generations are vouched for by their replacement's post-restore
        # check) — asserted by the tests' cross-process leak guard
        self.final_reports: dict[str, dict] = {}
        self.closed = False
        self._in_shutdown = False
        self._terminate = False
        self._sigchld = False
        self._prev_sigchld = None
        self._prev_sigterm = None
        if install_sigchld:
            self._install_signals()

        self._workers: list[_Worker] = []
        for i in range(int(num_workers)):
            w = _Worker(name=f"w{i}")
            self._workers.append(w)
            self._assigned[w.name] = set()
            self.restarts[w.name] = 0
        _LIVE_FLEETS.add(self)
        # spawn-to-hello wall per spawn, and the worker's own boot stages
        self.spawn_s: list[float] = []
        self.boot_s: list[dict] = []
        try:
            boots = [self._launch(w) for w in self._workers]
            for w, boot in zip(self._workers, boots):
                self._await_hello(w, *boot)
        except BaseException:
            self.shutdown(force=True)
            raise

    # -- signals -----------------------------------------------------------
    def _install_signals(self):
        """SIGCHLD -> reap flag; SIGTERM -> drain-shutdown flag.  Only the
        main thread may own handlers; elsewhere the poll()-based reaper
        alone carries death detection."""
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            self._prev_sigchld = signal.signal(
                signal.SIGCHLD, lambda *_: setattr(self, "_sigchld", True))
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, lambda *_: setattr(self, "_terminate", True))
        except ValueError:
            self._prev_sigchld = self._prev_sigterm = None

    def _restore_signals(self):
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            if self._prev_sigchld is not None:
                signal.signal(signal.SIGCHLD, self._prev_sigchld)
            if self._prev_sigterm is not None:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
        except (ValueError, TypeError):
            pass
        self._prev_sigchld = self._prev_sigterm = None

    # -- spawning ----------------------------------------------------------
    def _spawn(self, w: _Worker):
        """Launch one worker generation and block until its hello."""
        return self._await_hello(w, *self._launch(w))

    def _launch(self, w: _Worker):
        """Start one worker generation's process; returns what
        :meth:`_await_hello` waits on (portfile, log path, deadline, start
        time)."""
        w.generation += 0 if w.proc is None else 1
        gen = w.generation
        port = _free_port()
        portfile = os.path.join(self.workdir, f"{w.name}.g{gen}.port")
        snapdir = os.path.join(self.workdir, "snapshots", w.name)
        os.makedirs(snapdir, exist_ok=True)
        logpath = os.path.join(self.workdir, f"{w.name}.g{gen}.log")
        log = open(logpath, "ab")
        idx = self._workers.index(w) if w in self._workers \
            else len(self._workers)
        names = [wk.name for wk in self._workers] or [w.name]
        endpoints = ",".join(f"127.0.0.1:{port}" for _ in names)
        env = _rank_env(os.environ, rank=idx, local_rank=idx,
                        world=len(names), master=f"127.0.0.1:{port}",
                        endpoints=endpoints, nnodes=1, node_rank=0)
        # the worker must import the same paddle_tpu_torch tree regardless
        # of the supervisor's cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        cmd = [self.python, "-m", "paddle_tpu_torch.serving.worker",
               "--name", w.name, "--spec", self._spec_path,
               "--portfile", portfile, "--port", str(port),
               "--snapshot-root", snapdir,
               "--snapshot-every", str(self.snapshot_every),
               "--snapshot-mode", self.snapshot_mode]
        t_start = time.monotonic()
        w.proc = subprocess.Popen(cmd, stdout=log, stderr=log, env=env)
        w.log = log
        w.pid = w.proc.pid
        w.port = port
        w.missed = 0
        w.trace_cache = None
        self._c_spawns.inc()
        self.flight.record("spawn", worker=w.name, generation=gen,
                           pid=w.pid, port=port)
        return portfile, logpath, t_start + self.spawn_timeout, t_start

    def _await_hello(self, w: _Worker, portfile, logpath, deadline, t_start):
        """Block until the launched generation binds its port and answers
        ``hello``; a worker that exits, never binds, or fails its
        ``hello`` (it could not load its kernels) is killed and raises
        :class:`WorkerDiedError`."""
        gen = w.generation
        while not os.path.exists(portfile):
            if w.proc.poll() is not None:
                raise WorkerDiedError(
                    f"worker {w.name} gen {gen} exited rc={w.proc.returncode}"
                    f" before binding (log: {logpath})")
            if time.monotonic() > deadline:
                w.proc.kill()
                raise WorkerDiedError(
                    f"worker {w.name} gen {gen} never bound within "
                    f"{self.spawn_timeout}s (log: {logpath})")
            time.sleep(0.02)
        w.client = RpcClient(("127.0.0.1", w.port),
                             attempt_timeout=max(1.0, self.heartbeat_timeout),
                             call_timeout=self.spawn_timeout)
        try:
            hello = w.client.call(
                "hello", deadline_s=max(5.0, deadline - time.monotonic()))
        except RpcError as e:
            w.client.close()
            w.proc.kill()
            w.proc.wait(timeout=10)
            raise WorkerDiedError(
                f"worker {w.name} gen {gen} failed its hello: {e} "
                f"(log: {logpath})") from e
        self.spawn_s.append(time.monotonic() - t_start)
        self.boot_s.append(dict(hello.get("boot_s") or {}))
        w.alive = True
        w.routable = True
        self.elastic.register(w.key())
        self.tracer.engine_event("spawn", worker=w.name, generation=gen,
                                 pid=w.pid)
        return hello

    # -- request surface ---------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, top_p: float = 1.0,
               eos_token_id: int | None = None,
               timeout: float | None = None, on_token=None,
               trace_id: int | None = None) -> int:
        """Queue one request with the fleet; same contract as
        :meth:`ReplicaFleet.submit` (router-authoritative streaming,
        least-loaded placement, bounded waiting queue backpressure)."""
        if self.closed:
            raise RuntimeError("ProcessFleet is shut down")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        now = self.clock()
        fr = _ProcRequest(
            frid=self._next_frid, prompt=prompt,
            kw=dict(max_new_tokens=int(max_new_tokens),
                    temperature=float(temperature), top_p=float(top_p),
                    eos_token_id=eos_token_id),
            deadline=None if timeout is None else now + float(timeout),
            submit_t=now, on_token=on_token,
            trace_id=new_trace_id() if trace_id is None else int(trace_id))
        self._next_frid += 1
        self.flight.record("submit", frid=fr.frid,
                           prompt_tokens=len(prompt), trace_id=fr.trace_id)
        self.tracer.request_event(fr.frid, "submitted", t=now,
                                  prompt_tokens=len(prompt),
                                  trace_id=fr.trace_id)
        self.tracer.request_event(fr.frid, "queued", t=now,
                                  depth=len(self._waiting))
        try:
            placed = self._place(fr)
        except BaseException:
            self.tracer.request_event(fr.frid, "retired", rejected=True,
                                      error=True, tokens=0)
            raise
        if not placed:
            if self.max_queue is not None \
                    and len(self._waiting) >= self.max_queue:
                self.tracer.request_event(fr.frid, "retired",
                                          rejected=True, tokens=0)
                raise AdmissionRejected(
                    f"fleet queue full ({len(self._waiting)}/"
                    f"{self.max_queue} waiting)")
            fr.next_try_round = self._round + 1
            self._waiting.append(fr)
        self._requests[fr.frid] = fr
        self._c_submitted.inc()
        return fr.frid

    def cancel(self, frid: int) -> bool:
        """Client disconnect: drop the request everywhere — fleet queue,
        router record, and (best-effort RPC) the worker engine, whose KV
        parks in its prefix cache."""
        fr = self._requests.pop(frid, None)
        if fr is None:
            return False
        self._waiting = [x for x in self._waiting if x.frid != frid]
        if fr.worker is not None:
            self._assigned.get(fr.worker, set()).discard(frid)
            w = self._by_name(fr.worker)
            if w is not None and w.alive and fr.rid is not None:
                try:
                    w.client.call("cancel", rid=int(fr.rid), deadline_s=5.0)
                except RpcError:
                    pass     # a dead/wedged worker's failover sweeps it
        self.flight.record("cancel", frid=frid, streamed=len(fr.streamed))
        self.tracer.request_event(frid, "retired", cancelled=True,
                                  tokens=len(fr.streamed))
        return True

    # -- placement ---------------------------------------------------------
    def _by_name(self, name: str) -> _Worker | None:
        for w in self._workers:
            if w.name == name:
                return w
        return None

    def _routable(self) -> list[_Worker]:
        return [w for w in self._workers if w.alive and w.routable]

    def _backoff(self, fr: _ProcRequest):
        fr.retries += 1
        fr.next_try_round = self._round + min(
            self.max_backoff_rounds,
            self.retry_backoff_rounds * (2 ** min(fr.retries, 10)))

    def _place(self, fr: _ProcRequest) -> bool:
        cands = {w.name: w for w in self._routable()}
        if not cands:
            return False
        loads = [(n, w.load + len(self._assigned.get(n, ())))
                 for n, w in cands.items()]
        tokens = fr.prompt if not fr.streamed else np.concatenate(
            [fr.prompt, np.asarray(fr.streamed[:-1], np.int32)])
        decision = self.router.decide(tokens, loads, memo={})
        for name in decision.order:
            w = cands.get(name)
            if w is None:
                continue
            try:
                rid = w.client.call(
                    "adopt", prompt=[int(t) for t in fr.prompt],
                    generated=[int(t) for t in fr.streamed],
                    deadline=fr.deadline, trace_id=fr.trace_id,
                    deadline_s=10.0, **fr.kw)
            except RpcRemoteError as e:
                if e.etype == "AdmissionRejected":
                    continue
                if e.etype == "PoolCapacityError":
                    raise PoolCapacityError(e.emsg) from e
                raise
            except RpcError:
                # unreachable worker: not a placement verdict — the
                # health loop owns its fate; try the next candidate
                continue
            fr.worker = w.name
            fr.rid = int(rid)
            self._assigned[w.name].add(fr.frid)
            self.flight.record("route", frid=fr.frid, worker=w.name,
                               resumed_tokens=len(fr.streamed),
                               routing=decision.kind,
                               trace_id=fr.trace_id)
            self.tracer.request_event(fr.frid, "admitted", replica=w.name,
                                      routing=decision.kind,
                                      resumed_tokens=len(fr.streamed))
            return True
        return False

    # -- the supervisor loop ----------------------------------------------
    def step(self) -> bool:
        """One supervisor round: reap dead processes (SIGCHLD flag or
        poll()), health-probe every live worker (heartbeat timeouts count
        toward the wedge verdict; SIGKILL past the budget), drain new
        tokens into the authoritative log, retry queued placements."""
        self._round += 1
        progressed = False
        # 1. reap real deaths
        if self._sigchld or True:    # poll() is the portable reap; the
            self._sigchld = False    # SIGCHLD flag just makes it prompt
            for w in list(self._workers):
                if w.alive and w.proc is not None \
                        and w.proc.poll() is not None:
                    self._fail(w, "crash",
                               WorkerDiedError(
                                   f"{w.name} rc={w.proc.returncode}"))
                    progressed = True
        # 2. placements whose backoff expired
        for fr in list(self._waiting):
            if fr.next_try_round > self._round:
                continue
            if self._place(fr):
                self._waiting.remove(fr)
                progressed = True
            else:
                self._backoff(fr)
        # 3. health + token drain
        for w in list(self._workers):
            if not w.alive:
                continue
            try:
                h = w.client.call("health",
                                  deadline_s=self.heartbeat_timeout)
            except RpcError as e:
                if w.proc.poll() is not None:
                    self._fail(w, "crash", e)
                    progressed = True
                    continue
                w.missed += 1
                self.flight.record("missed_heartbeat", worker=w.name,
                                   missed=w.missed)
                if w.missed >= self.wedge_heartbeats:
                    # an unresponsive-but-running process (SIGSTOP, a
                    # livelock): kill it for real, then fail over
                    try:
                        os.kill(w.pid, signal.SIGKILL)
                    except OSError:
                        pass
                    w.proc.wait(timeout=10)
                    self._fail(w, "wedge", EngineStalledError(
                        f"{w.name}: {w.missed} consecutive heartbeat "
                        f"timeouts with work pending"))
                    progressed = True
                continue
            w.missed = 0
            w.hb = h.get("hb", 0)
            w.load = int(h["load"]["active"]) + int(h["load"]["queued"])
            self.elastic.heartbeat(w.key())
            if not h.get("invariants_ok", True):
                self.flight.record("invariants_violated", worker=w.name,
                                   error=h.get("invariants_error", ""))
            if self.trace_every and self._round % self.trace_every == 0:
                self._fetch_trace(w)
            if self._assigned.get(w.name):
                progressed |= self._drain(w)
        return progressed

    def _fetch_trace(self, w: _Worker):
        try:
            w.trace_cache = w.client.call(
                "trace", deadline_s=self.heartbeat_timeout)
        except RpcError:
            pass

    def _drain(self, w: _Worker) -> bool:
        have = {}
        frid_by_rid: dict[str, _ProcRequest] = {}
        for frid in sorted(self._assigned[w.name]):
            fr = self._requests[frid]
            rid_s = str(fr.rid)
            have[rid_s] = len(fr.streamed)
            frid_by_rid[rid_s] = fr
        try:
            rep = w.client.call("poll", have=have,
                                deadline_s=self.heartbeat_timeout)
        except RpcError:
            return False             # health loop owns the verdict
        now = self.clock()
        progressed = False
        for rid_s, st in rep.get("rids", {}).items():
            fr = frid_by_rid.get(rid_s)
            if fr is None or st is None:
                continue
            new = st.get("new", ())
            # `new` answers the have-count we sent THIS call; an
            # idempotency-cache replay can therefore never double-extend
            if new:
                if fr.first_token_t is None:
                    fr.first_token_t = now
                    self.tracer.request_event(fr.frid, "first_token",
                                              t=now, replica=w.name)
                for t in new:
                    fr.streamed.append(int(t))
                    self.tokens_streamed += 1
                    if fr.on_token is not None:
                        fr.on_token(int(t))
                progressed = True
            if st.get("done"):
                self._resolve(fr, now, timed_out=bool(st.get("timed_out")))
                progressed = True
        return progressed

    def _resolve(self, fr: _ProcRequest, now: float,
                 timed_out: bool = False):
        kw = fr.kw
        req = Request(rid=fr.frid, prompt=fr.prompt,
                      max_new_tokens=kw["max_new_tokens"],
                      temperature=kw["temperature"], top_p=kw["top_p"],
                      eos_token_id=kw["eos_token_id"],
                      generated=list(fr.streamed),
                      submit_time=fr.submit_t)
        req.finish_time = now
        req.timed_out = timed_out
        fr.result = req
        if fr.worker is not None:
            self._assigned.get(fr.worker, set()).discard(fr.frid)
        self._c_resolved.inc()
        self.flight.record("resolve", frid=fr.frid,
                           tokens=len(fr.streamed), timed_out=timed_out,
                           migrations=fr.migrations)
        self.tracer.request_event(fr.frid, "retired", t=now,
                                  tokens=len(fr.streamed),
                                  timed_out=timed_out,
                                  migrations=fr.migrations)

    # -- failover ----------------------------------------------------------
    def _fail(self, w: _Worker, kind: str, exc: BaseException):
        """A worker process died (or was just SIGKILLed for wedging).
        Unroutable mark happens FIRST — nothing can be placed on (or
        polled from) this generation once the failover decision is made —
        then spawn a replacement on the same snapshot directory, reattach
        what the snapshot carries, migrate the rest."""
        t0 = self.clock()
        w.routable = False
        w.alive = False
        w.missed = 0
        self._c_failovers.inc()
        self.elastic.deregister(w.key())
        dead_key = w.key()
        if w.trace_cache is not None:
            # one entry per worker death — failover forensics, read
            # whole by the stitched export
            self._dead_tracers.append(
                (f"{w.name} (crashed#{self.restarts[w.name] + 1})",
                 tracer_from_wire(w.trace_cache, clock=self.clock)))
        try:
            w.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            w.proc.kill()
        if w.log is not None:
            w.log.close()
            w.log = None
        if w.client is not None:
            w.client.close()
        self.flight.record("failover", worker=w.name, kind=kind,
                           rc=w.proc.returncode, error=str(exc)[:200],
                           fault_plan=fault_context())
        self.tracer.engine_event("failover", worker=w.name, kind=kind)
        routing = [e for e in self.flight.events()
                   if e["event"] in ("route", "migrate")]
        self.flight.dump("proc_failover", worker=w.name, kind=kind,
                         routing_decisions=routing[-16:])
        outstanding = [self._requests[f]
                       for f in sorted(self._assigned[w.name])]
        # keyed by worker name: bounded by fleet size
        self._assigned[w.name] = set()

        restored_rids: set[int] = set()
        replaced = False
        if self.restarts[w.name] < self.max_restarts_per_worker:
            self.restarts[w.name] += 1
            self._c_restarts.inc()
            try:
                hello = self._spawn(w)
                replaced = True
            except WorkerDiedError as e:
                self.flight.record("respawn_failed", worker=w.name,
                                   error=str(e)[:200])
            else:
                restored_rids = {int(r) for r in hello["restored_rids"]}
                # the dead generation's final invariants verdict, vouched
                # by its replacement's post-restore check over the state
                # the generation actually persisted
                # keyed per spawned generation — every generation must
                # file a report
                self.final_reports[dead_key] = {
                    "invariants_ok": bool(hello["restore_invariants_ok"]),
                    "invariants_error": hello.get("restore_error", ""),
                    "kind": f"killed:{kind}", "via": "replacement_restore"}
                self.flight.record(
                    "restore", worker=w.name,
                    mode=hello.get("restored_mode"),
                    requests=len(restored_rids))
        if not replaced:
            self.final_reports.setdefault(dead_key, {
                "invariants_ok": None, "kind": f"killed:{kind}",
                "via": "unverified (restart budget exhausted)"})

        still: list[_ProcRequest] = []
        kept: set[int] = set()
        for fr in outstanding:
            if replaced and fr.rid is not None and fr.rid in restored_rids \
                    and fr.kw["temperature"] <= 0.0:
                # the snapshot carries this GREEDY request — it continues
                # on the replacement; re-decoded tokens are bit-identical
                # to ones already streamed so the log only extends.
                # Sampled requests must NOT resume from a stale snapshot
                # (re-sampling diverges from streamed tokens) — migrated.
                fr.worker = w.name
                self._assigned[w.name].add(fr.frid)
                kept.add(fr.rid)
            else:
                still.append(fr)
        if replaced:
            for rid in sorted(restored_rids - kept):
                try:
                    w.client.call("cancel", rid=rid, deadline_s=10.0)
                except RpcError:
                    pass
        for fr in still:
            fr.worker = None
            fr.rid = None
            self._migrate(fr)
        if not self._routable() and any(fr.result is None
                                        for fr in self._requests.values()):
            raise FleetFailedError(
                f"no live workers left ({len(self._requests)} requests "
                f"tracked, restart budget "
                f"{self.max_restarts_per_worker}/worker exhausted)")
        self._h_recovery.observe(self.clock() - t0)

    def _migrate(self, fr: _ProcRequest):
        self._c_migrations.inc()
        fr.migrations += 1
        self.flight.record("migrate", frid=fr.frid,
                           tokens=len(fr.streamed), trace_id=fr.trace_id,
                           fault_plan=fault_context())
        self.tracer.request_event(fr.frid, "preempted", kind="migrate",
                                  tokens=len(fr.streamed))
        kw = fr.kw
        eos = kw["eos_token_id"]
        if fr.streamed and (len(fr.streamed) >= kw["max_new_tokens"]
                            or (eos is not None and eos in fr.streamed)):
            # completion edge: everything streamed before the death;
            # synthesize the result from the authoritative log
            self._resolve(fr, self.clock())
            return
        if not self._place(fr):
            self._backoff(fr)
            self._waiting.append(fr)

    # -- drain ladder (across the wire) -------------------------------------
    def retire_worker(self, name: str):
        """Zero-loss scale-down of one worker: mark unroutable (nothing
        new lands), live-migrate its streams to surviving workers, then
        ``drain`` + ``stop`` — the worker's final reply is its teardown
        invariants report — and reap the process."""
        w = self._by_name(name)
        if w is None or not w.alive:
            raise ValueError(f"no live worker {name!r}")
        if len(self._routable()) <= 1 and self._assigned.get(name):
            raise RuntimeError("cannot retire the last routable worker "
                               "with live requests")
        w.routable = False
        self.flight.record("retire", worker=name)
        self._fetch_trace(w)
        for frid in sorted(self._assigned[name]):
            fr = self._requests[frid]
            try:
                w.client.call("cancel", rid=int(fr.rid), deadline_s=10.0)
            except RpcError:
                pass
            fr.worker = None
            fr.rid = None
            self._migrate(fr)
        self._assigned[name] = set()
        self._stop_worker(w, kind="retired")

    def _stop_worker(self, w: _Worker, kind: str):
        try:
            report = w.client.call("stop", deadline_s=30.0)
        except RpcError as e:
            report = {"invariants_ok": None,
                      "invariants_error": f"stop rpc failed: {e}"}
        self.final_reports[w.key()] = dict(report, kind=kind)
        self.elastic.deregister(w.key())
        if w.trace_cache is not None:
            self._dead_tracers.append(
                (f"{w.name} ({kind})",
                 tracer_from_wire(w.trace_cache, clock=self.clock)))
        try:
            w.proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            w.proc.kill()
            w.proc.wait(timeout=5)
        w.alive = False
        w.routable = False
        if w.log is not None:
            w.log.close()
            w.log = None
        if w.client is not None:
            w.client.close()
        self.tracer.engine_event("scale_down", worker=w.name)

    # -- driving -----------------------------------------------------------
    # ProcessFleet supervision is deliberately single-threaded (workers are
    # PROCESSES; the supervisor polls their clients in one loop)
    def run(self, max_rounds: int | None = None,
            max_stall_rounds: int = 2000) -> dict:
        """Drive until every request resolved (or SIGTERM: drain + stop).
        Returns ``{frid: Request}``."""
        stalled = 0
        rounds = 0
        while any(fr.result is None for fr in self._requests.values()):
            if self._terminate and not self._in_shutdown:
                self.shutdown(drain=True)
                break
            progressed = self.step()
            if progressed:
                stalled = 0
            else:
                stalled += 1
                time.sleep(0.005)
            if stalled >= max_stall_rounds:
                raise EngineStalledError(
                    f"process fleet made no progress for {stalled} rounds "
                    f"({sum(fr.result is None for fr in self._requests.values())}"
                    f" unresolved, {len(self._waiting)} waiting)")
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        if self._terminate and not self._in_shutdown and not self.closed:
            # SIGTERM observed with nothing left to drain: finish the
            # ladder (per-worker stop + final invariants reports)
            self.shutdown(drain=True)
        return self.results()

    def results(self) -> dict:
        return {frid: fr.result for frid, fr in self._requests.items()
                if fr.result is not None}

    def shutdown(self, drain: bool = True, force: bool = False):
        """Stop the fleet.  ``drain=True`` finishes the live streams
        first (zero-loss); every surviving worker then tears down through
        ``stop`` and files its final invariants report.  ``force=True``
        SIGKILLs everything (leak-guard salvage path only)."""
        if self.closed:
            return
        self._in_shutdown = True
        if force:
            for w in self._workers:
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
                    w.proc.wait(timeout=5)
                w.alive = False
                w.routable = False
                if w.log is not None:
                    w.log.close()
                    w.log = None
                self.final_reports.setdefault(w.key(), {
                    "invariants_ok": None, "kind": "force_killed"})
            self.closed = True
            self._restore_signals()
            return
        if drain and any(fr.result is None
                         for fr in self._requests.values()):
            self.run(max_stall_rounds=2000)
        for w in list(self._workers):
            if w.alive:
                self._fetch_trace(w)
                self._stop_worker(w, kind="shutdown")
        self.closed = True
        self._restore_signals()

    # -- leak guard --------------------------------------------------------
    def assert_worker_invariants(self):
        """Every spawned worker generation must have filed a final
        invariants report that holds — directly (stop/retire/shutdown) or
        through its replacement's post-restore check (killed mid-drill).
        The tests' cross-process leak guard calls this after every test
        that built a ProcessFleet."""
        assert self.closed, "ProcessFleet was never shut down"
        missing = []
        for w in self._workers:
            for gen in range(w.generation + 1):
                key = f"{w.name}#{gen}"
                rep = self.final_reports.get(key)
                if rep is None:
                    missing.append(f"{key}: no final report")
                elif rep.get("invariants_ok") is not True:
                    missing.append(
                        f"{key}: invariants_ok={rep.get('invariants_ok')} "
                        f"({rep.get('invariants_error', '')[:160]} "
                        f"via {rep.get('via', rep.get('kind', '?'))})")
        assert not missing, \
            "cross-process leak guard: " + "; ".join(missing)

    # -- readouts ----------------------------------------------------------
    def stats(self) -> dict:
        q = self._h_recovery.percentiles()
        rpc = {"calls": 0, "retries": 0, "timeouts": 0, "reconnects": 0}
        for w in self._workers:
            if w.client is not None:
                for k in rpc:
                    rpc[k] += w.client.stats[k]
        return {
            "workers": len(self._workers),
            "workers_alive": sum(1 for w in self._workers if w.alive),
            "workers_routable": len(self._routable()),
            "members": self.elastic.members(),
            "failovers": self._c_failovers.value,
            "migrations": self._c_migrations.value,
            "spawns": self._c_spawns.value,
            "restarts": self._c_restarts.value,
            "worker_restarts": dict(self.restarts),
            "requests_submitted": self._c_submitted.value,
            "requests_resolved": self._c_resolved.value,
            "tokens_streamed": self.tokens_streamed,
            "waiting": len(self._waiting),
            "rpc": rpc,
            "recovery": {"count": self._h_recovery.count,
                         "p50_ms": round(q[50] * 1e3, 3),
                         "p95_ms": round(q[95] * 1e3, 3),
                         "p99_ms": round(q[99] * 1e3, 3),
                         "max_ms": round(self._h_recovery.max * 1e3, 3)
                         if self._h_recovery.count else 0.0},
            "per_worker": {w.name: {"pid": w.pid, "generation": w.generation,
                                    "alive": w.alive,
                                    "routable": w.routable,
                                    "load": w.load, "hb": w.hb,
                                    "restarts": self.restarts[w.name]}
                           for w in self._workers},
        }

    def worker_stats(self) -> dict:
        """``{name#generation: stats reply}`` of every live worker: its
        engine's ``stats()`` and, under ``"kernels"``, its process's ragged
        paged-attention launches and plain-version calls
        (``worker.kernel_counts``)."""
        return {w.key(): w.client.call("stats",
                                       deadline_s=self.heartbeat_timeout * 5)
                for w in self._workers if w.alive}

    def trace_components(self) -> list:
        """(name, Tracer) components for the stitched cross-process
        trace: the supervisor track, dead/retired generations, then a
        fresh fetch from every live worker."""
        comps: list = [("supervisor", self.tracer)]
        comps.extend(self._dead_tracers)
        for w in self._workers:
            if w.alive:
                self._fetch_trace(w)
            if w.trace_cache is not None and w.alive:
                comps.append((w.name,
                              tracer_from_wire(w.trace_cache,
                                               clock=self.clock)))
        return comps

    def stitcher(self) -> TraceStitcher:
        st = TraceStitcher()
        for name, tracer in self.trace_components():
            st.add(name, tracer)
        return st

    def stitched_trace(self) -> dict:
        """ONE Perfetto view of every request across the supervisor track
        and every worker PROCESS track, failovers included."""
        return self.stitcher().to_chrome_trace()

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()
