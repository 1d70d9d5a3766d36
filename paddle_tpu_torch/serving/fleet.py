"""Replica-fleet router: N ServingEngine replicas behind one ``submit()``.

One engine is one failure domain; a serving front end needs replicas that
can die while their in-flight requests MIGRATE instead of dying with them.
The fleet keeps the authoritative request log (prompt + sampling params +
every token STREAMED out of the engines so far), drives its replicas step
by step, and self-heals:

  * **routing** — each submit lands on the least-loaded live replica
    (deterministic tie-break), falling through the fleet-wide degradation
    ladder *route -> queue -> reject*: replicas full -> the bounded fleet
    queue (placement retried with exponential backoff), fleet queue
    full -> typed ``AdmissionRejected`` backpressure;
  * **health watchdog** — a replica whose ``step()`` raises is CRASHED; a
    replica that keeps reporting no progress while holding work is WEDGED
    (``EngineStalledError`` after ``stall_threshold`` heartbeats).  Both
    are drilled deterministically via the seeded ``serve.crash`` /
    ``serve.wedge`` fault points (resilience/faults.py);
  * **failover** — a failed replica is revived from its newest INTACT
    engine snapshot (``EngineSnapshotManager``; torn snapshots are
    rejected via manifest and flight-recorded), and every outstanding
    request the snapshot does not cover migrates to a surviving replica by
    re-prefill of prompt + streamed tokens (``ServingEngine.adopt``).
    Greedy outputs stay bit-exact either way: a full-KV restore resumes
    the identical computation, and a re-prefill resume regenerates the
    identical greedy continuation (the preemption-resume guarantee) — any
    tokens re-decoded past an old snapshot are bit-identical to the ones
    already streamed, so nothing is lost and nothing diverges.

Failovers, migrations, and torn-snapshot rejections land in the fleet's
flight recorder stamped with the active fault-plan context
(``observability.fault_context``); ``fleet.migrations`` /
``fleet.failovers`` counters and the ``fleet.recovery_s`` histogram
measure every drill.

Every replica is a :class:`~paddle_tpu_torch.inference.paged.ServingEngine`
on one card (``engine.tp`` is 1): the KV handoff of a disaggregated fleet is
a page gather on the source card and an in-place scatter on the
destination's.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from ..inference.paged import (AdmissionRejected, EngineStalledError,
                               KVHandoffError, Request, ServingEngine)
from ..observability.distributed import (FleetTelemetry, TraceStitcher,
                                         new_trace_id)
from ..observability.flight import FlightRecorder
from ..observability.metrics import MetricsRegistry
from ..observability.slo import slo_report
from ..observability.tracing import Tracer
from ..observability.train import fault_context
from .routing import LeastLoadedRouter, Router
from .snapshot import EngineSnapshotManager

__all__ = ["ReplicaFleet", "FleetFailedError"]


class FleetFailedError(RuntimeError):
    """No replica could be kept alive (engine factory kept failing or the
    per-replica failover budget is exhausted) while requests were still
    outstanding — the fleet cannot make progress."""


@dataclass
class _FleetRequest:
    """The router's authoritative record of one request: enough to place
    it, re-place it after a crash (prompt + streamed tokens), and report
    it (fleet-level latency timestamps)."""
    frid: int
    prompt: np.ndarray
    kw: dict                       # max_new_tokens/temperature/top_p/eos
    deadline: float | None
    submit_t: float
    replica: str | None = None
    handle: Request | None = None  # live engine-side Request object
    streamed: list = field(default_factory=list)
    on_token: object | None = None  # router-fired streaming hook: called
                                    #   once per token as the ROUTER log
                                    #   extends, so a failover re-decode
                                    #   never double-emits
    result: Request | None = None
    # None until the first token streams: a 0.0 sentinel would collide
    # with a VIRTUAL clock legitimately reading t=0.0 in the first round
    first_token_t: float | None = None
    finish_t: float = 0.0
    retries: int = 0
    next_try_round: int = 0
    migrations: int = 0
    no_handoff: bool = False       # set after a handoff fallback so the
                                   #   request finishes wherever it lands
                                   #   instead of ping-ponging export /
                                   #   re-prefill forever
    trace_id: int | None = None    # fleet-wide stitching id; threaded into
                                   #   every engine-side adopt() so one
                                   #   Perfetto view binds the request's
                                   #   spans across replicas + failovers
    route_memo: dict = field(default_factory=dict)
                                   # per-placement-state routing scratch:
                                   #   the concatenated token stream and
                                   #   the router's chain digests, keyed
                                   #   by streamed length — a backoff
                                   #   retry must not re-hash an
                                   #   unchanged prompt every round


class _Replica:
    __slots__ = ("name", "engine", "alive", "routable", "stall", "failures",
                 "snapshots", "role")

    def __init__(self, name, engine, snapshots, role="any"):
        self.name = name
        self.engine = engine
        self.alive = True
        self.routable = True      # False while drain-retiring (scale-down)
        self.stall = 0            # consecutive no-progress steps w/ work
        self.failures = 0         # failovers consumed
        self.snapshots = snapshots
        self.role = role          # "any" | "prefill" | "decode" — sticky
                                  #   across failover revival (the replica
                                  #   is the same engine geometry)

    def load(self) -> int:
        """Active + queued requests — THE per-replica load notion,
        shared by router placement, the autoscaler's idle detector, and
        drain-victim selection (one definition, three consumers)."""
        return self.engine.num_active + len(self.engine._queue)


class _SnapTel:
    """CheckpointManager-telemetry duck for the snapshot managers: torn-
    snapshot rejections land in the FLEET flight record (with fault-plan
    context) and the fleet.torn_snapshots counter."""

    def __init__(self, fleet: "ReplicaFleet", name: str):
        self._fleet = fleet
        self._name = name

    def torn_snapshot(self, path, error):
        self._fleet._c_torn.inc()
        self._fleet.flight.record(
            "torn_snapshot", replica=self._name,
            path=os.path.basename(str(path)), error=str(error)[:200],
            fault_plan=fault_context())


class ReplicaFleet:
    """``engine_factory`` builds one fresh :class:`ServingEngine` per call
    (same params/config each time — replicas are interchangeable);
    the fleet names them ``r0..rN-1`` (the ``serve.crash`` /
    ``serve.wedge`` fault-point ``engine=`` ctx, so drills target one
    replica via ``match={"engine": "r0"}``).

    ``snapshot_root`` + ``snapshot_every`` turn on periodic engine
    snapshots (one ``EngineSnapshotManager`` per replica under
    ``snapshot_root/<name>``, mode ``snapshot_mode``); without them
    failover falls back to pure re-prefill migration — still zero-loss and
    greedy-bit-exact, just a cold KV start for the migrated requests."""

    def __init__(self, engine_factory, num_replicas: int = 2, *,
                 roles=None,
                 handoff_retry_rounds: int = 8,
                 router: Router | None = None,
                 snapshot_root: str | None = None,
                 snapshot_every: int | None = None,
                 snapshot_mode: str = "full_kv",
                 snapshot_keep_last: int = 2,
                 max_queue: int | None = None,
                 stall_threshold: int = 8,
                 retry_backoff_rounds: int = 1,
                 max_backoff_rounds: int = 32,
                 max_failovers_per_replica: int = 4,
                 clock=time.perf_counter,
                 flight_capacity: int = 256,
                 route_dump_last: int = 16):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        # disaggregated prefill/decode: one role per replica.  "prefill"
        # replicas run prefill + the first token, then hand their KV
        # pages to a "decode"/"any" replica; "any" replicas (the default)
        # form a colocated fleet — no roles, no handoffs.
        if roles is None:
            roles = ["any"] * int(num_replicas)
        else:
            roles = [str(r) for r in roles]
            if len(roles) != int(num_replicas):
                raise ValueError(
                    f"roles needs one entry per replica: got {len(roles)} "
                    f"for num_replicas={num_replicas}")
            bad = sorted(set(roles) - {"any", "prefill", "decode"})
            if bad:
                raise ValueError(f"unknown replica roles {bad} "
                                 f"(valid: any/prefill/decode)")
            if "prefill" in roles \
                    and not any(r in ("decode", "any") for r in roles):
                raise ValueError(
                    "a disaggregated fleet needs at least one decode-"
                    "capable replica ('decode' or 'any') to receive "
                    "prefill handoffs")
        self._factory = engine_factory
        # factories that accept a role= keyword get told which role they
        # are building for (prefill and decode engines may want
        # different chunking / horizons); legacy factories are called
        # bare.  Detected ONCE here — a TypeError raised inside the
        # factory at spawn time must not be mistaken for "takes no role"
        try:
            import inspect
            params = inspect.signature(engine_factory).parameters.values()
            self._factory_takes_role = any(
                p.kind is inspect.Parameter.VAR_KEYWORD or p.name == "role"
                for p in params)
        except (TypeError, ValueError):
            self._factory_takes_role = False
        self.handoff_retry_rounds = int(handoff_retry_rounds)
        self._clock = clock
        self.router = router if router is not None else LeastLoadedRouter()
        self.snapshot_root = snapshot_root
        self.snapshot_every = snapshot_every
        self.snapshot_mode = snapshot_mode
        self.snapshot_keep_last = int(snapshot_keep_last)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.stall_threshold = int(stall_threshold)
        self.retry_backoff_rounds = int(retry_backoff_rounds)
        self.max_backoff_rounds = int(max_backoff_rounds)
        self.max_failovers_per_replica = int(max_failovers_per_replica)
        self.metrics = MetricsRegistry(clock=clock)
        self._c_failovers = self.metrics.counter("fleet.failovers")
        self._c_migrations = self.metrics.counter("fleet.migrations")
        self._c_rejections = self.metrics.counter("fleet.rejections")
        self._c_submitted = self.metrics.counter("fleet.requests_submitted")
        self._c_resolved = self.metrics.counter("fleet.requests_resolved")
        self._c_torn = self.metrics.counter("fleet.torn_snapshots")
        # elastic control plane: replica add/remove and
        # drain-migration accounting — fixed fleets report honest zeros
        self._c_scale_up = self.metrics.counter("fleet.scale_up")
        self._c_scale_down = self.metrics.counter("fleet.scale_down")
        self._c_drain_migr = self.metrics.counter("fleet.drain_migrations")
        self._h_recovery = self.metrics.histogram("fleet.recovery_s")
        # disaggregated KV handoff accounting: role-less
        # fleets report honest zeros, same contract as the elastic block
        self._c_handoffs = self.metrics.counter("fleet.kv_handoffs")
        self._c_handoff_fallbacks = self.metrics.counter(
            "fleet.kv_handoff_fallbacks")
        self._c_kv_pages = self.metrics.counter(
            "fleet.kv_pages_transferred")
        self._c_kv_bytes = self.metrics.counter(
            "fleet.kv_bytes_transferred")
        self._c_kv_rank_local = self.metrics.counter(
            "fleet.kv_rank_local_handoffs")
        self._h_kv_transfer = self.metrics.histogram("fleet.kv_transfer_s")
        # exported-but-not-yet-imported packets: export happens at the
        # END of a round (phase B, after streams), import at the START of
        # the next (phase A) — the one-round gap between the source and
        # destination residencies is what attribution classifies as the
        # kv_transfer segment
        self._pending_handoffs: list[dict] = []
        self.flight = FlightRecorder(capacity=flight_capacity, clock=clock)
        # the ROUTER track of the stitched fleet trace: one request record
        # per frid (submitted -> admitted(replica) -> first_token ->
        # retired, with migrations re-opening the queued phase), sharing
        # the fleet clock with every replica tracer
        self.tracer = Tracer(clock=clock)
        self.route_dump_last = int(route_dump_last)
        # tracers of crashed replica generations, kept so the stitched
        # trace still shows the spans a request ran on a now-dead engine
        self._dead_tracers: list[tuple[str, Tracer]] = []
        self._requests: dict[int, _FleetRequest] = {}
        self._assigned: dict[str, set[int]] = {}
        self._waiting: list[_FleetRequest] = []
        self._summaries: list[dict] = []
        self._next_frid = 0
        self._round = 0
        # router-observed token counter (one inc per streamed token — a
        # migrated engine's re-decode of already-streamed tokens does NOT
        # advance it) and replica-time accounting (integral of live
        # replica count over fleet heartbeats: the goodput-per-replica-
        # hour denominator)
        self.tokens_streamed = 0
        self.replica_seconds = 0.0
        self._last_tick: float | None = None
        # retired (drained) replicas: tracer rides _dead_tracers for the
        # stitched view; telemetry + final counters stay readable so the
        # fleet-wide hit-rate accounting covers their whole service life
        self._retired_telemetry: list[tuple[str, object]] = []
        self._retired_stats: list[tuple[str, dict]] = []
        self._replicas: list[_Replica] = []
        self._next_replica_idx = 0
        for role in roles:
            self._spawn_replica(role=role)

    # -- construction helpers ----------------------------------------------
    def _new_engine(self, name: str, role: str = "any") -> ServingEngine:
        eng = self._factory(role=role) if self._factory_takes_role \
            else self._factory()
        if not isinstance(eng, ServingEngine):
            raise TypeError("engine_factory must return a ServingEngine")
        eng.name = name
        return eng

    def _snapshot_manager(self, name: str):
        if self.snapshot_root is None:
            return None
        return EngineSnapshotManager(
            os.path.join(self.snapshot_root, name),
            keep_last=self.snapshot_keep_last,
            telemetry=_SnapTel(self, name))

    def _spawn_replica(self, role: str = "any") -> _Replica:
        """Build + register one replica under the next monotonic name
        (names are never reused — a retired r1's tracer track and a later
        r3 can coexist in one stitched view)."""
        name = f"r{self._next_replica_idx}"
        self._next_replica_idx += 1
        rep = _Replica(name, self._new_engine(name, role),
                       self._snapshot_manager(name), role=role)
        self._replicas.append(rep)
        self._assigned[name] = set()
        self._wire_router(rep)
        return rep

    def _wire_router(self, rep: _Replica):
        """Register a (new or revived) replica with the routing strategy
        and keep its cached-chain summary current: seed from whatever the
        engine's prefix cache already indexes (a snapshot-restored engine
        arrives warm), then subscribe to insert/evict notifications."""
        eng = rep.engine
        self.router.configure(page_size=eng.page_size)
        self.router.on_replica_added(rep.name)
        if eng.cache is not None:
            name = rep.name

            def _notify(kind, digests, _name=name):
                if kind == "insert":
                    self.router.note_cached(_name, digests)
                else:
                    self.router.note_evicted(_name, digests)

            eng.cache.notify = _notify
            existing = list(eng.cache.chain_digests())
            if existing:
                self.router.note_cached(name, existing)

    # -- elastic control plane ---------------------------------------------
    def add_replica(self, role: str = "any") -> str:
        """Scale up: spawn one fresh replica at runtime (the autoscaler's
        grow action).  Returns the new replica's name; it is routable
        immediately.  ``role`` lets a role-aware autoscaler grow prefill
        and decode capacity independently."""
        if role not in ("any", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        rep = self._spawn_replica(role=role)
        self._c_scale_up.inc()
        self.flight.record("scale_up", replica=rep.name, role=role,
                           replicas=len(self._alive()))
        self.tracer.engine_event("scale_up", replica=rep.name, role=role)
        return rep.name

    def retire_replica(self, name: str) -> bool:
        """Scale down with ZERO request loss: mark the replica
        unroutable, live-migrate every in-flight request it carries to a
        surviving replica (engine-side ``cancel`` parks the written KV
        and quiesces any in-flight dispatch at an exact host state, then
        the router's authoritative record re-places via ``adopt`` — the
        streamed-token re-prefill path, greedy-bit-exact by the
        preemption-resume guarantee), then destroy the empty engine.
        Returns True only when the replica was ACTUALLY retired: False
        for unknown/dead replicas, when it would drain the last live one,
        and when the
        target CRASHES mid-drain — that case falls through to the
        normal failover path (the requests still migrate, still
        zero-loss, and the replica is revived instead of retired, so no
        scale-down happened)."""
        rep = next((r for r in self._replicas
                    if r.name == name and r.alive), None)
        if rep is None or len(self._alive()) <= 1:
            return False
        rep.routable = False
        outstanding = [self._requests[f]
                       for f in sorted(self._assigned[name])]
        self.flight.record("drain_begin", replica=name,
                           inflight=len(outstanding))
        self.tracer.engine_event("drain", replica=name,
                                 inflight=len(outstanding))
        for fr in outstanding:
            rid = fr.handle.rid if fr.handle is not None else None
            try:
                if rid is not None:
                    rep.engine.cancel(rid)
            except Exception as exc:  # noqa: BLE001 — the drain target
                # died mid-migration: the failover path WINS (it migrates
                # every outstanding request, this one included) and the
                # replica is revived instead of retired — still
                # zero-loss, but NOT a scale-down (the caller must not
                # record a phantom retirement)
                self._fail(rep, "crash", exc)
                return False
            self._assigned[name].discard(fr.frid)
            fr.replica = None
            fr.handle = None
            self._c_drain_migr.inc()
            self._migrate(fr)
        # anything else still on the engine is a zombie the router never
        # tracked (e.g. snapshot-restored requests resolved elsewhere) —
        # same crash guard as the migration loop: a death HERE must also
        # fall through to failover, not escape the serve loop
        try:
            for rid in [sl.req.rid for sl in rep.engine._slots
                        if sl is not None] \
                    + [r.rid for r in rep.engine._queue]:
                rep.engine.cancel(rid)
        except Exception as exc:  # noqa: BLE001 — died cancelling zombies
            self._fail(rep, "crash", exc)
            return False
        self._destroy_replica(rep)
        return True

    def _destroy_replica(self, rep: _Replica):
        """Tear down a drained (empty) replica: detach the cache feed,
        keep its tracer (stitched views) + telemetry + final counters
        (fleet-wide hit-rate accounting spans its whole service life),
        verify its page accounting one last time, and drop the engine."""
        eng = rep.engine
        if eng.cache is not None:
            eng.cache.notify = None
        eng.release_cache()
        eng.check_invariants()      # retired-then-destroyed leak guard
        if eng.telemetry is not None:
            self._dead_tracers.append(
                (f"{rep.name} (retired)", eng.telemetry.tracer))
            self._retired_telemetry.append(
                (rep.name, eng.telemetry.registry))
        self._retired_stats.append((rep.name, eng.stats()))
        self.router.on_replica_removed(rep.name)
        rep.alive = False
        rep.engine = None
        self._replicas.remove(rep)
        del self._assigned[rep.name]
        self._c_scale_down.inc()
        self.flight.record("scale_down", replica=rep.name,
                           replicas=len(self._alive()))
        self.tracer.engine_event("scale_down", replica=rep.name)

    # -- submission (fleet ladder: route -> queue -> reject) ---------------
    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, top_p: float = 1.0,
               eos_token_id: int | None = None,
               timeout: float | None = None, on_token=None,
               trace_id: int | None = None) -> int:
        """Queue one request with the fleet; returns the fleet request id.
        Routing tries every live replica least-loaded-first; when all
        reject (their admission queues are full), the request waits in the
        bounded fleet queue; when THAT is full, typed
        ``AdmissionRejected`` backpressure.

        ``on_token`` is the fleet-level streaming hook: fired once per
        token as the ROUTER's authoritative log extends (at the fleet
        heartbeat that drained the token), in emission order.  It is
        deliberately NOT passed to the replica engines: after a failover
        a revived/migrated engine RE-decodes tokens the router already
        streamed (greedy-identical by the bit-exactness guarantee), and
        an engine-side hook would re-fire them — the router log only ever
        extends, so the fleet hook emits each position exactly once
        across any number of crashes and migrations.

        ``trace_id`` (optional) is the end-to-end stitching id from an
        upstream front end; the fleet mints one when none is supplied, so
        every request is stitchable."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        now = self._clock()
        fr = _FleetRequest(
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
        # place BEFORE registering: a placement-time PoolCapacityError /
        # ValueError (a request that can never fit) must propagate without
        # leaving an unresolvable ghost in self._requests (which would
        # wedge every later run()) — and without leaving a never-terminated
        # ghost in the router TRACER either (its live table is unbounded
        # and ghosts would pollute every stitched trace)
        try:
            placed = self._place(fr)
        except BaseException:
            self.tracer.request_event(fr.frid, "retired", rejected=True,
                                      error=True, tokens=0)
            raise
        if not placed:
            if self.max_queue is not None \
                    and len(self._waiting) >= self.max_queue:
                self._c_rejections.inc()
                self.flight.record("reject", frid=fr.frid,
                                   waiting=len(self._waiting))
                self.tracer.request_event(fr.frid, "retired",
                                          rejected=True, tokens=0)
                raise AdmissionRejected(
                    f"fleet queue full ({len(self._waiting)}/"
                    f"{self.max_queue} waiting) — backpressure, retry later")
            fr.next_try_round = self._round + 1
            self._waiting.append(fr)
            self.flight.record("queue", frid=fr.frid,
                               waiting=len(self._waiting))
        self._requests[fr.frid] = fr
        self._c_submitted.inc()
        return fr.frid

    def cancel(self, frid: int) -> bool:
        """Drop a fleet request wherever it lives (client disconnect from
        the async front end): cancel it on its replica engine (pages free
        mid-decode), remove it from the fleet queue and the router record.
        Returns True when the frid was known.  Already-resolved requests
        are forgotten (their result is discarded)."""
        fr = self._requests.pop(frid, None)
        if fr is None:
            return False
        self._waiting = [w for w in self._waiting if w.frid != frid]
        if fr.replica is not None:
            self._assigned.get(fr.replica, set()).discard(frid)
            for rep in self._replicas:
                if rep.name == fr.replica and rep.alive \
                        and fr.handle is not None:
                    rep.engine.cancel(fr.handle.rid)
                    break
        self.flight.record("cancel", frid=frid,
                           streamed=len(fr.streamed))
        self.tracer.request_event(frid, "retired", cancelled=True,
                                  tokens=len(fr.streamed))
        return True

    def _alive(self):
        return [rep for rep in self._replicas if rep.alive]

    @property
    def _has_roles(self) -> bool:
        """True when ANY replica carries a non-"any" role — checked per
        placement (not cached) so an elastic fleet that grows its first
        prefill replica at runtime becomes role-aware on the spot."""
        return any(rep.role != "any" for rep in self._replicas)

    def _backoff(self, fr: _FleetRequest):
        """One failed placement attempt: exponential backoff (capped) until
        the next retry round."""
        fr.retries += 1
        fr.next_try_round = self._round + min(
            self.max_backoff_rounds,
            self.retry_backoff_rounds * (2 ** min(fr.retries, 10)))

    def _place(self, fr: _FleetRequest) -> bool:
        """Route rung: ask the routing strategy for the candidate order
        (least-loaded by default; prefix-affine with
        :class:`~paddle_tpu_torch.serving.routing.PrefixAffinityRouter`) and
        try each candidate in turn.  Placement always goes through
        ``adopt`` so the fleet-anchored absolute deadline is preserved
        and a migrated request resumes from its streamed tokens (empty
        stream == fresh submission).  Typed ``PoolCapacityError`` (can
        NEVER fit) propagates to the caller.

        Role-aware fleets filter the candidates to prefill-capable
        replicas first (adopt ALWAYS prefills — prompt, or prompt +
        streamed for a migration); when none survives, every routable
        replica is eligible again: role is a throughput preference and
        must never become a reason to drop or strand work."""
        cands = {rep.name: rep for rep in self._alive() if rep.routable}
        role = None
        if self._has_roles:
            role = "prefill"
            pref = {n: r for n, r in cands.items()
                    if r.role in ("prefill", "any")}
            if pref:
                cands = pref
        if not cands:
            return False
        # the token stream the placement would prefill: prompt for a
        # fresh submission, prompt + streamed[:-1] for a migration (the
        # last streamed token rides as the pending sample, never
        # written).  Memoized per placement state: a backoff retry of an
        # unchanged request reuses the concatenation AND the router's
        # chain digests instead of re-hashing the whole prompt per round
        memo = fr.route_memo
        if memo.get("n_streamed") != len(fr.streamed):
            memo.clear()
            memo["n_streamed"] = len(fr.streamed)
            memo["tokens"] = fr.prompt if not fr.streamed \
                else np.concatenate(
                    [fr.prompt, np.asarray(fr.streamed[:-1], np.int32)])
        decision = self.router.decide(
            memo["tokens"],
            [(name, rep.load()) for name, rep in cands.items()],
            memo=memo, role=role)
        for name in decision.order:
            rep = cands.get(name)
            if rep is None:
                continue
            try:
                rid = rep.engine.adopt(fr.prompt, fr.streamed,
                                       deadline=fr.deadline,
                                       trace_id=fr.trace_id, **fr.kw)
            except AdmissionRejected:
                continue
            fr.replica = rep.name
            fr.handle = rep.engine.lookup(rid)
            self._assigned[rep.name].add(fr.frid)
            self.flight.record("route", frid=fr.frid, replica=rep.name,
                               resumed_tokens=len(fr.streamed),
                               routing=decision.kind,
                               affinity_blocks=decision.matched_blocks,
                               trace_id=fr.trace_id)
            self.tracer.request_event(fr.frid, "admitted",
                                      replica=rep.name,
                                      routing=decision.kind,
                                      affinity_blocks=decision.matched_blocks,
                                      resumed_tokens=len(fr.streamed))
            return True
        return False

    # -- the fleet loop ----------------------------------------------------
    def step(self) -> bool:
        """One fleet round: retry queued placements whose backoff expired,
        heartbeat-step every live replica (catching crashes, counting
        wedge stalls), stream newly emitted tokens into the router record,
        fail over dead replicas, and take periodic snapshots.  Returns
        True when anything progressed."""
        self._round += 1
        # replica-time accounting: the integral of live-replica count
        # over fleet heartbeats (draining replicas still cost machine
        # time until destroyed) — goodput-per-replica-hour's denominator
        now = self._clock()
        if self._last_tick is not None:
            self.replica_seconds += len(self._alive()) \
                * max(0.0, now - self._last_tick)
        self._last_tick = now
        progressed = False
        # phase A of the KV handoff: packets exported at the END of the
        # previous round splice into a decode replica BEFORE any other
        # placement this round (the handed-off request must not lose its
        # slot to a fresh admission racing it out of the fleet queue)
        if self._import_pending_handoffs():
            progressed = True
        for fr in list(self._waiting):
            if fr.next_try_round > self._round:
                continue
            if self._place(fr):
                self._waiting.remove(fr)
                progressed = True
            else:
                self._backoff(fr)
        for rep in self._replicas:
            if not rep.alive:
                continue
            eng = rep.engine
            # a double-buffered engine with nothing queued may still hold
            # an in-flight dispatch whose tokens only land at the next
            # drain — keep heartbeating it (step() reports the in-flight
            # progress) instead of parking it un-drained
            if not (eng.num_active or eng._queue or eng.inflight_depth):
                rep.stall = 0
                continue
            try:
                ok = eng.step()
            except Exception as exc:  # noqa: BLE001 — ANY escaped exception
                # is a dead replica (the drills raise InjectedFault; a real
                # deployment segfaults); the corpse's host state is not
                # trusted — recovery uses snapshots + the router record
                self._fail(rep, "crash", exc)
                progressed = True
                continue
            self._stream(rep)
            if ok:
                rep.stall = 0
                progressed = True
            else:
                rep.stall += 1
                if rep.stall >= self.stall_threshold:
                    self._fail(rep, "wedge", EngineStalledError(
                        f"replica {rep.name}: no progress for {rep.stall} "
                        f"consecutive heartbeats with work pending"))
                    progressed = True
        # phase B: prefill-role replicas export finished prefills AFTER
        # their streams drained (the router log must already cover every
        # token the packet carries, so the decode replica's re-emission
        # only ever EXTENDS it)
        if self._begin_handoffs():
            progressed = True
        if self.snapshot_root is not None and self.snapshot_every \
                and self._round % self.snapshot_every == 0:
            for rep in self._replicas:
                if not rep.alive:
                    continue
                try:
                    path = rep.snapshots.save_engine(
                        rep.engine, mode=self.snapshot_mode)
                    self.flight.record("snapshot", replica=rep.name,
                                       path=os.path.basename(path))
                except Exception as exc:  # noqa: BLE001 — died mid-snapshot
                    self._fail(rep, "crash", exc)
                    progressed = True   # the failover IS progress (same as
                    # the heartbeat crash path — the stall watchdog must
                    # not starve on rounds that spent their time recovering)
        return progressed

    # -- disaggregated KV handoff ------------------------------------------
    def _begin_handoffs(self) -> bool:
        """Phase B of the disaggregated handoff: every prefill-role
        replica exports each request whose prefill is DONE (first token
        decoded, no chunk in flight — ``ServingEngine.handoff_ready``)
        as a KV packet (page planes + scale planes + exact
        request state), cancels it locally (the written KV parks in the
        prefix cache: an affinity bonus if the fallback path ever
        re-prefills here), and queues the packet for phase-A import next
        round.  Pure host work — no engine steps, no device transfers
        beyond the page gather itself."""
        if not self._has_roles:
            return False
        progressed = False
        for rep in self._replicas:
            if not rep.alive or rep.role != "prefill":
                continue
            for frid in sorted(self._assigned[rep.name]):
                if frid not in self._assigned[rep.name]:
                    continue       # resolved by a _stream below
                fr = self._requests.get(frid)
                if fr is None or fr.result is not None \
                        or fr.handle is None or fr.no_handoff:
                    continue
                eng = rep.engine
                if not eng.handoff_ready(fr.handle.rid):
                    continue
                t0 = self._clock()
                try:
                    packet = eng.export_kv([fr.handle.rid])
                except KeyError:
                    # retired during the export quiesce (deadline race) —
                    # the drain below observes the retirement; nothing to
                    # hand off
                    self._stream(rep)
                    continue
                # drain tokens decoded up to the quiesce point FIRST: the
                # router log must cover everything the packet carries
                self._stream(rep)
                if fr.result is not None:
                    continue       # finished at the quiesce edge
                eng.cancel(fr.handle.rid)
                self._assigned[rep.name].discard(frid)
                fr.replica = None
                fr.handle = None
                self._pending_handoffs.append({
                    "fr": fr, "packet": packet, "src": rep.name,
                    "src_tp": int(packet["tp"]), "t0": t0, "tries": 0})
                self.flight.record("handoff_export", frid=frid,
                                   src=rep.name,
                                   pages=len(packet["kv_pages"]),
                                   bytes=int(packet["bytes"]),
                                   trace_id=fr.trace_id)
                # "preempted" re-opens the queued phase on the router
                # track; the import closes it with routing="handoff"
                self.tracer.request_event(frid, "preempted",
                                          kind="handoff",
                                          tokens=len(fr.streamed))
                progressed = True
        return progressed

    def _import_pending_handoffs(self) -> bool:
        """Phase A: splice every pending KV packet into a decode-capable
        replica.  Admission pressure retries for ``handoff_retry_rounds``
        rounds, then falls back to re-prefill migration; a geometry/
        dtype/mp-degree mismatch (``KVHandoffError`` — the packet can
        NEVER splice there) falls back immediately.  Either fallback
        rides the normal degradation ladder (route -> queue -> reject
        exempt: migrations are never dropped)."""
        if not self._pending_handoffs:
            return False
        progressed = False
        still: list[dict] = []
        for h in self._pending_handoffs:
            fr = h["fr"]
            if fr.result is not None or fr.frid not in self._requests:
                continue           # resolved or client-cancelled in flight
            outcome = self._import_one(h)
            if outcome == "retry":
                h["tries"] += 1
                if h["tries"] >= self.handoff_retry_rounds:
                    fr.no_handoff = True
                    self._c_handoff_fallbacks.inc()
                    self.flight.record("handoff_fallback", frid=fr.frid,
                                       src=h["src"],
                                       reason="no_decode_capacity",
                                       tries=h["tries"])
                    self._migrate(fr)
                    progressed = True
                else:
                    still.append(h)
            else:
                progressed = True  # placed, or fallback-migrated inline
        self._pending_handoffs = still
        return progressed

    def _import_one(self, h: dict) -> str:
        """Try one packet: returns ``"placed"`` (spliced into a decode
        replica), ``"fallback"`` (mismatch — already re-prefill-migrated),
        or ``"retry"`` (admission pressure / no decode capacity now)."""
        fr = h["fr"]
        cands = {rep.name: rep for rep in self._alive()
                 if rep.routable and rep.role == "decode"}
        if not cands:
            # no decode replica alive (mid-failover): "any" replicas can
            # decode too — never strand the packet on role purity.
            # Never a PREFILL replica: importing there would undo the
            # disaggregation the export just paid for.
            cands = {rep.name: rep for rep in self._alive()
                     if rep.routable and rep.role == "any"}
        if not cands:
            return "retry"
        memo = fr.route_memo
        if memo.get("n_streamed") != len(fr.streamed):
            memo.clear()
            memo["n_streamed"] = len(fr.streamed)
            memo["tokens"] = fr.prompt if not fr.streamed \
                else np.concatenate(
                    [fr.prompt, np.asarray(fr.streamed[:-1], np.int32)])
        decision = self.router.decide(
            memo["tokens"],
            [(name, rep.load()) for name, rep in cands.items()],
            memo=memo, role="decode")
        for name in decision.order:
            rep = cands.get(name)
            if rep is None:
                continue
            try:
                mapping = rep.engine.import_kv(h["packet"])
            except AdmissionRejected:
                continue
            except KVHandoffError as exc:
                fr.no_handoff = True
                self._c_handoff_fallbacks.inc()
                self.flight.record("handoff_fallback", frid=fr.frid,
                                   src=h["src"], dst=name,
                                   reason=str(exc)[:160])
                self._migrate(fr)
                return "fallback"
            rid = next(iter(mapping.values()))
            fr.replica = rep.name
            fr.handle = rep.engine.lookup(rid)
            self._assigned[rep.name].add(fr.frid)
            dt = max(0.0, self._clock() - h["t0"])
            rank_local = int(rep.engine.tp) == h["src_tp"]
            self._c_handoffs.inc()
            self._c_kv_pages.inc(len(h["packet"]["kv_pages"]))
            self._c_kv_bytes.inc(int(h["packet"]["bytes"]))
            if rank_local:
                self._c_kv_rank_local.inc()
            self._h_kv_transfer.observe(dt)
            self.flight.record("handoff", frid=fr.frid, src=h["src"],
                               dst=rep.name,
                               pages=len(h["packet"]["kv_pages"]),
                               bytes=int(h["packet"]["bytes"]),
                               rank_local=rank_local,
                               transfer_s=round(dt, 6),
                               trace_id=fr.trace_id)
            self.tracer.request_event(fr.frid, "admitted",
                                      replica=rep.name,
                                      routing="handoff",
                                      rank_local=rank_local,
                                      resumed_tokens=len(fr.streamed))
            return "placed"
        return "retry"

    def _stream(self, rep: _Replica):
        """Drain newly emitted tokens from the replica into the router's
        per-request record (the token-streaming path), and capture results
        for retired requests.  After a migration or snapshot restore the
        engine may RE-emit tokens the router already streamed — greedy
        regeneration is bit-identical, so the record only ever extends."""
        now = self._clock()
        for frid in sorted(self._assigned[rep.name]):
            fr = self._requests[frid]
            req = fr.handle
            gen = req.generated
            if len(gen) > len(fr.streamed):
                if fr.first_token_t is None:
                    fr.first_token_t = now
                    self.tracer.request_event(fr.frid, "first_token",
                                              t=now, replica=rep.name)
                for t in gen[len(fr.streamed):]:
                    t = int(t)
                    fr.streamed.append(t)
                    self.tokens_streamed += 1
                    if fr.on_token is not None:
                        # router-authoritative emission: fires exactly once
                        # per position, even when a migrated engine
                        # re-decodes already-streamed tokens
                        fr.on_token(t)
            if req.finish_time:
                self._resolve(fr, req, now)

    def _resolve(self, fr: _FleetRequest, req: Request, now: float):
        fr.result = req
        fr.finish_t = now
        self._c_resolved.inc()
        if fr.replica is not None:
            self._assigned[fr.replica].discard(fr.frid)
        n = len(req.generated)
        ttft = fr.first_token_t - fr.submit_t \
            if fr.first_token_t is not None else None
        tpot = (fr.finish_t - fr.first_token_t) / (n - 1) \
            if n > 1 and fr.first_token_t is not None else None
        # per-request result store the drill harness reads whole;
        # fleet lifetime is one drill
        self._summaries.append({
            "rid": fr.frid, "tokens": n, "ttft_s": ttft, "tpot_s": tpot,
            "e2e_s": now - fr.submit_t, "timed_out": req.timed_out,
            "migrations": fr.migrations, "at": now,
        })
        self.flight.record("resolve", frid=fr.frid, tokens=n,
                           timed_out=req.timed_out,
                           migrations=fr.migrations)
        self.tracer.request_event(fr.frid, "retired", t=now, tokens=n,
                                  timed_out=req.timed_out,
                                  migrations=fr.migrations)

    # -- failover ----------------------------------------------------------
    def _fail(self, rep: _Replica, kind: str, exc: BaseException):
        """Replica death: flight-record the failover (with any active
        fault-plan context), revive the replica — from its newest intact
        snapshot when one exists, blank otherwise — and migrate every
        outstanding request the revived engine does not already carry."""
        t0 = self._clock()
        self._c_failovers.inc()
        rep.failures += 1
        rep.alive = False
        # the unroutable mark happens-before EVERYTHING else in the
        # failover — placement candidates are filtered on it, so no
        # adopt can race a replica the supervisor already condemned
        rep.routable = False
        corpse = rep.engine
        rep.engine = None          # the corpse's state is not trusted
        rep.stall = 0
        # wedge-race quiesce: a wedged-but-ALIVE
        # engine can un-wedge after the failover decision — and anything
        # still holding a reference (an autoscaler sweep, a frontend
        # worker thread) could step it and keep decoding requests the
        # fleet is about to migrate: double emission through any
        # engine-level hook, pages pinned on the corpse.  Cancel the
        # outstanding requests ON THE CORPSE before any adopt happens,
        # so the quiesce happens-before the migration.  Crash corpses
        # are not trusted (possibly corrupt host state) — best-effort,
        # first failure aborts the sweep.
        if kind == "wedge" and corpse is not None:
            quiesced = 0
            for frid in sorted(self._assigned[rep.name]):
                fr = self._requests[frid]
                if fr.handle is None:
                    continue
                try:
                    corpse.cancel(fr.handle.rid)
                    quiesced += 1
                except BaseException:  # noqa: BLE001 — corpse may be wedged
                    break              # beyond cooperation; migration still
                                       # proceeds (router log is authoritative)
            self.flight.record("wedge_quiesce", replica=rep.name,
                               cancelled=quiesced)
        # the dead engine's cached chains died with it: the router must
        # not keep routing affinity traffic at a corpse (revival re-seeds
        # from whatever the restored snapshot actually carries)
        self.router.on_replica_removed(rep.name)
        # postmortem capture BEFORE the corpse is dropped: its flight ring
        # (what the replica was doing when it died) and its tracer (so the
        # stitched fleet trace keeps the spans this generation ran)
        corpse_ring = None
        if corpse is not None and corpse.telemetry is not None:
            corpse_ring = corpse.telemetry.flight.events()
            # one entry per replica death — failover forensics, read
            # whole by the stitched export
            self._dead_tracers.append(
                (f"{rep.name} (crashed#{rep.failures})",
                 corpse.telemetry.tracer))
        self.flight.record("failover", replica=rep.name, kind=kind,
                           failures=rep.failures, error=str(exc)[:200],
                           fault_plan=fault_context())
        self.tracer.engine_event("failover", replica=rep.name, kind=kind)
        # ONE merged postmortem artifact: the dying replica's ring PLUS
        # the router's last-N routing decisions — a misroute (the request
        # was on the wrong replica when it died) is diagnosable from this
        # dump alone, without correlating two files
        routing = [e for e in self.flight.events()
                   if e["event"] in ("route", "migrate")]
        self.flight.dump(
            "failover", replica=rep.name, kind=kind,
            routing_decisions=routing[-self.route_dump_last:],
            replica_ring=corpse_ring)
        outstanding = [self._requests[f]
                       for f in sorted(self._assigned[rep.name])]
        self._assigned[rep.name] = set()
        restored_rids = None
        if rep.failures <= self.max_failovers_per_replica:
            restored_rids = self._revive(rep)
        still = outstanding
        if rep.alive and restored_rids is not None:
            still = []
            kept: set[int] = set()
            for fr in outstanding:
                rid = fr.handle.rid if fr.handle is not None else None
                if rid is not None and rid in restored_rids \
                        and fr.kw["temperature"] <= 0.0:
                    # the snapshot carries this GREEDY request — it
                    # continues on the revived replica from the snapshot
                    # state (any re-decoded tokens are greedy-identical to
                    # the ones already streamed).  Sampled requests must
                    # NOT resume from a stale snapshot: re-sampling past
                    # the snapshot point diverges from tokens the router
                    # already streamed — they migrate via adopt() below,
                    # which continues from the streamed tokens exactly
                    # (their snapshot copy is pruned as a zombie).
                    fr.handle = rep.engine.lookup(rid)
                    self._assigned[rep.name].add(fr.frid)
                    kept.add(rid)
                else:
                    still.append(fr)
            # prune ZOMBIES: snapshot-restored requests the router already
            # resolved before the crash would otherwise occupy slots/pages
            # on the revived replica and decode to completion unobserved
            for rid in sorted(restored_rids - kept):
                rep.engine.cancel(rid)
        for fr in still:
            fr.replica = None
            fr.handle = None
            self._migrate(fr)
        if not self._alive() and any(fr.result is None
                                     for fr in self._requests.values()):
            raise FleetFailedError(
                f"no live replicas left ({len(self._requests)} requests "
                f"tracked, failover budget "
                f"{self.max_failovers_per_replica}/replica exhausted)")
        self._h_recovery.observe(self._clock() - t0)

    def _revive(self, rep: _Replica):
        """Build a replacement engine for a dead replica; restore it from
        the newest intact snapshot when one exists.  Returns the set of
        engine-side rids the restored engine carries (empty for a blank
        replacement), or None when the replacement could not be built
        (the replica stays dead)."""
        try:
            eng = self._new_engine(rep.name, rep.role)
        except Exception as exc:  # noqa: BLE001 — factory failure
            self.flight.record("revive_failed", replica=rep.name,
                               error=str(exc)[:200])
            return None
        restored: set[int] = set()
        if rep.snapshots is not None:
            try:
                res = rep.snapshots.restore_engine(eng)
            except Exception as exc:  # noqa: BLE001 — unreadable snapshot
                self.flight.record("restore_failed", replica=rep.name,
                                   error=str(exc)[:200])
                res = None
            if res is not None:
                path, applied = res
                restored = set(eng._finished) \
                    | {sl.req.rid for sl in eng._slots if sl is not None} \
                    | {r.rid for r in eng._queue}
                self.flight.record("restore", replica=rep.name,
                                   path=os.path.basename(path),
                                   mode=applied, requests=len(restored))
        rep.engine = eng
        rep.alive = True
        rep.routable = True
        self._wire_router(rep)
        return restored

    def _migrate(self, fr: _FleetRequest):
        """Move one orphaned request to a live replica by re-prefill of
        prompt + streamed tokens; unplaceable requests wait in the fleet
        queue with backoff (migrated requests are never dropped — the
        reject rung applies to NEW submissions only)."""
        self._c_migrations.inc()
        fr.migrations += 1
        self.flight.record("migrate", frid=fr.frid,
                           tokens=len(fr.streamed),
                           trace_id=fr.trace_id,
                           fault_plan=fault_context())
        # "preempted" re-opens the queued phase on the router track — a
        # migration reads as: left its replica, waiting for placement
        self.tracer.request_event(fr.frid, "preempted", kind="migrate",
                                  tokens=len(fr.streamed))
        kw = fr.kw
        eos = kw["eos_token_id"]
        if fr.streamed and (len(fr.streamed) >= kw["max_new_tokens"]
                            or (eos is not None and eos in fr.streamed)):
            # completion edge: every token was streamed before the crash
            # but the retirement was never observed — nothing to continue,
            # synthesize the result from the router record
            req = Request(rid=-1, prompt=fr.prompt,
                          max_new_tokens=kw["max_new_tokens"],
                          temperature=kw["temperature"], top_p=kw["top_p"],
                          eos_token_id=eos, generated=list(fr.streamed),
                          submit_time=fr.submit_t)
            req.finish_time = self._clock()
            self._resolve(fr, req, req.finish_time)
            return
        if not self._place(fr):
            self._backoff(fr)
            self._waiting.append(fr)

    # -- driving -----------------------------------------------------------
    # the supervisor loop is single-threaded by design: all fleet state
    # (placement, retries, summaries) is owned by the driving thread —
    # owner=main turns any future thread reaching it into a lint error
    def run(self, max_rounds: int | None = None,
            max_stall_rounds: int = 1000) -> dict:
        """Drive the fleet until every submitted request resolved; returns
        ``{frid: Request}``.  ``max_stall_rounds`` consecutive no-progress
        rounds raise :class:`EngineStalledError` (only reachable under a
        never-clearing injected fault window)."""
        stalled = 0
        rounds = 0
        while any(fr.result is None for fr in self._requests.values()):
            progressed = self.step()
            stalled = 0 if progressed else stalled + 1
            if stalled >= max_stall_rounds:
                unresolved = sum(fr.result is None
                                 for fr in self._requests.values())
                raise EngineStalledError(
                    f"fleet made no progress for {stalled} consecutive "
                    f"rounds ({unresolved} unresolved, "
                    f"{len(self._waiting)} waiting)")
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        return self.results()

    def results(self) -> dict:
        return {frid: fr.result for frid, fr in self._requests.items()
                if fr.result is not None}

    # -- readouts ----------------------------------------------------------
    def stats(self) -> dict:
        q = self._h_recovery.percentiles()
        tq = self._h_kv_transfer.percentiles()
        handoffs = self._c_handoffs.value
        return {
            "replicas": len(self._replicas),
            "replicas_alive": len(self._alive()),
            "replicas_routable": sum(1 for rep in self._alive()
                                     if rep.routable),
            "replicas_retired": len(self._retired_stats),
            "failovers": self._c_failovers.value,
            "migrations": self._c_migrations.value,
            "rejections": self._c_rejections.value,
            "torn_snapshots": self._c_torn.value,
            "scale_ups": self._c_scale_up.value,
            "scale_downs": self._c_scale_down.value,
            "drain_migrations": self._c_drain_migr.value,
            "handoffs": handoffs,
            "handoff_fallbacks": self._c_handoff_fallbacks.value,
            "handoffs_pending": len(self._pending_handoffs),
            "kv_transfer": {
                "pages": self._c_kv_pages.value,
                "bytes": self._c_kv_bytes.value,
                "rank_local": self._c_kv_rank_local.value,
                "rank_local_hit_rate":
                    round(self._c_kv_rank_local.value / handoffs, 4)
                    if handoffs else None,
                "transfer_s": {
                    "count": self._h_kv_transfer.count,
                    "p50_ms": round(tq[50] * 1e3, 3),
                    "p95_ms": round(tq[95] * 1e3, 3),
                    "p99_ms": round(tq[99] * 1e3, 3),
                    "max_ms": round(self._h_kv_transfer.max * 1e3, 3)
                    if self._h_kv_transfer.count else 0.0},
            },
            "roles": {rep.name: rep.role for rep in self._replicas},
            "requests_submitted": self._c_submitted.value,
            "requests_resolved": self._c_resolved.value,
            "tokens_streamed": self.tokens_streamed,
            "replica_seconds": round(self.replica_seconds, 4),
            "waiting": len(self._waiting),
            "recovery": {"count": self._h_recovery.count,
                         "p50_ms": round(q[50] * 1e3, 3),
                         "p95_ms": round(q[95] * 1e3, 3),
                         "p99_ms": round(q[99] * 1e3, 3),
                         "max_ms": round(self._h_recovery.max * 1e3, 3)
                         if self._h_recovery.count else 0.0},
            "per_replica": {rep.name: (dict(rep.engine.stats(),
                                            routable=rep.routable,
                                            role=rep.role)
                                       if rep.alive else None)
                            for rep in self._replicas},
        }

    @staticmethod
    def _hit_rate(stats: dict) -> float | None:
        """One replica's lifetime prefix-cache hit rate: cached tokens
        over (cached + executed) prefill tokens; None before any
        prefill."""
        hit = stats.get("cached_prefix_tokens", 0)
        ex = stats.get("prefill_tokens_executed", 0)
        return round(hit / (hit + ex), 4) if hit + ex else None

    def fleet_hit_rate(self) -> dict:
        """Fleet-wide prefix-cache hit rate over the fleet's WHOLE
        service history — live replicas plus retired ones (a drained
        replica's hits must not vanish from the accounting the moment
        the autoscaler destroys it)."""
        hit = ex = 0
        per: dict[str, float | None] = {}
        for name, st in self._retired_stats:
            hit += st.get("cached_prefix_tokens", 0)
            ex += st.get("prefill_tokens_executed", 0)
            per[name] = self._hit_rate(st)
        for rep in self._alive():
            st = rep.engine.stats()
            hit += st.get("cached_prefix_tokens", 0)
            ex += st.get("prefill_tokens_executed", 0)
            per[rep.name] = self._hit_rate(st)
        return {
            "cached_prefix_tokens": hit,
            "prefill_tokens_executed": ex,
            "hit_rate": round(hit / (hit + ex), 4) if hit + ex else 0.0,
            "per_replica": per,
        }

    def stats_snapshot(self, ttft_deadline_s: float | None = None) -> dict:
        """The fleet-wide observability snapshot: the router
        :meth:`stats` plus the :class:`FleetTelemetry` aggregation over
        every live telemetry-bearing replica — replica histograms merged
        BUCKET-WISE into fleet quantiles (``merged``), gauges/series/
        counters side-by-side per replica (``per_replica_telemetry``).
        With ``ttft_deadline_s``, a fleet-wide SLO report read straight
        off the merged TTFT histogram rides along (``fleet_slo``).
        The snapshot also carries ``alerts`` — the
        aggregated health-sentinel view across replicas (empty components
        when no replica runs a sentinel)."""
        ft = FleetTelemetry.from_fleet(self)
        snap = ft.snapshot()
        out = dict(self.stats())
        out["replica_names"] = snap["replicas"]
        out["merged"] = snap["merged"]
        out["per_replica_telemetry"] = snap["per_replica"]
        out["alerts"] = self.alerts_report()
        # routing observability: per-replica hit rates +
        # the router's affinity-hit/fallback counters ride every snapshot
        out["cache"] = self.fleet_hit_rate()
        for rep in self._replicas:
            if rep.alive:
                pr = out["per_replica"].get(rep.name)
                if isinstance(pr, dict):
                    pr["cache_hit_rate"] = self._hit_rate(pr)
        out["router"] = self.router.stats()
        if ttft_deadline_s is not None:
            out["fleet_slo"] = ft.slo_report(ttft_deadline_s)
        return out

    # -- latency forensics + health sentinel -------------------------------
    def _sentinels(self) -> dict:
        out: dict = {}
        for rep in self._replicas:
            if rep.alive and rep.engine is not None \
                    and rep.engine.telemetry is not None \
                    and rep.engine.telemetry.sentinel is not None:
                out[rep.name] = rep.engine.telemetry.sentinel
        return out

    def alerts_report(self) -> dict:
        """Aggregated health-sentinel view across live replicas (worst
        status wins, fire counts sum) — the failover artifact's
        ``alerts`` section and the frontend exporter's ``/alerts``
        source when the fleet is the backend."""
        from ..observability.health import aggregate_alerts
        return aggregate_alerts(self._sentinels())

    def slow_requests(self, k: int = 8) -> list:
        """Fleet-level tail forensics: the top-``k`` slowest captured
        requests across every live replica's TailRecorder, slowest
        first (flight-style outlier dumps with attribution + engine
        context)."""
        from ..observability.attribution import merge_tail_dumps
        tails = [(rep.name, rep.engine.telemetry.tail)
                 for rep in self._replicas
                 if rep.alive and rep.engine is not None
                 and rep.engine.telemetry is not None
                 and rep.engine.telemetry.tail is not None]
        return merge_tail_dumps(tails, k=k)

    def attribution_report(self, top_k: int = 5) -> dict:
        """Stitched critical-path attribution over every END-TO-END
        request the fleet resolved: each trace_id's residencies attribute
        on their replica's spans, inter-replica gaps classify as
        ``migration`` / ``snapshot_restore`` — crashed generations'
        tracers included, so a failover-migrated request still decomposes
        exactly (observability.attribution)."""
        from ..observability.attribution import stitched_attribution_report
        return stitched_attribution_report(self.trace_components(),
                                           top_k=top_k)

    def trace_components(self) -> list:
        """(name, Tracer) per stitched-trace component: the router track
        first, then crashed replica generations, then the live replicas
        (telemetry-bearing only — a tracer lives inside Telemetry)."""
        comps: list = [("router", self.tracer)]
        comps.extend(self._dead_tracers)
        for rep in self._replicas:
            if rep.alive and rep.engine is not None \
                    and rep.engine.telemetry is not None:
                comps.append((rep.name, rep.engine.telemetry.tracer))
        return comps

    def stitcher(self, frontend=None) -> TraceStitcher:
        """A :class:`TraceStitcher` over this fleet's components (plus an
        optional upstream front end's ``(name, tracer)`` first)."""
        st = TraceStitcher()
        if frontend is not None:
            st.add("frontend", frontend.tracer
                   if hasattr(frontend, "tracer") else frontend)
        for name, tracer in self.trace_components():
            st.add(name, tracer)
        return st

    def stitched_trace(self, frontend=None) -> dict:
        """ONE Perfetto view of every request across frontend/router/
        replica tracks, failovers included (crashed generations keep
        their own tracks; flow events follow each trace_id)."""
        return self.stitcher(frontend=frontend).to_chrome_trace()

    def slo_report(self, ttft_deadline_s: float,
                   window_s: float | None = None) -> dict:
        """Fleet-level SLO report (TTFT measured at the ROUTER — token
        observed leaving a replica — which is what a user would see)."""
        return slo_report(self._summaries, ttft_deadline_s,
                          window_s=window_s)

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()
