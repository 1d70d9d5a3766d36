"""Deterministic, scoped fault injection.

Production training and serving jobs treat preemption, torn checkpoint writes, NaN bursts,
pool pressure, and slow collectives as *normal operating conditions*; the
recovery paths that handle them are exactly the code that never runs in a
clean CI environment.  This module makes every one of those paths testable
on CPU: subsystems consult named **fault points** (`fault_point(name,
**ctx)`) at the moments where real hardware would fail, and a seeded
:class:`FaultPlan` — activated for a scope with :func:`inject` — decides
deterministically which consults fire.

Fault-point catalog (the consulting subsystem documents exact ctx keys):

==========================  ====================================================
``ckpt.write``              checkpoint writer, once per WRITE_CHUNK bytes per
                            staged file (ctx: ``file``, ``offset``) — ``raise``
                            kills the write mid-file, leaving a torn staging dir
``ckpt.commit``             just before the atomic staging->final rename
                            (ctx: ``path``) — ``raise`` simulates preemption
                            after a complete write but before the commit point
``ckpt.dirsync``            just before the parent-directory-entry fsync that
                            precedes the rename (ctx: ``path``, ``phase``) —
                            ``raise`` kills the commit in the window where the
                            staging dir's NAME is not yet durable
``train.nonfinite``         once per TrainStep call (ctx: ``step``) —
                            ``trigger`` poisons that step's loss+grads with NaN
``pagepool.alloc``          PagePool.alloc (ctx: ``n``, ``free``) — ``raise``
                            injects InjectedFault, ``trigger`` the standard
                            pool-exhausted RuntimeError
``serve.pool_pressure``     once per ServingEngine.step (ctx: ``step``) —
                            ``trigger`` makes the engine see zero free pages
                            that step (exhaustion without shrinking the pool)
``serve.crash``             twice per ServingEngine.step (ctx: ``engine``,
                            ``step``, ``phase`` in {"sched", "record"}) —
                            ``raise`` kills the replica mid-step (after
                            admissions / after token record), stranding its
                            in-flight requests for a fleet to migrate
``serve.wedge``             once per ServingEngine.step (ctx: ``engine``,
                            ``step``) — ``trigger`` makes the step return
                            without doing ANY work (an unresponsive replica;
                            fleet watchdogs see consecutive no-progress
                            heartbeats)
``serve.snapshot``          once per EngineSnapshotManager.save_engine (ctx:
                            ``engine``, ``step``, ``mode``) — ``raise`` dies
                            before anything stages; ``trigger`` TEARS the
                            committed snapshot after the fact (bit-rot),
                            which manifest verification must reject
``spmd.collective``         once per recorded collective in a spmd_sanitize
                            scope (ctx: ``rank``, ``index``, ``kind``) —
                            ``trigger`` drops that rank's event (the
                            skipped-branch divergence drill)
``comm.ready``              wait_with_timeout readiness check (ctx: ``op``) —
                            ``trigger`` simulates a collective that never
                            becomes ready (CommTimeoutError)
``rpc.drop_frame``          RpcClient, once per send attempt (ctx: ``method``,
                            ``attempt``) — ``trigger`` loses the request frame
                            before the wire; the client burns the attempt
                            timeout waiting, then backs off and retries
``rpc.delay_frame``         RpcClient (ctx: ``method``, ``attempt``) —
                            ``trigger`` sends the frame ``fault_delay_s`` late
``rpc.truncate_frame``      RpcClient (ctx: ``method``, ``attempt``) —
                            ``trigger`` sends half the body then kills the
                            connection; the server must drop the torn frame
                            WITHOUT invoking the handler
``rpc.half_open``           RpcClient (ctx: ``method``, ``attempt``) —
                            ``trigger`` delivers the request fully but dies
                            before the reply: the handler runs exactly once
                            and the retry must hit the idempotency cache (the
                            no-double-submit drill)
``thread.interleave``       ThreadSanitizer, once per instrumented lock
                            acquire/release (ctx: ``op``, ``lock``,
                            ``thread``) — ``trigger`` injects a short
                            sleep-yield at that point, steering the OS
                            scheduler into rare interleavings; with a seeded
                            plan the yield schedule is reproducible, turning
                            flaky race reports into deterministic drills
==========================  ====================================================

Firing rules per spec: ``at=k`` fires exactly on the k-th matching consult
(0-based); otherwise consults ``after`` <= hit fire until ``count`` fires
have happened (``count=None`` -> forever).  ``prob`` gates each eligible
fire through the plan-seeded RNG (chaos sweeps).  ``match`` filters consults
by ctx equality, e.g. ``match={"file": "rank0.data"}``.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

__all__ = ["InjectedFault", "FaultSpec", "FaultPlan", "inject", "fault_point",
           "active_plan"]


class InjectedFault(RuntimeError):
    """Raised at a fault point by a firing spec with ``action='raise'``."""


@dataclass
class FaultSpec:
    """One fault rule: where (``point`` + ``match``), when (``at`` /
    ``after`` / ``count`` / ``prob``), and how (``action``)."""
    point: str
    action: str = "raise"          # "raise" -> InjectedFault; "trigger" ->
    at: int | None = None          #   point-specific degraded behavior
    after: int = 0
    count: int | None = 1
    prob: float = 1.0
    match: dict = field(default_factory=dict)
    hits: int = 0                  # matching consults so far (telemetry)
    fired: int = 0

    def __post_init__(self):
        if self.action not in ("raise", "trigger"):
            raise ValueError(f"unknown fault action {self.action!r}")

    def _matches(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())


class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules, consulted via
    :func:`fault_point` while active (see :func:`inject`)."""

    def __init__(self, specs=(), seed: int = 0):
        self.specs: list[FaultSpec] = []
        if isinstance(specs, dict):
            specs = [FaultSpec(point=p, **kw) for p, kw in specs.items()]
        for s in specs:
            self.specs.append(s if isinstance(s, FaultSpec)
                              else FaultSpec(**s) if isinstance(s, dict)
                              else FaultSpec(point=s))
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()

    def consult(self, point: str, ctx: dict) -> FaultSpec | None:
        """Count a hit on every matching spec; return the first that fires."""
        firing = None
        with self._lock:
            for spec in self.specs:
                if spec.point != point or not spec._matches(ctx):
                    continue
                h = spec.hits
                spec.hits += 1
                if firing is not None:
                    continue  # one action per consult: later specs keep
                              # their hit count but spend no fire budget
                if spec.at is not None:
                    eligible = h == spec.at
                else:
                    eligible = h >= spec.after and (
                        spec.count is None or spec.fired < spec.count)
                if eligible and (spec.prob >= 1.0
                                 or self._rng.random() < spec.prob):
                    spec.fired += 1
                    firing = spec
        return firing

    def fired(self, point: str | None = None) -> int:
        return sum(s.fired for s in self.specs
                   if point is None or s.point == point)

    def hits(self, point: str | None = None) -> int:
        return sum(s.hits for s in self.specs
                   if point is None or s.point == point)


# Active-plan stack. Module-level (not thread-local) on purpose: faults must
# be visible to worker threads the scope spawns (async checkpoint writers,
# watchdog waiters). Every ``inject`` scope pops its own plan on exit.
_ACTIVE: list[FaultPlan] = []
_STACK_LOCK = threading.Lock()


def active_plan() -> FaultPlan | None:
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def inject(plan=None, *, seed: int = 0, **kw):
    """Activate a fault plan for the enclosed scope (re-entrant; the innermost
    plan wins). Accepts a :class:`FaultPlan`, or anything
    ``FaultPlan(specs, seed=seed)`` accepts — e.g. a ``{point: rule-kwargs}``
    dict or a list of :class:`FaultSpec`."""
    if not isinstance(plan, FaultPlan):
        plan = FaultPlan(plan or (), seed=seed, **kw)
    with _STACK_LOCK:
        _ACTIVE.append(plan)
    try:
        yield plan
    finally:
        with _STACK_LOCK:
            _ACTIVE.remove(plan)


def fault_point(name: str, **ctx) -> FaultSpec | None:
    """Consult the active plan at a named fault point.

    Returns None (the overwhelmingly common no-plan / no-fire case), raises
    :class:`InjectedFault` for a firing ``action='raise'`` spec, or returns
    the firing spec for ``action='trigger'`` (the call site degrades
    accordingly)."""
    plan = active_plan()
    if plan is None:
        return None
    spec = plan.consult(name, ctx)
    if spec is not None and spec.action == "raise":
        raise InjectedFault(
            f"injected fault at '{name}' (hit {spec.hits - 1}, ctx={ctx})")
    return spec
