"""Sentinel-driven elastic autoscaling over the replica fleet.

:class:`~.fleet.ReplicaFleet` serves a FIXED N; under a diurnal load
curve that is wrong twice a day — peak traffic queues behind too few
replicas (TTFT SLO burns), trough traffic pays for idle ones
(goodput-per-replica-hour collapses).  This module
closes the loop:

  * :class:`AutoscalePolicy` — the decision layer, deliberately shaped
    like the training side's ``ElasticManager`` change/exit protocol
    (``distributed/fleet/elastic``): each evaluation returns
    :class:`AutoscaleDecision` ``HOLD`` / ``GROW`` / ``SHRINK``, derived
    from which sentinel alerts are active.  GROW fires on the sustained
    ``queue_growth`` signal (the autoscaler trigger — the same
    :class:`~paddle_tpu_torch.observability.health.TrendRule` shape,
    evaluated here over fleet-wide queue pressure) or on a TTFT SLO-burn
    signal (``slo_ttft_s=``); SHRINK fires on ``fleet_idle`` (windowed
    per-replica load below the idle floor).  ``scale_cooldown_s``
    separates actions so one incident scales one step at a time.
  * :class:`ElasticFleet` — a :class:`~.fleet.ReplicaFleet` whose
    ``step()`` additionally evaluates the policy's
    :class:`~paddle_tpu_torch.observability.health.HealthSentinel` and acts:
    GROW -> :meth:`~.fleet.ReplicaFleet.add_replica` (up to
    ``max_replicas``); SHRINK -> :meth:`~.fleet.ReplicaFleet.
    retire_replica` on the idlest replica — the ZERO-LOSS drain:
    mark-unroutable -> live-migrate every in-flight request through the
    streamed-token re-prefill path (``cancel`` + ``adopt``; greedy
    outputs stay bit-exact by the preemption-resume guarantee) ->
    destroy the empty
    engine (its tracer/telemetry/hit counters outlive it).

The sentinel runs under an INJECTABLE clock, and by default that clock
is *round time* (``fleet round * dt_per_round``): scaling decisions then
depend only on the work content of the trace, not on machine speed — a
seeded diurnal scenario produces the identical scale-event timeline on
any host (``tests/test_torch_disagg_autoscale.py`` pins this), while
wall-clock metrics (TTFT, goodput) keep their own domain.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

from ..observability.health import HealthSentinel, AlertRule, autoscale_rules
from ..observability.slo import burn_rate, on_time
from .fleet import ReplicaFleet

__all__ = ["AutoscaleDecision", "AutoscalePolicy", "ElasticFleet"]


class AutoscaleDecision(enum.Enum):
    """The change/exit-protocol analog for serving capacity (the training
    side's ``ElasticStatus`` HOLD/CHANGE/EXIT, reshaped as a direction)."""
    HOLD = "hold"
    GROW = "grow"
    SHRINK = "shrink"


class _RecentBurnRule(AlertRule):
    """TTFT SLO burn over the most recent fleet request summaries —
    count-windowed rather than time-windowed so it shares whatever clock
    the sentinel runs on (round time by default).  Reads the shared
    :func:`~paddle_tpu_torch.observability.slo.on_time` predicate and
    :func:`~paddle_tpu_torch.observability.slo.burn_rate` math; fires when the
    recent-bad-fraction burns faster than ``threshold``."""

    def __init__(self, name: str, *, summaries_fn, slo_ttft_s: float,
                 slo_target: float = 0.95, recent: int = 8, **kw):
        kw.setdefault("threshold", 1.0)
        super().__init__(name, **kw)
        self.summaries_fn = summaries_fn
        self.slo_ttft_s = float(slo_ttft_s)
        self.slo_target = float(slo_target)
        self.recent = int(recent)
        self._seen = 0

    def reset(self):
        self._seen = 0

    def sample(self, ctx) -> float | None:
        rows = self.summaries_fn(ctx)
        if len(rows) < self.recent:
            return None
        if len(rows) == self._seen:
            # nothing NEW resolved since the last evaluation: idle
            # traffic is not an SLO emergency, and re-reporting the same
            # stale tail would pin the alert active forever — blocking
            # scale-down exactly when the fleet is most over-provisioned
            return 0.0
        self._seen = len(rows)
        tail = rows[-self.recent:]
        bad = sum(1 for s in tail if not on_time(s, self.slo_ttft_s))
        return burn_rate(bad / len(tail), self.slo_target)

    def describe(self) -> dict:
        d = super().describe()
        d.update(slo_ttft_s=self.slo_ttft_s, slo_target=self.slo_target,
                 recent=self.recent)
        return d


@dataclass
class AutoscalePolicy:
    """Every knob of the elastic loop.  Windows/cooldowns are in the
    SENTINEL's clock domain — round-virtual seconds by default (one fleet
    heartbeat == ``dt_per_round``), wall seconds if an explicit wall
    clock is injected into :class:`ElasticFleet`."""
    min_replicas: int = 1
    max_replicas: int = 4
    # scale-up: sustained fleet-queue growth
    queue_growth: float = 4.0
    queue_min_depth: float = 3.0
    growth_window_s: float = 6.0
    growth_fire_frac: float = 0.5
    # scale-up (optional): TTFT SLO burn over recent resolutions
    slo_ttft_s: float | None = None
    slo_target: float = 0.95
    burn_threshold: float = 1.0
    burn_recent: int = 8
    # scale-down: sustained per-routable-replica load below the floor
    idle_per_replica: float = 0.5
    idle_window_s: float = 10.0
    # pacing
    min_samples: int = 3
    scale_cooldown_s: float = 6.0
    dt_per_round: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")

    def build_rules(self, fleet: "ElasticFleet", role=None) -> list:
        rules = autoscale_rules(
            depth_fn=lambda ctx: fleet.queue_pressure(role),
            load_fn=lambda ctx: fleet.load_per_replica(role),
            queue_growth=self.queue_growth,
            queue_min_depth=self.queue_min_depth,
            growth_window_s=self.growth_window_s,
            growth_fire_frac=self.growth_fire_frac,
            idle_per_replica=self.idle_per_replica,
            idle_window_s=self.idle_window_s,
            min_samples=self.min_samples)
        if self.slo_ttft_s is not None:
            rules.append(_RecentBurnRule(
                "ttft_slo_burn",
                summaries_fn=lambda ctx: fleet._summaries,
                slo_ttft_s=self.slo_ttft_s, slo_target=self.slo_target,
                threshold=self.burn_threshold, recent=self.burn_recent,
                window_s=self.growth_window_s,
                min_samples=self.min_samples, fire_frac=0.6,
                # pacing lives in the POLICY's scale_cooldown_s, exactly
                # like the two autoscale_rules companions — the rule's
                # own 30 s default would deafen the trigger between
                # incidents
                cooldown_s=0.0,
                severity="page",
                description="recent resolutions burning the TTFT error "
                            "budget faster than allotted — elastic "
                            "scale-up trigger"))
        return rules

    def decide(self, sentinel: HealthSentinel, fleet: "ElasticFleet",
               now: float, last_action_t: float,
               role=None) -> AutoscaleDecision:
        """Map active alerts to a capacity direction.  GROW wins over
        SHRINK (pressure evidence beats idleness evidence — both can be
        momentarily active around a load edge), and every action honors
        the shared cooldown.  With ``role``, every reading is scoped to
        that role's slice of the fleet (a disaggregated fleet scales
        prefill and decode capacity independently)."""
        if now < last_action_t + self.scale_cooldown_s:
            return AutoscaleDecision.HOLD
        active = {a.rule for a in sentinel.active()}
        routable = fleet.routable_replicas(role)
        if "queue_growth" in active or "ttft_slo_burn" in active:
            # a live pressure signal NEVER shrinks — even at max
            # capacity (where growing is impossible) an also-active idle
            # alert must not drain a replica the queue is about to need;
            # an at-max oscillator (grow impossible -> shrink -> grow)
            # would otherwise thrash a replica per cooldown
            return AutoscaleDecision.GROW \
                if routable < self.max_replicas else AutoscaleDecision.HOLD
        if "fleet_idle" in active and routable > self.min_replicas:
            return AutoscaleDecision.SHRINK
        return AutoscaleDecision.HOLD


class ElasticFleet(ReplicaFleet):
    """A :class:`~.fleet.ReplicaFleet` that scales itself.  Starts at
    ``policy.min_replicas`` (``num_replicas`` may not be passed — the
    policy owns N), evaluates the sentinel at every fleet heartbeat, and
    grows/drains one replica per decision.  Everything else — routing
    (pass ``router=PrefixAffinityRouter()`` for cache-affine placement),
    failover, snapshots, streaming — is inherited unchanged, and the
    zero-loss/bit-exactness guarantees hold across every scale event
    (the drain path IS the failover migration path)."""

    def __init__(self, engine_factory, *, policy: AutoscalePolicy | None = None,
                 role_policies: dict | None = None,
                 sentinel_clock=None, **kw):
        if "num_replicas" in kw:
            raise TypeError("ElasticFleet sizes itself — set "
                            "policy.min_replicas/max_replicas instead of "
                            "num_replicas")
        if role_policies:
            # disaggregated elastic: one AutoscalePolicy PER
            # ROLE, each with its own sentinel, readings, and cooldown —
            # a prefill burst grows prefill capacity without touching
            # the decode pool, and vice versa
            if policy is not None:
                raise TypeError("pass either policy= (role-less) or "
                                "role_policies= (disaggregated), not both")
            if "roles" in kw:
                raise TypeError("role_policies owns the role layout — "
                                "do not also pass roles=")
            bad = sorted(set(map(str, role_policies))
                         - {"any", "prefill", "decode"})
            if bad:
                raise ValueError(f"unknown roles in role_policies: {bad}")
            self.policy = None
            self.role_policies = {str(r): p
                                  for r, p in role_policies.items()}
            roles = [r for r in sorted(self.role_policies)
                     for _ in range(self.role_policies[r].min_replicas)]
            super().__init__(engine_factory, num_replicas=len(roles),
                             roles=roles, **kw)
        else:
            self.policy = policy if policy is not None else AutoscalePolicy()
            self.role_policies = None
            super().__init__(engine_factory,
                             num_replicas=self.policy.min_replicas, **kw)
        self._vclock = 0.0
        self._sentinel_clock = sentinel_clock
        clock = (sentinel_clock if sentinel_clock is not None
                 else (lambda: self._vclock))
        if self.role_policies is not None:
            self.sentinel = None
            self.sentinels = {
                role: HealthSentinel(rules=pol.build_rules(self, role=role),
                                     clock=clock)
                for role, pol in sorted(self.role_policies.items())}
            self._last_scale_by_role = {r: float("-inf")
                                        for r in self.role_policies}
        else:
            self.sentinel = HealthSentinel(
                rules=self.policy.build_rules(self), clock=clock)
            self.sentinels = {None: self.sentinel}
        self._last_scale_t = float("-inf")
        self.scale_events: list[dict] = []

    # -- the policy's fleet readings ---------------------------------------
    def _role_replicas(self, role=None):
        return [rep for rep in self._alive()
                if rep.routable and (role is None or rep.role == role)]

    def routable_replicas(self, role=None) -> int:
        return len(self._role_replicas(role))

    def queue_pressure(self, role=None) -> int:
        """Fleet-wide queued work: the fleet queue plus every routable
        replica's engine-side admission queue (work that has a home but
        no slot yet).  Role-scoped readings split it by who would absorb
        the work: fresh admissions always prefill, so the fleet queue is
        PREFILL pressure; exported-but-unplaced KV packets are DECODE
        pressure."""
        n = 0
        if role is None or role in ("prefill", "any"):
            n += len(self._waiting)
        if role is None or role in ("decode", "any"):
            n += len(self._pending_handoffs)
        for rep in self._role_replicas(role):
            n += len(rep.engine._queue)
        return n

    def load_per_replica(self, role=None) -> float | None:
        """Mean (active + queued) requests per routable replica — the
        idle detector's reading."""
        routable = self._role_replicas(role)
        if not routable:
            return None
        load = sum(rep.load() for rep in routable)
        if role is None or role in ("prefill", "any"):
            load += len(self._waiting)
        if role is None or role in ("decode", "any"):
            load += len(self._pending_handoffs)
        return load / len(routable)

    # -- the loop ----------------------------------------------------------
    def _dt_per_round(self) -> float:
        if self.role_policies is not None:
            return next(iter(self.role_policies.values())).dt_per_round
        return self.policy.dt_per_round

    def step(self) -> bool:
        progressed = super().step()
        self._vclock = self._round * self._dt_per_round()
        self._autoscale()
        return progressed

    def _sentinel_now(self) -> float:
        return float(self._sentinel_clock()
                     if self._sentinel_clock is not None else self._vclock)

    def _autoscale(self):
        now = self._sentinel_now()
        if self.role_policies is None:
            self.sentinel.evaluate(telemetry=None, now=now)
            decision = self.policy.decide(self.sentinel, self, now,
                                          self._last_scale_t)
            self._act(decision, now, role=None, policy=self.policy,
                      sentinel=self.sentinel)
            return
        # disaggregated: each role runs its own sentinel + cooldown —
        # deterministic role order so a seeded trace replays identically
        for role in sorted(self.role_policies):
            pol = self.role_policies[role]
            sen = self.sentinels[role]
            sen.evaluate(telemetry=None, now=now)
            decision = pol.decide(sen, self, now,
                                  self._last_scale_by_role[role],
                                  role=role)
            self._act(decision, now, role=role, policy=pol, sentinel=sen)

    def _act(self, decision: AutoscaleDecision, now: float, *, role,
             policy: AutoscalePolicy, sentinel: HealthSentinel):
        if decision is AutoscaleDecision.GROW:
            name = self.add_replica(role if role is not None else "any")
            self._record_scale("scale_up", name, now, role=role,
                               sentinel=sentinel)
        elif decision is AutoscaleDecision.SHRINK:
            # drain the idlest routable replica OF THIS ROLE (fewest
            # active+queued; deterministic name tie-break) — never below
            # the role policy's min_replicas, and retire_replica itself
            # refuses the last live one
            routable = self._role_replicas(role)
            if not routable:
                return
            victim = min(routable,
                         key=lambda rep: (rep.load(), rep.name))
            if self.retire_replica(victim.name):
                self._record_scale("scale_down", victim.name, now,
                                   role=role, sentinel=sentinel)

    def _record_scale(self, action: str, replica: str, now: float, *,
                      role=None, sentinel: HealthSentinel):
        self._last_scale_t = now
        if role is not None:
            # keyed by role (prefill/decode): bounded
          
            self._last_scale_by_role[role] = now
        ev = {
            "action": action, "replica": replica, "round": self._round,
            "t": round(now, 4),
            "replicas_alive": len(self._alive()),
            "active_alerts": sorted(a.rule for a in sentinel.active()),
        }
        if role is not None:
            ev["role"] = role
        # the drill's scale-event audit log: one entry per scale
        # decision, read whole by the drills
        self.scale_events.append(ev)

    # -- readouts ----------------------------------------------------------
    def stats(self) -> dict:
        out = super().stats()
        if self.role_policies is not None:
            out["autoscale"] = {
                "scale_events": len(self.scale_events),
                "peak_replicas": max(
                    [e["replicas_alive"] for e in self.scale_events],
                    default=len(self._alive())),
                "per_role": {
                    role: {
                        "min_replicas": pol.min_replicas,
                        "max_replicas": pol.max_replicas,
                        "routable": self.routable_replicas(role),
                        "scale_events": sum(
                            1 for e in self.scale_events
                            if e.get("role") == role),
                        "rule_fires": {
                            rule.name:
                                self.sentinels[role]._states[rule.name].fires
                            for rule in self.sentinels[role].rules},
                    } for role, pol in sorted(self.role_policies.items())},
            }
            return out
        out["autoscale"] = {
            "min_replicas": self.policy.min_replicas,
            "max_replicas": self.policy.max_replicas,
            "scale_events": len(self.scale_events),
            "peak_replicas": max(
                [e["replicas_alive"] for e in self.scale_events],
                default=len(self._alive())),
            "rule_fires": {rule.name: self.sentinel._states[rule.name].fires
                           for rule in self.sentinel.rules},
        }
        return out
