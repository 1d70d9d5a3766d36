"""Windowed health sentinel: typed alert rules with hysteresis + cooldown.

The measurement plane (metrics, traces, the flight recorder) records
everything and interprets nothing: there is no component that watches
the registry series and says "queue depth has been growing for thirty
seconds" or "the TTFT error budget is burning 4x too fast".  This module is that component —
deliberately boring, deterministic machinery:

  * :class:`AlertRule` — a named detector over a scalar reading
    (``sample_fn(ctx)``), with a breach threshold + direction, a
    persistence window (``fire_frac`` of the in-window readings must
    breach before firing — one spiky sample is not an incident), a CLEAR
    threshold for hysteresis (the whole window must sit back under it
    before the alert clears), and a post-clear ``cooldown_s`` before the
    rule may re-fire.  Derived rules reshape the reading:
    :class:`TrendRule` (windowed growth: newest - oldest),
    :class:`DeltaRule` (windowed delta of a cumulative counter, self-
    arming on the first zero delta so warm-up activity never pages),
    :class:`RatioDeltaRule` (windowed Δnum/Δden over two cumulative
    counters), :class:`BurnRateRule` (fast/slow dual-window SLO burn over
    the request summaries, via the shared
    :func:`~paddle_tpu_torch.observability.slo.windowed_burn` math).
  * :class:`HealthSentinel` — evaluates the rules at engine-step ends
    (it rides the existing ``Telemetry.step_done`` -> ``sample_memory``
    hook: telemetry-off engines never construct it, no device work, zero
    per-token work).  Every timestamp comes from the injected telemetry
    clock, so seeded traffic scenarios drive the detectors
    deterministically (tests/test_torch_health_export.py).
    Fired/cleared alerts land in the flight recorder stamped with the
    active fault-plan context, fires auto-dump the ring (the postmortem
    shows the ramp that tripped the rule), and the live exporter serves ``report()`` at ``/alerts``
    with ``/healthz`` turning degraded-aware.

Default rule set (:func:`default_rules`): sustained queue growth,
pool-occupancy pressure, prefix-hit-rate collapse, TTFT SLO burn rate
(fast/slow dual window), ``frontend.ttft_pred_err_s`` drift, and
steady-state recompile events (on a card, an ``engine.compiles`` tick is a
CUDA-graph capture of a new dispatch variant).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from .slo import windowed_burn

__all__ = ["Alert", "AlertRule", "TrendRule", "DeltaRule", "RatioDeltaRule",
           "BurnRateRule", "HealthSentinel", "default_rules",
           "autoscale_rules", "aggregate_alerts"]


@dataclass
class Alert:
    """One fired detector: the typed record the flight recorder, the
    ``/alerts`` endpoint, and the artifact sections all carry."""
    rule: str
    severity: str
    value: float
    threshold: float
    fired_at: float
    state: str = "firing"              # firing | cleared
    cleared_at: float | None = None
    context: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "severity": self.severity,
            "state": self.state, "value": round(self.value, 6),
            "threshold": self.threshold,
            "fired_at": round(self.fired_at, 6),
            "cleared_at": None if self.cleared_at is None
            else round(self.cleared_at, 6),
            "context": dict(self.context),
        }


class AlertRule:
    """A windowed threshold detector with hysteresis and cooldown.

    ``sample_fn(ctx)`` returns the instantaneous reading (None = nothing
    to observe this round; the window keeps its old samples).  ``ctx`` is
    the evaluating :class:`HealthSentinel` (``ctx.telemetry``,
    ``ctx.registries``, ``ctx.now``).

    Firing: over the readings inside ``window_s``, at least
    ``min_samples`` present and ``fire_frac`` of them breaching (reading
    ``>= threshold`` for ``direction="above"``, ``<=`` for ``"below"``),
    and the rule not inside its post-clear cooldown.  Clearing: every
    in-window reading back on the OK side of ``clear_threshold`` (default
    = ``threshold``; set it wider for hysteresis).  ``arm_above`` /
    ``arm_below`` keep the rule dormant until a reading has crossed that
    bound once — a hit-rate-collapse rule must not page an engine whose
    cache never warmed up in the first place."""

    def __init__(self, name: str, *, threshold: float,
                 sample_fn=None, severity: str = "warn",
                 direction: str = "above", clear_threshold: float | None = None,
                 window_s: float = 10.0, min_samples: int = 3,
                 fire_frac: float = 1.0, cooldown_s: float = 30.0,
                 arm_above: float | None = None,
                 arm_below: float | None = None,
                 description: str = ""):
        if direction not in ("above", "below"):
            raise ValueError(f"direction must be above|below, "
                             f"not {direction!r}")
        self.name = name
        self.threshold = float(threshold)
        self.sample_fn = sample_fn
        self.severity = severity
        self.direction = direction
        self.clear_threshold = self.threshold if clear_threshold is None \
            else float(clear_threshold)
        self.window_s = float(window_s)
        self.min_samples = int(min_samples)
        self.fire_frac = float(fire_frac)
        self.cooldown_s = float(cooldown_s)
        self.arm_above = arm_above
        self.arm_below = arm_below
        self.description = description

    # -- the reading -------------------------------------------------------
    def sample(self, ctx) -> float | None:
        return self.sample_fn(ctx) if self.sample_fn is not None else None

    def reset(self):
        """Window boundary: derived rules drop their internal baselines
        (the base rule keeps no state outside the sentinel)."""

    # -- predicates --------------------------------------------------------
    def breach(self, v: float) -> bool:
        return v >= self.threshold if self.direction == "above" \
            else v <= self.threshold

    def clear_ok(self, v: float) -> bool:
        return v < self.clear_threshold if self.direction == "above" \
            else v > self.clear_threshold

    def describe(self) -> dict:
        return {
            "threshold": self.threshold,
            "clear_threshold": self.clear_threshold,
            "direction": self.direction,
            "window_s": self.window_s,
            "min_samples": self.min_samples,
            "fire_frac": self.fire_frac,
            "cooldown_s": self.cooldown_s,
            "severity": self.severity,
            "description": self.description,
        }


class TrendRule(AlertRule):
    """Windowed GROWTH detector: the reading is ``newest - oldest`` over
    the raw samples inside ``window_s`` (None until two raw samples).
    ``min_value`` additionally requires the newest raw value itself to be
    at least that high — a queue "growing" 0 -> 3 is not pressure."""

    def __init__(self, name: str, *, raw_fn, min_value: float = 0.0,
                 **kw):
        super().__init__(name, **kw)
        self.raw_fn = raw_fn
        self.min_value = float(min_value)
        self._raw: deque = deque()

    def reset(self):
        self._raw.clear()

    def sample(self, ctx) -> float | None:
        v = self.raw_fn(ctx)
        if v is None:
            return None
        now = ctx.now
        self._raw.append((now, float(v)))
        while self._raw and self._raw[0][0] < now - self.window_s:
            self._raw.popleft()
        if len(self._raw) < 2:
            return None
        growth = self._raw[-1][1] - self._raw[0][1]
        if self._raw[-1][1] < self.min_value:
            # below the floor: report a non-breaching reading so the
            # window drains toward clear instead of holding stale growth
            return min(growth, 0.0) if self.direction == "above" \
                else max(growth, 0.0)
        return growth


class DeltaRule(AlertRule):
    """Windowed delta of a cumulative counter (``counter_fn(ctx)``), SELF-
    ARMING: readings are withheld (None) until one evaluation observes a
    ZERO delta — i.e. the counter went quiet once.  Warm-up activity
    (graph captures, first-touch growth) therefore never fires; a fresh
    delta AFTER the quiet point is exactly the steady-state event the rule
    exists for (a capture in steady state is a silent p99 killer)."""

    def __init__(self, name: str, *, counter_fn, **kw):
        kw.setdefault("min_samples", 1)
        super().__init__(name, **kw)
        self.counter_fn = counter_fn
        self._last: float | None = None
        self._armed = False

    def reset(self):
        self._last = None
        self._armed = False

    def sample(self, ctx) -> float | None:
        v = self.counter_fn(ctx)
        if v is None:
            return None
        v = float(v)
        if self._last is None:
            self._last = v
            return None
        delta, self._last = v - self._last, v
        if not self._armed:
            if delta == 0.0:
                self._armed = True
            return None
        return delta


class RatioDeltaRule(AlertRule):
    """Windowed ratio of two cumulative counters: Δnum / Δden over the
    samples inside ``window_s`` (None while Δden < ``min_den`` — a rate
    over nothing is noise, not a reading).  The hit-rate-collapse and
    prediction-error-drift rules are both this shape."""

    def __init__(self, name: str, *, num_fn, den_fn, min_den: float = 1.0,
                 **kw):
        super().__init__(name, **kw)
        self.num_fn = num_fn
        self.den_fn = den_fn
        self.min_den = float(min_den)
        self._ring: deque = deque()

    def reset(self):
        self._ring.clear()

    def sample(self, ctx) -> float | None:
        num = self.num_fn(ctx)
        den = self.den_fn(ctx)
        if num is None or den is None:
            return None
        now = ctx.now
        self._ring.append((now, float(num), float(den)))
        while self._ring and self._ring[0][0] < now - self.window_s:
            self._ring.popleft()
        if len(self._ring) < 2:
            return None
        d_num = self._ring[-1][1] - self._ring[0][1]
        d_den = self._ring[-1][2] - self._ring[0][2]
        if d_den < self.min_den:
            return None
        return d_num / d_den


class BurnRateRule(AlertRule):
    """TTFT SLO burn rate, fast/slow DUAL window (the SRE pattern: the
    fast window catches a cliff quickly, the slow window keeps a brief
    blip from paging — fire only when BOTH burn above the threshold, so
    the reading is ``min(fast_burn, slow_burn)``).  Burn math is the
    shared :func:`~paddle_tpu_torch.observability.slo.windowed_burn` over
    ``Telemetry.request_summaries`` (each stamped ``at`` retirement
    time); no duplicated goodput arithmetic."""

    def __init__(self, name: str, *, slo_ttft_s: float,
                 slo_target: float = 0.95, fast_window_s: float = 5.0,
                 slow_window_s: float = 30.0, min_requests: int = 4,
                 **kw):
        kw.setdefault("threshold", 1.0)
        kw.setdefault("window_s", fast_window_s)
        super().__init__(name, **kw)
        self.slo_ttft_s = float(slo_ttft_s)
        self.slo_target = float(slo_target)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.min_requests = int(min_requests)

    def sample(self, ctx) -> float | None:
        tel = ctx.telemetry
        if tel is None:
            return None
        summaries = tel.request_summaries
        fast = windowed_burn(summaries, self.slo_ttft_s,
                             slo_target=self.slo_target,
                             window_s=self.fast_window_s, now=ctx.now)
        slow = windowed_burn(summaries, self.slo_ttft_s,
                             slo_target=self.slo_target,
                             window_s=self.slow_window_s, now=ctx.now)
        if fast["requests"] < self.min_requests \
                or slow["requests"] < self.min_requests:
            return None
        return min(fast["burn_rate"], slow["burn_rate"])

    def describe(self) -> dict:
        d = super().describe()
        d.update(slo_ttft_s=self.slo_ttft_s, slo_target=self.slo_target,
                 fast_window_s=self.fast_window_s,
                 slow_window_s=self.slow_window_s,
                 min_requests=self.min_requests)
        return d


# ---------------------------------------------------------------------------
# default rule set
# ---------------------------------------------------------------------------
def _mem_last(ctx, field_name):
    tel = ctx.telemetry
    if tel is None:
        return None
    row = tel.memory.last
    return None if row is None else row.get(field_name)


def _frontend_hist(ctx, name):
    reg = ctx.registries.get("frontend")
    if reg is None or name not in reg:
        return None
    return reg.histogram(name)


def default_rules(*, slo_ttft_s: float | None = None,
                  slo_target: float = 0.95,
                  queue_growth: float = 8.0, queue_min_depth: float = 4.0,
                  queue_window_s: float = 5.0,
                  occupancy_threshold: float = 0.92,
                  occupancy_clear: float = 0.85,
                  occupancy_window_s: float = 5.0,
                  hit_rate_floor: float = 0.15, hit_rate_arm: float = 0.35,
                  hit_rate_window_s: float = 10.0,
                  pred_err_s: float | None = None,
                  burn_threshold: float = 1.0,
                  fast_window_s: float = 5.0, slow_window_s: float = 30.0,
                  cooldown_s: float = 30.0) -> list:
    """The stock sentinel: sustained queue growth, pool-occupancy
    pressure, prefix-hit-rate collapse, TTFT burn rate (only when a
    deadline is supplied), prediction-error drift (only when a bound is
    supplied — it needs the frontend registry attached), and steady-state
    recompiles.  Every threshold is a keyword so tests and deployments
    tune without subclassing."""
    rules: list = [
        TrendRule(
            "queue_growth",
            raw_fn=lambda ctx: _mem_last(ctx, "queue_depth"),
            threshold=queue_growth, min_value=queue_min_depth,
            window_s=queue_window_s, min_samples=3, fire_frac=0.6,
            clear_threshold=0.0, cooldown_s=cooldown_s,
            description="admission queue grew by >= threshold over the "
                        "window and is above the min depth — the "
                        "autoscaler trigger"),
        AlertRule(
            "pool_pressure",
            sample_fn=lambda ctx: _mem_last(ctx, "occupancy_frac"),
            threshold=occupancy_threshold, clear_threshold=occupancy_clear,
            window_s=occupancy_window_s, min_samples=3, fire_frac=1.0,
            cooldown_s=cooldown_s,
            description="PagePool occupancy sustained above threshold — "
                        "the degradation ladder (evict/preempt) is near"),
        RatioDeltaRule(
            "prefix_hit_collapse",
            num_fn=lambda ctx: _mem_last(ctx, "cache_hit_tokens"),
            den_fn=lambda ctx: (
                None if _mem_last(ctx, "cache_hit_tokens") is None
                or _mem_last(ctx, "prefill_tokens_executed") is None
                else _mem_last(ctx, "cache_hit_tokens")
                + _mem_last(ctx, "prefill_tokens_executed")),
            min_den=32.0, threshold=hit_rate_floor, direction="below",
            arm_above=hit_rate_arm, window_s=hit_rate_window_s,
            min_samples=3, fire_frac=1.0, cooldown_s=cooldown_s,
            description="windowed prefix-cache hit rate collapsed below "
                        "the floor after having been warm — routing or "
                        "eviction regression"),
        DeltaRule(
            "recompile",
            counter_fn=lambda ctx: None if ctx.telemetry is None
            else ctx.telemetry._c_compiles.value,
            threshold=1.0, window_s=fast_window_s, fire_frac=0.01,
            min_samples=1, cooldown_s=cooldown_s,
            description="steady-state dispatch capture (a new CUDA-graph "
                        "variant; self-armed after the first quiet "
                        "evaluation) — capture creep is a silent p99 "
                        "killer"),
    ]
    if slo_ttft_s is not None:
        rules.append(BurnRateRule(
            "ttft_slo_burn", slo_ttft_s=slo_ttft_s, slo_target=slo_target,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            threshold=burn_threshold, min_samples=2, fire_frac=1.0,
            cooldown_s=cooldown_s, severity="page",
            description="TTFT error budget burning faster than allotted "
                        "over BOTH the fast and slow windows"))
    if pred_err_s is not None:
        rules.append(RatioDeltaRule(
            "ttft_pred_err_drift",
            num_fn=lambda ctx: (
                None if _frontend_hist(ctx, "frontend.ttft_pred_err_s")
                is None
                else _frontend_hist(ctx, "frontend.ttft_pred_err_s").total),
            den_fn=lambda ctx: (
                None if _frontend_hist(ctx, "frontend.ttft_pred_err_s")
                is None
                else float(_frontend_hist(
                    ctx, "frontend.ttft_pred_err_s").count)),
            min_den=4.0, threshold=pred_err_s,
            window_s=slow_window_s, min_samples=2, fire_frac=1.0,
            cooldown_s=cooldown_s,
            description="windowed mean admission-prediction error drifted "
                        "above the bound — the controller's model of the "
                        "engine has rotted"))
    return rules


def autoscale_rules(*, depth_fn, load_fn,
                    queue_growth: float = 4.0,
                    queue_min_depth: float = 3.0,
                    growth_window_s: float = 6.0,
                    growth_fire_frac: float = 0.5,
                    idle_per_replica: float = 0.5,
                    idle_window_s: float = 10.0,
                    min_samples: int = 3,
                    cooldown_s: float = 0.0) -> list:
    """The elastic-fleet autoscaler's rule pair: the
    same :func:`default_rules` ``queue_growth`` TrendRule shape — here
    over the FLEET-wide queue pressure ``depth_fn(ctx)`` — as the
    scale-UP trigger, plus ``fleet_idle`` (windowed per-routable-replica
    load ``load_fn(ctx)`` sustained below ``idle_per_replica``) as the
    scale-DOWN trigger.  Both run inside an ordinary
    :class:`HealthSentinel` under its injectable clock, so seeded
    traffic drives scaling decisions deterministically
    (serving/autoscale.py wires a round-based virtual clock by
    default)."""
    return [
        TrendRule(
            "queue_growth",
            raw_fn=depth_fn,
            threshold=queue_growth, min_value=queue_min_depth,
            window_s=growth_window_s, min_samples=min_samples,
            fire_frac=growth_fire_frac,
            # clear once the whole window stops growing (readings < 1) —
            # a drained-flat queue reads growth 0.0, which must clear the
            # alert, not hold it active into the next trough
            clear_threshold=1.0,
            cooldown_s=cooldown_s,
            description="fleet-wide admission-queue pressure grew by >= "
                        "threshold over the window and sits above the "
                        "min depth — the elastic scale-up trigger"),
        AlertRule(
            "fleet_idle",
            sample_fn=load_fn,
            threshold=idle_per_replica, direction="below",
            window_s=idle_window_s, min_samples=min_samples,
            fire_frac=1.0, cooldown_s=cooldown_s,
            description="per-routable-replica load sustained below the "
                        "idle floor for the whole window — the elastic "
                        "scale-down (drain) trigger"),
    ]


# ---------------------------------------------------------------------------
# the sentinel
# ---------------------------------------------------------------------------
class _RuleState:
    __slots__ = ("readings", "active", "last_cleared_at", "fires", "armed")

    def __init__(self):
        self.readings: deque = deque()      # (t, value)
        self.active: Alert | None = None
        self.last_cleared_at = -float("inf")
        self.fires = 0
        self.armed = False                  # arm_above/arm_below crossed


class HealthSentinel:
    """Evaluate a rule set over live telemetry at engine-step ends.

    Wire-up: ``Telemetry(sentinel=HealthSentinel(...))`` (or
    ``telemetry.attach_sentinel(sent)``) — ``Telemetry.step_done`` calls
    :meth:`on_step` right after the memory-observatory sample, so the
    sentinel sees each fresh series row with zero additional hooks.
    ``every_steps`` throttles evaluation; the clock is adopted from the
    telemetry (one injected fake clock drives sampling, windowing,
    cooldowns, and every Alert timestamp).

    ``rule_kw`` (anything :func:`default_rules` accepts, e.g.
    ``slo_ttft_s=0.5``) builds the stock rule set when ``rules`` is not
    given."""

    def __init__(self, rules=None, *, clock=None, every_steps: int = 1,
                 history: int = 64, **rule_kw):
        self.rules = list(rules) if rules is not None \
            else default_rules(**rule_kw)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.clock = clock or time.perf_counter
        self.every_steps = max(1, int(every_steps))
        self._states = {r.name: _RuleState() for r in self.rules}
        self.history: deque = deque(maxlen=int(history))
        self.fired_total = 0
        self.evaluations = 0
        self._step_count = 0
        # evaluation context (rules read these)
        self.telemetry = None
        self.registries: dict = {}
        self.now = 0.0

    # -- wiring ------------------------------------------------------------
    def attach(self, telemetry) -> "HealthSentinel":
        """Adopt the telemetry's clock (one clock domain) and make it the
        default evaluation subject."""
        self.telemetry = telemetry
        self.clock = telemetry.clock
        return self

    def attach_registry(self, label: str, registry):
        """Expose an extra registry (e.g. the frontend admission
        controller's) to rules that read it."""
        self.registries[label] = registry

    def add_rule(self, rule: AlertRule) -> "HealthSentinel":
        """Add a rule after construction (e.g. a BurnRateRule once the
        deployment's SLO deadline has been calibrated)."""
        if rule.name in self._states:
            raise ValueError(f"rule {rule.name!r} already registered")
        self.rules.append(rule)
        self._states[rule.name] = _RuleState()
        return self

    def reset(self):
        """Measurement-window boundary (``Telemetry.reset_window`` calls
        this): drop readings and derived-rule baselines, force-clear any
        active alert WITHOUT a cleared event (the window that fired it is
        gone), keep the lifetime fire counters and history."""
        for r in self.rules:
            r.reset()
        for st in self._states.values():
            st.readings.clear()
            if st.active is not None:
                st.active.state = "cleared"
                st.active = None
            st.last_cleared_at = -float("inf")
            st.armed = False

    # -- evaluation --------------------------------------------------------
    def on_step(self, telemetry):
        """The step-end hook (rides sample_memory): throttled by
        ``every_steps``."""
        self._step_count += 1
        if self._step_count % self.every_steps == 0:
            self.evaluate(telemetry)

    def evaluate(self, telemetry=None, now: float | None = None) -> list:
        """One evaluation round over every rule; returns newly FIRED
        alerts.  Deterministic: same clock + same readings -> same fires."""
        tel = telemetry if telemetry is not None else self.telemetry
        self.telemetry = tel
        self.now = float(self.clock() if now is None else now)
        self.evaluations += 1
        fired: list[Alert] = []
        for rule in self.rules:
            st = self._states[rule.name]
            v = rule.sample(self)
            if v is not None:
                v = float(v)
                if rule.arm_above is not None or rule.arm_below is not None:
                    if not st.armed:
                        if (rule.arm_above is not None
                                and v >= rule.arm_above) or \
                                (rule.arm_below is not None
                                 and v <= rule.arm_below):
                            st.armed = True
                        else:
                            v = None
                if v is not None:
                    st.readings.append((self.now, v))
            while st.readings and st.readings[0][0] < self.now - rule.window_s:
                st.readings.popleft()
            n = len(st.readings)
            if st.active is None:
                if n < rule.min_samples:
                    continue
                breaches = sum(1 for _t, x in st.readings if rule.breach(x))
                if breaches / n >= rule.fire_frac \
                        and breaches >= 1 \
                        and self.now >= st.last_cleared_at + rule.cooldown_s:
                    last = st.readings[-1][1]
                    alert = Alert(rule=rule.name, severity=rule.severity,
                                  value=last, threshold=rule.threshold,
                                  fired_at=self.now,
                                  context={"window_samples": n,
                                           "breaches": breaches})
                    st.active = alert
                    st.fires += 1
                    self.fired_total += 1
                    self.history.append(alert)
                    fired.append(alert)
                    self._record_fire(alert)
            else:
                # hysteresis: the WHOLE window must read OK vs the clear
                # threshold (and be populated) before the alert clears
                if n >= rule.min_samples and \
                        all(rule.clear_ok(x) for _t, x in st.readings):
                    st.active.state = "cleared"
                    st.active.cleared_at = self.now
                    st.last_cleared_at = self.now
                    self._record_clear(st.active)
                    st.active = None
                else:
                    st.active.value = st.readings[-1][1] if n \
                        else st.active.value
        return fired

    def _record_fire(self, alert: Alert):
        tel = self.telemetry
        if tel is None:
            return
        hook = getattr(tel, "alert_fired", None)
        if hook is not None:
            hook(alert)

    def _record_clear(self, alert: Alert):
        tel = self.telemetry
        if tel is None:
            return
        hook = getattr(tel, "alert_cleared", None)
        if hook is not None:
            hook(alert)

    # -- readouts ----------------------------------------------------------
    def active(self) -> list:
        return [st.active for st in self._states.values()
                if st.active is not None]

    @property
    def degraded(self) -> bool:
        return bool(self.active())

    def health(self) -> dict:
        """The degraded-aware ``/healthz`` contribution: status flips to
        ``degraded`` while any alert is active (HTTP 200 either way —
        scrapers must not flap on a warning)."""
        act = self.active()
        return {
            "status": "degraded" if act else "ok",
            "active_alerts": len(act),
            "alerts": sorted(a.rule for a in act),
        }

    def report(self) -> dict:
        """The ``/alerts`` endpoint body and the drills' report section:
        live status + per-rule fire counts + active/history records +
        rule catalog."""
        act = self.active()
        return {
            "status": "degraded" if act else "ok",
            "active_alerts": len(act),
            "fired_total": self.fired_total,
            "evaluations": self.evaluations,
            "active": [a.to_dict() for a in act],
            "history": [a.to_dict() for a in self.history],
            "rules": {r.name: dict(r.describe(),
                                   fires=self._states[r.name].fires)
                      for r in self.rules},
        }


def aggregate_alerts(sentinels) -> dict:
    """Fleet-level alert view: ``sentinels`` is ``{label: HealthSentinel}``
    (or an iterable of pairs).  Worst status wins; fire counts sum; the
    per-component reports ride side by side — the shape both the
    ``/alerts`` endpoint and the ``alerts`` artifact sections use."""
    items = sentinels.items() if hasattr(sentinels, "items") else sentinels
    components = {}
    active = 0
    fired = 0
    for label, s in items:
        rep = s.report()
        components[str(label)] = rep
        active += rep["active_alerts"]
        fired += rep["fired_total"]
    return {
        "status": "degraded" if active else "ok",
        "active_alerts": active,
        "fired_total": fired,
        "components": components,
    }
