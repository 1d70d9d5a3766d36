"""Metrics registry: counters, gauges, log-bucketed histograms.

The serving engine's counters are a flat dict of int attributes
(``ServingEngine.stats()``); this module is the one shared implementation of
the metrics built over them and over the engine's telemetry hooks:

  * :class:`Counter` / :class:`Gauge` — monotonic count / last-value.
  * :class:`Histogram` — log-bucketed latency histogram with
    p50/p95/p99 quantile readout.  Buckets grow geometrically
    (``growth`` per bucket, default 1.1 → ≤ ~5% relative bucket error,
    tightened further by linear interpolation inside the bucket and exact
    min/max clamping), stored sparsely, so observe() is one dict bump —
    cheap enough for per-request serving paths, never per-token.
  * :class:`MetricsRegistry` — named metric directory with
    ``snapshot()``/``delta`` semantics and an injectable ``clock`` so
    tests are deterministic.
  * :class:`EngineStats` — an immutable, flattened snapshot of
    ``ServingEngine.stats()``; ``delta(earlier)`` yields exactly the
    per-window activity (the counters are monotonic, so a delta is always
    non-negative — tests/test_torch_observability.py pins both
    properties).
"""
from __future__ import annotations

import math
import numbers
import threading
import time
from collections import deque
from collections.abc import Mapping

__all__ = ["Counter", "Gauge", "GaugeSeries", "Histogram", "MetricsRegistry",
           "EngineStats"]


class Counter:
    """Monotonically increasing counter (dashboards diff it; a decrement is
    a bug and raises)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1):
        if n < 0:
            raise ValueError(f"Counter {self.name!r} cannot decrease (n={n})")
        self.value += n

    def to_value(self):
        return self.value


class Gauge:
    """Last-written value (queue depth, free pages, acceptance rate...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def to_value(self):
        return self.value


class GaugeSeries:
    """Bounded time series of gauge rows — the memory observatory appends
    one row per engine step, so the flight recorder can show the
    occupancy RAMP that led to a pool-pressure event, not just the final
    value.  Each row is ``{"seq", "t", **fields}`` with ``seq`` strictly
    increasing (sample order) and ``t`` from the caller's clock; the ring
    holds the last ``capacity`` rows.  Values are normalized to plain
    python ints/floats so rows serialize straight into flight-dump JSON."""

    __slots__ = ("name", "capacity", "_rows", "_seq")

    def __init__(self, name: str, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.name = name
        self.capacity = int(capacity)
        self._rows: deque = deque(maxlen=self.capacity)
        self._seq = 0

    def __len__(self):
        return len(self._rows)

    @property
    def total_samples(self) -> int:
        """Samples ever taken (>= len(self): the ring drops the oldest)."""
        return self._seq

    def sample(self, t: float, **fields) -> dict:
        """Append one row; returns it (already normalized)."""
        self._seq += 1
        row = {"seq": self._seq, "t": float(t)}
        for k, v in fields.items():
            # exact-type fast path first: this runs at every engine-step
            # end with ~20 plain int/float fields, and the numbers.*
            # ABC isinstance checks dominate the whole sampler's cost
            # (bool subclasses int, so `type(v) is int` stays False for it)
            tv = type(v)
            if tv is int or tv is float or tv is bool or v is None:
                row[k] = v
            elif isinstance(v, numbers.Integral):
                row[k] = int(v)
            elif isinstance(v, numbers.Real):
                row[k] = float(v)
            else:
                row[k] = v
        self._rows.append(row)
        return row

    def rows(self) -> list[dict]:
        return list(self._rows)

    def tail(self, n: int) -> list[dict]:
        """The most recent n rows (the ramp a flight dump embeds)."""
        if n <= 0:
            return []
        return list(self._rows)[-n:]

    @property
    def last(self) -> dict | None:
        return self._rows[-1] if self._rows else None

    def reset(self):
        """Drop the rows (a measurement-window boundary); ``seq`` keeps
        counting so sample order stays globally monotonic across windows."""
        self._rows.clear()

    def field_minmax(self, field: str) -> tuple[float, float] | None:
        """(min, max) of a numeric field over the retained rows."""
        vals = [r[field] for r in self._rows
                if isinstance(r.get(field), (int, float))
                and not isinstance(r.get(field), bool)]
        if not vals:
            return None
        return min(vals), max(vals)

    def to_value(self) -> dict:
        return {"count": len(self._rows), "total_samples": self._seq,
                "last": self.last}


class Histogram:
    """Log-bucketed histogram with quantile readout.

    Bucket 0 holds values ``<= lo``; bucket k (k >= 1) holds
    ``(lo * growth**(k-1), lo * growth**k]``.  Quantiles interpolate
    linearly inside the winning bucket and clamp to the exact observed
    [min, max], so small-sample readouts stay sane (a 1-sample histogram
    reports that sample for every quantile)."""

    __slots__ = ("name", "unit", "lo", "growth", "_log_g", "count", "total",
                 "min", "max", "_buckets")

    def __init__(self, name: str, unit: str = "s", lo: float = 1e-6,
                 growth: float = 1.1):
        if lo <= 0 or growth <= 1.0:
            raise ValueError("lo must be > 0 and growth > 1.0")
        self.name = name
        self.unit = unit
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: dict[int, int] = {}

    def reset(self):
        """Drop every observation (a measurement-window boundary — e.g.
        `Telemetry.reset_window()` between a bench's warm pass and its
        timed pass, so quantiles describe the window, not the compiles)."""
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets.clear()

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.lo:
            idx = 0
        else:
            idx = max(1, math.ceil(math.log(v / self.lo) / self._log_g))
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def _bounds(self, idx: int) -> tuple[float, float]:
        if idx == 0:
            return 0.0, self.lo
        return self.lo * self.growth ** (idx - 1), self.lo * self.growth ** idx

    def quantile(self, q: float) -> float:
        """Value at quantile q in [0, 1] (0 when empty)."""
        if self.count == 0:
            return 0.0
        if q <= 0.0:
            return self.min
        target = min(self.count, q * self.count)
        cum = 0
        for idx in sorted(self._buckets):
            n = self._buckets[idx]
            if cum + n >= target:
                b_lo, b_hi = self._bounds(idx)
                frac = (target - cum) / n
                val = b_lo + frac * (b_hi - b_lo)
                return min(max(val, self.min), self.max)
            cum += n
        return self.max

    def percentiles(self, ps=(50, 95, 99)) -> dict:
        return {p: self.quantile(p / 100.0) for p in ps}

    def fraction_below(self, x) -> float:
        """Fraction of observations <= x (bucket-interpolated) — the
        goodput readout for 'how many requests met the deadline'."""
        if self.count == 0:
            return 0.0
        x = float(x)
        if x >= self.max:
            return 1.0
        if x < self.min:
            return 0.0
        cum = 0
        for idx in sorted(self._buckets):
            b_lo, b_hi = self._bounds(idx)
            n = self._buckets[idx]
            if x >= b_hi:
                cum += n
                continue
            if x > b_lo:
                cum += n * (x - b_lo) / (b_hi - b_lo)
            break
        return min(1.0, cum / self.count)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def same_layout(self, other: "Histogram") -> bool:
        return (self.lo, self.growth) == (other.lo, other.growth)

    def merge_from(self, other: "Histogram") -> "Histogram":
        """Fold another histogram's observations into this one.  Exact
        when both share the same (lo, growth) bucket layout — every
        observation lands in the identical bucket index either way, so a
        fleet-wide merge of N replica histograms is bucket-wise addition,
        not an approximation (the FleetTelemetry aggregation rail)."""
        if not self.same_layout(other):
            raise ValueError(
                f"histogram {self.name!r} (lo={self.lo}, "
                f"growth={self.growth}) cannot merge bucket-wise with "
                f"{other.name!r} (lo={other.lo}, growth={other.growth}) — "
                f"layouts differ")
        self.count += other.count
        self.total += other.total
        if other.count:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        for idx, n in list(other._buckets.items()):
            self._buckets[idx] = self._buckets.get(idx, 0) + n
        return self

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """Sparse cumulative bucket readout: ascending (upper_bound,
        cumulative_count) pairs over the non-empty buckets — the
        Prometheus ``_bucket{le=...}`` series (the exporter appends the
        ``+Inf`` row from ``count``, read AFTER the buckets so a
        concurrent observe can never make the series non-cumulative)."""
        items = sorted(list(self._buckets.items()))
        out = []
        cum = 0
        for idx, n in items:
            cum += n
            out.append((self._bounds(idx)[1], cum))
        return out

    def to_value(self) -> dict:
        p = self.percentiles()
        return {
            "count": self.count,
            "sum": round(self.total, 9),
            "mean": round(self.mean, 9),
            "min": round(self.min, 9) if self.count else 0.0,
            "max": round(self.max, 9) if self.count else 0.0,
            "p50": round(p[50], 9),
            "p95": round(p[95], 9),
            "p99": round(p[99], 9),
            "unit": self.unit,
        }


class MetricsRegistry:
    """Named metric directory.  ``clock`` is injectable (tests pass a fake
    counter and get deterministic timestamps everywhere downstream —
    Telemetry threads the same clock through tracing and the flight
    recorder)."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self._metrics: dict[str, object] = {}
        self._frozen = False

    def freeze(self):
        """Registry-freeze invariant: after warmup every hot-path metric
        must already exist, so any metric-created-at-first-use from a
        NON-main thread raises from here on.  Metric-at-first-use is a
        registry mutation; once writer threads (the frontend worker, an
        exporter scrape, an async checkpoint writer) are live, a lazy
        first-use from one of them races every concurrent reader — the
        generalization of the checkpoint-metric pre-registration.  Reads and
        observes of EXISTING metrics stay lock-free and legal from any
        thread; main-thread creation (tests, late wiring) stays allowed."""
        self._frozen = True

    @property
    def frozen(self) -> bool:
        return self._frozen

    def _get(self, name, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            if self._frozen and \
                    threading.current_thread() is not threading.main_thread():
                raise RuntimeError(
                    f"MetricsRegistry is frozen: metric {name!r} would be "
                    f"created at first use from non-main thread "
                    f"{threading.current_thread().name!r} — pre-register it "
                    f"before the writer threads start (registry-freeze "
                    f"invariant)")
            m = cls(name, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def series(self, name: str, **kw) -> GaugeSeries:
        return self._get(name, GaugeSeries, **kw)

    def names(self):
        return sorted(self._metrics)

    def __contains__(self, name):
        return name in self._metrics

    def snapshot(self) -> dict:
        """{metric name: value} — ints for counters, floats for gauges,
        a stats dict (count/sum/min/max/p50/p95/p99) for histograms; plus
        the snapshot clock under ``"at"``.  The items are copied before
        sorting so a metric registered concurrently (e.g. an async
        checkpoint writer's phase report) cannot tear the iteration."""
        out = {name: m.to_value()
               for name, m in sorted(list(self._metrics.items()))}
        out["at"] = float(self.clock())
        return out


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, prefix=f"{key}."))
        elif isinstance(v, (int, float, bool)):
            out[key] = v
    return out


class EngineStats(Mapping):
    """Immutable flattened snapshot of ``ServingEngine.stats()`` (nested
    dicts dotted: ``jit_cache_misses.prefill``).  ``delta(earlier)``
    returns per-window activity over the integer counters — ratios
    (``draft_accept_rate``) are snapshot-only and excluded from deltas."""

    __slots__ = ("_v", "at")

    def __init__(self, values: dict, at: float):
        self._v = dict(values)
        self.at = float(at)

    @classmethod
    def capture(cls, stats: dict, clock=time.perf_counter) -> "EngineStats":
        return cls(_flatten(stats), clock())

    # Mapping interface ----------------------------------------------------
    def __getitem__(self, k):
        return self._v[k]

    def __iter__(self):
        return iter(self._v)

    def __len__(self):
        return len(self._v)

    def counters(self) -> dict:
        """The integer (monotonic) subset."""
        return {k: v for k, v in self._v.items()
                if isinstance(v, int) and not isinstance(v, bool)}

    def delta(self, earlier: "EngineStats") -> dict:
        """Per-window activity: this snapshot's counters minus an earlier
        snapshot's (missing earlier keys count from 0 — e.g. a counter that
        first appears inside the window).  Includes
        ``window_s``, the clock span between the snapshots."""
        mine = self.counters()
        theirs = earlier.counters()
        out = {k: v - theirs.get(k, 0) for k, v in mine.items()}
        out["window_s"] = self.at - earlier.at
        return out

    def __repr__(self):
        return f"EngineStats(at={self.at:.6f}, {self._v!r})"
