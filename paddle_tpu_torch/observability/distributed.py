"""Fleet-wide observability: cross-component trace stitching + aggregated
metrics.

The engine telemetry is scoped to ONE engine: each
:class:`~paddle_tpu_torch.inference.paged.ServingEngine` owns a registry /
tracer / flight trio, the
:class:`~paddle_tpu_torch.serving.fleet.ReplicaFleet` router keeps its own
registry, and the :class:`AsyncFrontend` keeps a third.  A
request that crosses frontend -> router -> replica -> failover-migration
leaves three disjoint traces with no common ID.  This module closes both
gaps:

  * **Trace stitching** — one integer ``trace_id`` (``new_trace_id()``)
    threads from ``AsyncFrontend.submit()`` through router placement,
    replica admission (``submit``/``adopt``), snapshot restore, and
    failover re-decode; every component's tracer records it on the
    request's ``submitted`` event.  :class:`TraceStitcher` merges N
    component tracers into ONE Perfetto view: each component becomes a
    process (frontend / router / per-engine replica tracks, crashed
    replica generations kept as their own tracks), and Chrome flow events
    (``ph`` s/t/f, keyed by trace_id) draw arrows along each request's
    path — a failover reads as a single request timeline: frontend span
    -> replica r0 -> migration flow-event -> replica r1.
  * **Fleet aggregation** — :class:`FleetTelemetry` merges N replica
    registries plus the frontend/router registries into one labeled
    snapshot.  Histograms merge BUCKET-WISE (every registry uses the same
    log-bucket layout per metric name, so the merge is exact addition,
    not approximation — :meth:`~.metrics.Histogram.merge_from`); counters
    sum; gauges and memory series stay per-replica side-by-side.  The
    fleet-wide SLO report reads goodput straight off the merged TTFT
    histogram (``fraction_below`` at the deadline).  Powers
    ``ReplicaFleet.stats_snapshot()``.

Everything here is pure host code operating on snapshots — no device
work, zero device syncs, zero engine-thread work.
"""
from __future__ import annotations

import itertools
import json
import time

from .metrics import Counter, Gauge, GaugeSeries, Histogram, MetricsRegistry
from .tracing import Tracer

__all__ = ["new_trace_id", "TraceStitcher", "FleetTelemetry"]

# process-global monotonic trace-id mint: an int (Chrome flow-event ids
# bind on it), unique within the process — which is the stitching domain
# (in-process fleets share one clock AND one id space)
_TRACE_IDS = itertools.count(1)


def new_trace_id() -> int:
    """Mint a fleet-unique trace id (monotonic int)."""
    return next(_TRACE_IDS)


def _trace_id_of(tr) -> int | None:
    """The trace_id a RequestTrace carries (stamped on its ``submitted``
    event attrs by Telemetry/fleet/frontend), or None."""
    for _name, _t, attrs in tr.events:
        if attrs and "trace_id" in attrs:
            return attrs["trace_id"]
    return None


class TraceStitcher:
    """Merge per-component :class:`~.tracing.Tracer` records into one
    Perfetto/chrome-trace view with flow events binding each trace_id's
    spans across components.

    ``add(name, tracer)`` order decides process ids (pid 0 = first
    component — conventionally the frontend or router track).  Components
    may share request ids freely: tracks are (pid, tid) pairs, and the
    flow arrows bind on trace_id, not rid."""

    def __init__(self):
        self._components: list[tuple[str, Tracer]] = []

    def add(self, name: str, tracer: Tracer) -> "TraceStitcher":
        self._components.append((str(name), tracer))
        return self

    @property
    def component_names(self) -> list[str]:
        return [n for n, _ in self._components]

    def flow_chains(self) -> dict:
        """{trace_id: [(component name, t_first, t_last), ...]} ordered by
        each component's first touch — the per-request path across the
        fleet (the failover acceptance reads the crashed request's chain
        here: router -> r0 (crashed) -> r1)."""
        chains: dict = {}
        for name, tracer in self._components:
            for tr in tracer.traces():
                if not tr.events:
                    continue
                tid = _trace_id_of(tr)
                if tid is None:
                    continue
                chains.setdefault(tid, []).append(
                    (name, tr.events[0][1], tr.events[-1][1]))
        for touches in chains.values():
            touches.sort(key=lambda x: (x[1], x[2]))
        return chains

    def to_chrome_trace(self) -> dict:
        """One chrome://tracing / Perfetto-loadable dict: component i's
        events re-homed to pid i (its own named process), plus flow
        events (``ph`` s/t/f, id = trace_id) from each request's first
        touch on every component it crossed."""
        us = 1e6
        events: list[dict] = []
        # (pid, tid, t_first) per (component, trace_id) for the flows
        touches: dict = {}
        for pid, (name, tracer) in enumerate(self._components):
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": name}})
            for ev in tracer.to_chrome_trace()["traceEvents"]:
                if ev.get("ph") == "M" and ev.get("name") == "process_name":
                    continue        # replaced by the component name above
                ev = dict(ev)
                ev["pid"] = pid
                events.append(ev)
            for tr in tracer.traces():
                if not tr.events:
                    continue
                tid = _trace_id_of(tr)
                if tid is not None:
                    touches.setdefault(tid, []).append(
                        (tr.events[0][1], pid, tr.rid + 1))
        flow_events: list[dict] = []
        for tid, ts in sorted(touches.items()):
            if len(ts) < 2:
                continue            # a single-component request needs no arrow
            ts.sort()
            last = len(ts) - 1
            for i, (t0, pid, ttid) in enumerate(ts):
                ph = "s" if i == 0 else ("f" if i == last else "t")
                ev = {"name": "request", "cat": "request_flow", "ph": ph,
                      "id": int(tid), "pid": pid, "tid": ttid,
                      "ts": round(t0 * us, 3)}
                if ph == "f":
                    ev["bp"] = "e"  # bind to the enclosing slice's begin
                flow_events.append(ev)
        return {"traceEvents": events + flow_events,
                "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def summary(self) -> dict:
        """Artifact-embeddable digest: event/flow counts, component list,
        and the longest per-request chain (``max_chain``: a failed-over
        request reads router -> crashed replica -> survivor)."""
        trace = self.to_chrome_trace()["traceEvents"]
        flows = [e for e in trace if e.get("cat") == "request_flow"]
        chains = self.flow_chains()
        max_chain: list[str] = []
        for touched in chains.values():
            names = [name for name, _t0, _t1 in touched]
            if len(names) > len(max_chain):
                max_chain = names
        return {
            "components": self.component_names,
            "trace_events": len(trace),
            "flow_events": len(flows),
            "requests_stitched": sum(1 for t in chains.values()
                                     if len(t) >= 2),
            "max_chain": max_chain,
        }


# ---------------------------------------------------------------------------
# Fleet metric aggregation
# ---------------------------------------------------------------------------
def _registry_of(component) -> MetricsRegistry:
    """Accept a MetricsRegistry, a Telemetry, or a ServingEngine (with
    telemetry attached) — FleetTelemetry callers hold any of the three."""
    if isinstance(component, MetricsRegistry):
        return component
    reg = getattr(component, "registry", None)
    if isinstance(reg, MetricsRegistry):
        return reg
    tel = getattr(component, "telemetry", None)
    if tel is not None and isinstance(getattr(tel, "registry", None),
                                      MetricsRegistry):
        return tel.registry
    raise TypeError(
        f"FleetTelemetry needs a MetricsRegistry / Telemetry / telemetry-"
        f"bearing engine, not {type(component).__name__}")


class FleetTelemetry:
    """Merge N labeled registries (replicas + frontend/router) into one
    fleet snapshot.

    ``components``: ``{label: MetricsRegistry | Telemetry | engine}``.
    ``frontend``: optional extra registry merged under the ``frontend``
    label (the AsyncFrontend admission controller's).  Merging reads the
    live registries at snapshot time — pure host reads, no locks the
    writers could wait on."""

    def __init__(self, components: dict, frontend=None,
                 clock=time.perf_counter):
        self._components = {str(k): _registry_of(v)
                            for k, v in dict(components).items()}
        if frontend is not None:
            self._components.setdefault("frontend", _registry_of(frontend))
        self.clock = clock

    @classmethod
    def from_fleet(cls, fleet, frontend=None,
                   clock=time.perf_counter) -> "FleetTelemetry":
        """Aggregate a live
        :class:`~paddle_tpu_torch.serving.fleet.ReplicaFleet`: every live
        telemetry-bearing replica plus the fleet's own router registry
        (label ``router``)."""
        comps: dict = {}
        # drain-retired replicas (elastic scale-down) keep their final
        # registries on the fleet: their service life stays in the merged
        # fleet quantiles and the per-replica hit-rate series
        for name, reg in getattr(fleet, "_retired_telemetry", ()):
            comps[f"{name} (retired)"] = reg
        for rep in fleet._replicas:
            if rep.alive and rep.engine is not None \
                    and rep.engine.telemetry is not None:
                comps[rep.name] = rep.engine.telemetry.registry
        comps["router"] = fleet.metrics
        return cls(comps, frontend=frontend, clock=clock)

    @property
    def labels(self) -> list[str]:
        return sorted(self._components)

    def merged_histograms(self) -> dict:
        """{name: merged Histogram} — bucket-wise exact across every
        component that registers the name (same log-bucket layout by
        construction: same name, same constructor)."""
        out: dict[str, Histogram] = {}
        for label in self.labels:
            reg = self._components[label]
            for name in reg.names():
                m = reg._metrics.get(name)
                if not isinstance(m, Histogram):
                    continue
                tgt = out.get(name)
                if tgt is None:
                    tgt = Histogram(name, unit=m.unit, lo=m.lo,
                                    growth=m.growth)
                    out[name] = tgt
                tgt.merge_from(m)
        return out

    def snapshot(self) -> dict:
        """One labeled fleet snapshot:

          * ``merged`` — histograms merged bucket-wise (full quantile
            dicts) and counters summed across components;
          * ``per_replica`` — gauges, series tails, and counters
            side-by-side per label (``mem.*`` occupancy next to each
            other is the fleet memory observatory view);
          * ``replicas`` — the label list, ``at`` — snapshot clock."""
        merged: dict = {name: h.to_value()
                        for name, h in sorted(self.merged_histograms()
                                              .items())}
        counters: dict[str, int] = {}
        per_replica: dict = {}
        for label in self.labels:
            reg = self._components[label]
            side: dict = {}
            for name in reg.names():
                m = reg._metrics.get(name)
                if isinstance(m, Counter):
                    counters[name] = counters.get(name, 0) + m.value
                    side[name] = m.value
                elif isinstance(m, Gauge):
                    side[name] = m.value
                elif isinstance(m, GaugeSeries):
                    side[name] = m.to_value()
            per_replica[label] = side
        merged.update(sorted(counters.items()))
        return {"replicas": self.labels, "merged": merged,
                "per_replica": per_replica, "at": float(self.clock())}

    def slo_report(self, ttft_deadline_s: float) -> dict:
        """Fleet-wide SLO readout straight off the MERGED histograms:
        TTFT/TPOT/E2E quantiles plus goodput at the deadline via the
        merged TTFT histogram's ``fraction_below`` — exact bucket-wise,
        no per-request resampling needed."""
        m = self.merged_histograms()

        def _q(name):
            h = m.get(name)
            if h is None or not h.count:
                return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                        "count": 0}
            q = h.percentiles()
            return {"p50_ms": round(q[50] * 1e3, 2),
                    "p95_ms": round(q[95] * 1e3, 2),
                    "p99_ms": round(q[99] * 1e3, 2), "count": h.count}

        h_ttft = m.get("serve.ttft_s")
        n = h_ttft.count if h_ttft is not None else 0
        frac = h_ttft.fraction_below(ttft_deadline_s) \
            if h_ttft is not None and n else 0.0
        return {
            "ttft": _q("serve.ttft_s"),
            "tpot": _q("serve.tpot_s"),
            "e2e": _q("serve.e2e_s"),
            "ttft_deadline_ms": round(ttft_deadline_s * 1e3, 2),
            "requests": n,
            "goodput_fraction": round(frac, 4),
            "on_time_requests": int(round(frac * n)),
        }
