"""Serving observability: metrics registry, request-lifecycle tracing,
crash flight recorder, SLO reporting and latency attribution.

Three pieces, one clock:

  * :mod:`.metrics` — counters / gauges / log-bucketed histograms with
    p50/p95/p99 readout, a named registry with snapshot semantics, and
    :class:`EngineStats` (flattened ``ServingEngine.stats()`` snapshots
    with exact per-window ``delta()``).
  * :mod:`.tracing` — per-request ordered lifecycle event records +
    engine phase spans, exportable as Chrome-trace/Perfetto JSON and
    bridged into ``torch.profiler`` traces via
    ``paddle_tpu_torch.profiler``.
  * :mod:`.flight` — a bounded ring of recent engine events that dumps
    automatically on stalls, preemption storms, and injected faults.

:class:`.telemetry.Telemetry` bundles all three for the serving engine
(``ServingEngine(..., telemetry=True)``) and adds the step decomposition
(:meth:`~.telemetry.Telemetry.utilization_report`), the per-step PagePool
memory series (``mem.pool``), capture accounting (``engine.compile_s``)
and tail-outlier attribution (:mod:`.attribution`).  Telemetry off (the
default) is a no-op fast path — one flag check per hook site, zero
per-token work."""
from .attribution import (CriticalPath, TailRecorder, attribute,
                          attribution_report)
from .flight import FlightRecorder
from .metrics import (Counter, EngineStats, Gauge, GaugeSeries, Histogram,
                      MetricsRegistry)
from .slo import burn_rate, latency_percentiles, slo_report, windowed_burn
from .telemetry import Telemetry
from .tracing import RequestTrace, Tracer
from .train import fault_context

__all__ = ["Counter", "Gauge", "GaugeSeries", "Histogram", "MetricsRegistry",
           "EngineStats", "Tracer", "RequestTrace", "FlightRecorder",
           "Telemetry", "fault_context", "latency_percentiles", "slo_report",
           "CriticalPath", "attribute", "attribution_report", "TailRecorder",
           "burn_rate", "windowed_burn"]
