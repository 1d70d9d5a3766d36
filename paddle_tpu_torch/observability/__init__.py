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
and tail-outlier attribution (:mod:`.attribution`).

Across engines: :mod:`.distributed` stitches the traces of a request that
crossed frontend -> router -> replicas (one ``trace_id``) and merges the
replica registries bucket-wise; :mod:`.health` watches the series with
windowed alert rules; :mod:`.export` serves it all live over HTTP
(``/metrics``, ``/healthz``, ``/alerts``, ``/slow``, ``POST /generate``).  Telemetry off (the
default) is a no-op fast path — one flag check per hook site, zero
per-token work."""
from .attribution import (CriticalPath, TailRecorder, attribute,
                          attribute_stitched, attribution_report,
                          merge_tail_dumps, stitched_attribution_report)
from .distributed import FleetTelemetry, TraceStitcher, new_trace_id
from .export import (MetricsExporter, export_snapshot, render_json,
                     render_prometheus)
from .flight import FlightRecorder
from .health import (Alert, AlertRule, BurnRateRule, DeltaRule,
                     HealthSentinel, RatioDeltaRule, TrendRule,
                     aggregate_alerts, autoscale_rules, default_rules)
from .metrics import (Counter, EngineStats, Gauge, GaugeSeries, Histogram,
                      MetricsRegistry)
from .slo import burn_rate, latency_percentiles, slo_report, windowed_burn
from .telemetry import Telemetry
from .tracing import RequestTrace, Tracer
from .train import TrainTelemetry, batch_samples, fault_context

__all__ = ["Counter", "Gauge", "GaugeSeries", "Histogram", "MetricsRegistry",
           "EngineStats", "Tracer", "RequestTrace", "FlightRecorder",
           "Telemetry", "TrainTelemetry", "batch_samples", "fault_context",
           "latency_percentiles", "slo_report",
           # fleet-wide observability plane
           "FleetTelemetry", "TraceStitcher", "new_trace_id",
           "MetricsExporter", "export_snapshot", "render_prometheus",
           "render_json",
           # latency forensics + health sentinel
           "CriticalPath", "attribute", "attribute_stitched",
           "attribution_report", "stitched_attribution_report",
           "TailRecorder", "merge_tail_dumps",
           "Alert", "AlertRule", "TrendRule", "DeltaRule", "RatioDeltaRule",
           "BurnRateRule", "HealthSentinel", "default_rules",
           "autoscale_rules", "aggregate_alerts", "burn_rate",
           "windowed_burn"]
