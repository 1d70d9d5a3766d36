"""Live metric export: Prometheus-text + JSON renderers over registry
snapshots, and a stdlib ``http.server``-on-a-thread endpoint.

A serving deployment must be debuggable WHILE it runs, not only post-hoc
from saved artifacts.  This module adds the pull side with
no new dependencies and zero engine-thread work:

  * :func:`export_snapshot` — a TYPED snapshot of a
    :class:`~.metrics.MetricsRegistry`: every metric tagged
    counter/gauge/histogram/series, histograms carrying their sparse
    cumulative buckets (so the Prometheus render has real ``_bucket``
    lines, not just quantiles).  Reading is lock-free: buckets are read
    BEFORE the count, so a concurrent ``observe()`` can never make a
    rendered series non-cumulative (torn-snapshot safety by construction).
  * :func:`render_prometheus` / :func:`render_json` — the two text
    renderers over one (or several labeled) typed snapshots; both render
    the same values, and a test pins that they agree on every one.
  * :class:`MetricsExporter` — ``ThreadingHTTPServer`` on a daemon
    thread serving ``/metrics`` (Prometheus text), ``/metrics.json``,
    ``/healthz`` (degraded-aware: status flips to
    ``degraded`` with an active-alert count while the health sentinel
    has firing rules — the HTTP code stays 200 so scrapers don't flap),
    ``/alerts`` (the sentinel report), ``/slow`` (tail-outlier dumps:
    the top-K slowest requests with their critical-path attribution),
    and ``/requests`` (recent request summaries).  Off by default, binds
    ``127.0.0.1`` by default (metrics can leak workload shape — put real
    auth in front before binding wider).  All rendering happens on the
    HTTP thread from snapshots; the serving engine thread does no
    exporter work at all.
"""
from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import Counter, Gauge, GaugeSeries, Histogram, MetricsRegistry

__all__ = ["export_snapshot", "render_prometheus", "render_json",
           "prom_name", "prom_escape_label", "MetricsExporter"]

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """Prometheus metric-name sanitization: the charset is
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` — dots (our namespace separator) and
    anything else illegal become underscores, and a leading digit gets a
    guard underscore."""
    s = _NAME_BAD.sub("_", str(name))
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def prom_escape_label(value) -> str:
    """Label-VALUE escaping per the text-format spec: backslash, double
    quote, and newline must be escaped; everything else passes through."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{prom_name(k)}="{prom_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def hist_export(h: Histogram) -> dict:
    """One histogram's typed export row: the quantile summary plus the
    sparse cumulative buckets.  Buckets are read before ``count`` (see
    ``Histogram.cumulative_buckets``) so under concurrent observes the
    ``+Inf`` row — rendered from ``count`` — is always >= the last
    bucket: every render is cumulative, never torn."""
    buckets = h.cumulative_buckets()
    v = h.to_value()                 # count read after the buckets
    v["buckets"] = [[le, n] for le, n in buckets]
    return v


def export_snapshot(registry: MetricsRegistry) -> dict:
    """Typed snapshot: ``{name: {"type": ..., ...}}`` plus ``at``.  The
    type tag is what lets the renderers emit correct Prometheus metric
    types without guessing from the value shape."""
    out: dict = {}
    for name in registry.names():
        m = registry._metrics.get(name)
        if isinstance(m, Counter):
            out[name] = {"type": "counter", "value": m.value}
        elif isinstance(m, Gauge):
            out[name] = {"type": "gauge", "value": m.value}
        elif isinstance(m, Histogram):
            out[name] = {"type": "histogram", **hist_export(m)}
        elif isinstance(m, GaugeSeries):
            out[name] = {"type": "series", **m.to_value()}
    out["at"] = float(registry.clock())
    return out


def _as_labeled(snap: dict) -> dict:
    """Normalize to ``{label: typed snapshot}`` (single snapshot ->
    label '').  A typed entry at top level means single; otherwise it is
    a labeled bundle only when every non-``at`` value is itself a dict —
    an EMPTY snapshot (just ``at``, e.g. a registry scraped before its
    first metric) is a single snapshot, not a bundle of floats."""
    if any(isinstance(v, dict) and "type" in v for v in snap.values()):
        return {"": snap}
    vals = [v for k, v in snap.items() if k != "at"]
    if vals and all(isinstance(v, dict) for v in vals):
        return snap
    return {"": snap}


def render_prometheus(snapshot: dict, label_key: str = "component") -> str:
    """Prometheus text format over a typed snapshot (or a ``{label:
    snapshot}`` bundle — each sample then carries ``component="label"``).

    Counters render with the conventional ``_total`` suffix; histograms
    render ``_bucket{le=...}`` (cumulative, ``+Inf`` == count) +
    ``_sum`` + ``_count``; series render their last-sample numeric fields
    as gauges suffixed ``_last_<field>``."""
    labeled = _as_labeled(snapshot)
    # group by metric name so each # TYPE header appears exactly once
    names: dict[str, str] = {}
    for lab, snap in labeled.items():
        for name, entry in snap.items():
            if name == "at" or not isinstance(entry, dict):
                continue
            names.setdefault(name, entry.get("type", "gauge"))
    lines: list[str] = []
    for name in sorted(names):
        kind = names[name]
        base = prom_name(name)
        if kind == "counter":
            lines.append(f"# TYPE {base}_total counter")
        elif kind == "histogram":
            lines.append(f"# TYPE {base} histogram")
        elif kind in ("gauge", "series"):
            lines.append(f"# TYPE {base} gauge" if kind == "gauge"
                         else f"# TYPE {base}_last gauge")
        for lab in sorted(labeled):
            entry = labeled[lab].get(name)
            if not isinstance(entry, dict):
                continue
            lb = {label_key: lab} if lab else {}
            if kind == "counter":
                lines.append(f"{base}_total{_fmt_labels(lb)} "
                             f"{entry['value']}")
            elif kind == "gauge":
                lines.append(f"{base}{_fmt_labels(lb)} {entry['value']}")
            elif kind == "histogram":
                for le, n in entry.get("buckets", []):
                    bl = dict(lb)
                    bl["le"] = repr(float(le))
                    lines.append(f"{base}_bucket{_fmt_labels(bl)} {n}")
                bl = dict(lb)
                bl["le"] = "+Inf"
                lines.append(f"{base}_bucket{_fmt_labels(bl)} "
                             f"{entry['count']}")
                lines.append(f"{base}_sum{_fmt_labels(lb)} {entry['sum']}")
                lines.append(f"{base}_count{_fmt_labels(lb)} "
                             f"{entry['count']}")
            elif kind == "series":
                last = entry.get("last") or {}
                for field, v in sorted(last.items()):
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    lines.append(f"{base}_last_{prom_name(field)}"
                                 f"{_fmt_labels(lb)} {v}")
    return "\n".join(lines) + "\n"


def render_json(snapshot: dict) -> str:
    """The JSON twin of :func:`render_prometheus` — same typed snapshot,
    every value identical (a test diffs the two renders value by
    value)."""
    return json.dumps(snapshot, sort_keys=True)


class _Handler(BaseHTTPRequestHandler):
    exporter: "MetricsExporter" = None      # set per server

    # silence the default stderr access log (a scrape per second would
    # otherwise spam the serving process's output)
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _send(self, code: int, body: str, ctype: str):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # one _Handler instance per request, owned by its server thread
    def do_GET(self):  # noqa: N802
        ex = self.server.exporter
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                ex.scrapes += 1
                self._send(200, render_prometheus(ex.snapshot_fn()),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metrics.json":
                ex.scrapes += 1
                self._send(200, render_json(ex.snapshot_fn()),
                           "application/json")
            elif path == "/healthz":
                # degraded-aware: the health_fn (usually the
                # sentinel's health()) may flip status to "degraded" and
                # report the active-alert count — the HTTP code stays 200
                # either way so scrapers don't flap on a warning
                health = {"status": "ok", "active_alerts": 0,
                          "uptime_s": round(time.monotonic() - ex._t0, 3),
                          "scrapes": ex.scrapes}
                if ex.health_fn is not None:
                    health.update(ex.health_fn())
                self._send(200, json.dumps(health), "application/json")
            elif path == "/alerts":
                alerts = ex.alerts_fn() if ex.alerts_fn is not None \
                    else {"status": "ok", "active_alerts": 0,
                          "fired_total": 0, "components": {},
                          "note": "no health sentinel attached"}
                self._send(200, json.dumps(alerts), "application/json")
            elif path == "/slow":
                slow = ex.slow_fn() if ex.slow_fn is not None else []
                self._send(200, json.dumps(list(slow)), "application/json")
            elif path == "/requests":
                reqs = ex.requests_fn() if ex.requests_fn is not None else []
                self._send(200, json.dumps(list(reqs)), "application/json")
            else:
                self._send(404, json.dumps(
                    {"error": "unknown path", "paths": [
                        "/metrics", "/metrics.json", "/healthz",
                        "/alerts", "/slow", "/requests"]}),
                    "application/json")
        except Exception as exc:  # noqa: BLE001 — a scrape must never
            # take the server thread down; report the failure to the
            # scraper instead
            self._send(500, json.dumps({"error": f"{type(exc).__name__}: "
                                                 f"{exc}"}),
                       "application/json")

    # one _Handler instance per request, owned by its server thread
    def do_POST(self):  # noqa: N802
        """``POST /generate`` -> Server-Sent-Events token stream (the
        real-socket serving transport over :class:`~paddle_tpu_torch.serving.
        frontend.AsyncFrontend`).  ``generate_fn(payload)`` yields
        SSE-framed strings; a client disconnect mid-stream surfaces here
        as a broken pipe, and CLOSING the generator is the cancel signal
        (its ``finally`` abandons the stream -> ``engine.cancel`` frees
        the pages mid-decode)."""
        ex = self.server.exporter
        path = self.path.split("?", 1)[0]
        if path != "/generate" or ex.generate_fn is None:
            self._send(404, json.dumps({"error": "unknown path"}),
                       "application/json")
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, TypeError) as exc:
            self._send(400, json.dumps({"error": f"bad request body: "
                                                 f"{exc}"}),
                       "application/json")
            return
        gen = ex.generate_fn(payload)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            for chunk in gen:
                self.wfile.write(chunk.encode("utf-8"))
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client went away mid-stream — closing the generator runs
            # its finally block, which cancels the live request
            pass
        finally:
            gen.close()


class MetricsExporter:
    """``/metrics`` + ``/healthz`` + ``/requests`` on a daemon thread.

    ``snapshot_fn`` returns a typed snapshot (:func:`export_snapshot`) or
    a ``{label: typed snapshot}`` bundle; it runs ON THE HTTP THREAD —
    the component being observed does zero exporter work.  ``port=0``
    picks a free port (read it back from ``.port``).  SECURITY: binds
    localhost by default; metrics and ``/requests`` expose workload shape
    (prompt lengths, queue depths) — front with real auth before binding
    a routable interface."""

    def __init__(self, snapshot_fn, requests_fn=None, health_fn=None,
                 alerts_fn=None, slow_fn=None, generate_fn=None,
                 host: str = "127.0.0.1", port: int = 0):
        self.snapshot_fn = snapshot_fn
        self.requests_fn = requests_fn
        self.health_fn = health_fn
        self.alerts_fn = alerts_fn      # /alerts: the health-sentinel report
        self.slow_fn = slow_fn          # /slow: tail-outlier dumps
        self.generate_fn = generate_fn  # POST /generate: SSE token stream
        self.host = host
        self._requested_port = int(port)
        self.scrapes = 0
        self._t0 = time.monotonic()
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int | None:
        return self._server.server_address[1] if self._server else None

    @property
    def url(self) -> str | None:
        return f"http://{self.host}:{self.port}" if self._server else None

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            raise RuntimeError("exporter already started")
        self._server = ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler)
        self._server.exporter = self
        self._server.daemon_threads = True
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="metrics-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        self._server = None
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
