"""Request-lifecycle tracing: ordered per-request event records, engine
phase spans, Chrome-trace/Perfetto export, and a bridge into
``paddle_tpu_torch.profiler`` so host spans land in the same
``torch.profiler`` timeline as the kernels they launched.

Every request carries an ordered event record stamped with HOST timestamps
taken only at existing host-sync boundaries (the engine never adds a device
round-trip for telemetry):

    submitted -> queued -> admitted -> prefill_chunk x N -> first_token
      -> decode_dispatch / verify_dispatch ... -> retired
    (+ preempted -> queued -> admitted ... on the self-healing path, and
     instant events: cache_hit, cow_copy, cache_evict, rejected, deadline)

The Chrome export derives PHASE SPANS from the lifecycle events with a tiny
state machine (queued: submitted->admitted, prefill: admitted->first_token,
decode: first_token->retired; preemption closes the open phase and re-opens
queued), nests them under one top-level span per request (tid = rid), and
emits everything else as instant events — the JSON loads directly in
chrome://tracing or https://ui.perfetto.dev.
"""
from __future__ import annotations

import json
import time
from collections import deque

__all__ = ["RequestTrace", "Tracer", "NULL_CONTEXT", "tracer_to_wire",
           "tracer_from_wire"]


class _NullContext:
    """Reusable no-op context (module singleton — telemetry-off code paths
    pay one flag check, not an allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_CONTEXT = _NullContext()

# lifecycle events that OPEN a phase span (value: the span name)
_PHASE_OPEN = {"submitted": "queued", "admitted": "prefill",
               "first_token": "decode", "preempted": "queued"}
# events that CLOSE whatever phase is open
_PHASE_CLOSE = {"admitted", "first_token", "preempted", "retired"}
# terminal events: the request record moves to the completed ring
_TERMINAL = {"retired"}


class RequestTrace:
    """One request's ordered (event, host_ts, attrs) record."""

    __slots__ = ("rid", "events")

    def __init__(self, rid: int):
        self.rid = rid
        self.events: list[tuple[str, float, dict | None]] = []

    def names(self) -> list[str]:
        return [e[0] for e in self.events]

    def append(self, name: str, t: float, attrs: dict | None):
        self.events.append((name, t, attrs))


class Tracer:
    """Engine-level trace collector.

    Live requests index into ``_live``; terminal events move the record to
    a bounded completed ring (``max_completed``) so a long-running engine
    cannot grow without bound.  Engine-scope spans (step phases, dispatch
    host timings) land in their own bounded ring and export on a dedicated
    ``engine`` track."""

    def __init__(self, clock=time.perf_counter, bridge: bool = False,
                 max_completed: int = 1024, max_engine_events: int = 8192,
                 max_counter_events: int = 8192):
        self.clock = clock
        self.bridge = bool(bridge)
        self._live: dict[int, RequestTrace] = {}
        self._done: deque[RequestTrace] = deque(maxlen=max_completed)
        # (name, t0, t1 | None for instants, attrs)
        self._engine: deque[tuple] = deque(maxlen=max_engine_events)
        # (track name, t, {series: value}) — exported as Chrome counter
        # events ("ph": "C"), which Perfetto renders as counter TRACKS
        # (PagePool occupancy, queue depth) alongside the request spans
        self._counters: deque[tuple] = deque(maxlen=max_counter_events)

    # -- recording ---------------------------------------------------------
    def request_event(self, rid: int, name: str, t: float | None = None,
                      **attrs):
        tr = self._live.get(rid)
        if tr is None:
            tr = RequestTrace(rid)
            self._live[rid] = tr
        tr.append(name, self.clock() if t is None else t, attrs or None)
        if name in _TERMINAL:
            self._done.append(self._live.pop(rid))

    def engine_span(self, name: str, t0: float, t1: float, **attrs):
        self._engine.append((name, t0, t1, attrs or None))

    def engine_event(self, name: str, t: float | None = None, **attrs):
        self._engine.append((name, self.clock() if t is None else t, None,
                             attrs or None))

    def counter(self, track: str, t: float | None = None, **values):
        """One sample on a named counter track: every keyword becomes a
        series inside the track (Perfetto stacks them).  Values must be
        numbers."""
        self._counters.append((track, self.clock() if t is None else t,
                               {k: float(v) for k, v in values.items()}))

    def counter_events(self) -> list[tuple]:
        return list(self._counters)

    def annotation(self, name: str):
        """Context manager for the profiler bridge: when ``bridge`` is on,
        wraps the scope in ``paddle_tpu_torch.profiler.host_annotation`` (a
        ``torch.profiler.record_function``), so the host span shows up in
        any active ``torch.profiler`` trace around the kernels it launched.
        Off-bridge: a shared no-op."""
        if not self.bridge:
            return NULL_CONTEXT
        from ..profiler import host_annotation
        return host_annotation(name)

    # -- introspection -----------------------------------------------------
    def get(self, rid: int) -> RequestTrace | None:
        tr = self._live.get(rid)
        if tr is not None:
            return tr
        for t in self._done:
            if t.rid == rid:
                return t
        return None

    def traces(self) -> list[RequestTrace]:
        out = list(self._done)
        out.extend(self._live.values())
        out.sort(key=lambda t: t.rid)
        return out

    # -- export ------------------------------------------------------------
    @staticmethod
    def _span_events(tr: RequestTrace) -> list[dict]:
        """Phase spans + instants for one request, nested under a single
        top-level span (chrome nesting = containment on one tid)."""
        if not tr.events:
            return []
        t_first = tr.events[0][1]
        t_last = tr.events[-1][1]
        tid = tr.rid + 1               # tid 0 is the engine track
        us = 1e6
        events = [{
            "name": f"request {tr.rid}", "cat": "request", "ph": "X",
            "pid": 0, "tid": tid, "ts": round(t_first * us, 3),
            "dur": round(max(0.0, (t_last - t_first)) * us, 3),
            "args": {"rid": tr.rid},
        }]
        open_name, open_t = None, 0.0
        for name, t, attrs in tr.events:
            if name in _PHASE_CLOSE and open_name is not None:
                events.append({
                    "name": open_name, "cat": "phase", "ph": "X",
                    "pid": 0, "tid": tid, "ts": round(open_t * us, 3),
                    "dur": round(max(0.0, t - open_t) * us, 3),
                })
                open_name = None
            if name in _PHASE_OPEN:
                open_name, open_t = _PHASE_OPEN[name], t
            if name not in _PHASE_OPEN and name not in _PHASE_CLOSE \
                    or name in ("preempted", "retired"):
                dur = (attrs or {}).get("dur")
                ev = {"name": name, "cat": "event",
                      "pid": 0, "tid": tid, "ts": round(t * us, 3)}
                if dur is not None:
                    # host-measured sub-span (e.g. one prefill chunk's
                    # dispatch) — export as a real slice, clamped inside
                    # the parent request span
                    ev["ph"] = "X"
                    ev["ts"] = round(max(t_first, t - float(dur)) * us, 3)
                    ev["dur"] = round(min(float(dur), t - t_first) * us, 3)
                else:
                    ev["ph"] = "i"
                    ev["s"] = "t"
                if attrs:
                    ev["args"] = {k: v for k, v in attrs.items()
                                  if k != "dur"}
                events.append(ev)
        if open_name is not None:
            # request still in flight: close the open phase at its last
            # known timestamp so the export is always loadable
            events.append({
                "name": open_name, "cat": "phase", "ph": "X",
                "pid": 0, "tid": tid, "ts": round(open_t * us, 3),
                "dur": round(max(0.0, t_last - open_t) * us, 3),
            })
        return events

    def to_chrome_trace(self) -> dict:
        """chrome://tracing / Perfetto-loadable dict.  Request tracks are
        tid = rid + 1; engine step/phase spans are tid 0."""
        us = 1e6
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "paddle_tpu_torch serving engine"}},
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "engine"}},
        ]
        for name, t0, t1, attrs in self._engine:
            if t1 is None:
                ev = {"name": name, "cat": "engine", "ph": "i", "s": "t",
                      "pid": 0, "tid": 0, "ts": round(t0 * us, 3)}
            else:
                ev = {"name": name, "cat": "engine", "ph": "X",
                      "pid": 0, "tid": 0, "ts": round(t0 * us, 3),
                      "dur": round(max(0.0, t1 - t0) * us, 3)}
            if attrs:
                ev["args"] = dict(attrs)
            events.append(ev)
        for track, t, values in self._counters:
            events.append({"name": track, "cat": "gauge", "ph": "C",
                           "pid": 0, "ts": round(t * us, 3),
                           "args": dict(values)})
        for tr in self.traces():
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tr.rid + 1,
                           "args": {"name": f"request {tr.rid}"}})
            events.extend(self._span_events(tr))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


# -- cross-process wire form --------------------------------------------------
# A worker process ships its Tracer to the supervisor over the `trace` RPC
# as plain JSON; the supervisor rebuilds an equivalent Tracer so the
# TraceStitcher sees worker tracks exactly like in-process replica tracks.
# Both sides must run on the SAME clock domain (the process fleet uses
# time.time end to end) or the stitched spans shear.

def _py(v):
    """JSON-safe scalar: numpy scalars and one-element tensors -> Python
    numbers (``.item()``); anything else with an ``item`` that refuses
    (a multi-element array or tensor) -> its ``str``."""
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        try:
            return v.item()
        except (AttributeError, ValueError, RuntimeError):
            return str(v)
    return v


def _py_attrs(attrs):
    return None if not attrs else {str(k): _py(v) for k, v in attrs.items()}


def tracer_to_wire(tracer: "Tracer") -> dict:
    """Serialize a Tracer (request records, engine spans, counter tracks)
    into a JSON-ready dict for the worker->supervisor ``trace`` RPC."""
    return {
        "requests": [{"rid": int(tr.rid),
                      "events": [[n, float(t), _py_attrs(a)]
                                 for n, t, a in tr.events]}
                     for tr in tracer.traces()],
        "engine": [[n, float(t0), None if t1 is None else float(t1),
                    _py_attrs(a)] for n, t0, t1, a in tracer._engine],
        "counters": [[track, float(t), {k: float(v) for k, v in vals.items()}]
                     for track, t, vals in tracer._counters],
    }


def tracer_from_wire(data: dict, clock=time.time) -> "Tracer":
    """Rebuild a Tracer from :func:`tracer_to_wire` output.  Records are
    replayed structurally (not through ``request_event``) so attr keys can
    never collide with parameter names and terminal placement matches the
    original exactly."""
    t = Tracer(clock=clock)
    for r in data.get("requests", ()):
        tr = RequestTrace(int(r["rid"]))
        for name, ts, attrs in r.get("events", ()):
            tr.append(name, float(ts), attrs or None)
        if tr.events and tr.events[-1][0] in _TERMINAL:
            t._done.append(tr)
        else:
            t._live[tr.rid] = tr
    for name, t0, t1, attrs in data.get("engine", ()):
        t._engine.append((name, float(t0),
                          None if t1 is None else float(t1), attrs or None))
    for track, ts, vals in data.get("counters", ()):
        t._counters.append((track, float(ts),
                            {k: float(v) for k, v in vals.items()}))
    return t
