"""Per-request critical-path attribution + tail-outlier capture.

Quantiles say how slow the tail is; this module says **why one request was
slow**.  It decomposes each request's end-to-end latency into EXACT
DISJOINT segments over its traced lifetime, so a slow request reads as a
bill of materials instead of a single number:

    queue 41%  |  admission 3%  |  prefill_chunk 22%  |  decode_sync 30%
    decode_dispatch 2%  |  decode_record 1%  |  host_other 1%

The decomposition overlays the engine-scope phase spans (the ``Tracer``
engine track: ``sched``, ``prefill_*``, ``decode_*``, ``verify_*``,
``overlap_*``) onto the request's own lifecycle window (``submitted`` ..
``retired``): at every instant of the request's life, the segment is *what
the engine was doing* — waiting in queue, host scheduling (``admission``),
dispatching or syncing a decode, verifying drafts.  Segments are built on
shared boundary floats, so they are contiguous and disjoint BY
CONSTRUCTION and their durations telescope to the traced e2e
(:meth:`CriticalPath.is_exact` asserts the structure).

Tail forensics: :class:`TailRecorder` auto-captures the top-K slowest
requests at retirement — full span chain, computed attribution, and the
engine-state context row (pool occupancy / queue depth at the time) — as
flight-style outlier dumps, browsable live via the exporter's ``/slow``
endpoint.  Capture is O(log K) per retirement (a heap check); the
attribution itself is only computed for requests that enter the top K.

Everything here is pure host code over already-recorded traces: zero
device syncs, zero per-token work.

Cross-replica requests (failover, live migration, snapshot restore, KV
handoff) attribute through the stitched view (:func:`attribute_stitched`):
the component tracers a ``trace_id`` crossed are ordered by first touch,
each engine residency attributes locally, and the inter-engine gaps
classify as ``migration`` (adopt / re-prefill placement),
``snapshot_restore`` (the successor record carries ``restored=True``) or
``kv_transfer`` (``handoff=True``).
"""
from __future__ import annotations

import heapq
import math
import time
from bisect import bisect_left, bisect_right

__all__ = ["SEGMENT_KINDS", "CriticalPath", "attribute", "attribute_trace",
           "attribute_stitched", "attribution_report",
           "stitched_attribution_report", "TailRecorder",
           "merge_tail_dumps"]

# engine-span name -> attribution segment kind.  The overlap_* phases are
# the double-buffered loop's decode phases (same roles, suffix convention
# shared with Telemetry.utilization_report); verify_* collapse into one
# ``verify`` segment (dispatch/sync/record of a speculative verify are one
# causal unit from the request's point of view).
_SPAN_KIND = {
    "sched": "admission",
    "prefill_dense": "prefill_dense",
    "prefill_chunk": "prefill_chunk",
    "decode_dispatch": "decode_dispatch",
    "overlap_dispatch": "decode_dispatch",
    "decode_sync": "decode_sync",
    "overlap_sync": "decode_sync",
    "overlap_join_sync": "decode_sync",
    "decode_record": "decode_record",
    "overlap_record": "decode_record",
    "verify_dispatch": "verify",
    "verify_sync": "verify",
    "verify_record": "verify",
}

SEGMENT_KINDS = ("queue", "admission", "prefill_dense", "prefill_chunk",
                 "decode_dispatch", "decode_sync", "decode_record", "verify",
                 "migration", "snapshot_restore", "kv_transfer", "host_other")


class CriticalPath:
    """One request's exact latency decomposition.

    ``segments`` is an ordered list of ``(kind, t0, t1, component)`` tuples
    sharing boundary floats: ``segments[i][2] is segments[i+1][1]`` up to
    float identity, the first starts at the traced window's start and the
    last ends at its end — disjointness and exact coverage are structural,
    not numerical, properties (:meth:`is_exact`)."""

    __slots__ = ("key", "trace_id", "t0", "t1", "segments")

    def __init__(self, key, trace_id, t0: float, t1: float, segments):
        self.key = key                  # rid (single engine) or trace_id
        self.trace_id = trace_id
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.segments = list(segments)

    @property
    def traced_e2e_s(self) -> float:
        """e2e as the tracer saw it: last event minus first event."""
        return self.t1 - self.t0

    @property
    def e2e_s(self) -> float:
        """e2e as the segments bill it (math.fsum of durations)."""
        return math.fsum(t1 - t0 for _k, t0, t1, _c in self.segments)

    def is_exact(self) -> bool:
        """Structural exactness: contiguous non-negative segments covering
        [t0, t1] with no gaps and no overlaps."""
        if not self.segments:
            return self.t1 == self.t0
        if self.segments[0][1] != self.t0 or self.segments[-1][2] != self.t1:
            return False
        prev_end = self.t0
        for _k, a, b, _c in self.segments:
            if a != prev_end or b < a:
                return False
            prev_end = b
        return True

    def sum_matches(self, rel_tol: float = 1e-9) -> bool:
        """The telescoped duration sum equals the traced e2e (float
        rounding of the pairwise differences is the only slack)."""
        ref = abs(self.traced_e2e_s)
        return abs(self.e2e_s - self.traced_e2e_s) <= rel_tol * max(1.0, ref)

    def totals(self) -> dict:
        """{kind: seconds} over the segments (fsum per kind)."""
        acc: dict[str, list] = {}
        for kind, a, b, _c in self.segments:
            acc.setdefault(kind, []).append(b - a)
        return {k: math.fsum(v) for k, v in sorted(acc.items())}

    def fractions(self) -> dict:
        e2e = self.traced_e2e_s
        if e2e <= 0.0:
            return {k: 0.0 for k in self.totals()}
        return {k: v / e2e for k, v in self.totals().items()}

    def to_dict(self, segments: bool = False) -> dict:
        out = {
            "key": self.key,
            "trace_id": self.trace_id,
            "e2e_s": round(self.traced_e2e_s, 9),
            "exact": self.is_exact() and self.sum_matches(),
            "totals_s": {k: round(v, 9) for k, v in self.totals().items()},
            "fractions": {k: round(v, 4)
                          for k, v in self.fractions().items()},
        }
        if segments:
            out["segments"] = [
                {"kind": k, "t0": round(a, 9), "t1": round(b, 9),
                 "component": c} for k, a, b, c in self.segments]
        return out


# ---------------------------------------------------------------------------
# single-tracer attribution
# ---------------------------------------------------------------------------
def _engine_spans(tracer) -> tuple[list, list, list]:
    """Sorted (t0, t1, name) phase spans from a tracer's engine track,
    plus the parallel t0 list for bisect windowing and a prefix-max of
    span ENDS (pmax[i] = max t1 over spans[:i]) so the window scan can
    walk back past short nested spans to a long enclosing one.  Instants
    and non-phase spans (``step``) are ignored."""
    spans = [(t0, t1, name) for (name, t0, t1, _a) in tracer._engine
             if t1 is not None and name in _SPAN_KIND]
    spans.sort()
    pmax = [float("-inf")]
    for _t0, t1, _n in spans:
        pmax.append(max(pmax[-1], t1))
    return spans, [s[0] for s in spans], pmax


def _queue_intervals(events) -> list:
    """[(a, b)] windows where the request sat in the admission queue:
    submitted -> first admitted, and preempted -> re-admitted (a migrated
    record's fresh ``submitted`` re-opens it too)."""
    out = []
    open_t = None
    for name, t, _attrs in events:
        if name in ("submitted", "preempted") and open_t is None:
            open_t = t
        elif name == "admitted" and open_t is not None:
            out.append((open_t, t))
            open_t = None
    if open_t is not None and events:
        out.append((open_t, events[-1][1]))
    return out


def _in_any(t: float, intervals) -> bool:
    return any(a <= t <= b for a, b in intervals)


def _window_segments(events, spans, span_t0s, span_pmax, w_lo: float,
                     w_hi: float, component: str) -> list:
    """Exact segment list for one component residency [w_lo, w_hi]:
    overlay the engine phase spans (innermost wins where they nest — a
    prefill dispatch drawn inside its ``sched`` window bills as prefill),
    default uncovered time to ``queue`` (inside a queue interval) or
    ``host_other``."""
    if w_hi <= w_lo:
        return []
    # candidate spans overlapping the window, clipped to it
    lo_i = bisect_left(span_t0s, w_lo)
    # spans starting before w_lo can still reach into the window — walk
    # back while ANY earlier span does (the prefix-max of ends, not the
    # immediately preceding span: a short nested span sitting between
    # must not hide a long enclosing one that still covers the window)
    i = lo_i
    while i > 0 and span_pmax[i] > w_lo:
        i -= 1
    cand = []
    for t0, t1, name in spans[i:bisect_right(span_t0s, w_hi)]:
        if t1 <= w_lo or t0 >= w_hi:
            continue
        cand.append((max(t0, w_lo), min(t1, w_hi), name))
    queue_iv = [(max(a, w_lo), min(b, w_hi))
                for a, b in _queue_intervals(events)
                if b > w_lo and a < w_hi]
    cuts = {w_lo, w_hi}
    for a, b, _n in cand:
        cuts.add(a)
        cuts.add(b)
    for a, b in queue_iv:
        cuts.add(a)
        cuts.add(b)
    bounds = sorted(cuts)
    segments = []
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        mid = a + (b - a) / 2.0
        if _in_any(mid, queue_iv):
            # queue wait takes PRIORITY over the span overlay: while this
            # request waited for a slot the engine was busy with OTHERS —
            # billing that time as their decode phases would dilute the
            # one number admission/autoscaling policies act on
            kind = "queue"
        else:
            # innermost covering span: max t0, then smallest extent
            # (spans either fully cover an atomic interval or miss it —
            # every span boundary is a cut point)
            best = None
            for t0, t1, name in cand:
                if t0 <= mid <= t1:
                    if best is None or \
                            (t0, -(t1 - t0)) > (best[0],
                                                -(best[1] - best[0])):
                        best = (t0, t1, name)
            kind = _SPAN_KIND[best[2]] if best is not None else "host_other"
        if segments and segments[-1][0] == kind:
            segments[-1] = (kind, segments[-1][1], b, component)
        else:
            segments.append((kind, a, b, component))
    return segments


def _tracer_of(source):
    tracer = getattr(source, "tracer", source)
    if not hasattr(tracer, "_engine"):
        raise TypeError(f"attribute() needs a Tracer or a Telemetry, "
                        f"not {type(source).__name__}")
    return tracer


def _trace_id_of(tr):
    for _name, _t, attrs in tr.events:
        if attrs and "trace_id" in attrs:
            return attrs["trace_id"]
    return None


def attribute_trace(trace, tracer, component: str = "engine") -> CriticalPath:
    """Attribution for one already-located RequestTrace."""
    spans, span_t0s, pmax = _engine_spans(tracer)
    t_lo = trace.events[0][1]
    t_hi = trace.events[-1][1]
    segs = _window_segments(trace.events, spans, span_t0s, pmax, t_lo, t_hi,
                            component)
    return CriticalPath(trace.rid, _trace_id_of(trace), t_lo, t_hi, segs)


def attribute(source, rid: int, component: str = "engine") -> CriticalPath:
    """Critical-path attribution for request ``rid`` on one engine's
    tracer (``source``: a ``Tracer`` or a ``Telemetry``).  Raises KeyError
    for an unknown rid."""
    tracer = _tracer_of(source)
    trace = tracer.get(rid)
    if trace is None or not trace.events:
        raise KeyError(f"no trace recorded for rid {rid}")
    return attribute_trace(trace, tracer, component=component)


# ---------------------------------------------------------------------------
# stitched (cross-component) attribution
# ---------------------------------------------------------------------------
def _is_engine_tracer(tracer) -> bool:
    """A component is an ENGINE residency when its tracer carries real
    phase spans (router/frontend tracers only record request events and
    instants)."""
    return any(t1 is not None and name in _SPAN_KIND
               for name, t0, t1, _a in tracer._engine)


def attribute_stitched(components, trace_id: int) -> CriticalPath | None:
    """Attribution for one end-to-end ``trace_id`` across stitched
    component tracers (``components``: iterable of ``(name, tracer)`` —
    ``ReplicaFleet.trace_components()`` / ``TraceStitcher`` order).

    The request's global window spans from its FIRST touch on any
    component to its LAST.  Engine residencies attribute locally (the
    component's own phase spans); the gap before the first residency is
    ``queue`` (router/frontend placement), a gap BETWEEN residencies is
    ``kv_transfer`` when the successor record was opened by
    ``ServingEngine.import_kv()`` (``handoff=True`` — the disaggregated
    prefill->decode page transfer), ``snapshot_restore`` when re-recorded
    by ``ServingEngine.restore()`` (``restored=True``), and ``migration``
    otherwise (adopt / re-prefill placement), and the tail after the last
    residency (the router heartbeat observing the retirement) is
    ``host_other``.  Returns None when no component saw the trace_id."""
    touches = []
    for name, tracer in components:
        spans, span_t0s, pmax = _engine_spans(tracer)
        is_engine = bool(spans) or _is_engine_tracer(tracer)
        for tr in tracer.traces():
            if not tr.events or _trace_id_of(tr) != trace_id:
                continue
            touches.append({
                "name": name, "tracer": tracer, "trace": tr,
                "spans": spans, "span_t0s": span_t0s, "pmax": pmax,
                "t0": tr.events[0][1], "t1": tr.events[-1][1],
                "engine": is_engine,
                "restored": bool((tr.events[0][2] or {}).get("restored")),
                "handoff": bool((tr.events[0][2] or {}).get("handoff")),
            })
    if not touches:
        return None
    t_lo = min(t["t0"] for t in touches)
    t_hi = max(t["t1"] for t in touches)
    def _retired(t, cancelled):
        last = t["trace"].events[-1]
        return last[0] == "retired" \
            and bool((last[2] or {}).get("cancelled")) == cancelled

    done_ts = [t["t1"] for t in touches if _retired(t, False)] \
        or [t["t1"] for t in touches if _retired(t, True)]
    if done_ts:
        # clamp at the LATEST REAL retirement: a snapshot-restored ZOMBIE
        # copy of an already-resolved request (pruned via cancel by the
        # router) must not re-open the request's window — cancelled
        # records only set the bound when no real retirement exists
        t_hi = max(done_ts)
        touches = [t for t in touches if t["t0"] <= t_hi]
        for t in touches:
            t["t1"] = min(t["t1"], t_hi)
    engines = sorted((t for t in touches if t["engine"]),
                     key=lambda t: (t["t0"], t["t1"]))
    segments: list = []
    cursor = t_lo
    for i, tc in enumerate(engines):
        w_lo = max(tc["t0"], cursor)
        w_hi = max(tc["t1"], w_lo)
        if w_lo > cursor:
            if i == 0:
                kind = "queue"
            elif tc["handoff"]:
                kind = "kv_transfer"
            else:
                kind = "snapshot_restore" if tc["restored"] else "migration"
            segments.append((kind, cursor, w_lo, "fleet"))
        segments.extend(_window_segments(tc["trace"].events, tc["spans"],
                                         tc["span_t0s"], tc["pmax"],
                                         w_lo, w_hi, tc["name"]))
        cursor = max(cursor, w_hi)
    if cursor < t_hi:
        segments.append(("host_other" if engines else "queue",
                         cursor, t_hi, "fleet"))
    return CriticalPath(trace_id, trace_id, t_lo, t_hi, segments)


# ---------------------------------------------------------------------------
# aggregate reports
# ---------------------------------------------------------------------------
def _aggregate(paths, top_k: int) -> dict:
    paths = [p for p in paths if p is not None]
    totals: dict[str, list] = {}
    e2e_all: list[float] = []
    exact = 0
    for p in paths:
        for k, v in p.totals().items():
            totals.setdefault(k, []).append(v)
        e2e_all.append(p.traced_e2e_s)
        if p.is_exact() and p.sum_matches():
            exact += 1
    e2e_total = math.fsum(e2e_all)
    seg = {}
    for k in sorted(totals):
        tot = math.fsum(totals[k])
        seg[k] = {"total_s": round(tot, 6),
                  "frac": round(tot / e2e_total, 4) if e2e_total else 0.0}
    slowest = sorted(paths, key=lambda p: -p.traced_e2e_s)[:top_k]
    return {
        "requests": len(paths),
        "exact_requests": exact,
        "e2e_s_total": round(e2e_total, 6),
        "segments": seg,
        # the headline share: decode_sync is the only bucket where the
        # DEVICE is provably the request's bottleneck
        "decode_sync_frac": seg.get("decode_sync", {}).get("frac", 0.0),
        "slowest": [p.to_dict() for p in slowest],
    }


def attribution_report(source, top_k: int = 5,
                       component: str = "engine") -> dict:
    """Aggregate attribution over every COMPLETED request on one engine's
    tracer: per-segment totals + e2e shares, exactness census, and the
    top-K slowest requests with their full decomposition."""
    tracer = _tracer_of(source)
    paths = [attribute_trace(tr, tracer, component=component)
             for tr in tracer.traces()
             if tr.events and tr.events[-1][0] == "retired"]
    return _aggregate(paths, top_k)


def stitched_attribution_report(components, top_k: int = 5) -> dict:
    """Aggregate attribution over every stitched end-to-end request
    (``components`` as for :func:`attribute_stitched`): one
    :class:`CriticalPath` per trace_id whose chain saw a retirement."""
    components = list(components)
    done_ids = set()
    for _name, tracer in components:
        for tr in tracer.traces():
            if tr.events and tr.events[-1][0] == "retired":
                tid = _trace_id_of(tr)
                if tid is not None:
                    done_ids.add(tid)
    paths = [attribute_stitched(components, tid) for tid in sorted(done_ids)]
    return _aggregate(paths, top_k)


# ---------------------------------------------------------------------------
# tail-outlier capture
# ---------------------------------------------------------------------------
class TailRecorder:
    """Top-K slowest-request capture (flight-style outlier dumps).

    ``offer()`` is called once per retirement (Telemetry wires it); a
    request slower than the current K-th slowest is captured WITH its
    full span chain, computed attribution, and the engine-state context
    row — the postmortem evidence survives the tracer's bounded completed
    ring."""

    def __init__(self, k: int = 8, clock=time.perf_counter):
        if k < 1:
            raise ValueError("TailRecorder k must be >= 1")
        self.k = int(k)
        self.clock = clock
        self.offered = 0
        self._seq = 0
        self._heap: list = []       # (e2e_s, seq, dump) min-heap

    def __len__(self):
        return len(self._heap)

    def offer(self, summary: dict, trace, tracer,
              context: dict | None = None) -> dict | None:
        """Consider one retired request (its Telemetry summary dict, its
        RequestTrace, and the tracer holding the engine spans).  Returns
        the dump when captured, None when the request was fast enough to
        skip (the common case — one float compare)."""
        e2e = summary.get("e2e_s")
        if e2e is None:
            return None
        e2e = float(e2e)
        self.offered += 1
        if len(self._heap) >= self.k and e2e <= self._heap[0][0]:
            return None
        cp = attribute_trace(trace, tracer)
        dump = {
            "reason": "slow_request",
            "rid": trace.rid,
            "trace_id": cp.trace_id,
            "captured_at": float(self.clock()),
            "e2e_s": round(e2e, 9),
            "summary": dict(summary),
            "attribution": cp.to_dict(segments=True),
            "events": [dict({"event": name, "t": round(t, 9)},
                            **(attrs or {}))
                       for name, t, attrs in trace.events],
            "context": dict(context) if context else None,
        }
        self._seq += 1
        heapq.heappush(self._heap, (e2e, self._seq, dump))
        if len(self._heap) > self.k:
            heapq.heappop(self._heap)
        return dump

    def dumps(self) -> list[dict]:
        """Captured outliers, slowest first."""
        return [d for _e, _s, d in
                sorted(self._heap, key=lambda x: (-x[0], x[1]))]

    def reset(self):
        """Window boundary: drop captures (warm-pass outliers must not
        shadow the measured window's tail)."""
        self._heap.clear()
        self.offered = 0

    def report(self) -> dict:
        ds = self.dumps()
        return {
            "k": self.k,
            "captured": len(ds),
            "offered": self.offered,
            "slowest_e2e_s": ds[0]["e2e_s"] if ds else 0.0,
            "rids": [d["rid"] for d in ds],
        }


def merge_tail_dumps(recorders, k: int = 8) -> list[dict]:
    """Fleet-level /slow view: merge per-replica TailRecorder captures
    into one slowest-first top-K list (``recorders``: iterable of
    ``(label, TailRecorder)``)."""
    rows = []
    for label, rec in recorders:
        for d in rec.dumps():
            d = dict(d)
            d["component"] = label
            rows.append(d)
    rows.sort(key=lambda d: -d["e2e_s"])
    return rows[:k]
