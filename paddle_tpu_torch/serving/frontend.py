"""Async serving front end: asyncio transport + SLO-aware admission.

The engine streams (``submit(on_token=...)`` / ``Request.stream()``), but
its hooks are synchronous callbacks inside the engine thread: no
backpressure, no cancel-on-disconnect, and admission by raw queue depth.
This module is the missing layer between "an engine that can stream" and "thousands of
concurrent clients":

  * :class:`AsyncFrontend` — an asyncio transport wrapping a
    :class:`~paddle_tpu_torch.inference.paged.ServingEngine` or a
    :class:`~paddle_tpu_torch.serving.fleet.ReplicaFleet`.  The engine steps on
    ONE worker thread (engines are deliberately not thread-safe); every
    token crosses into the event loop via ``call_soon_threadsafe`` in
    emission order.  ``await submit()`` returns an :class:`AsyncStream` —
    an async token iterator backed by a BOUNDED per-request
    ``asyncio.Queue``.  A slow client fills its queue and stalls only its
    own drain fan-out task (the engine-side feed buffers host ints and
    never blocks): backpressure is per-client, the engine never waits on
    a consumer.  Client disconnect — task cancellation inside the
    iterator, ``async with`` exit, an explicit ``abandon()``, or the
    stream being garbage-collected — propagates to ``engine.cancel(rid)``
    on the worker thread, so a mid-decode disconnect frees its KV pages
    instead of decoding to an audience of zero.
  * :class:`AdmissionController` + :class:`TTFTPredictor` — SLO-aware
    admission.  The predictor turns the live engine telemetry (decode
    phase histograms + prefill-token accounting) plus the engine's
    host-visible schedulable state (free slots, per-slot remaining
    budgets, queued prefill backlog — an :class:`AdmissionView`) into a
    PREDICTED TTFT via a tiny earliest-free-slot simulation; the
    controller rejects (typed :class:`SLORejected`, an
    ``AdmissionRejected`` subclass) when the prediction exceeds the
    request's deadline.  Prediction error is itself a tracked metric —
    ``frontend.ttft_pred_err_s`` — because an admission controller whose
    predictions silently rot is worse than a depth cap.  The depth-cap
    policy (``policy="depth"``) is kept as the A/B baseline.

Everything here is pure host-side asyncio/numpy: no device work and no new
captured graphs.  The engine (or fleet) steps on the worker thread, so on
a card the first call of each decode horizon — its CUDA-graph capture —
runs there too: while the worker steps, no other thread may touch the
device (``start`` documents the warm-up rule).
"""
from __future__ import annotations

import asyncio
import heapq
import threading
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..inference.paged import AdmissionRejected, ServingEngine
from ..observability.distributed import new_trace_id
from ..observability.metrics import MetricsRegistry
from ..observability.tracing import Tracer

__all__ = ["AsyncFrontend", "AsyncStream", "SLORejected", "AdmissionView",
           "TTFTPredictor", "AdmissionController", "admission_view"]


class SLORejected(AdmissionRejected):
    """Admission rejected because the PREDICTED TTFT exceeds the request's
    deadline — the SLO-aware analog of the queue-full
    ``AdmissionRejected`` (and a subclass of it, so existing backpressure
    handling catches both)."""


# --------------------------------------------------------------------------
# Predicted-TTFT admission
# --------------------------------------------------------------------------
@dataclass
class AdmissionView:
    """A host-only snapshot of everything the TTFT predictor needs —
    built from a live engine (:func:`admission_view`), an aggregated
    fleet, or a simulator
    (:func:`~paddle_tpu_torch.serving.traffic.replay_sim`).

    ``active`` rows are (prefill_tokens_left, decode_tokens_left) per
    busy slot; ``queued`` rows are (prefill_tokens, max_new_tokens) in
    queue order.  ``step_s`` is the measured wall cost of one decode
    dispatch (``decode_horizon`` tokens per live slot)."""
    free_slots: int
    active: list = field(default_factory=list)
    queued: list = field(default_factory=list)
    prefill_rate_tps: float = 2000.0
    step_s: float = 0.02
    decode_horizon: int = 8

    @property
    def queue_depth(self) -> int:
        return len(self.queued)


def _hist(registry, name: str):
    """A registry histogram ONLY if it already exists (reading rates must
    not register phantom metrics)."""
    if registry is not None and name in registry:
        return registry.histogram(name)
    return None


def admission_view(engine: ServingEngine, *,
                   default_prefill_rate_tps: float = 2000.0,
                   default_step_s: float = 0.02,
                   min_samples: int = 3) -> AdmissionView:
    """Build an :class:`AdmissionView` from a live engine.

    Rates come from the engine telemetry when the engine carries one with
    enough samples — prefill tokens/s from the executed-prefill counter
    over the ``prefill_dense``/``prefill_chunk`` phase totals, decode
    step seconds from the ``engine.step_host_s`` histogram mean — and
    fall back to the supplied priors on a cold engine.  Prediction error
    against reality is tracked either way
    (``frontend.ttft_pred_err_s``)."""
    prefill_rate = default_prefill_rate_tps
    step_s = default_step_s
    tel = engine.telemetry
    if tel is not None:
        r = tel.registry
        pf_s = 0.0
        pf_n = 0
        for name in ("engine.phase.prefill_dense_s",
                     "engine.phase.prefill_chunk_s"):
            h = _hist(r, name)
            if h is not None:
                pf_s += h.total
                pf_n += h.count
        # windowed tokens over windowed seconds — both reset together by
        # Telemetry.reset_window(); the engine's lifetime prefill_tokens
        # counter over a freshly reset phase histogram would inflate the
        # rate unboundedly
        ht = _hist(r, "engine.prefill_tokens_per_dispatch")
        pf_tokens = ht.total if ht is not None else 0.0
        if pf_n >= min_samples and pf_s > 0.0 and pf_tokens > 0.0:
            prefill_rate = pf_tokens / pf_s
        hs = _hist(r, "engine.step_host_s")
        if hs is not None and hs.count >= min_samples:
            step_s = hs.mean
    active = []
    for s, slot in enumerate(engine._slots):
        if slot is None:
            continue
        if slot.prefill_pos is not None:
            pf_left = len(slot.ctx) - slot.prefill_pos
            dec_left = slot.req.max_new_tokens - len(slot.req.generated)
        else:
            pf_left = 0
            dec_left = max(1, slot.req.max_new_tokens
                           - len(slot.req.generated))
        active.append((int(pf_left), int(dec_left)))
    queued = [(len(r_.prompt) + max(0, len(r_.generated) - 1),
               max(1, r_.max_new_tokens - len(r_.generated)))
              for r_ in engine._queue]
    return AdmissionView(
        free_slots=engine.num_slots - len(active), active=active,
        queued=queued, prefill_rate_tps=float(prefill_rate),
        step_s=float(step_s), decode_horizon=engine.decode_horizon)


class TTFTPredictor:
    """Predict a new request's TTFT from an :class:`AdmissionView` with a
    tiny earliest-free-slot (FIFO, S-server) simulation:

      * each busy slot frees after its remaining prefill + decode work
        (decode at ``step_s / decode_horizon`` seconds per token — the
        whole batch shares one dispatch, so per-slot token cost is the
        step cost, not the step cost times the batch);
      * queued requests ahead are granted slots earliest-free-first and
        occupy them for their own prefill + full budget;
      * the new request's TTFT = the wait for the slot it would get,
        plus its own prefill (the fused prefill+sample emits the first
        token at prefill end).

    Deliberately ignores the prefix cache (a hit only makes TTFT better
    — predictions stay conservative) and chunked-prefill interleaving.
    The point is not a perfect model: the controller tracks
    ``frontend.ttft_pred_err_s`` precisely so the error is a measured,
    gateable quantity instead of a hidden assumption."""

    def predict(self, view: AdmissionView, prompt_tokens: int) -> float:
        tpt = view.step_s / max(1, view.decode_horizon)
        inv = 1.0 / max(view.prefill_rate_tps, 1e-9)
        free = [0.0] * max(0, view.free_slots)
        busy = [pf * inv + dec * tpt for pf, dec in view.active]
        heap = free + busy
        if not heap:
            heap = [0.0]
        heapq.heapify(heap)
        for pf, mn in view.queued:
            t = heapq.heappop(heap)
            heapq.heappush(heap, t + pf * inv + mn * tpt)
        t_admit = heap[0] if heap else 0.0
        return float(t_admit + prompt_tokens * inv)


class AdmissionController:
    """Admission policy front door: ``policy`` is

      * ``"predictive"`` — reject (:class:`SLORejected`) when the
        predicted TTFT exceeds the request's ``slo_ttft_s`` deadline
        times ``margin``; otherwise admit (counted ``admitted`` when a
        slot is free and nothing queues ahead, ``queued`` otherwise);
      * ``"depth"`` — the baseline: reject (``AdmissionRejected``) when
        the queue is ``max_queue_depth`` deep, regardless of any SLO;
      * ``"always"`` — admit everything (the bit-equality harness runs
        here: admission must not perturb outputs).

    Decisions, predictions, and prediction error land in an owned (or
    injected) :class:`~paddle_tpu_torch.observability.metrics.MetricsRegistry`:
    counters ``frontend.offered`` / ``admitted`` / ``queued`` /
    ``rejected_slo`` / ``rejected_depth`` (admitted + queued + rejections
    == offered — the fraction-sum the obs gate checks), histograms
    ``frontend.ttft_pred_s`` and ``frontend.ttft_pred_err_s`` (|predicted
    - actual| at first token)."""

    POLICIES = ("predictive", "depth", "always")

    def __init__(self, policy: str = "predictive", *,
                 slo_ttft_s: float | None = None,
                 max_queue_depth: int | None = None,
                 margin: float = 1.0,
                 predictor: TTFTPredictor | None = None,
                 default_prefill_rate_tps: float = 2000.0,
                 default_step_s: float = 0.02,
                 metrics: MetricsRegistry | None = None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown admission policy {policy!r} "
                             f"(expected one of {self.POLICIES})")
        self.policy = policy
        self.slo_ttft_s = slo_ttft_s
        self.max_queue_depth = max_queue_depth
        self.margin = float(margin)
        self.predictor = predictor or TTFTPredictor()
        self.default_prefill_rate_tps = float(default_prefill_rate_tps)
        self.default_step_s = float(default_step_s)
        self.metrics = metrics or MetricsRegistry()
        r = self.metrics
        self._c_offered = r.counter("frontend.offered")
        self._c_admitted = r.counter("frontend.admitted")
        self._c_queued = r.counter("frontend.queued")
        self._c_rej_slo = r.counter("frontend.rejected_slo")
        self._c_rej_depth = r.counter("frontend.rejected_depth")
        self._h_pred = r.histogram("frontend.ttft_pred_s")
        self._h_err = r.histogram("frontend.ttft_pred_err_s")
        self._pending: dict[int, float] = {}      # rid -> predicted ttft

    # -- decision ----------------------------------------------------------
    def decide(self, view: AdmissionView, prompt_tokens: int,
               slo_ttft_s: float | None = None) -> float:
        """Count the offered request, predict its TTFT, and either return
        the prediction (admitted/queued) or raise the typed rejection."""
        self._c_offered.inc()
        pred = self.predictor.predict(view, prompt_tokens)
        self._h_pred.observe(pred)
        if self.policy == "depth":
            depth = self.max_queue_depth
            if depth is not None and view.queue_depth >= depth:
                self._c_rej_depth.inc()
                raise AdmissionRejected(
                    f"admission queue full ({view.queue_depth}/{depth} "
                    f"deep) — depth-based backpressure, retry later")
        elif self.policy == "predictive":
            slo = slo_ttft_s if slo_ttft_s is not None else self.slo_ttft_s
            if slo is not None and pred > slo * self.margin:
                self._c_rej_slo.inc()
                raise SLORejected(
                    f"predicted TTFT {pred * 1e3:.1f} ms exceeds the "
                    f"{slo * 1e3:.1f} ms deadline "
                    f"({view.queue_depth} queued, {view.free_slots} free "
                    f"slots) — SLO-aware rejection, retry later or relax "
                    f"the deadline")
        if view.free_slots > 0 and view.queue_depth == 0:
            self._c_admitted.inc()
        else:
            self._c_queued.inc()
        return pred

    def submit(self, engine, prompt, *, slo_ttft_s: float | None = None,
               **kw) -> int:
        """Decide + submit to a live engine (the synchronous replay entry;
        :class:`AsyncFrontend` routes through :meth:`decide` on its
        worker thread).  ``**kw`` passes through to ``engine.submit``."""
        view = admission_view(
            engine, default_prefill_rate_tps=self.default_prefill_rate_tps,
            default_step_s=self.default_step_s)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pred = self.decide(view, len(prompt), slo_ttft_s=slo_ttft_s)
        rid = engine.submit(prompt, **kw)
        self._pending[rid] = pred
        return rid

    # -- outcome tracking --------------------------------------------------
    def track(self, rid: int, predicted_ttft_s: float):
        self._pending[rid] = float(predicted_ttft_s)

    def resolve(self, rid: int, req) -> None:
        """Fold a retired/abandoned request's actual TTFT into the
        prediction-error histogram (no-op for untracked rids or requests
        that never produced a first token)."""
        pred = self._pending.pop(rid, None)
        if pred is None or req is None:
            return
        ttft = getattr(req, "ttft", 0.0)
        if ttft:
            self._h_err.observe(abs(ttft - pred))

    def resolve_sim(self, predicted: float, actual: float) -> None:
        """Simulator-side outcome (no Request object exists there)."""
        self._h_err.observe(abs(actual - predicted))

    def report(self) -> dict:
        """Admission counters + fraction decomposition + prediction-error
        stats (admit/queue/reject fractions sum to ~1 over offered)."""
        offered = self._c_offered.value
        parts = {
            "admitted": self._c_admitted.value,
            "queued": self._c_queued.value,
            "rejected_slo": self._c_rej_slo.value,
            "rejected_depth": self._c_rej_depth.value,
        }
        fr = {f"{k}_frac": round(v / offered, 4) if offered else 0.0
              for k, v in parts.items()}
        err = self._h_err
        q = err.percentiles()
        return {
            "policy": self.policy,
            "slo_ttft_s": self.slo_ttft_s,
            "max_queue_depth": self.max_queue_depth,
            "offered": offered,
            **parts,
            **fr,
            "fraction_sum": round(sum(fr.values()), 4),
            "ttft_pred_err_s": {
                "count": err.count,
                "mean_s": round(err.mean, 6),
                "p50_s": round(q[50], 6),
                "p95_s": round(q[95], 6),
                "max_s": round(err.max, 6) if err.count else 0.0,
            },
            "ttft_pred_s": {
                "count": self._h_pred.count,
                "mean_s": round(self._h_pred.mean, 6),
                "p95_s": round(self._h_pred.percentiles()[95], 6),
            },
        }


# --------------------------------------------------------------------------
# Transport adapters (one engine, one fleet — same worker-side surface)
# --------------------------------------------------------------------------
class _EngineAdapter:
    """Worker-side view of a single ServingEngine."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine

    def has_work(self) -> bool:
        e = self.engine
        return bool(e.num_active or e._queue or e.inflight_depth)

    def step(self) -> bool:
        return self.engine.step()

    def view(self, controller: AdmissionController) -> AdmissionView:
        return admission_view(
            self.engine,
            default_prefill_rate_tps=controller.default_prefill_rate_tps,
            default_step_s=controller.default_step_s)

    def submit(self, prompt, **kw) -> int:
        return self.engine.submit(prompt, **kw)

    def cancel(self, rid: int) -> bool:
        return self.engine.cancel(rid)

    def result(self, rid: int):
        req = self.engine._finished.get(rid)
        return req if req is not None and req.finish_time else None


class _FleetAdapter:
    """Worker-side view of a ReplicaFleet: admission aggregates the live
    replicas (free slots summed, queues concatenated fleet-queue-last,
    rates from the first telemetry-bearing replica), tokens ride the
    router-authoritative ``on_token`` (satellite: a stream survives
    failover without double emission because the router log only ever
    extends)."""

    def __init__(self, fleet):
        self.fleet = fleet

    def has_work(self) -> bool:
        return any(fr.result is None
                   for fr in self.fleet._requests.values())

    def step(self) -> bool:
        return self.fleet.step()

    def view(self, controller: AdmissionController) -> AdmissionView:
        free = 0
        active: list = []
        queued: list = []
        rate = controller.default_prefill_rate_tps
        step_s = controller.default_step_s
        horizon = 8
        got_rates = False
        for rep in self.fleet._replicas:
            # a drain-retiring (unroutable) replica's slots must not be
            # promised to admission — new work can never be placed there
            if not rep.alive or not rep.routable:
                continue
            v = admission_view(
                rep.engine,
                default_prefill_rate_tps=controller.default_prefill_rate_tps,
                default_step_s=controller.default_step_s)
            free += v.free_slots
            active.extend(v.active)
            queued.extend(v.queued)
            horizon = v.decode_horizon
            if not got_rates and rep.engine.telemetry is not None:
                rate, step_s = v.prefill_rate_tps, v.step_s
                got_rates = True
        queued.extend((len(fr.prompt), fr.kw["max_new_tokens"])
                      for fr in self.fleet._waiting)
        return AdmissionView(free_slots=free, active=active, queued=queued,
                             prefill_rate_tps=rate, step_s=step_s,
                             decode_horizon=horizon)

    def submit(self, prompt, *, on_token=None, timeout=None, **kw) -> int:
        return self.fleet.submit(prompt, timeout=timeout,
                                 on_token=on_token, **kw)

    def cancel(self, frid: int) -> bool:
        return self.fleet.cancel(frid)

    def result(self, frid: int):
        fr = self.fleet._requests.get(frid)
        return fr.result if fr is not None else None


# --------------------------------------------------------------------------
# The async transport
# --------------------------------------------------------------------------
_END = object()


def _gc_abandon(fe_ref, rid_box, state):
    """weakref.finalize hook: an AsyncStream garbage-collected while its
    request is still live cancels the request (the async analog of the
    ``Request.stream()`` early-exit guarantee).  Must not capture the
    stream itself — and CAN fire, because every frontend-side reference
    to a stream (the engine's on_token closure, the tracking tables, the
    fan-out task) is deliberately weak."""
    if state.get("open"):
        fe = fe_ref()
        rid = rid_box.get("rid")
        if fe is not None and rid is not None:
            fe._request_cancel(rid, handle=None)


async def _drain_overflow(sref):
    """Per-request drain fan-out: move buffered tokens into the bounded
    client queue, awaiting queue space — THE backpressure stall point
    (per request; the engine thread never blocks here).  Holds the stream
    only through a weakref and re-checks liveness every quarter second,
    so a garbage-collected stream releases its fan-out instead of
    pinning it behind a queue nobody will ever drain."""
    while True:
        s = sref()
        if s is None or not s._overflow:
            return
        item = s._overflow[0]
        q = s._q
        s = None                       # drop the strong ref across waits
        while True:
            try:
                q.put_nowait(item)     # never double-delivers (a timed-out
                break                  # q.put() can race its own success)
            except asyncio.QueueFull:
                if sref() is None:     # client vanished mid-backpressure
                    return
                await asyncio.sleep(0.05)
        s = sref()
        if s is None:
            return
        s._overflow.popleft()


class AsyncStream:
    """One client's async token stream.

    ``async for tok in stream`` yields host-int tokens in emission order;
    the iterator ends when the request retires.  ``await stream.result()``
    returns the final :class:`~paddle_tpu_torch.inference.paged.Request` record
    (``None`` when the request was cancelled).  Disconnect semantics —
    every path lands in ``engine.cancel(rid)`` on the worker thread:

      * the consuming task is CANCELLED while waiting on the iterator;
      * ``async with stream:`` exits before the stream finished;
      * explicit :meth:`abandon`;
      * the stream object is garbage-collected while the request lives.

    Backpressure: tokens land in a bounded ``asyncio.Queue``; when a slow
    client lets it fill, excess tokens buffer in an engine-side deque and
    a per-request fan-out task awaits queue space — the stall is entirely
    inside this request's fan-out, the engine thread never blocks."""

    def __init__(self, frontend: "AsyncFrontend", buffer: int):
        self._fe = frontend
        self.rid: int | None = None
        self.trace_id: int | None = None
        self.predicted_ttft_s: float | None = None
        self._q: asyncio.Queue = asyncio.Queue(maxsize=max(1, buffer))
        self._overflow: deque = deque()
        self._fanout: asyncio.Task | None = None
        self._result = None
        self._done = asyncio.Event()
        self._end_seen = False
        self._abandoned = False
        # GC-abandon guard: shared mutable boxes, not the stream itself
        self._rid_box: dict = {}
        self._state = {"open": True}
        self._finalizer = weakref.finalize(
            self, _gc_abandon, weakref.ref(frontend), self._rid_box,
            self._state)

    # -- loop-thread feeders (always via call_soon_threadsafe) -------------
    def _feed(self, item):
        if not self._overflow and (self._fanout is None
                                   or self._fanout.done()):
            try:
                self._q.put_nowait(item)
                return
            except asyncio.QueueFull:
                pass
        self._overflow.append(item)
        if self._fanout is None or self._fanout.done():
            # the fan-out task holds only a WEAK ref to the stream: a
            # pinned strong ref would keep an abandoned-by-GC stream
            # alive forever behind its own full queue
            self._fanout = self._fe._loop.create_task(
                _drain_overflow(weakref.ref(self)))

    def _finish(self, req):
        self._state["open"] = False
        self._result = req
        self._done.set()
        self._feed(_END)

    # -- client surface ----------------------------------------------------
    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._end_seen:
            raise StopAsyncIteration
        try:
            item = await self._q.get()
        except asyncio.CancelledError:
            # client disconnect: the consuming task died mid-stream —
            # propagate to the engine so the pages free mid-decode
            self.abandon()
            raise
        if item is _END:
            self._end_seen = True
            raise StopAsyncIteration
        return item

    def abandon(self):
        """Disconnect: cancel the request on the worker thread (idempotent;
        a no-op once the request retired)."""
        if self._abandoned or self._done.is_set():
            return
        self._abandoned = True
        self._state["open"] = False
        if self.rid is not None:
            self._fe._request_cancel(self.rid, handle=self)

    async def result(self):
        """The final Request record (None when cancelled/abandoned)."""
        await self._done.wait()
        return self._result

    async def __aenter__(self):
        return self

    async def __aexit__(self, exc_type, exc, tb):
        if not self._done.is_set():
            self.abandon()
            await self._done.wait()
        return False


class AsyncFrontend:
    """The asyncio serving transport.  Construct over a live
    ``ServingEngine`` or ``ReplicaFleet``, enter it (``async with`` or
    ``await start()``), then ``await submit(...)`` from any number of
    client coroutines:

        async with AsyncFrontend(engine, slo_ttft_s=0.5) as fe:
            stream = await fe.submit(prompt, max_new_tokens=64)
            async for tok in stream:
                ...                       # tokens in emission order
            final = await stream.result() # the Request record

    The engine steps on one daemon worker thread; submissions, cancels,
    and admission decisions all execute THERE (engines are not
    thread-safe), bridged back via ``call_soon_threadsafe`` futures.
    ``admission`` picks the :class:`AdmissionController` policy (or pass
    a controller instance); ``submit`` raises :class:`SLORejected` /
    ``AdmissionRejected`` exactly like the engine's bounded queue.

    ``await drain()`` waits until every open stream finished (the clean
    shutdown point); ``aclose()`` stops the worker (the engine object —
    with whatever state it still holds — stays valid and inspectable)."""

    def __init__(self, engine, *, admission="always",
                 slo_ttft_s: float | None = None,
                 max_queue_depth: int | None = None,
                 stream_buffer: int = 64,
                 poll_interval_s: float = 0.002):
        from .fleet import ReplicaFleet
        if isinstance(engine, ServingEngine):
            self._adapter = _EngineAdapter(engine)
        elif isinstance(engine, ReplicaFleet):
            self._adapter = _FleetAdapter(engine)
        else:
            raise TypeError("AsyncFrontend wraps a ServingEngine or a "
                            f"ReplicaFleet, not {type(engine).__name__}")
        self.engine = engine
        if isinstance(admission, AdmissionController):
            self.controller = admission
        else:
            self.controller = AdmissionController(
                policy=admission, slo_ttft_s=slo_ttft_s,
                max_queue_depth=max_queue_depth)
        self.stream_buffer = int(stream_buffer)
        self._poll = float(poll_interval_s)
        # the FRONTEND track of the stitched trace: one span per request,
        # from the admission decision to retirement, stamped with the
        # trace_id that threads through router placement and replica
        # admission.  All writes happen on the worker thread.
        self.tracer = Tracer()
        self.exporter = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._cv = threading.Condition()
        self._cmds: list = []
        self._stop = False
        # BOTH tables hold weak refs: a client that silently drops its
        # stream must be able to reach the GC-abandon finalizer (the
        # frontend must never be the thing keeping a dead client alive)
        self._tracked: dict[int, weakref.ref] = {}   # worker-owned
        self._streams: "weakref.WeakSet[AsyncStream]" = weakref.WeakSet()
        self._error: BaseException | None = None

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "AsyncFrontend":
        """Start the worker thread that steps the engine (or fleet).  On a
        card a decode horizon the engine has not run yet is captured as a
        CUDA graph on that thread, and a capture fails if another thread
        calls into CUDA meanwhile: serve one request on each engine before
        ``start`` (its graphs are then captured on the calling thread),
        and touch the device from no other thread while the worker runs."""
        if self._thread is not None:
            raise RuntimeError("AsyncFrontend already started")
        self._stop = False          # restartable after aclose()
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(target=self._worker,
                                        name="frontend-engine", daemon=True)
        self._thread.start()
        return self

    async def __aenter__(self):
        return await self.start()

    async def __aexit__(self, exc_type, exc, tb):
        await self.aclose()
        return False

    async def aclose(self):
        """Stop the worker thread (after it finishes the step in
        progress).  Outstanding streams are finished with ``None``."""
        if self.exporter is not None:
            self.exporter.stop()
            self.exporter = None
        if self._thread is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join)
        self._thread = None

    async def drain(self):
        """Wait until every open stream has finished (retired, cancelled,
        or failed) — the graceful-shutdown barrier."""
        while self._streams:
            waiters = [s._done.wait() for s in list(self._streams)]
            await asyncio.gather(*waiters)

    # -- client surface ----------------------------------------------------
    async def submit(self, prompt, max_new_tokens: int = 32,
                     temperature: float = 0.0, top_p: float = 1.0,
                     eos_token_id: int | None = None,
                     timeout: float | None = None,
                     slo_ttft_s: float | None = None,
                     stream_buffer: int | None = None) -> AsyncStream:
        """Admission-checked async submit; returns the token stream.
        Raises :class:`SLORejected` when predictive admission says the
        deadline cannot be met, ``AdmissionRejected`` on depth/queue
        backpressure — both BEFORE the request touches the engine."""
        if self._thread is None:
            raise RuntimeError("AsyncFrontend not started — use "
                               "'async with AsyncFrontend(...)' or await "
                               "start()")
        if self._error is not None:
            raise RuntimeError("frontend worker died") from self._error
        loop = self._loop
        fut: asyncio.Future = loop.create_future()
        stream = AsyncStream(self, stream_buffer or self.stream_buffer)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        sref = weakref.ref(stream)
        # the end-to-end stitching id: minted HERE (the outermost
        # component) and threaded through router placement, replica
        # admission, migration, and snapshot restore
        trace_id = new_trace_id()
        stream.trace_id = trace_id

        def on_token(tok, _sref=sref, _self=self):
            # worker thread -> event loop, in emission order.  Weak ref
            # only: the engine Request holds this closure until
            # retirement, and a strong ref here would keep an
            # abandoned-by-GC stream alive for the request's lifetime
            s = _sref()
            if s is not None:
                _self._post(s._feed, tok)

        def do_submit():
            # captures `sref`, never `stream`: a closure cell here would
            # outlive the call and keep a dropped stream from ever
            # reaching the GC-abandon finalizer.  The awaiting submit()
            # coroutine holds the stream strongly until this resolves.
            try:
                if self._error is not None:   # worker died before us
                    raise RuntimeError("frontend worker died") \
                        from self._error
                t_decide = self.tracer.clock()
                view = self._adapter.view(self.controller)
                pred = self.controller.decide(view, len(prompt),
                                              slo_ttft_s=slo_ttft_s)
                rid = self._adapter.submit(
                    prompt, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_p=top_p,
                    eos_token_id=eos_token_id, timeout=timeout,
                    on_token=on_token, trace_id=trace_id)
                self.controller.track(rid, pred)
                self._tracked[rid] = sref
                # stamped at the admission DECISION time (before the
                # engine-side submit), so the frontend span is the
                # outermost touch in the stitched flow chain
                self.tracer.request_event(
                    rid, "submitted", t=t_decide, trace_id=trace_id,
                    prompt_tokens=len(prompt),
                    predicted_ttft_s=round(pred, 6))
            except BaseException as exc:  # noqa: BLE001 — delivered async
                self._post(self._reject_future, fut, exc)
                return
            s = sref()
            if s is not None:
                self._post(self._resolve_submit, fut, s, rid, pred)

        self._enqueue_cmd(do_submit)
        await fut
        return stream

    @staticmethod
    def _reject_future(fut: asyncio.Future, exc: BaseException):
        if not fut.done():
            fut.set_exception(exc)

    def _resolve_submit(self, fut: asyncio.Future, stream: AsyncStream,
                        rid: int, pred: float):
        stream.rid = rid
        stream._rid_box["rid"] = rid
        stream.predicted_ttft_s = pred
        self._streams.add(stream)
        if not fut.done():
            fut.set_result(rid)

    def stats(self) -> dict:
        """Admission report + open-stream count (host-only reads)."""
        rep = self.controller.report()
        rep["open_streams"] = len(self._streams)
        return rep

    # -- live exporter -----------------------------------------------------
    def _sentinels(self) -> dict:
        """{label: HealthSentinel} for every telemetry-bearing component
        behind this front end that carries one — recomputed per scrape so
        failover-revived replicas appear automatically, and every
        sentinel found gets the admission controller's registry attached
        (the prediction-error drift rule reads it; a revived replica's
        FRESH sentinel must be wired on discovery, not only at
        start_exporter time)."""
        out: dict = {}
        eng = self.engine
        if isinstance(eng, ServingEngine):
            tel = eng.telemetry
            if tel is not None and tel.sentinel is not None:
                out["engine"] = tel.sentinel
        else:                                     # ReplicaFleet
            out.update(eng._sentinels())
        for s in out.values():
            s.registries.setdefault("frontend", self.controller.metrics)
        return out

    def _slow_dumps(self) -> list:
        """The /slow body: tail-outlier dumps merged across components."""
        from ..observability.attribution import merge_tail_dumps
        eng = self.engine
        if isinstance(eng, ServingEngine):
            tel = eng.telemetry
            if tel is None or tel.tail is None:
                return []
            return merge_tail_dumps([("engine", tel.tail)])
        return eng.slow_requests()                # ReplicaFleet

    def _export_registries(self) -> dict:
        """{label: MetricsRegistry} for every component behind this front
        end — recomputed per scrape, so failover-revived replicas (fresh
        registries) appear automatically."""
        regs = {"frontend": self.controller.metrics}
        eng = self.engine
        if isinstance(eng, ServingEngine):
            if eng.telemetry is not None:
                regs["engine"] = eng.telemetry.registry
        else:                                     # ReplicaFleet
            regs["router"] = eng.metrics
            for rep in eng._replicas:
                if rep.alive and rep.engine is not None \
                        and rep.engine.telemetry is not None:
                    regs[rep.name] = rep.engine.telemetry.registry
        return regs

    # -- HTTP/SSE streaming endpoint ---------------------------------------
    def _sse_generate(self, payload: dict):
        """``POST /generate`` body -> SSE-framed event strings.  Runs on
        the exporter's HTTP thread: the submit and every token pull hop
        onto the asyncio loop via ``run_coroutine_threadsafe``, so the
        transport semantics (admission, backpressure, cancel path) are
        EXACTLY :meth:`submit`'s.  A client disconnect closes this
        generator mid-iteration; the ``finally`` abandons the stream —
        the same ``engine.cancel()`` path as an async client vanishing,
        pages freed mid-decode."""
        import json as _json

        def _ev(event, obj):
            return f"event: {event}\ndata: {_json.dumps(obj)}\n\n"

        loop = self._loop
        if loop is None or self._thread is None:
            yield _ev("error", {"error": "frontend not started"})
            return
        try:
            prompt = np.asarray(payload["prompt"], np.int32).reshape(-1)
            kw = dict(
                max_new_tokens=int(payload.get("max_new_tokens", 32)),
                temperature=float(payload.get("temperature", 0.0)),
                top_p=float(payload.get("top_p", 1.0)),
                eos_token_id=payload.get("eos_token_id"),
                slo_ttft_s=payload.get("slo_ttft_s"))
        except (KeyError, TypeError, ValueError) as exc:
            yield _ev("error", {"error": f"bad request: {exc}"})
            return
        try:
            stream = asyncio.run_coroutine_threadsafe(
                self.submit(prompt, **kw), loop).result()
        except AdmissionRejected as exc:
            yield _ev("rejected", {"error": str(exc),
                                   "slo": isinstance(exc, SLORejected)})
            return
        except Exception as exc:  # noqa: BLE001 — surfaced to the client
            yield _ev("error", {"error": f"{type(exc).__name__}: {exc}"})
            return
        done = False
        err: Exception | None = None
        n = 0
        try:
            yield _ev("start", {"rid": stream.rid,
                                "trace_id": stream.trace_id,
                                "predicted_ttft_s": stream.predicted_ttft_s})
            while True:
                try:
                    tok = asyncio.run_coroutine_threadsafe(
                        stream.__anext__(), loop).result()
                except StopAsyncIteration:
                    break
                except Exception as exc:  # noqa: BLE001 — engine/worker
                    # died mid-stream: the contract is a TYPED error
                    # frame, not a silent truncation indistinguishable
                    # from a network drop (GeneratorExit — the client
                    # disconnect — is BaseException and still propagates)
                    err = exc
                    break
                n += 1
                yield f"data: {_json.dumps({'token': int(tok)})}\n\n"
            done = err is None
        finally:
            if not done:
                # generator closed mid-stream (disconnect) or the stream
                # errored: cancel any live request through the existing
                # abandon path
                loop.call_soon_threadsafe(stream.abandon)
        if err is not None:
            yield _ev("error", {"error": f"{type(err).__name__}: {err}",
                                "tokens": n})
        else:
            yield _ev("done", {"tokens": n})

    def start_exporter(self, host: str = "127.0.0.1", port: int = 0,
                       freeze: bool = True):
        """Attach the live pull endpoint: ``/metrics`` (Prometheus text,
        every component labeled), ``/metrics.json``, ``/healthz``
        (degraded-aware when a health sentinel rides the engine
        telemetry), ``/alerts`` (the aggregated sentinel report),
        ``/slow`` (top-K slowest requests with their critical-path
        attribution, merged across replicas), and ``/requests`` (recent
        request summaries) on a stdlib ``http.server`` daemon thread —
        plus the streaming ingress ``POST /generate``: a JSON body
        (``{"prompt": [...], "max_new_tokens": ...}``) answered with a
        Server-Sent-Events token stream (``event: start`` ->
        ``data: {"token": N}`` per token -> ``event: done``; admission
        rejections arrive as ``event: rejected``), and a mid-stream
        disconnect cancels the request and frees its pages exactly like
        an async client vanishing.  Off by default; ``port=0`` picks a
        free port (read ``.port`` back from the returned exporter).

        SECURITY: binds ``127.0.0.1`` by default — metrics and request
        summaries expose workload shape; put real auth in front before
        binding a routable interface.

        Rendering happens entirely on the HTTP thread from registry
        snapshots — the engine worker does zero exporter work.  With
        ``freeze`` (default), every component registry is frozen first
        (registry-freeze invariant): all hot-path metrics are
        pre-registered, so a scrape can never race a metric being
        created at first use from the worker thread."""
        from ..observability.export import MetricsExporter, export_snapshot
        from ..observability.health import aggregate_alerts
        if self.exporter is not None:
            raise RuntimeError("exporter already attached")
        if freeze:
            for reg in self._export_registries().values():
                reg.freeze()

        def snapshot_fn():
            return {lab: export_snapshot(reg)
                    for lab, reg in self._export_registries().items()}

        def requests_fn():
            eng = self.engine
            if isinstance(eng, ServingEngine):
                tel = eng.telemetry
                return list(tel.request_summaries)[-64:] \
                    if tel is not None else []
            return list(eng._summaries)[-64:]

        def health_fn():
            h = {"worker_alive": self._thread is not None
                 and self._thread.is_alive(),
                 "open_streams": len(self._streams),
                 "worker_error": None if self._error is None
                 else str(self._error)[:200]}
            sentinels = self._sentinels()
            if sentinels:
                # degraded-aware /healthz: worst component status wins,
                # active alerts counted fleet-wide (HTTP 200 either way)
                agg = aggregate_alerts(sentinels)
                h["status"] = agg["status"]
                h["active_alerts"] = agg["active_alerts"]
            return h

        def alerts_fn():
            return aggregate_alerts(self._sentinels())

        def slow_fn():
            return self._slow_dumps()

        self.exporter = MetricsExporter(
            snapshot_fn, requests_fn=requests_fn, health_fn=health_fn,
            alerts_fn=alerts_fn, slow_fn=slow_fn,
            generate_fn=self._sse_generate,
            host=host, port=port).start()
        return self.exporter

    # -- worker ------------------------------------------------------------
    def _post(self, fn, *args) -> bool:
        """call_soon_threadsafe that tolerates a closed/gone event loop
        (teardown race: the engine may still be mid-step when asyncio.run
        returns) — the engine must never die because a client's loop
        left first."""
        loop = self._loop
        if loop is None:
            return False
        try:
            loop.call_soon_threadsafe(fn, *args)
            return True
        except RuntimeError:
            return False

    def _enqueue_cmd(self, fn):
        with self._cv:
            self._cmds.append(fn)
            self._cv.notify_all()

    def _request_cancel(self, rid: int, handle: AsyncStream | None):
        """Schedule an engine-side cancel from the event loop (or a GC
        finalizer).  Safe to call multiple times."""
        def do_cancel():
            # the disconnect may race the retirement: if the request
            # already finished, deliver the real record instead of
            # cancelling a ghost (engine.cancel would discard it)
            req = self._adapter.result(rid)
            ref = self._tracked.pop(rid, None)
            h = ref() if ref is not None else handle
            if req is None:
                self._adapter.cancel(rid)
                self.controller._pending.pop(rid, None)
                self.tracer.request_event(rid, "retired", cancelled=True)
            else:
                self.controller.resolve(rid, req)
                self.tracer.request_event(rid, "retired",
                                          tokens=len(req.generated))
            if h is not None:
                self._post(self._finish_stream, h, req)
        self._enqueue_cmd(do_cancel)

    def _finish_stream(self, stream: AsyncStream, req):
        self._streams.discard(stream)
        if not stream._done.is_set():
            stream._finish(req)

    def _sweep_retired(self):
        """Worker-side: notify streams whose request retired (finish,
        deadline, fleet resolution)."""
        if not self._tracked:
            return
        for rid in list(self._tracked):
            req = self._adapter.result(rid)
            if req is None:
                continue
            stream = self._tracked.pop(rid)()
            self.controller.resolve(rid, req)
            self.tracer.request_event(rid, "retired",
                                      tokens=len(req.generated))
            if stream is not None:        # GC-abandoned: finalizer's
                self._post(self._finish_stream, stream, req)  # cancel
                                          # command races the retirement
                                          # and resolves as a no-op

    def _fail_all(self, exc: BaseException):
        self._error = exc
        for rid, ref in list(self._tracked.items()):
            stream = ref()
            if stream is not None:
                self._post(self._finish_stream, stream, None)
            self.tracer.request_event(rid, "retired", failed=True)
        self._tracked.clear()

    def _drain_cmds_on_exit(self):
        """Run (or fail) every still-queued command before the worker
        exits: a do_submit enqueued moments before a crash/stop would
        otherwise leave its client awaiting a future nobody resolves.
        Each command owns its error delivery (do_submit's except posts
        the rejection); anything it raises beyond that is swallowed —
        the worker is already on its way out."""
        with self._cv:
            cmds, self._cmds = self._cmds, []
        for fn in cmds:
            try:
                fn()
            except BaseException:  # noqa: BLE001 — exit path, best effort
                pass

    # the worker thread OWNS _tracked/_cmds-drain/_error: every other
    # thread reaches them through _enqueue_cmd (loop->worker) or _post
    # (worker->loop) — never directly (README §Async frontend)
    def _worker(self):
        adapter = self._adapter
        while True:
            with self._cv:
                if not self._cmds and not adapter.has_work() \
                        and not self._stop:
                    self._cv.wait(timeout=self._poll)
                cmds, self._cmds = self._cmds, []
                stop = self._stop
            for fn in cmds:
                fn()
            if adapter.has_work():
                try:
                    adapter.step()
                except BaseException as exc:  # noqa: BLE001 — a dead
                    # engine must not hang every client: fail the open
                    # streams, resolve any queued commands, and stop the
                    # worker (the engine object keeps its state for
                    # postmortem; new submits raise via self._error)
                    self._fail_all(exc)
                    self._drain_cmds_on_exit()
                    return
            self._sweep_retired()
            if stop:
                # finish whatever is still open with None (closed while
                # requests were live), resolve late-enqueued commands,
                # and exit
                self._drain_cmds_on_exit()
                self._sweep_retired()
                for rid, ref in list(self._tracked.items()):
                    stream = ref()
                    if stream is not None:
                        self._post(self._finish_stream, stream, None)
                self._tracked.clear()
                return
