"""Telemetry facade the serving engine threads through its step loop.

One object bundles the three observability pieces (metrics registry,
request-lifecycle tracer, crash flight recorder) behind engine-shaped
methods, so ``inference/paged.py`` stays readable: every hook site in the
engine is one ``if tel is not None:`` flag check — telemetry OFF is a
no-op fast path with zero per-token Python work, telemetry ON records at
existing host-sync boundaries only (no new device round-trips, no new
synchronising call, and the engine's captured graphs and their replays are
untouched — telemetry is pure host code).

Metric catalog (README §Observability):

  histograms (seconds): ``serve.ttft_s``, ``serve.tpot_s``,
    ``serve.queue_s``, ``serve.prefill_s``, ``serve.e2e_s``,
    ``engine.step_host_s``, ``engine.compile_s`` (per captured dispatch
    variant: the eager warm-up run + the CUDA-graph capture),
    ``engine.phase.<name>_s`` for phases
    ``sched`` (retire+admit host work), ``prefill_chunk``,
    ``decode_dispatch`` / ``decode_sync`` / ``decode_record``,
    ``verify_dispatch`` / ``verify_sync`` / ``verify_record``, and — on
    a double-buffered engine (``overlap=True``) — ``overlap_dispatch``
    / ``overlap_sync`` / ``overlap_record`` (dispatch issue, the
    drain's event wait, and the host replay of the drained step);
    the suffix convention keeps them in the right
    ``utilization_report`` buckets automatically
  counters: ``serve.requests_submitted``, ``serve.requests_retired``,
    ``serve.requests_timed_out``, ``serve.rejections``,
    ``serve.preemptions``, ``serve.cache_evictions``, ``serve.cow_copies``,
    ``serve.flight_dumps``, ``engine.compiles``
  gauges + series: ``mem.pool_free_pages``, ``mem.pool_occupancy_frac``,
    ``mem.fragmentation_frac``, ``mem.cache_page_refs``,
    ``mem.queue_depth`` (last value), and ``mem.pool`` — the per-step
    memory-observatory :class:`~.metrics.GaugeSeries` whose tail rides
    every flight dump as the occupancy ramp
  derived reports: :meth:`Telemetry.utilization_report` (host / dispatch /
    device-wait / gap step decomposition), :meth:`Telemetry.memory_report`,
    :meth:`Telemetry.compile_report`

Flight-recorder event ladder (the degradation-ladder events land in the
ring in the order the engine walks the rungs): ``submit`` -> ``admit`` ->
``evict`` -> ``preempt`` (+ ``reject``, ``timeout``, ``fault``, ``step``,
``retire``, ``cow``).  Dumps fire automatically on ``EngineStalledError``,
preemption storms (``storm_threshold`` preemptions within ``storm_window``
engine steps), and injected faults."""
from __future__ import annotations

import time
from collections import deque

import torch

from .attribution import TailRecorder, attribution_report
from .flight import FlightRecorder
from .metrics import MetricsRegistry
from .slo import slo_report
from .tracing import NULL_CONTEXT, Tracer

__all__ = ["Telemetry", "ENGINE_PHASES"]

# every phase name the engine family emits, pre-registered at construction
# so the registry-freeze invariant holds: once a worker thread is live,
# `engine.phase.<name>_s` must never be created at first use from that
# thread (MetricsRegistry.freeze raises there).  `overlap_join_sync` is the
# reference engine's wait on its dispatch thread; this engine has no
# dispatch thread (stream order does that work), so it never emits it, but
# the registry keeps the same names.
ENGINE_PHASES = ("sched", "prefill_dense", "prefill_chunk",
                 "decode_dispatch", "decode_sync", "decode_record",
                 "verify_dispatch", "verify_sync", "verify_record",
                 "overlap_dispatch", "overlap_sync", "overlap_record",
                 "overlap_join_sync")


class Telemetry:
    """Serving-engine telemetry: pass ``telemetry=Telemetry(...)`` (or
    ``telemetry=True`` for defaults) to :class:`ServingEngine`.

    ``clock`` is injectable for deterministic tests and is shared by the
    registry, tracer, and flight recorder, so one fake clock drives every
    timestamp.  ``profiler_bridge=True`` additionally wraps engine
    dispatch phases in ``paddle_tpu_torch.profiler`` annotations
    (``torch.profiler.record_function``)."""

    def __init__(self, clock=time.perf_counter, flight_capacity: int = 256,
                 flight_dump_path: str | None = None,
                 storm_threshold: int = 4, storm_window: int = 32,
                 profiler_bridge: bool = False, max_completed: int = 4096,
                 mem_series_capacity: int = 4096, mem_ramp_events: int = 64,
                 tail_k: int = 8):
        self.clock = clock
        self.registry = MetricsRegistry(clock=clock)
        self.tracer = Tracer(clock=clock, bridge=profiler_bridge,
                             max_completed=max_completed)
        self.flight = FlightRecorder(capacity=flight_capacity, clock=clock,
                                     dump_path=flight_dump_path)
        self.storm_threshold = int(storm_threshold)
        self.storm_window = int(storm_window)
        self._preempt_steps: deque[int] = deque()
        self._storm_dumped_at = -(1 << 60)   # "never" (one dump per storm)
        # per-request summaries for exact SLO/goodput accounting (bounded)
        self.request_summaries: deque[dict] = deque(maxlen=max_completed)
        r = self.registry
        self._h_ttft = r.histogram("serve.ttft_s")
        self._h_tpot = r.histogram("serve.tpot_s")
        self._h_queue = r.histogram("serve.queue_s")
        self._h_prefill = r.histogram("serve.prefill_s")
        self._h_e2e = r.histogram("serve.e2e_s")
        self._h_step = r.histogram("engine.step_host_s")
        # tokens per prefill dispatch, WINDOW-scoped like the phase
        # histograms (reset together): its total over the prefill phase
        # totals is the windowed prefill tokens/s the admission
        # predictor needs — the engine's prefill_tokens counter is
        # lifetime-cumulative and would inflate the rate after any
        # reset_window()
        self._h_prefill_tok = r.histogram(
            "engine.prefill_tokens_per_dispatch", unit="tokens", lo=1.0)
        self._phase_h = {}
        # pre-register every engine phase histogram (registry-freeze
        # invariant: phase() must never CREATE a metric from a worker
        # thread after freeze() — it only fetches these).  _phase_h stays
        # lazy so utilization_report keeps listing only phases that ran.
        for name in ENGINE_PHASES:
            r.histogram(f"engine.phase.{name}_s")
        self._c_submitted = r.counter("serve.requests_submitted")
        self._c_retired = r.counter("serve.requests_retired")
        self._c_timed_out = r.counter("serve.requests_timed_out")
        self._c_rejections = r.counter("serve.rejections")
        self._c_preemptions = r.counter("serve.preemptions")
        self._c_evictions = r.counter("serve.cache_evictions")
        self._c_cow = r.counter("serve.cow_copies")
        self._c_dumps = r.counter("serve.flight_dumps")
        # compile accounting: every CUDA-graph capture of an engine dispatch
        # (a decode horizon or the verify step) lands here with its wall
        # cost (warm-up run + capture), so the report shows WHERE warm-up
        # time went and a steady-state capture is visible in the flight
        # record
        self._h_compile = r.histogram("engine.compile_s")
        self._c_compiles = r.counter("engine.compiles")
        self._compiles: dict[str, dict] = {}
        # memory observatory: one GaugeSeries row per engine step (pool
        # occupancy / fragmentation / cache / queue), sampled at the step's
        # END — an existing host boundary, no device sync; flight dumps
        # embed the tail of this series as the occupancy RAMP
        self.memory = r.series("mem.pool", capacity=mem_series_capacity)
        self.mem_ramp_events = int(mem_ramp_events)
        self._g_free = r.gauge("mem.pool_free_pages")
        self._g_occ = r.gauge("mem.pool_occupancy_frac")
        self._g_frag = r.gauge("mem.fragmentation_frac")
        self._g_cache = r.gauge("mem.cache_page_refs")
        self._g_queue = r.gauge("mem.queue_depth")
        # BYTES, not just page counts: pages × page_bytes for the engine's
        # active kv_dtype — the gauge a quantized page store moves, where a
        # page count alone would hide the capacity win
        self._g_alloc_bytes = r.gauge("mem.pool_allocated_bytes")
        self._g_cap_bytes = r.gauge("mem.pool_capacity_bytes")
        # double-buffered host loop: decode dispatches in flight at the
        # step's end (0 on a synchronous engine, 0/1 at depth 1) — the
        # liveness companion to the engine.phase.overlap_* histograms
        self._g_inflight = r.gauge("engine.inflight_depth")
        self._nested_dispatch_s = 0.0   # dispatch time inside a sched span
        # tail-outlier capture: the top-K slowest requests auto-captured at
        # retirement with span chain + attribution + engine-state context
        # (O(log K) heap check per retire; OFF with tail_k=0)
        self.tail = TailRecorder(k=tail_k, clock=clock) if tail_k else None

    def attribution_report(self, top_k: int = 5) -> dict:
        """Aggregate critical-path attribution over every completed
        request on this engine's tracer (observability.attribution)."""
        return attribution_report(self.tracer, top_k=top_k)

    # -- low-level ---------------------------------------------------------
    def phase(self, name: str, t0: float, t1: float, **attrs):
        h = self._phase_h.get(name)
        if h is None:
            h = self.registry.histogram(f"engine.phase.{name}_s")
            self._phase_h[name] = h
        h.observe(t1 - t0)
        self.tracer.engine_span(name, t0, t1, **attrs)

    def sched_begin(self) -> float:
        """Start of a step's scheduling window (deadline sweep +
        admissions); returns the start timestamp.  Admission can run
        prefill DISPATCHES inside this window — they record their own
        phase spans and accumulate into ``_nested_dispatch_s``, which
        :meth:`sched_done` subtracts so the ``sched`` histogram holds pure
        host scheduling time and the utilization buckets stay DISJOINT
        (no second-counted seconds)."""
        self._nested_dispatch_s = 0.0
        return self.clock()

    def sched_done(self, t0: float, t1: float):
        nested = self._nested_dispatch_s
        self._nested_dispatch_s = 0.0
        h = self._phase_h.get("sched")
        if h is None:
            h = self.registry.histogram("engine.phase.sched_s")
            self._phase_h["sched"] = h
        h.observe(max(0.0, (t1 - t0) - nested))
        # the trace span keeps the full wall extent (visual truth: nested
        # prefill spans draw inside it on the engine track)
        self.tracer.engine_span("sched", t0, t1,
                                nested_dispatch_s=round(nested, 6))

    def bridge_begin(self, name: str):
        """Enter a ``paddle_tpu_torch.profiler.host_annotation`` span
        (bridge on only) around a dispatch the caller times manually;
        returns the entered context (pass it to :meth:`bridge_end`) or None
        when the bridge is off.  The engine brackets its dispatch calls with
        these so host phases land in any active ``torch.profiler`` trace
        around the kernels they launched."""
        ann = self.tracer.annotation(f"serve.{name}")
        if ann is NULL_CONTEXT:
            return None
        ann.__enter__()
        return ann

    @staticmethod
    def bridge_end(ann):
        if ann is not None:
            ann.__exit__(None, None, None)

    def request_event(self, rid: int, name: str, t: float | None = None,
                      **attrs):
        self.tracer.request_event(rid, name, t=t, **attrs)

    def _dump(self, reason: str, **extra) -> dict:
        self._c_dumps.inc()
        ramp = self.memory.tail(self.mem_ramp_events)
        if ramp:
            # the occupancy ramp that led here — a pool-pressure postmortem
            # needs the trajectory, not just the final free-page count
            extra = dict(extra)
            extra["memory_ramp"] = ramp
        return self.flight.dump(reason, **extra)

    # -- compile accounting ------------------------------------------------
    def compiled(self, name: str, n: int, dur_s: float):
        """One dispatch variant built (the engine's CUDA-graph capture of
        a decode horizon or the verify step): `n` new variants for model
        fn `name`, costing `dur_s` wall seconds (the eager warm-up run +
        the capture — what building it cost the caller)."""
        self._c_compiles.inc(n)
        self._h_compile.observe(dur_s)
        e = self._compiles.setdefault(name, {"count": 0, "total_s": 0.0})
        e["count"] += n
        e["total_s"] += dur_s
        self.flight.record("compile", fn=name, variants=n,
                           dur_s=round(dur_s, 6))

    def compile_report(self) -> dict:
        """Cumulative per-fn capture counts/durations (engine lifetime —
        deliberately NOT window-scoped: warm-up captures are the bulk and
        a timed-window capture shows up in `jit_variants()`)."""
        return {
            "total_compiles": self._c_compiles.value,
            "compile_s_total": round(self._h_compile.total, 6),
            "compile_s_max": round(self._h_compile.max, 6)
            if self._h_compile.count else 0.0,
            "per_fn": {k: {"count": v["count"],
                           "total_s": round(v["total_s"], 6)}
                       for k, v in sorted(self._compiles.items())},
        }

    # -- memory observatory ------------------------------------------------
    @staticmethod
    def _device_bytes(engine):
        """Bytes the caching allocator holds in live tensors on a CUDA
        engine's device (``torch.cuda.memory_allocated``: an allocator
        counter, no sync), or None for an engine on the CPU."""
        dev = getattr(engine, "device", None)
        if dev is None or dev.type != "cuda":
            return None
        return int(torch.cuda.memory_allocated(dev))

    def sample_memory(self, engine):
        """One memory-observatory row at an engine-step end (host state
        reads only — the pool/cache/queue live on the host, and the
        allocator's byte counter is a host read, not a device sync)."""
        t = self.clock()
        pool = engine.pool
        total = pool.num_pages
        free = pool.num_free
        cache = engine.cache
        cache_refs = len(cache) if cache is not None else 0
        slot_pages = 0
        slot_tokens = 0
        for s, slot in enumerate(engine._slots):
            if slot is not None:
                slot_pages += len(slot.pages)
                slot_tokens += int(engine._lengths[s])
        # internal fragmentation: token capacity the live page tables hold
        # but no sequence fills (tail-of-page waste) — pages are fixed-size
        # so this, not external fragmentation, is the waste axis
        frag = 1.0 - slot_tokens / (slot_pages * pool.page_size) \
            if slot_pages else 0.0
        occ = (total - free) / total
        # occupancy in BYTES (pages x page_bytes for the active kv_dtype):
        # a quantized page store's capacity win must be visible in mem.*
        # gauges, not just in page counts
        pb = int(getattr(engine, "page_bytes", 0) or 0)
        fields = dict(
            step=engine._step_seq, total_pages=total, free_pages=free,
            allocated_pages=pool.num_allocated,
            referenced=pool.num_referenced, cache_page_refs=cache_refs,
            page_bytes=pb,
            pool_allocated_bytes=pool.num_allocated * pb,
            pool_capacity_bytes=total * pb,
            occupancy_frac=round(occ, 4),
            fragmentation_frac=round(frag, 4), slot_tokens=slot_tokens,
            queue_depth=len(engine._queue), active=engine.num_active,
            # cumulative prefix-cache accounting per row: windowed hit
            # rates are deltas of these (Δhit / Δ(hit+executed))
            cache_hit_tokens=engine.cache_hit_tokens,
            prefill_tokens_executed=engine.prefill_tokens)
        dev = self._device_bytes(engine)
        if dev is not None:
            fields["device_bytes_in_use"] = dev
        self.memory.sample(t, **fields)
        self._g_free.set(free)
        self._g_occ.set(occ)
        self._g_frag.set(frag)
        self._g_cache.set(cache_refs)
        self._g_queue.set(len(engine._queue))
        self._g_alloc_bytes.set(pool.num_allocated * pb)
        self._g_cap_bytes.set(total * pb)
        # Perfetto counter tracks next to the request spans
        self.tracer.counter("pagepool.pages", t, used=total - free,
                            free=free, cached=cache_refs)
        self.tracer.counter("engine.load", t, queue_depth=len(engine._queue),
                            active=engine.num_active)

    def memory_report(self, engine_stats: dict | None = None) -> dict:
        """Memory-observatory summary over the retained series (the
        current measurement window after `reset_window()`): last sample,
        occupancy/fragmentation peaks, free-page floor — plus prefix-cache
        hit accounting when the engine's `stats()` dict is passed."""
        rows = self.memory.rows()
        rep = {"samples": len(rows),
               "total_samples": self.memory.total_samples,
               "last": rows[-1] if rows else None}
        for key, field, fn in (("peak_occupancy_frac", "occupancy_frac", max),
                               ("peak_fragmentation_frac",
                                "fragmentation_frac", max),
                               ("min_free_pages", "free_pages", min)):
            mm = self.memory.field_minmax(field)
            rep[key] = (mm[1] if fn is max else mm[0]) if mm else None
        if engine_stats is not None:
            hit = int(engine_stats.get("cached_prefix_tokens", 0))
            run = int(engine_stats.get("prefill_tokens_executed", 0))
            rep["prefix_cache"] = {
                "hit_tokens": hit, "executed_tokens": run,
                "hit_rate": round(hit / (hit + run), 4) if hit + run else 0.0,
                "evictions": int(engine_stats.get("cache_evictions", 0)),
            }
        return rep

    # -- engine lifecycle hooks --------------------------------------------
    def submitted(self, req, queue_depth: int):
        self._c_submitted.inc()
        attrs = dict(prompt_tokens=len(req.prompt),
                     max_new_tokens=req.max_new_tokens)
        if req.generated:
            # a mid-flight adoption (`adopt`): the record starts with
            # tokens already emitted elsewhere — the attribution analyzer
            # reads this to label the residency
            attrs["resumed_tokens"] = len(req.generated)
        if getattr(req, "trace_id", None) is not None:
            # cross-component trace stitching: the trace_id rides the
            # request record, binding this engine's span to the spans other
            # components record for the same request
            attrs["trace_id"] = req.trace_id
        self.tracer.request_event(req.rid, "submitted", t=req.submit_time,
                                  **attrs)
        self.tracer.request_event(req.rid, "queued", t=req.submit_time,
                                  depth=queue_depth)
        self.flight.record("submit", rid=req.rid,
                           prompt_tokens=len(req.prompt), depth=queue_depth)

    def rejected(self, queue_depth: int, max_queue: int):
        self._c_rejections.inc()
        t = self.clock()
        self.tracer.engine_event("rejected", t=t, depth=queue_depth,
                                 max_queue=max_queue)
        self.flight.record("reject", depth=queue_depth, max_queue=max_queue)

    def admitted(self, req, slot: int, t: float, resuming: bool,
                 first: bool, cached_tokens: int, prefill_tokens: int):
        if first:
            # FIRST admission only: t - submit is the queue wait TTFT used
            # to hide inside first_token_time.  `first` is the engine's
            # admit_time==0 predicate, NOT `not resuming` — a preemption
            # victim evicted before emitting anything re-admits with
            # resuming=False but must not re-observe (inflated) queue wait.
            self._h_queue.observe(t - req.submit_time)
        self.tracer.request_event(req.rid, "admitted", t=t, slot=slot,
                                  resuming=resuming, first=first,
                                  cached_tokens=cached_tokens,
                                  prefill_tokens=prefill_tokens)
        if cached_tokens:
            self.tracer.request_event(req.rid, "cache_hit", t=t,
                                      tokens=cached_tokens)
        self.flight.record("admit", rid=req.rid, slot=slot,
                           resuming=resuming, cached_tokens=cached_tokens,
                           prefill_tokens=prefill_tokens)

    def prefill_dispatch(self, rid: int, pos: int, tokens: int, t0: float,
                         kind: str = "prefill_chunk"):
        """One prefill dispatch's host span (kind: ``prefill_chunk`` for
        the chunked/suffix path, ``prefill_dense`` for the fused
        whole-prompt prefill+sample)."""
        t1 = self.clock()
        self._nested_dispatch_s += t1 - t0
        self._h_prefill_tok.observe(tokens)
        self.phase(kind, t0, t1, rid=rid, tokens=tokens)
        self.tracer.request_event(rid, kind, t=t1, pos=pos,
                                  tokens=tokens, dur=t1 - t0)

    def first_token(self, req):
        t = req.first_token_time
        self._h_ttft.observe(t - req.submit_time)
        if req.admit_time:
            self._h_prefill.observe(t - req.admit_time)
        self.tracer.request_event(req.rid, "first_token", t=t,
                                  ttft_s=t - req.submit_time)

    def cow_copy(self, rid: int, src: int, dst: int):
        self._c_cow.inc()
        self.tracer.request_event(rid, "cow_copy", src=src, dst=dst)
        self.flight.record("cow", rid=rid, src=src, dst=dst)

    def evicted(self, requested: int, freed: int):
        self._c_evictions.inc(freed)
        t = self.clock()
        self.tracer.engine_event("cache_evict", t=t, requested=requested,
                                 freed=freed)
        self.flight.record("evict", requested=requested, freed=freed)

    def preempted(self, req, step: int) -> dict | None:
        """Record a preemption; detect storms (``storm_threshold``
        preemptions within the last ``storm_window`` engine steps) and
        auto-dump once per storm.  Returns the dump when one fired."""
        self._c_preemptions.inc()
        self.tracer.request_event(req.rid, "preempted",
                                  generated=len(req.generated),
                                  preemptions=req.preemptions)
        self.flight.record("preempt", rid=req.rid, step=step,
                           generated=len(req.generated))
        q = self._preempt_steps
        q.append(step)
        while q and q[0] < step - self.storm_window:
            q.popleft()
        if len(q) >= self.storm_threshold \
                and self._storm_dumped_at < step - self.storm_window:
            self._storm_dumped_at = step
            return self._dump("preemption_storm", step=step,
                              preemptions_in_window=len(q),
                              window_steps=self.storm_window)
        return None

    def retired(self, req, reason: str = "retired"):
        t = req.retire_time or self.clock()
        self._c_retired.inc()
        tokens = len(req.generated)
        ttft = (req.first_token_time - req.submit_time) \
            if req.first_token_time else None
        tpot = req.tpot or None
        e2e = t - req.submit_time
        self._h_e2e.observe(e2e)
        if tpot:
            self._h_tpot.observe(tpot)
        if req.timed_out:
            self._c_timed_out.inc()
            self.tracer.request_event(req.rid, "deadline",
                                      generated=tokens)
            self.flight.record("timeout", rid=req.rid, tokens=tokens)
        self.tracer.request_event(req.rid, "retired", t=t, tokens=tokens,
                                  timed_out=req.timed_out,
                                  preemptions=req.preemptions)
        self.flight.record("retire", rid=req.rid, tokens=tokens,
                           timed_out=req.timed_out)
        summary = {
            "rid": req.rid, "tokens": tokens, "ttft_s": ttft,
            "tpot_s": tpot, "e2e_s": e2e,
            "queue_s": req.queue_time or None,
            "timed_out": req.timed_out, "preemptions": req.preemptions,
            "cached_prefix_tokens": req.cached_prefix_tokens,
            # retirement stamp: the burn-rate detector windows on this
            "at": t,
        }
        self.request_summaries.append(summary)
        if self.tail is not None:
            # the record the retired event just completed sits at the top
            # of the done ring — O(1), no linear rid scan
            done = self.tracer._done
            tr = done[-1] if done and done[-1].rid == req.rid \
                else self.tracer.get(req.rid)
            if tr is not None:
                self.tail.offer(summary, tr, self.tracer,
                                context=self.memory.last)

    def cancelled(self, rid: int):
        """A request cancelled mid-flight (client disconnect / zombie
        prune): terminate its trace record — cancels are terminal, and a
        live-table ghost would grow the tracer unboundedly — and flight-
        record the cancellation.  No latency histograms: a cancel is not
        a completion."""
        self.tracer.request_event(rid, "retired", cancelled=True)
        self.flight.record("cancel", rid=rid)

    def step_done(self, engine, t0: float, progressed: bool,
                  tokens: int):
        t1 = self.clock()
        self._h_step.observe(t1 - t0)
        self.tracer.engine_span("step", t0, t1,
                                step=engine._step_seq,
                                progressed=progressed, tokens=tokens)
        # memory observatory sample BEFORE the step/fault records, so a
        # pool-pressure dump's ramp already includes this step's occupancy
        self.sample_memory(engine)
        inflight = getattr(engine, "inflight_depth", 0)
        self._g_inflight.set(inflight)
        self.flight.record("step", step=engine._step_seq,
                           progressed=progressed, tokens=tokens,
                           active=engine.num_active,
                           queued=len(engine._queue),
                           free_pages=engine.pool.num_free,
                           inflight=inflight)
        if engine._pressure:
            self.flight.record("fault", point="serve.pool_pressure",
                               step=engine._step_seq)
            self._dump("injected_fault", point="serve.pool_pressure",
                       step=engine._step_seq)

    def fault_dump(self, reason: str, **extra) -> dict:
        return self._dump(reason, **extra)

    def reset_window(self):
        """Start a fresh measurement window: clear the per-request SLO
        summaries and reset the latency histograms (step/phase/request)
        and the memory series, so `slo_report`, `utilization_report`,
        `memory_report`, and the histogram snapshots describe the window —
        not the warm-up compiles that preceded it.  Counters, the compile
        record, and the tracer/flight record stay cumulative (they are
        event history, not window statistics)."""
        self.request_summaries.clear()
        for h in (self._h_ttft, self._h_tpot, self._h_queue,
                  self._h_prefill, self._h_e2e, self._h_step,
                  self._h_prefill_tok, *self._phase_h.values()):
            h.reset()
        self.memory.reset()
        if self.tail is not None:
            # warm-pass outliers (compile-inflated) must not shadow the
            # measured window's true tail
            self.tail.reset()

    # -- readouts ----------------------------------------------------------
    def utilization_report(self, window_s: float | None = None) -> dict:
        """Host/device step decomposition over the current measurement
        window — the overlap-headroom readout.

        Every engine phase histogram (host timestamps at the EXISTING
        sync boundaries only) lands in one of three buckets:

          * ``host_busy_s`` — pure host scheduling/bookkeeping (``sched``,
            ``*_record``): the device has nothing to run that this engine
            dispatched;
          * ``dispatch_s`` — time inside dispatch calls (``*_dispatch``,
            ``prefill_*``): the launch cost on a CUDA device (launches are
            asynchronous), launch + execution where dispatch runs inline
            (the CPU) — counted here, honestly over- rather than
            under-stating device busyness;
          * ``device_wait_s`` — host blocked fetching results at the
            engine's sync points (``*_sync``: the drain's event wait, the
            verify step's token copy): the only bucket where the device is
            PROVABLY the bottleneck.

        With ``window_s`` (the measured wall clock), ``gap_s`` is the
        unaccounted remainder (inter-step host work, caller bookkeeping)
        and ``device_idle_frac_est`` = (host_busy + gap) / window — the
        fraction of the window the device provably had nothing dispatched
        to run, i.e. the headroom a double-buffered host loop
        (``overlap=True``) can reclaim."""
        host = disp = wait = 0.0
        per_phase = {}
        for name in sorted(self._phase_h):
            h = self._phase_h[name]
            per_phase[name] = {"total_s": round(h.total, 6),
                               "count": h.count}
            if name.endswith("_sync"):
                wait += h.total
            elif name.endswith("_dispatch") or name.startswith("prefill"):
                disp += h.total
            else:
                host += h.total
        rep = {"steps": self._h_step.count,
               "step_host_s_total": round(self._h_step.total, 6),
               "host_busy_s": round(host, 6),
               "dispatch_s": round(disp, 6),
               "device_wait_s": round(wait, 6),
               "per_phase": per_phase}
        if window_s is not None and window_s > 0:
            gap = max(0.0, window_s - (host + disp + wait))
            rep["window_s"] = round(float(window_s), 6)
            rep["gap_s"] = round(gap, 6)
            rep["host_busy_frac"] = round(host / window_s, 4)
            rep["dispatch_frac"] = round(disp / window_s, 4)
            rep["device_wait_frac"] = round(wait / window_s, 4)
            rep["gap_frac"] = round(gap / window_s, 4)
            rep["device_idle_frac_est"] = round((host + gap) / window_s, 4)
        return rep

    def snapshot(self, engine_stats: dict | None = None) -> dict:
        """Full metrics snapshot; when the engine's ``stats()`` dict is
        passed, its counters fold in under ``engine.*`` so one artifact
        carries both views."""
        snap = self.registry.snapshot()
        if engine_stats is not None:
            for k, v in engine_stats.items():
                if isinstance(v, dict):
                    for k2, v2 in v.items():
                        snap[f"engine.{k}.{k2}"] = v2
                else:
                    snap[f"engine.{k}"] = v
        return snap

    def slo_report(self, ttft_deadline_s: float,
                   window_s: float | None = None) -> dict:
        """TTFT/TPOT/E2E quantiles + goodput at the deadline, plus the
        engine step-latency quantiles (host)."""
        rep = slo_report(self.request_summaries, ttft_deadline_s,
                         window_s=window_s)
        q = self._h_step.percentiles()
        rep["step_latency"] = {"p50_ms": round(q[50] * 1e3, 3),
                               "p95_ms": round(q[95] * 1e3, 3),
                               "p99_ms": round(q[99] * 1e3, 3),
                               "count": self._h_step.count}
        return rep
