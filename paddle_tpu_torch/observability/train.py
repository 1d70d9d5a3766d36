"""Training-loop telemetry (port of ``paddle_tpu/observability/train.py``):
step / data-wait timing, resilience counters, checkpoint spans, and a
flight record of nonfinite / torn-snapshot events.

The serving engine's three pieces (metrics registry, tracer, flight
recorder) shaped for the TRAINING loop — ``TrainStep``, ``hapi.Model.fit``
and ``CheckpointManager`` all accept a :class:`TrainTelemetry` and hook it
at host boundaries they already stand on:

  histograms (seconds): ``train.step_s`` (one fit / TrainStep iteration,
    host wall — a real device time only where the loop already syncs, e.g.
    the non-finite guard's flag fetch or ``float(loss)``),
    ``train.data_s`` (fit's wait on the data loader), ``train.compute_s``
    (fit's train_batch call), ``ckpt.save_s`` / ``ckpt.stage_s`` /
    ``ckpt.commit_s`` / ``ckpt.restore_s`` (checkpoint spans).
  counters: ``train.steps``, ``train.samples``,
    ``train.nonfinite_skips``, ``train.nonfinite_raises``,
    ``train.scaler_backoffs``, ``ckpt.saves``, ``ckpt.restores``,
    ``ckpt.torn_snapshots``, ``ckpt.async_save_failures``.

Resilience events land in the flight recorder WITH the active
:class:`~paddle_tpu_torch.resilience.faults.FaultPlan` context (seed, specs,
fire counts); ``nonfinite_raise`` also dumps the ring — the crash artifact
for a diverged run.  Telemetry off (the default everywhere) is one ``is not
None`` check per hook site; the hooks read host timestamps and host values
only, so training numerics are the same on or off.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque

from .flight import FlightRecorder
from .metrics import MetricsRegistry
from .tracing import Tracer

__all__ = ["TrainTelemetry", "fault_context", "batch_samples"]


def batch_samples(x) -> int:
    """Leading-dim sample count of one batch input (0 when unknowable —
    scalars, 0-d arrays, non-arrays) — shape metadata only, never a device
    sync.  Shared by ``Model.fit`` and ``TrainStep`` so a 0-d batch arg
    cannot crash the telemetry-on path that telemetry-off survives."""
    first = x[0] if isinstance(x, (list, tuple)) and x else x
    shape = getattr(first, "shape", None)
    try:
        return int(shape[0]) if shape else 0
    except (TypeError, IndexError):
        return 0


def fault_context() -> dict | None:
    """The active FaultPlan, summarized for a flight event (None outside
    an ``inject()`` scope): seed, spec list, hit/fire counts — enough to
    tie a recorded skip/torn-snapshot to the drill that injected it."""
    from ..resilience.faults import active_plan
    plan = active_plan()
    if plan is None:
        return None
    return {"seed": plan.seed,
            "specs": [f"{s.point}:{s.action}" for s in plan.specs],
            "hits": plan.hits(), "fired": plan.fired()}


class TrainTelemetry:
    """Telemetry bundle for one training job: pass to
    ``TrainStep(..., telemetry=...)``, ``Model.fit(..., telemetry=...)``,
    and ``CheckpointManager(..., telemetry=...)`` (sharing one instance
    gives one clock domain and one flight record across all three)."""

    def __init__(self, clock=time.perf_counter, flight_capacity: int = 256,
                 flight_dump_path: str | None = None,
                 max_engine_events: int = 8192):
        self.clock = clock
        self.registry = MetricsRegistry(clock=clock)
        self.tracer = Tracer(clock=clock,
                             max_engine_events=max_engine_events)
        self.flight = FlightRecorder(capacity=flight_capacity, clock=clock,
                                     dump_path=flight_dump_path)
        r = self.registry
        self._h_step = r.histogram("train.step_s")
        self._h_data = r.histogram("train.data_s")
        self._h_compute = r.histogram("train.compute_s")
        self._c_steps = r.counter("train.steps")
        self._c_samples = r.counter("train.samples")
        self._c_skips = r.counter("train.nonfinite_skips")
        self._c_raises = r.counter("train.nonfinite_raises")
        self._c_backoffs = r.counter("train.scaler_backoffs")
        self._c_saves = r.counter("ckpt.saves")
        self._c_restores = r.counter("ckpt.restores")
        self._c_torn = r.counter("ckpt.torn_snapshots")
        self._c_async_fail = r.counter("ckpt.async_save_failures")
        # pre-register the checkpoint span/phase histograms: an ASYNC save
        # reports ckpt.stage/ckpt.commit from the writer thread, and the
        # phase_event fast path must then be a read-only dict get — never
        # a lazy insert into the registry while the training thread reads
        # or extends it
        for nm in ("ckpt.save_s", "ckpt.stage_s", "ckpt.commit_s",
                   "ckpt.restore_s"):
            r.histogram(nm)
        # bounded recent step summaries (throughput windows, debugging)
        self.step_log: deque[dict] = deque(maxlen=4096)
        self._win_samples = 0      # samples within the current window

    # -- train loop hooks --------------------------------------------------
    def step(self, dur_s: float, data_s: float | None = None,
             compute_s: float | None = None, samples: int = 0,
             good: bool = True):
        """One training iteration: total host wall `dur_s`, optionally
        split into data wait vs compute (fit measures both; a bare
        TrainStep only knows its own dispatch time)."""
        self._c_steps.inc()
        self._h_step.observe(dur_s)
        if data_s is not None:
            self._h_data.observe(data_s)
        if compute_s is not None:
            self._h_compute.observe(compute_s)
        if samples:
            self._c_samples.inc(int(samples))
            self._win_samples += int(samples)
        self.step_log.append({"t": self.clock(), "dur_s": float(dur_s),
                              "data_s": data_s, "compute_s": compute_s,
                              "samples": int(samples), "good": bool(good)})

    def nonfinite_skip(self, step: int, consecutive: int):
        """TrainStep's guard skipped a non-finite step (params untouched)."""
        self._c_skips.inc()
        self.flight.record("nonfinite_skip", step=int(step),
                           consecutive=int(consecutive),
                           fault_plan=fault_context())

    def nonfinite_raise(self, step: int, consecutive: int,
                        skipped_total: int) -> dict:
        """The guard gave up (M consecutive bad steps): record + auto-dump
        the flight ring — the postmortem artifact for a diverged run."""
        self._c_raises.inc()
        self.flight.record("nonfinite_raise", step=int(step),
                           consecutive=int(consecutive),
                           fault_plan=fault_context())
        return self.flight.dump("nonfinite_raise", step=int(step),
                                consecutive=int(consecutive),
                                skipped_total=int(skipped_total))

    def scaler_backoff(self, step: int):
        """GradScaler dynamic-loss-scale backoff on a skipped step."""
        self._c_backoffs.inc()
        self.flight.record("scaler_backoff", step=int(step))

    # -- checkpoint hooks --------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Timed span around a checkpoint (or any) operation: lands in the
        ``<name>_s`` histogram, the tracer's engine track, and the flight
        record — exception-safe (the span closes either way, with
        ``ok=False`` on the error path)."""
        t0 = self.clock()
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            t1 = self.clock()
            self.registry.histogram(f"{name}_s").observe(t1 - t0)
            self.tracer.engine_span(name, t0, t1, ok=ok, **attrs)
            self.flight.record(name, dur_s=round(t1 - t0, 6), ok=ok,
                               **attrs)

    def phase_event(self, name: str, dur_s: float, **attrs):
        """A sub-phase measured by the callee (the checkpoint writer's
        stage/commit durations ride `save_state_dict(on_phase=...)`)."""
        self.registry.histogram(f"{name}_s").observe(dur_s)
        self.flight.record(name, dur_s=round(float(dur_s), 6), **attrs)

    def saved(self, step: int, path: str):
        self._c_saves.inc()
        self.flight.record("ckpt.saved", step=int(step), path=str(path))

    def restored(self, step, path: str):
        """A successful restore — the flight record says WHICH snapshot a
        resumed run actually loaded (the postmortem question)."""
        self._c_restores.inc()
        self.flight.record("ckpt.restored", step=int(step),
                           path=str(path))

    def async_save_failed(self, error):
        """A pipelined background save died — detected at the NEXT
        ``wait()``/``save()`` entry, so the failure is on the record even
        though the launching span already closed ok=True (async spans
        measure launch + snapshot capture; durability is only confirmed at
        the next drain)."""
        self._c_async_fail.inc()
        self.flight.record("ckpt.async_save_failed",
                           error=str(error)[:200],
                           fault_plan=fault_context())

    def torn_snapshot(self, path: str, error):
        """A snapshot failed manifest verification during discovery —
        recorded with the fault context so chaos-sweep postmortems tie the
        rejection to the injected ckpt.write/commit fault that tore it."""
        self._c_torn.inc()
        self.flight.record("torn_snapshot", path=str(path),
                           error=str(error)[:200],
                           fault_plan=fault_context())

    # -- readouts ----------------------------------------------------------
    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def report(self, window_s: float | None = None) -> dict:
        """train.* summary: step/data/compute quantiles, the data-wait vs
        compute split, skip/backoff counters, and throughput when the
        measurement wall clock is given.  ``steps``/``samples`` and the
        derived throughput are WINDOW-scoped (what the histograms hold
        since the last :meth:`reset_window`) so dividing by ``window_s``
        is internally consistent; the engine-lifetime totals ride along as
        ``total_steps``/``total_samples``."""
        def _q(h):
            q = h.percentiles()
            return {"p50_ms": round(q[50] * 1e3, 3),
                    "p95_ms": round(q[95] * 1e3, 3),
                    "p99_ms": round(q[99] * 1e3, 3),
                    "mean_ms": round(h.mean * 1e3, 3), "count": h.count}

        busy = self._h_data.total + self._h_compute.total
        rep = {
            "steps": self._h_step.count,
            "samples": self._win_samples,
            "total_steps": self._c_steps.value,
            "total_samples": self._c_samples.value,
            "step_s": _q(self._h_step),
            "data_s": _q(self._h_data),
            "compute_s": _q(self._h_compute),
            "data_wait_frac": round(self._h_data.total / busy, 4)
            if busy else 0.0,
            "nonfinite_skips": self._c_skips.value,
            "nonfinite_raises": self._c_raises.value,
            "scaler_backoffs": self._c_backoffs.value,
            "ckpt": {"saves": self._c_saves.value,
                     "restores": self._c_restores.value,
                     "torn_snapshots": self._c_torn.value,
                     "async_save_failures": self._c_async_fail.value},
        }
        if window_s is not None and window_s > 0:
            rep["window_s"] = round(float(window_s), 6)
            rep["steps_per_sec"] = round(self._h_step.count / window_s, 3)
            rep["samples_per_sec"] = round(
                self._win_samples / window_s, 2)
        return rep

    def reset_window(self):
        """Measurement-window boundary: reset the step/data/compute
        histograms, the windowed sample count, and the step log; counters
        and the flight/trace record stay cumulative (same contract as the
        serving Telemetry)."""
        for h in (self._h_step, self._h_data, self._h_compute):
            h.reset()
        self._win_samples = 0
        self.step_log.clear()
