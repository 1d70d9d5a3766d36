"""Crash flight recorder: a bounded ring buffer of recent engine-step
events that dumps automatically when something goes wrong.

The resilience layer makes the serving engine self-healing — but when
a run does die (``EngineStalledError``, an injected fault that never
cleared) the counters alone say *how many* preemptions happened, never *what the engine was
doing right before it stalled*.  The flight recorder keeps the last
``capacity`` events (admissions, evictions, preemptions, rejections,
deadline retirements, per-step summaries, faults) in a ring; on a trigger
the engine calls :meth:`FlightRecorder.dump`, which snapshots the ring into
``dumps`` (bounded) and optionally appends a JSON line to ``dump_path``.

Recording is O(1) (deque append of a small dict); the ring holds plain
Python values only — no device arrays, no syncs."""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring of recent engine events + bounded dump history."""

    def __init__(self, capacity: int = 256, clock=time.perf_counter,
                 max_dumps: int = 8, dump_path: str | None = None):
        self.capacity = int(capacity)
        self.clock = clock
        self.max_dumps = int(max_dumps)
        self.dump_path = dump_path
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._seq = 0
        self.dumps: list[dict] = []
        # engines, fleet watchdogs and exporter scrape threads all hit
        # one recorder: the seq counter, the ring snapshot (iterating a
        # deque while another thread appends raises RuntimeError) and
        # the dump-history trim must be atomic
        self._lock = threading.Lock()

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def record(self, event: str, **attrs):
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "t": float(self.clock()),
                   "event": event}
            if attrs:
                rec.update(attrs)
            self._ring.append(rec)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def event_names(self) -> list[str]:
        with self._lock:
            return [r["event"] for r in self._ring]

    def dump(self, reason: str, **extra) -> dict:
        """Snapshot the ring (the full recent-event window) under `reason`.
        Returns the dump dict; also kept in ``self.dumps`` (last
        ``max_dumps``) and appended as one JSON line to ``dump_path`` when
        configured — the artifact a postmortem actually reads."""
        with self._lock:
            d = {"reason": reason, "at": float(self.clock()),
                 "total_events": self._seq, "events": list(self._ring)}
            if extra:
                d["extra"] = dict(extra)
            self.dumps.append(d)
            if len(self.dumps) > self.max_dumps:
                del self.dumps[: len(self.dumps) - self.max_dumps]
        if self.dump_path:
            try:
                with open(self.dump_path, "a") as f:
                    json.dump(d, f)
                    f.write("\n")
            except OSError:
                pass        # a full disk must never take the engine down
        return d

    def last_dump(self) -> dict | None:
        return self.dumps[-1] if self.dumps else None

    @staticmethod
    def format_dump(d: dict) -> str:
        """Human-readable rendering of one dump (README §Observability
        documents how to read it)."""
        lines = [f"flight-recorder dump: {d['reason']} at t={d['at']:.6f} "
                 f"({len(d['events'])} of {d['total_events']} events "
                 f"retained)"]
        for e in d["events"]:
            attrs = {k: v for k, v in e.items()
                     if k not in ("seq", "t", "event")}
            lines.append(f"  #{e['seq']:>6} t={e['t']:.6f} {e['event']:<12}"
                         + (f" {attrs}" if attrs else ""))
        if "extra" in d:
            lines.append(f"  extra: {d['extra']}")
        return "\n".join(lines)
