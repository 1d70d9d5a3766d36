"""Traffic harness: seeded, replayable serving scenarios at 10k+ scale.

A serving gate shaped like "goodput-under-SLO on realistic traffic" needs
traffic that is (a) realistic —
bursty and diurnal arrival processes, shared-prefix user fleets, mixed
greedy/sampled/long-context requests, streaming clients that abandon
mid-decode — and (b) REPLAYABLE: one integer seed pins the entire
scenario (arrival schedule, prompts, sampling params, abandon points)
with zero wall-clock leakage, so two policies, two engines, or two builds
can be compared on the identical offered load.

Three layers:

  * :func:`make_scenario` — pure generation: a :class:`Scenario` is a
    list of :class:`ClientRequest` rows derived from ONE
    ``np.random.default_rng(seed)`` stream.  ``Scenario.signature()``
    SHA-256-fingerprints every replay-relevant byte (the determinism
    tests pin ``make_scenario(seed) == make_scenario(seed)`` through it).
  * :func:`replay_engine` — drive a real :class:`ServingEngine` through a
    scenario.  Arrivals are paced in TOKEN TIME (request i is submitted
    once the engine has generated ``arrival_s * load_tps`` tokens —
    machine-independent offered load), admission goes through an
    :class:`~paddle_tpu_torch.serving.frontend.AdmissionController`, and
    abandon clients cancel their request mid-decode through the engine's
    ``cancel()`` (deferred to the step boundary: ``on_token`` fires
    inside the drain and must never re-enter the engine).
  * :func:`replay_sim` — the same scenario against an analytic
    S-slot server model on a VIRTUAL clock: no device, no wall time,
    deterministic to the last float.  It exercises the real
    :class:`~paddle_tpu_torch.serving.frontend.AdmissionController` /
    :class:`~paddle_tpu_torch.serving.frontend.TTFTPredictor` code path at
    10k+ requests in well under a second — the scale the tier-1 lane
    cannot afford to push through a real engine (that replay is
    slow-marked).
"""
from __future__ import annotations

import hashlib
import heapq
import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["ClientRequest", "Scenario", "VirtualClock", "make_scenario",
           "replay_engine", "replay_fleet", "replay_sim", "goodput_report"]


class VirtualClock:
    """Round-driven virtual time for fleet replays.

    On a shared host every replica time-slices one CPU, so wall-clock
    fleet economics are a lie: an N-replica fleet's heartbeat costs ~N×
    the wall time of a 1-replica fleet's, which would bill the elastic
    arm for parallelism the simulation cannot express.  The virtual
    clock models the real deployment instead — each replica is its own
    machine, all stepping CONCURRENTLY — by advancing a fixed ``dt``
    per fleet round regardless of replica count.  Inject it as the
    fleet's ``clock=`` (request timestamps, TTFT, ``replica_seconds``
    all move to the virtual domain) and hand it to
    :func:`replay_fleet` (arrival pacing + idle jumps); every metric the
    elastic A/B gates on then becomes DETERMINISTIC: same seed, same
    scale-event timeline, same goodput-per-replica-hour, on any host."""

    def __init__(self, dt: float = 1.0):
        self.t = 0.0
        self.dt = float(dt)

    def __call__(self) -> float:
        return self.t

    def tick(self):
        self.t += self.dt

    def advance_to(self, t: float):
        self.t = max(self.t, float(t))


@dataclass
class ClientRequest:
    """One scenario row: everything a replay needs to submit (and maybe
    abandon) the request.  ``arrival_s`` is on the SCENARIO clock —
    replays map it to token time (engine) or a virtual clock (sim)."""
    idx: int
    arrival_s: float
    prompt: np.ndarray                 # int32 [T]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    slo_ttft_s: float | None = None    # per-request TTFT deadline override
    abandon_after: int | None = None   # client disconnects after streaming
                                       #   this many tokens (None: stays)
    user: int | None = None            # shared-prefix fleet user id
    kind: str = "short"                # short | long | sampled


@dataclass
class Scenario:
    """A named, seeded batch of :class:`ClientRequest` rows (arrival-time
    ordered) plus the generation knobs that produced them."""
    name: str
    seed: int
    requests: list[ClientRequest] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].arrival_s if self.requests else 0.0

    def offered_tokens(self) -> int:
        return sum(r.max_new_tokens for r in self.requests)

    def signature(self) -> str:
        """SHA-256 over every replay-relevant field of every request —
        identical seeds MUST yield identical signatures (the determinism
        contract; no wall clock, host, or dict-order leakage)."""
        h = hashlib.sha256()
        h.update(self.name.encode())
        h.update(str(self.seed).encode())
        for r in self.requests:
            h.update(np.float64(r.arrival_s).tobytes())
            h.update(np.ascontiguousarray(r.prompt, np.int32).tobytes())
            h.update(np.int64(r.max_new_tokens).tobytes())
            h.update(np.float64(r.temperature).tobytes())
            h.update(np.float64(r.top_p).tobytes())
            h.update(np.float64(-1.0 if r.slo_ttft_s is None
                                else r.slo_ttft_s).tobytes())
            h.update(np.int64(-1 if r.abandon_after is None
                              else r.abandon_after).tobytes())
            h.update(np.int64(-1 if r.user is None else r.user).tobytes())
            h.update(r.kind.encode())
        return h.hexdigest()


def _arrivals(rng, n: int, arrival: str, mean_interarrival_s: float,
              burst_every_s: float, burst_size: int, burst_spread_s: float,
              diurnal_period_s: float, diurnal_amplitude: float):
    """Arrival offsets (seconds, sorted, starting at 0) for the three
    supported processes.

      * ``poisson`` — homogeneous: exp(mean) inter-arrivals.
      * ``bursty``  — the poisson base plus a burst of ``burst_size``
        arrivals every ``burst_every_s``, packed into ``burst_spread_s``
        (flash-crowd traffic; the burst members come out of the SAME
        request budget ``n``, so offered totals stay comparable across
        processes).
      * ``diurnal`` — non-homogeneous poisson with rate(t) = base *
        (1 + amplitude * sin(2*pi*t / period)), via per-step thinning of
        the instantaneous rate (peak/trough traffic over one or more
        simulated days, squeezed to ``period``).
    """
    if n <= 0:
        return np.zeros((0,), np.float64)
    if arrival == "poisson":
        gaps = rng.exponential(mean_interarrival_s, n)
        gaps[0] = 0.0
        return np.cumsum(gaps)
    if arrival == "bursty":
        n_bursts = max(1, int(n // max(1, 4 * burst_size)))
        n_burst_reqs = min(n - 1, n_bursts * burst_size)
        n_base = n - n_burst_reqs
        gaps = rng.exponential(mean_interarrival_s, n_base)
        gaps[0] = 0.0
        base = np.cumsum(gaps)
        ts = [base]
        for b in range(n_bursts):
            t0 = (b + 1) * burst_every_s
            k = min(burst_size, n_burst_reqs - b * burst_size)
            if k <= 0:
                break
            ts.append(t0 + np.sort(rng.uniform(0.0, burst_spread_s, k)))
        return np.sort(np.concatenate(ts))[:n]
    if arrival == "diurnal":
        base_rate = 1.0 / mean_interarrival_s
        out = np.empty((n,), np.float64)
        t = 0.0
        # thinning: draw from the PEAK rate, accept with rate(t)/peak
        peak = base_rate * (1.0 + diurnal_amplitude)
        i = 0
        out[0] = 0.0
        i = 1
        while i < n:
            t += rng.exponential(1.0 / peak)
            rate = base_rate * (1.0 + diurnal_amplitude
                                * math.sin(2.0 * math.pi * t
                                           / diurnal_period_s))
            if rng.uniform() * peak <= max(rate, 1e-9):
                out[i] = t
                i += 1
        return out
    raise ValueError(f"unknown arrival process {arrival!r} "
                     f"(expected poisson | bursty | diurnal)")


def make_scenario(name: str, *, seed: int, n_requests: int, vocab: int,
                  arrival: str = "poisson",
                  mean_interarrival_s: float = 0.5,
                  burst_every_s: float = 10.0, burst_size: int = 8,
                  burst_spread_s: float = 0.25,
                  diurnal_period_s: float = 60.0,
                  diurnal_amplitude: float = 0.9,
                  prompt_len: tuple[int, int] = (8, 48),
                  max_new: tuple[int, int] = (8, 24),
                  long_context_frac: float = 0.0,
                  long_prompt_len: tuple[int, int] = (96, 160),
                  sampled_frac: float = 0.0,
                  shared_prefix_users: int = 0,
                  system_prompt_len: int = 32,
                  abandon_frac: float = 0.0,
                  abandon_range: tuple[int, int] = (2, 8),
                  slo_ttft_s: float | None = None) -> Scenario:
    """Generate one seeded scenario.  EVERY random draw comes from the one
    ``np.random.default_rng(seed)`` stream in a fixed order, and nothing
    reads a clock — ``make_scenario(seed=s, ...)`` is a pure function of
    its arguments (see :meth:`Scenario.signature`).

    ``shared_prefix_users=U`` gives the scenario a U-user fleet sharing
    one system prompt: each request's prompt is ``system + user-history +
    fresh turn``, and a user's history grows with every request they send
    (the multi-turn shape the prefix cache exists for).  ``sampled_frac``
    marks that fraction temperature>0 (they ride the same engine but are
    excluded from greedy bit-equality checks); ``long_context_frac``
    draws that fraction's prompt from ``long_prompt_len``.
    ``abandon_frac`` marks streaming clients that disconnect after
    ``abandon_range`` tokens — a replay must turn each into an
    ``engine.cancel()`` mid-decode."""
    rng = np.random.default_rng(seed)
    at = _arrivals(rng, n_requests, arrival, mean_interarrival_s,
                   burst_every_s, burst_size, burst_spread_s,
                   diurnal_period_s, diurnal_amplitude)
    system = rng.integers(1, vocab, (system_prompt_len,)).astype(np.int32) \
        if shared_prefix_users > 0 else None
    histories = [[] for _ in range(max(0, shared_prefix_users))]
    reqs: list[ClientRequest] = []
    for i in range(n_requests):
        is_long = rng.uniform() < long_context_frac
        lo, hi = long_prompt_len if is_long else prompt_len
        t_len = int(rng.integers(lo, hi))
        user = None
        if shared_prefix_users > 0 and not is_long:
            user = int(rng.integers(0, shared_prefix_users))
            turn = rng.integers(1, vocab, (t_len,)).astype(np.int32)
            prompt = np.concatenate(
                [system, np.asarray(histories[user], np.int32), turn])
            histories[user].extend(int(t) for t in turn)
        else:
            prompt = rng.integers(1, vocab, (t_len,)).astype(np.int32)
        mn = int(rng.integers(max_new[0], max_new[1]))
        sampled = rng.uniform() < sampled_frac
        abandon = None
        if rng.uniform() < abandon_frac:
            # clamp BOTH bounds into [1, mn]: a short request must not
            # crash generation when abandon_range sits above its budget
            a_lo = max(1, min(abandon_range[0], mn))
            a_hi = max(a_lo, min(abandon_range[1], mn))
            abandon = int(rng.integers(a_lo, a_hi + 1))
        reqs.append(ClientRequest(
            idx=i, arrival_s=float(at[i]), prompt=prompt,
            max_new_tokens=mn,
            temperature=0.7 if sampled else 0.0,
            top_p=0.9 if sampled else 1.0,
            slo_ttft_s=slo_ttft_s, abandon_after=abandon, user=user,
            kind="sampled" if sampled else ("long" if is_long else "short")))
    return Scenario(name=name, seed=int(seed), requests=reqs, meta=dict(
        arrival=arrival, n_requests=n_requests, vocab=vocab,
        mean_interarrival_s=mean_interarrival_s,
        shared_prefix_users=shared_prefix_users,
        sampled_frac=sampled_frac, long_context_frac=long_context_frac,
        abandon_frac=abandon_frac, slo_ttft_s=slo_ttft_s))


def goodput_report(records: list[dict], slo_ttft_s: float,
                   window_s: float | None = None) -> dict:
    """Goodput-under-SLO over OFFERED requests: a request is good iff it
    was admitted and its first token arrived within ``slo_ttft_s`` of
    submission.  Rejected requests count in the denominator (an admission
    policy cannot improve its goodput by rejecting everything), abandoned
    clients count like any other (their first token either met the SLO or
    did not).  Delegates the quantile shape to the shared
    :func:`~paddle_tpu_torch.observability.slo.slo_report` so artifacts stay
    schema-compatible with every other serving trace."""
    from ..observability.slo import slo_report
    summaries = []
    for r in records:
        summaries.append({
            "rid": r.get("idx"),
            "tokens": int(r.get("tokens", 0)),
            "ttft_s": r.get("ttft_s"),
            "tpot_s": r.get("tpot_s"),
            "e2e_s": r.get("e2e_s"),
            "timed_out": bool(r.get("timed_out")),
        })
    rep = slo_report(summaries, slo_ttft_s, window_s=window_s)
    n = len(records)
    rejected = sum(1 for r in records if r.get("rejected"))
    abandoned = sum(1 for r in records if r.get("abandoned"))
    rep["offered_requests"] = n
    rep["rejected_requests"] = rejected
    rep["abandoned_requests"] = abandoned
    rep["goodput_under_slo"] = round(rep["on_time_requests"] / n, 4) \
        if n else 0.0
    return rep


def replay_engine(engine, scenario: Scenario, controller=None, *,
                  load_tps: float, slo_ttft_s: float,
                  collect_tokens: bool = False,
                  max_stall_steps: int = 2000) -> dict:
    """Drive a real ServingEngine through ``scenario``.

    Arrivals are paced in token time: request i is submitted once the
    engine has generated ``arrival_s * load_tps`` tokens since the replay
    began (``load_tps`` converts the scenario clock into offered load
    relative to THIS machine's measured capacity — the same offered load
    reaches a fast card and a slow CI host).  Admission goes through
    ``controller`` (an
    :class:`~paddle_tpu_torch.serving.frontend.AdmissionController`; None =
    admit-always).  Abandon clients stream through ``on_token`` and
    cancel at their scenario-pinned token count — the cancel itself runs
    at the step boundary (``on_token`` must never re-enter the engine).

    Returns ``{"records": [...], "window_s": ..., "report":
    goodput_report(...), "admission": controller report}``; with
    ``collect_tokens`` each record carries the streamed token list (the
    bit-equality surface)."""
    import time as _time

    from .frontend import AdmissionController, SLORejected
    from ..inference.paged import AdmissionRejected

    if controller is None:
        controller = AdmissionController(policy="always")
    n = len(scenario.requests)
    records: list[dict] = [
        {"idx": r.idx, "rejected": False, "abandoned": False, "tokens": 0,
         "ttft_s": None, "tpot_s": None, "e2e_s": None, "timed_out": False,
         "kind": r.kind}
        for r in scenario.requests]
    streams: dict[int, list] = {}
    to_cancel: list[int] = []
    rid_to_idx: dict[int, int] = {}
    idx_to_rid: dict[int, int] = {}

    def _mk_cb(idx: int, abandon_after):
        toks: list = []
        streams[idx] = toks

        def cb(tok, _toks=toks, _aa=abandon_after, _idx=idx):
            _toks.append(tok)
            if _aa is not None and len(_toks) == _aa:
                # disconnect mid-decode: defer the cancel to the step
                # boundary (we are inside the engine's drain right now)
                to_cancel.append(_idx)
        return cb

    base_tok = engine.tokens_generated
    i = 0
    stalled = 0

    def _submit_next():
        """Submit scenario request i through the controller (recording a
        rejection instead of raising) and advance i."""
        nonlocal i
        sr = scenario.requests[i]
        try:
            rid = controller.submit(
                engine, sr.prompt, max_new_tokens=sr.max_new_tokens,
                temperature=sr.temperature, top_p=sr.top_p,
                slo_ttft_s=sr.slo_ttft_s
                if sr.slo_ttft_s is not None else slo_ttft_s,
                on_token=_mk_cb(sr.idx, sr.abandon_after))
            rid_to_idx[rid] = sr.idx
            idx_to_rid[sr.idx] = rid
        except (SLORejected, AdmissionRejected):
            records[sr.idx]["rejected"] = True
        i += 1

    t0 = _time.perf_counter()
    while True:
        while i < n and scenario.requests[i].arrival_s * load_tps \
                <= engine.tokens_generated - base_tok:
            _submit_next()
        if i < n and engine.num_active == 0 and not engine._queue \
                and not engine.inflight_depth:
            # idle jump: nothing is running, so token time cannot advance
            # to the next arrival on its own — submit it now (the analog
            # of a wall clock rolling forward through an idle valley)
            _submit_next()
            continue
        if i >= n and not engine.num_active and not engine._queue \
                and not engine.inflight_depth:
            break
        progressed = engine.step()
        stalled = 0 if progressed else stalled + 1
        if stalled >= max_stall_steps:
            raise RuntimeError(
                f"replay_engine: no progress for {stalled} steps "
                f"({engine.num_active} active, {len(engine._queue)} queued)")
        if to_cancel:
            for idx in to_cancel:
                rec = records[idx]
                if not rec["abandoned"]:
                    rec["abandoned"] = True
                    rid = idx_to_rid[idx]
                    req = engine.lookup(rid)
                    if req is not None and req.first_token_time:
                        rec["ttft_s"] = req.ttft
                    controller.resolve(rid, req)
                    engine.cancel(rid)
                    rec["tokens"] = len(streams[idx])
            to_cancel.clear()
    engine.quiesce()
    window_s = _time.perf_counter() - t0
    for rid, idx in rid_to_idx.items():
        rec = records[idx]
        if rec["abandoned"]:
            continue
        req = engine._finished.get(rid)
        if req is None:
            continue
        rec["tokens"] = len(req.generated)
        rec["ttft_s"] = req.ttft or None
        rec["tpot_s"] = req.tpot or None
        rec["e2e_s"] = req.finish_time - req.submit_time
        rec["timed_out"] = req.timed_out
        controller.resolve(rid, req)
    if collect_tokens:
        for idx, toks in streams.items():
            records[idx]["stream"] = list(toks)
    return {
        "records": records,
        "window_s": window_s,
        "report": goodput_report(records, slo_ttft_s, window_s=window_s),
        "admission": controller.report(),
    }


def replay_fleet(fleet, scenario: Scenario, *, slo_ttft_s: float,
                 load_tps: float | None = None,
                 virtual_clock: VirtualClock | None = None,
                 collect_tokens: bool = False,
                 max_stall_rounds: int = 4000) -> dict:
    """Drive a :class:`~paddle_tpu_torch.serving.fleet.ReplicaFleet` (fixed-N
    or :class:`~paddle_tpu_torch.serving.autoscale.ElasticFleet`) through
    ``scenario`` — the fleet-shaped twin of :func:`replay_engine`.
    Exactly one pacing mode:

      * ``load_tps`` — ROUTER token time: request i is submitted once
        the fleet has streamed ``arrival_s * load_tps`` tokens since the
        replay began (the router's ``tokens_streamed`` counter advances
        once per authoritative emission, so a failover/migration
        re-decode never inflates the clock).  Machine-independent
        offered load, but fleet-SIZE-normalizing: aggregate generation
        IS the clock, so capacity differences between fleets cancel out
        of the queue dynamics — use it for exactness/chaos drills, not
        capacity A/Bs.
      * ``virtual_clock`` — ROUND time (:class:`VirtualClock`): each
        fleet heartbeat advances ``dt`` virtual seconds as if every
        replica were its own concurrently-stepping host, and idle
        valleys jump the clock to the next arrival (idle replicas still
        accrue ``replica_seconds`` across the jump — exactly the cost
        scale-down exists to shed).  An N-replica fleet then clears an
        arrival backlog N× faster in virtual time, so capacity and
        elasticity are measurable — and every reported number is
        DETERMINISTIC for a given seed.  The fleet must have been built
        with ``clock=virtual_clock`` (one clock domain for request
        stamps, replica-time, and pacing); ``slo_ttft_s`` is then in
        virtual seconds.

    Abandon clients cancel through ``fleet.cancel`` at the round
    boundary.  Returns the :func:`replay_engine` report shape plus
    ``replica_seconds`` — the integral of live-replica count over the
    replay (the goodput-per-replica-hour denominator of an elastic
    A/B)."""
    import time as _time

    from ..inference.paged import AdmissionRejected

    if (load_tps is None) == (virtual_clock is None):
        raise ValueError("pass exactly one of load_tps / virtual_clock")
    if virtual_clock is not None and fleet._clock is not virtual_clock:
        raise ValueError("virtual-clock replay requires the fleet to run "
                         "on the SAME clock: ReplicaFleet(clock=vc)")
    n = len(scenario.requests)
    records: list[dict] = [
        {"idx": r.idx, "rejected": False, "abandoned": False, "tokens": 0,
         "ttft_s": None, "tpot_s": None, "e2e_s": None, "timed_out": False,
         "migrations": 0, "kind": r.kind}
        for r in scenario.requests]
    streams: dict[int, list] = {}
    to_cancel: list[int] = []
    frid_of: dict[int, int] = {}

    def _mk_cb(idx: int, abandon_after):
        toks: list = []
        streams[idx] = toks

        def cb(tok, _toks=toks, _aa=abandon_after, _idx=idx):
            _toks.append(tok)
            if _aa is not None and len(_toks) == _aa:
                # disconnect mid-decode: the fleet hook fires inside the
                # router's stream drain — defer to the round boundary
                to_cancel.append(_idx)
        return cb

    base_tok = fleet.tokens_streamed
    rs0 = fleet.replica_seconds
    i = 0
    stalled = 0

    def _submit_next():
        nonlocal i
        sr = scenario.requests[i]
        try:
            frid = fleet.submit(
                sr.prompt, max_new_tokens=sr.max_new_tokens,
                temperature=sr.temperature, top_p=sr.top_p,
                on_token=_mk_cb(sr.idx, sr.abandon_after))
            frid_of[sr.idx] = frid
        except AdmissionRejected:
            records[sr.idx]["rejected"] = True
        i += 1

    def _busy():
        return any(fr.result is None for fr in fleet._requests.values())

    def _due() -> bool:
        if i >= n:
            return False
        at = scenario.requests[i].arrival_s
        if virtual_clock is not None:
            return at <= virtual_clock()
        return at * load_tps <= fleet.tokens_streamed - base_tok

    t0 = _time.perf_counter()
    v0 = virtual_clock() if virtual_clock is not None else 0.0
    while True:
        while _due():
            _submit_next()
        if i < n and not _busy():
            # idle jump: the clock cannot advance to the next arrival on
            # its own — roll forward through the empty valley (virtual
            # mode jumps the shared clock, so idle replicas keep
            # accruing replica_seconds across the gap)
            if virtual_clock is not None:
                virtual_clock.advance_to(scenario.requests[i].arrival_s)
            _submit_next()
            continue
        if i >= n and not _busy():
            break
        progressed = fleet.step()
        if virtual_clock is not None:
            virtual_clock.tick()
        stalled = 0 if progressed else stalled + 1
        if stalled >= max_stall_rounds:
            raise RuntimeError(
                f"replay_fleet: no progress for {stalled} rounds "
                f"({sum(fr.result is None for fr in fleet._requests.values())}"
                f" unresolved, {len(fleet._waiting)} waiting)")
        if to_cancel:
            for idx in to_cancel:
                rec = records[idx]
                if not rec["abandoned"]:
                    rec["abandoned"] = True
                    frid = frid_of[idx]
                    fr = fleet._requests.get(frid)
                    if fr is not None and fr.first_token_t is not None:
                        rec["ttft_s"] = fr.first_token_t - fr.submit_t
                    rec["tokens"] = len(streams[idx])
                    fleet.cancel(frid)
            to_cancel.clear()
    window_s = (virtual_clock() - v0) if virtual_clock is not None \
        else _time.perf_counter() - t0
    for idx, frid in frid_of.items():
        rec = records[idx]
        if rec["abandoned"]:
            continue
        fr = fleet._requests.get(frid)
        if fr is None or fr.result is None:
            continue
        ngen = len(fr.result.generated)
        rec["tokens"] = ngen
        rec["ttft_s"] = (fr.first_token_t - fr.submit_t
                         if fr.first_token_t is not None else None)
        rec["tpot_s"] = ((fr.finish_t - fr.first_token_t) / (ngen - 1)
                         if ngen > 1 and fr.first_token_t is not None
                         else None)
        rec["e2e_s"] = fr.finish_t - fr.submit_t
        rec["timed_out"] = fr.result.timed_out
        rec["migrations"] = fr.migrations
    if collect_tokens:
        for idx, toks in streams.items():
            records[idx]["stream"] = list(toks)
    return {
        "records": records,
        "window_s": window_s,
        "replica_seconds": fleet.replica_seconds - rs0,
        "report": goodput_report(records, slo_ttft_s, window_s=window_s),
    }


def replay_sim(scenario: Scenario, *, num_slots: int,
               prefill_rate_tps: float, step_s: float, decode_horizon: int,
               policy: str = "predictive", slo_ttft_s: float = 1.0,
               max_queue_depth: int | None = None,
               controller=None) -> dict:
    """Replay ``scenario`` against an analytic S-slot server on a virtual
    clock — deterministic, device-free, fast at 10k+ requests.

    The server model matches the
    :class:`~paddle_tpu_torch.serving.frontend.TTFTPredictor`'s: a request
    occupies one slot for ``prefill/rate + decode * step_s/horizon``
    seconds, slots are granted FIFO (earliest-free first).  Admission
    runs through the REAL :class:`AdmissionController` — each arrival
    gets an :class:`AdmissionView` built from the sim state, so the
    controller/predictor logic is exercised at a scale the engine replay
    cannot afford (the tier-1 10k determinism + A/B tests run here).

    Returns the same report shape as :func:`replay_engine`."""
    from .frontend import (AdmissionController, AdmissionView, SLORejected)
    from ..inference.paged import AdmissionRejected

    if controller is None:
        controller = AdmissionController(
            policy=policy, slo_ttft_s=slo_ttft_s,
            max_queue_depth=max_queue_depth)
    tpt = step_s / max(1, decode_horizon)
    inv_rate = 1.0 / max(prefill_rate_tps, 1e-9)
    slot_free = [0.0] * num_slots           # heap of slot free times
    heapq.heapify(slot_free)
    # (start_time, prefill_tokens, decode_tokens) of admitted-not-started
    waiting: list[tuple[float, int, int]] = []
    records: list[dict] = []
    for sr in scenario.requests:
        t = sr.arrival_s
        waiting = [w for w in waiting if w[0] > t]
        busy = [ft for ft in slot_free if ft > t]
        view = AdmissionView(
            free_slots=num_slots - len(busy),
            active=[(0, max(1, int(math.ceil((ft - t) / tpt))))
                    for ft in busy],
            queued=[(pf, mn) for (_st, pf, mn) in waiting],
            prefill_rate_tps=prefill_rate_tps, step_s=step_s,
            decode_horizon=decode_horizon)
        dec = min(sr.max_new_tokens, sr.abandon_after
                  or sr.max_new_tokens)
        rec = {"idx": sr.idx, "rejected": False,
               "abandoned": sr.abandon_after is not None,
               "tokens": dec, "ttft_s": None, "tpot_s": None,
               "e2e_s": None, "timed_out": False, "kind": sr.kind}
        try:
            pred = controller.decide(
                view, len(sr.prompt),
                slo_ttft_s=sr.slo_ttft_s
                if sr.slo_ttft_s is not None else slo_ttft_s)
        except (SLORejected, AdmissionRejected):
            rec["rejected"] = True
            rec["tokens"] = 0
            records.append(rec)
            continue
        free_at = heapq.heappop(slot_free)
        start = max(t, free_at)
        pf_s = len(sr.prompt) * inv_rate
        finish = start + pf_s + dec * tpt
        heapq.heappush(slot_free, finish)
        if start > t:
            waiting.append((start, len(sr.prompt), dec))
        ttft = start - t + pf_s
        rec["ttft_s"] = ttft
        rec["tpot_s"] = tpt
        rec["e2e_s"] = finish - t
        records.append(rec)
        controller.resolve_sim(pred, ttft)
    window = max((r["e2e_s"] + scenario.requests[r["idx"]].arrival_s)
                 for r in records if r["e2e_s"] is not None) \
        if any(r["e2e_s"] is not None for r in records) else 0.0
    return {
        "records": records,
        "window_s": window,
        "report": goodput_report(records, slo_ttft_s, window_s=window
                                 if window > 0 else None),
        "admission": controller.report(),
    }
