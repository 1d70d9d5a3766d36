"""SLO reporting: latency quantiles + goodput at a deadline.

One shared implementation for every consumer (the serving engine's
telemetry, ``chip_smoke.py`` phase 3k, dashboards): given per-request summaries from
:class:`~paddle_tpu_torch.observability.telemetry.Telemetry` (or raw latency
lists), produce TTFT/TPOT/E2E quantiles and **goodput** — the share of
work that met its deadline, the number a latency SLO actually pays on.

Goodput here is TTFT-deadline goodput: a request is "good" when its first
token arrived within ``ttft_deadline_s`` of submission (and it was not
retired overdue).  ``goodput_tokens`` counts only good requests' generated
tokens, so ``goodput_tokens_per_sec`` (when a wall-clock window is given)
is directly comparable to raw tokens/s — the gap between the two is the
throughput the SLO would forfeit."""
from __future__ import annotations

from .metrics import Histogram

__all__ = ["latency_percentiles", "slo_report", "on_time", "burn_rate",
           "windowed_burn"]


def on_time(summary: dict, ttft_deadline_s: float) -> bool:
    """THE goodput predicate, shared by :func:`slo_report` and the health
    sentinel's burn-rate detector (one definition of "good", everywhere):
    the request was not retired overdue and its first token arrived
    within the deadline."""
    return (not summary.get("timed_out")
            and summary.get("ttft_s") is not None
            and summary["ttft_s"] <= ttft_deadline_s)


def burn_rate(bad_fraction: float, slo_target: float) -> float:
    """SLO burn rate: the error budget's consumption speed.  With a
    target of ``slo_target`` (e.g. 0.95 of requests on time), the budget
    is ``1 - slo_target``; a ``bad_fraction`` equal to the budget burns
    at exactly 1.0 (on pace), 4x the budget burns at 4.0 (the classic
    page-worthy burn)."""
    budget = max(1e-9, 1.0 - float(slo_target))
    return float(bad_fraction) / budget


def windowed_burn(summaries, ttft_deadline_s: float, *, slo_target: float,
                  window_s: float, now: float) -> dict:
    """Budget consumption over ONE trailing window: request summaries
    (``Telemetry.request_summaries`` — each stamped with its retirement
    time under ``at``, and therefore ASCENDING in ``at``; pass anything
    else pre-sorted) newer than ``now - window_s`` score through
    :func:`on_time`; returns the bad fraction and its burn rate.  The
    health sentinel's fast/slow dual-window TTFT detector calls this
    twice — same math, two windows, zero duplication."""
    lo = now - float(window_s)
    n = 0
    bad = 0
    # summaries are retirement-time ordered (Telemetry appends at
    # retire): walk backwards and stop at the window edge, so a
    # per-step evaluation over a full 4096-deep deque costs the window
    # size, not the history size
    for s in reversed(summaries):
        at = s.get("at")
        if at is None:
            continue
        if at < lo:
            break
        n += 1
        if not on_time(s, ttft_deadline_s):
            bad += 1
    frac = bad / n if n else 0.0
    return {"requests": n, "bad": bad, "bad_fraction": round(frac, 4),
            "burn_rate": burn_rate(frac, slo_target) if n else 0.0,
            "window_s": float(window_s)}


def latency_percentiles(values_s, name: str = "latency",
                        ps=(50, 95, 99)) -> dict:
    """{p<q>_ms: ...} readout over a list of second-valued latencies, via
    the shared log-bucketed :class:`Histogram` (the single percentile
    implementation every report uses)."""
    h = Histogram(name)
    for v in values_s:
        h.observe(v)
    q = h.percentiles(ps)
    return {f"p{p}_ms": round(q[p] * 1e3, 2) for p in ps}


def slo_report(summaries, ttft_deadline_s: float,
               window_s: float | None = None) -> dict:
    """SLO report over request summaries.

    ``summaries``: iterable of dicts with (at least) ``ttft_s``,
    ``tpot_s``, ``e2e_s``, ``tokens``, ``timed_out`` — exactly what
    ``Telemetry.request_summaries`` holds.  ``window_s``: the measurement
    wall-clock, enabling goodput tokens/s."""
    summaries = list(summaries)
    h_ttft = Histogram("ttft_s")
    h_tpot = Histogram("tpot_s")
    h_e2e = Histogram("e2e_s")
    good_req = 0
    good_tokens = 0
    total_tokens = 0
    for s in summaries:
        if s.get("ttft_s") is not None:
            h_ttft.observe(s["ttft_s"])
        if s.get("tpot_s") is not None:
            h_tpot.observe(s["tpot_s"])
        if s.get("e2e_s") is not None:
            h_e2e.observe(s["e2e_s"])
        tokens = int(s.get("tokens", 0))
        total_tokens += tokens
        if on_time(s, ttft_deadline_s):
            good_req += 1
            good_tokens += tokens

    def _q(h: Histogram) -> dict:
        q = h.percentiles()
        return {"p50_ms": round(q[50] * 1e3, 2),
                "p95_ms": round(q[95] * 1e3, 2),
                "p99_ms": round(q[99] * 1e3, 2),
                "count": h.count}

    n = len(summaries)
    rep = {
        "requests": n,
        "ttft": _q(h_ttft),
        "tpot": _q(h_tpot),
        "e2e": _q(h_e2e),
        "ttft_deadline_ms": round(ttft_deadline_s * 1e3, 2),
        "on_time_requests": good_req,
        "goodput_fraction": round(good_req / n, 4) if n else 0.0,
        "total_tokens": total_tokens,
        "goodput_tokens": good_tokens,
    }
    if window_s is not None and window_s > 0:
        rep["tokens_per_sec"] = round(total_tokens / window_s, 1)
        rep["goodput_tokens_per_sec"] = round(good_tokens / window_s, 1)
    return rep
