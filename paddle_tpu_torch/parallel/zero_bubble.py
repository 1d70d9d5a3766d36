"""The zero-bubble schedule tables (port of the pure-Python part of
``paddle_tpu/parallel/zero_bubble.py``: ``build_schedule``,
``schedule_stats``, ``_slot_ticks``, ``_depths``; reference
passes/pipeline_scheduler_pass/pipeline_zero_bubble.py:62).

ZB-H1 splits each microbatch's backward into

    B: input-grad only   (dL/dx — the inter-stage critical path)
    W: weight-grad only  (dL/dW — no successor, schedulable into bubbles)

and a greedy list scheduler lays F / B / W slots out, one row per pp rank
and one column per tick.  The tables are plain Python and equal JAX's
element for element; the eager engine that runs them is
``pipeline_schedules.run_zero_bubble``.
"""
from __future__ import annotations

from typing import List, Tuple

__all__ = ["build_schedule", "schedule_stats", "IDLE", "F", "B", "W"]

IDLE, F, B, W = 0, 1, 2, 3


def build_schedule(n_stages: int, n_micro: int, policy: str = "zb1"
                   ) -> List[List[Tuple[int, int]]]:
    """Greedy list scheduler. Returns per-rank slot lists [(kind, mb), ...]
    (all rows same length = makespan).

    policy "1f1b": W is chained right after its B (the classic fused
    backward, split into two unit slots — the fair fine-grained baseline).
    policy "zb1": W defers; B and F take priority, W fills bubbles (ZB-H1).
    In-flight activations per rank are capped at n_stages (H1's memory
    bound ~ 1F1B's).
    """
    S, M = n_stages, n_micro
    f_done = [[-1] * M for _ in range(S)]   # tick F(s,m) executed
    b_done = [[-1] * M for _ in range(S)]
    w_done = [[-1] * M for _ in range(S)]
    rows: List[List[Tuple[int, int]]] = [[] for _ in range(S)]
    forced: List[Tuple[int, int]] = [None] * S  # 1f1b: W forced next tick
    t = 0
    limit = 4 * (M + 2 * S) + 8
    while (any(w_done[s][m] < 0 for s in range(S) for m in range(M))
           and t < limit):
        for s in range(S):
            rows[s].append((IDLE, 0))

        def ready_F(s, m):
            if f_done[s][m] >= 0:
                return False
            if s > 0 and not (0 <= f_done[s - 1][m] < t):
                return False
            # memory cap: in-flight (F done or now, W not done) < S + 1
            inflight = sum(1 for mm in range(M)
                           if f_done[s][mm] >= 0 and w_done[s][mm] < 0)
            return inflight <= S

        def ready_B(s, m):
            if b_done[s][m] >= 0 or f_done[s][m] < 0:
                return False
            if s == S - 1:
                return f_done[s][m] < t
            return 0 <= b_done[s + 1][m] < t

        def ready_W(s, m):
            return w_done[s][m] < 0 <= b_done[s][m] and b_done[s][m] < t

        for s in range(S):
            if forced[s] is not None:
                m = forced[s][1]
                rows[s][t] = (W, m)
                w_done[s][m] = t
                forced[s] = None
                continue
            slot = None
            # priority: B first (critical path), then F, then W
            for m in range(M):
                if ready_B(s, m):
                    slot = (B, m)
                    break
            if slot is None:
                for m in range(M):
                    if ready_F(s, m):
                        slot = (F, m)
                        break
            if slot is None and policy == "zb1":
                for m in range(M):
                    if ready_W(s, m):
                        slot = (W, m)
                        break
            if slot is None:
                continue
            kind, m = slot
            rows[s][t] = slot
            if kind == F:
                f_done[s][m] = t
            elif kind == B:
                b_done[s][m] = t
                if policy == "1f1b":
                    forced[s] = (W, m)
            elif kind == W:
                w_done[s][m] = t
        t += 1
    if t >= limit:
        raise RuntimeError("schedule did not converge")
    return rows


def schedule_stats(rows):
    """(makespan, idle_slots, bubble_fraction)."""
    T = len(rows[0])
    idle = sum(1 for r in rows for k, _ in r if k == IDLE)
    return T, idle, idle / (T * len(rows))


def _slot_ticks(rows):
    S = len(rows)
    f_t = [{} for _ in range(S)]
    b_t = [{} for _ in range(S)]
    w_t = [{} for _ in range(S)]
    for s in range(S):
        for t, (k, m) in enumerate(rows[s]):
            if k == F:
                f_t[s][m] = t
            elif k == B:
                b_t[s][m] = t
            elif k == W:
                w_t[s][m] = t
    return f_t, b_t, w_t


def _depths(rows, n_micro):
    """Ring-buffer depths (act, cot, res): max lifetime span (in distinct
    mbs) of saved activations, cotangents and saved graphs (JAX's vjp
    residuals).

    Lifetimes start at the *arrival* tick, not this stage's own execution
    tick: stage s receives mb m's activation at the end of tick
    f_done[s-1][m] (cotangent: b_done[s+1][m]) and holds it through its W
    tick inclusive (W re-reads the activation, the cotangent and the saved
    graph).  Graphs are made at this stage's own F tick and read at B and
    W.  Stage 0 receives no activation and the last stage no cotangent, so
    neither constrains those rings."""
    S = len(rows)
    T = len(rows[0])
    f_t, b_t, w_t = _slot_ticks(rows)
    act_d, cot_d, res_d = 1, 1, 1
    for s in range(S):
        for t in range(T):
            if s > 0:
                live_a = [m for m in range(n_micro)
                          if f_t[s - 1].get(m, 10**9) + 1 <= t
                          and w_t[s].get(m, -1) >= t]
                if live_a:
                    act_d = max(act_d, max(live_a) - min(live_a) + 1)
            if s < S - 1:
                live_c = [m for m in range(n_micro)
                          if b_t[s + 1].get(m, 10**9) + 1 <= t
                          and w_t[s].get(m, -1) >= t]
                if live_c:
                    cot_d = max(cot_d, max(live_c) - min(live_c) + 1)
            live_r = [m for m in range(n_micro)
                      if f_t[s].get(m, 10**9) <= t
                      and w_t[s].get(m, -1) >= t]
            if live_r:
                res_d = max(res_d, max(live_r) - min(live_r) + 1)
    return (min(act_d, n_micro), min(cot_d, n_micro), min(res_d, n_micro))
