"""The training side of the observability plane.

Only :func:`fault_context` lives here so far: the serving telemetry ties
its flight events to the active fault drill through it.  The training
loop's own telemetry bundle comes with the train-loop exterior."""
from __future__ import annotations

__all__ = ["fault_context"]


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
