"""Resilience layer: deterministic fault injection, crash-consistent
checkpoint management, and the typed failures the self-healing serving
engine surfaces (the fault-point catalog is resilience/faults.py's
docstring)."""
from .faults import (FaultPlan, FaultSpec, InjectedFault, inject,  # noqa: F401
                     fault_point, active_plan)
from .checkpoint import CheckpointManager  # noqa: F401

__all__ = ["FaultPlan", "FaultSpec", "InjectedFault", "inject", "fault_point",
           "active_plan", "CheckpointManager"]
