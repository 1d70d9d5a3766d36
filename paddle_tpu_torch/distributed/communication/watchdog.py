"""The collective watchdog and the comm sanitizer (port of
``paddle_tpu/distributed/communication/watchdog.py``; reference
paddle/phi/core/distributed/comm_task_manager.h:37 CommTaskManager,
IsTimeout :57, and the comm NaN check in distributed/check/).

Every wait on a collective goes through :func:`wait_with_timeout`.  On the
CPU (gloo) the host blocks on the work with the deadline and a dead peer
raises :class:`CommTimeoutError` after it.  On the card (NCCL) the wait is
stream-ordered — the host does not block, so the step keeps queueing work —
and the process group's own timeout, enforced by NCCL's watchdog thread,
aborts a collective that never completes.  A CUDA tensor (not a work
handle) is waited for on the host, polling an event up to the deadline.
The ``comm.ready`` fault point simulates a peer whose collective never
completes.  ``check_comm_result`` is the NaN/Inf scan of a finished result,
on when ``FLAGS_check_comm_nan`` is set.
"""
from __future__ import annotations

import datetime
import os
import threading
import time

import torch

from ...resilience.faults import fault_point

__all__ = ["CommTimeoutError", "CommAggregateError", "CommTaskManager",
           "wait_with_timeout", "check_comm_result", "get_comm_task_manager"]


class CommTimeoutError(RuntimeError):
    pass


class CommAggregateError(RuntimeError):
    """Several tracked collectives failed in one ``wait_all()``; ``.errors``
    holds every (op_name, exception) pair."""

    def __init__(self, message, errors):
        super().__init__(message)
        self.errors = errors


def _timeout_message(op_name, timeout):
    return (f"{op_name} not complete after {timeout:.1f}s — peer failure or "
            f"hung link (reference comm_task_manager.h IsTimeout)")


def wait_with_timeout(value, timeout: float, op_name: str = "collective",
                      on_card: bool = False):
    """Wait for ``value`` — a ``torch.distributed`` work handle, a task of
    :mod:`.collectives`, or a tensor — at most ``timeout`` seconds;
    ``on_card`` marks a work handle of an NCCL collective (its wait is
    stream-ordered, see the module docstring).  Returns ``value``."""
    if fault_point("comm.ready", op=op_name) is not None:
        raise CommTimeoutError(_timeout_message(op_name, 0.0)
                               + " (injected delayed readiness)")
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(value.device))
            deadline = time.monotonic() + timeout
            while not ev.query():
                if time.monotonic() > deadline:
                    raise CommTimeoutError(_timeout_message(op_name, timeout))
                time.sleep(1e-4)
        return value
    if value is None:
        return value
    if hasattr(value, "work") and hasattr(value, "on_card"):
        # a task of ``collectives``: wait on its work handle
        wait_with_timeout(value.work, timeout, op_name, value.on_card)
        return value
    if on_card:
        value.wait()
        return value
    try:
        value.wait(timeout=datetime.timedelta(seconds=timeout))
    except RuntimeError as e:
        if "timed out" in str(e).lower():
            raise CommTimeoutError(_timeout_message(op_name, timeout)) from e
        raise
    return value


def check_comm_result(value, op_name: str = "collective"):
    """NaN/Inf scan of a finished collective's tensor (reference
    distributed/check/); active when ``FLAGS_check_comm_nan`` is set."""
    if os.environ.get("FLAGS_check_comm_nan", "0").lower() \
            not in ("1", "true", "yes"):
        return value
    if isinstance(value, torch.Tensor) and value.is_floating_point() \
            and not bool(torch.isfinite(value).all()):
        raise FloatingPointError(f"NaN/Inf in result of {op_name}")
    return value


class CommTaskManager:
    """Tracks in-flight collectives (reference comm_task_manager.h:37):
    ``track(op_name, work_or_tensor)`` registers one; ``wait_all(timeout)``
    requires every tracked one to complete, and be finite, within a deadline
    shared by the set, checking all of them even after one fails."""

    def __init__(self, default_timeout: float = None):
        from ..env import comm_timeout_s
        self.default_timeout = default_timeout or comm_timeout_s()
        self._lock = threading.Lock()
        self._tasks = []

    def track(self, op_name, value, result=None):
        """``result``: the tensor the collective writes, scanned by
        ``check_comm_result`` once the work completes."""
        with self._lock:
            self._tasks.append((op_name, value, result))
        return value

    def pending(self):
        with self._lock:
            return len(self._tasks)

    def wait_all(self, timeout: float = None):
        timeout = timeout or self.default_timeout
        with self._lock:
            tasks, self._tasks = self._tasks, []
        errors = []
        start = time.monotonic()
        for name, v, result in tasks:
            remaining = max(0.05, timeout - (time.monotonic() - start))
            try:
                wait_with_timeout(v, remaining, name)
                check_comm_result(v if result is None else result, name)
            except Exception as e:  # noqa: BLE001 — aggregated below
                errors.append((name, e))
        if len(errors) == 1:
            raise errors[0][1]
        if errors:
            detail = "; ".join(f"{n}: {type(e).__name__}: {e}"
                               for n, e in errors)
            raise CommAggregateError(
                f"{len(errors)} of {len(tasks)} tracked collectives failed "
                f"— {detail}", errors)


_manager = [None]


def get_comm_task_manager() -> CommTaskManager:
    if _manager[0] is None:
        _manager[0] = CommTaskManager()
    return _manager[0]
