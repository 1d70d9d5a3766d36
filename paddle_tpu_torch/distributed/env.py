"""The distributed environment (port of ``paddle_tpu/distributed/env.py``;
reference: python/paddle/distributed/parallel.py, the PADDLE_* contract the
launch CLI exports, launch/controllers/collective.py:76).

One process per rank, as ``torch.distributed`` runs it.  ``init_parallel_env``
reads the rank, the world size and the rendezvous address from the
environment — ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_MASTER`` or the torch names ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` — and joins the process group over TCP.
With no environment it makes a group of one rank on a free local port.

The backend follows the device: ``nccl`` for the card (``device=None`` means
the card and raises without one), ``gloo`` for an explicit ``device="cpu"``.
A CUDA run never falls back to gloo: when NCCL cannot make its
communicator the call raises.  Every group is made with a timeout
(``FLAGS_comm_timeout_seconds``, 1,800 s unless set), so a dead peer ends a
collective instead of hanging it.
"""
from __future__ import annotations

import datetime
import inspect
import os

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "global_rank", "parallel_device_count",
           "current_device", "comm_timeout_s"]

# the device and backend the process group was made for
_state = {"device": None, "backend": None}


def comm_timeout_s() -> float:
    """The collectives' deadline in seconds (``FLAGS_comm_timeout_seconds``,
    the JAX package's flag of that name, default 1,800)."""
    return float(os.environ.get("FLAGS_comm_timeout_seconds", 1800.0))


def _env_int(*names, default):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def global_rank() -> int:
    if is_initialized():
        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (its index among the group's
    ranks), or in the world."""
    if group is not None:
        return group.get_group_rank(global_rank())
    return global_rank()


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if is_initialized():
        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


def current_device() -> torch.device:
    """The device the process group was made for (the CPU before
    ``init_parallel_env``)."""
    return _state["device"] or torch.device("cpu")


def parallel_device_count() -> int:
    """Ranks in the world: one device each."""
    return get_world_size()


def _master():
    master = os.environ.get("PADDLE_MASTER")
    if master:
        host, port = master.rsplit(":", 1)
        return host, int(port)
    host = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if host and port:
        return host, int(port)
    return None


def init_parallel_env(device=None, backend=None, timeout=None):
    """Join the world's process group (reference parallel.py:978).  Returns
    the device this rank runs on.  A second call is a no-op."""
    if is_initialized():
        return current_device()
    dev = resolve_device(device)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend is not None and backend != want:
        raise ValueError(f"init_parallel_env: backend {backend!r} on a "
                         f"{dev.type} device; the port runs {want} there")
    rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    addr = _master()
    if addr is None:
        if world > 1:
            raise RuntimeError(
                f"init_parallel_env: world of {world} ranks but no "
                "PADDLE_MASTER or MASTER_ADDR / MASTER_PORT; start the "
                "ranks through python -m paddle_tpu_torch.distributed.launch")
        from .launch.main import _free_port
        addr = ("127.0.0.1", _free_port())
    kw = dict(backend=want, init_method=f"tcp://{addr[0]}:{addr[1]}",
              rank=rank, world_size=world,
              timeout=datetime.timedelta(
                  seconds=comm_timeout_s() if timeout is None else timeout))
    if dev.type == "cuda":
        local = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=0)
        idx = dev.index if dev.index is not None \
            else local % torch.cuda.device_count()
        torch.cuda.set_device(idx)
        dev = torch.device("cuda", idx)
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kw["device_id"] = dev     # the communicator is made now
    dist.init_process_group(**kw)
    _state.update(device=dev, backend=want)
    # one reduction before anything else: NCCL makes its communicator on
    # the first collective, so a card that cannot join fails here, loudly
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if float(probe.item()) != world:
        raise RuntimeError(f"init_parallel_env: the {want} probe summed "
                           f"{probe.item()} over {world} ranks")
    from . import topology
    topology.reset_default_mesh()
    return dev


def _forget():
    """Reset the module's state after the group is destroyed."""
    _state.update(device=None, backend=None)
