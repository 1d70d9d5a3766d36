"""Process groups (port of ``paddle_tpu/distributed/communication/group.py``;
reference python/paddle/distributed/communication/group.py:29).

A :class:`Group` is a list of global ranks over a ``torch.distributed``
process group, and carries the name of the mesh axis it spans when it was
cut from a mesh (``topology.axis_group``), as a JAX group names its mesh
axis.  Before ``init_parallel_env`` every group is this one process and a
collective over it is the identity, as JAX's single-participant path is.
A ``solo`` group is this rank alone at any world size (the group along an
axis no mesh has): every collective over it is the identity too, where a
group without a process group would otherwise mean the world's.
"""
from __future__ import annotations

from typing import List, Optional

import torch.distributed as dist

__all__ = ["Group", "new_group", "get_group", "is_initialized",
           "destroy_process_group", "wait", "barrier", "get_backend"]

_groups = {}
_next_gid = [1]


class Group:
    def __init__(self, ranks: List[int], gid: int = 0,
                 axis_name: Optional[str] = None, pg=None,
                 solo: bool = False):
        if solo and len(ranks) != 1:
            raise ValueError(f"a solo group is one rank, not {ranks}")
        self.ranks = list(ranks)
        self.id = gid
        self.axis_name = axis_name
        self._pg = pg
        self.solo = solo

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self):
        from ..env import global_rank
        return self.get_group_rank(global_rank())

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self):
        from ..env import global_rank
        return global_rank() in self.ranks

    @property
    def process_group(self):
        """The ``torch.distributed`` group (``None``: the world's, unless
        the group is ``solo``)."""
        return self._pg

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, "
                f"axis={self.axis_name})")


def _world_group():
    from ..env import get_world_size, is_initialized as inited
    n = get_world_size() if inited() else 1
    g = _groups.get(0)
    if g is None or g.nranks != n:
        g = _groups[0] = Group(list(range(n)), 0)
    return g


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    """A group over ``ranks`` (all of the world's by default).  Every rank
    of the world calls it, members or not, as ``torch.distributed``
    requires."""
    from ..env import get_world_size, is_initialized as inited
    if ranks is None:
        ranks = list(range(get_world_size()))
    pg = None
    if inited():
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(list(ranks), **kw)
    gid = _next_gid[0]
    _next_gid[0] += 1
    g = Group(list(ranks), gid, axis_name=axis_name, pg=pg)
    _groups[gid] = g
    return g


def get_group(gid=0):
    if gid == 0:
        return _world_group()
    return _groups.get(gid)


def is_initialized():
    from ..env import is_initialized as f
    return f()


def destroy_process_group(group=None):
    """Destroy ``group``, or with no argument the world's process group and
    every group, mesh and state this package holds."""
    from .. import env, topology
    if group is None:
        _groups.clear()
        topology.set_default_mesh(None)
        if env.is_initialized():
            dist.destroy_process_group()
        env._forget()
        return
    _groups.pop(group.id, None)
    if group.process_group is not None and env.is_initialized():
        dist.destroy_process_group(group.process_group)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until ``tensor``'s pending work is done, within the watchdog's
    deadline."""
    from ..env import comm_timeout_s
    from .watchdog import wait_with_timeout
    return wait_with_timeout(tensor, comm_timeout_s(), "wait")


def barrier(group=None):
    from .collectives import _issue
    from ..env import is_initialized as inited
    if not inited() or getattr(group, "solo", False):
        return
    pg = None if group is None else group.process_group
    _issue("barrier", dist.barrier, True, group=pg)


def get_backend(group=None):
    """``nccl`` or ``gloo``; ``None`` before ``init_parallel_env``."""
    from ..env import is_initialized as inited
    if not inited():
        return None
    return dist.get_backend(None if group is None else group.process_group)
