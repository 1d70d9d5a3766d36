"""The rank mesh (port of ``paddle_tpu/distributed/topology.py``; reference
python/paddle/distributed/fleet/base/topology.py:70 CommunicateTopology,
:189 HybridCommunicateGroup).

A JAX mesh axis becomes a process group: :func:`build_mesh` returns a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks with the
axis names as its ``mesh_dim_names`` (one rank a device, the last axis
fastest-varying, as the JAX mesh lays devices out), and
:func:`axis_group` gives this rank's :class:`Group` along one axis,
carrying the axis name.  Without a mesh (before ``init_parallel_env``, or
before anything set or asked for the default mesh), or along an axis the
mesh lacks, an axis's group is this rank alone (a ``solo`` group), over
which every collective is the identity at any world size.  Where the JAX
package needs the axis (``ShardedTrainStep``'s ``mesh.shape[axis]``), the
port raises too (:func:`require_axis`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["build_mesh", "get_default_mesh", "set_default_mesh",
           "reset_default_mesh", "axis_group", "require_axis",
           "CommunicateTopology",
           "HybridCommunicateGroup"]

_DEFAULT_MESH = [None]
_AXIS_GROUPS = {}           # (id(mesh), axis) -> Group


def _device_type():
    from .env import current_device
    return current_device().type


def build_mesh(axes: Dict[str, int], devices=None):
    """A ``DeviceMesh`` over the world's ranks with ``axes`` (name -> size,
    in order) as its dimensions.  The sizes must multiply to the world
    size (singleton axes allowed); ``devices`` (a list of global ranks)
    takes a subset in that order."""
    from torch.distributed.device_mesh import DeviceMesh
    from .env import get_world_size, is_initialized
    if not is_initialized():
        raise RuntimeError("build_mesh: call init_parallel_env first")
    ranks = list(range(get_world_size())) if devices is None \
        else [int(d) for d in devices]
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    total = int(np.prod(sizes))
    if total != len(ranks):
        raise ValueError(f"mesh {axes} needs {total} ranks, have "
                         f"{len(ranks)}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(sizes)
    return DeviceMesh(_device_type(), grid, mesh_dim_names=tuple(names))


def get_default_mesh():
    if _DEFAULT_MESH[0] is None:
        reset_default_mesh()
    return _DEFAULT_MESH[0]


def set_default_mesh(mesh):
    _DEFAULT_MESH[0] = mesh
    _AXIS_GROUPS.clear()
    return mesh


def reset_default_mesh():
    """Default: a 1-D data-parallel mesh over every rank (``None`` before
    ``init_parallel_env``)."""
    from .env import get_world_size, is_initialized
    mesh = build_mesh({"dp": get_world_size()}) if is_initialized() \
        else None
    return set_default_mesh(mesh)


def axis_group(axis: str, mesh=None):
    """This rank's group along ``axis`` of ``mesh`` (the default mesh), as a
    :class:`Group` named ``axis``.  Without a mesh, or along an axis the
    mesh lacks, the group is this rank alone (``solo``: its collectives are
    the identity, not the world's)."""
    from .communication.group import Group
    from .env import global_rank
    mesh = mesh if mesh is not None else _DEFAULT_MESH[0]
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if mesh is None or axis not in names:
        return Group([global_rank()], axis_name=axis, solo=True)
    key = (id(mesh), axis)
    g = _AXIS_GROUPS.get(key)
    if g is None:
        import torch.distributed as dist
        pg = mesh.get_group(axis)
        g = _AXIS_GROUPS[key] = Group(dist.get_process_group_ranks(pg),
                                      axis_name=axis, pg=pg)
    return g


def require_axis(mesh, axis):
    """Raise where ``mesh`` (a mesh, not ``None``) has no axis ``axis``, as
    JAX's ``mesh.shape[axis]`` does."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if mesh is not None and axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (its axes: "
                         f"{names})")


class CommunicateTopology:
    """The nd rank grid (reference topology.py:70)."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world = int(np.prod(self._dims))
        self._grid = np.arange(self._world).reshape(self._dims)

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, name):
        return self._dims[self._names.index(name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        idx = tuple(kwargs[n] for n in self._names)
        return int(self._grid[idx])

    def get_coord(self, rank):
        import collections
        coords = np.unravel_index(rank, self._dims)
        C = collections.namedtuple("Coord", self._names)
        return C(*[int(c) for c in coords])

    def get_axis_list(self, axis_name, index):
        axis = self._names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return sorted(self._grid[tuple(sl)].reshape(-1).tolist())

    def get_comm_list(self, axis_name):
        """Every group along ``axis_name``: a list of rank lists."""
        axis = self._names.index(axis_name)
        moved = np.moveaxis(self._grid, axis, -1)
        return moved.reshape(-1, self._dims[axis]).tolist()


_MESH_NAMES = (("data", "dp"), ("pipe", "pp"), ("sharding", "sharding"),
               ("sep", "sep"), ("model", "mp"))


class HybridCommunicateGroup:
    """The hybrid groups (reference topology.py:189): one ``DeviceMesh``
    over the world with the axes dp, pp, sharding, sep, mp (made the
    default mesh), and this rank's group along each."""

    def __init__(self, topology: CommunicateTopology):
        from .env import get_world_size, global_rank, is_initialized
        self._topo = topology
        self.global_rank = global_rank()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep")
        self._mp_degree = topology.get_dim("model")
        axes = {mesh: topology.get_dim(ref) for ref, mesh in _MESH_NAMES}
        self.mesh = None
        if is_initialized() and topology.world_size() == get_world_size():
            self.mesh = set_default_mesh(build_mesh(axes))

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def _coord(self):
        return self._topo.get_coord(self.global_rank)

    def get_data_parallel_rank(self):
        return self._coord().data

    def get_model_parallel_rank(self):
        return self._coord().model

    def get_stage_id(self):
        return self._coord().pipe

    def get_sharding_parallel_rank(self):
        return self._coord().sharding

    def get_sep_parallel_rank(self):
        return self._coord().sep

    def topology(self):
        return self._topo

    def get_data_parallel_group(self):
        return axis_group("dp", self.mesh)

    def get_model_parallel_group(self):
        return axis_group("mp", self.mesh)

    def get_pipe_parallel_group(self):
        return axis_group("pp", self.mesh)

    def get_sharding_parallel_group(self):
        return axis_group("sharding", self.mesh)

    def get_sep_parallel_group(self):
        return axis_group("sep", self.mesh)

    def get_check_parallel_group(self, *a, **k):
        from .communication.group import get_group
        return get_group(0)
