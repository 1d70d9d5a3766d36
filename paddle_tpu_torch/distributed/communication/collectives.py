"""Collective communication (port of
``paddle_tpu/distributed/communication/collectives.py``; reference
python/paddle/distributed/communication/*.py over ProcessGroupNCCL,
process_group_nccl.h:37).

Eager calls on ``torch.distributed`` with Paddle's signatures: ``tensor``
arguments are updated in place, a ``src`` / ``dst`` / peer is a global rank,
``sync_op=False`` returns a task whose ``wait()`` goes through the watchdog.
JAX's traced path (collectives inside ``shard_map``) has no counterpart:
every call here issues its collective when it is made.  Before
``init_parallel_env`` (one participant), and over a ``solo`` group (this
rank alone), each call is the identity.

Every issued collective adds one to its kind's count in
:data:`COLLECTIVE_COUNTS` (``all_reduce``, ``reduce``, ``all_gather``,
``broadcast``, ``scatter``, ``reduce_scatter``, ``all_to_all``, ``gather``,
``send``, ``recv``, ``barrier``) — the port's tests read these where the
JAX tests read the collective out of the compiled HLO.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from .watchdog import wait_with_timeout

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_gather_object",
           "all_gather_into_tensor", "reduce", "broadcast", "scatter",
           "reduce_scatter", "all_to_all",
           "all_to_all_single", "send", "recv", "isend", "irecv",
           "batch_isend_irecv", "P2POp", "gather", "COLLECTIVE_COUNTS",
           "collective_counts", "reset_collective_counts"]

#: collectives issued, by kind, since the last reset
COLLECTIVE_COUNTS = collections.Counter()


def collective_counts() -> dict:
    return dict(COLLECTIVE_COUNTS)


def reset_collective_counts():
    COLLECTIVE_COUNTS.clear()


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}   # AVG: SUM, then / n

# the single-tensor collectives under their current names (older torch
# has only the second)
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _inited():
    return dist.is_available() and dist.is_initialized()


def _solo(group):
    """One participant: no world yet, or a group of this rank alone."""
    return not _inited() or getattr(group, "solo", False)


def _pg(group):
    return None if group is None else group.process_group


def _nranks(group):
    return dist.get_world_size(_pg(group))


class _Task:
    """An issued collective; ``wait()`` waits through the watchdog."""

    def __init__(self, work, kind, on_card, result=None):
        self.work, self.kind, self.on_card = work, kind, on_card
        self.result = result

    def wait(self, timeout=None):
        from ..env import comm_timeout_s
        wait_with_timeout(self.work, timeout or comm_timeout_s(), self.kind,
                          on_card=self.on_card)
        return self.result

    def is_completed(self):
        return self.work.is_completed()


def _on_card(*tensors):
    return any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in tensors)


def _issue(kind, fn, sync_op, *args, result=None, **kw):
    """Issue one collective, count it, and wait through the watchdog
    (``sync_op``) or return its task.  ``fn`` is a ``torch.distributed``
    call taking ``async_op``, or ``isend`` / ``irecv`` (always async)."""
    from ..env import comm_timeout_s
    COLLECTIVE_COUNTS[kind] += 1
    if fn not in (dist.isend, dist.irecv):
        kw["async_op"] = True
    work = fn(*args, **kw)
    task = _Task(work, kind, _on_card(*args, result), result)
    if sync_op:
        wait_with_timeout(work, comm_timeout_s(), kind, on_card=task.on_card)
        return result
    return task


def _avg(tensor, op, group, sync_op):
    if op == ReduceOp.AVG:
        if not sync_op:
            raise NotImplementedError("ReduceOp.AVG with sync_op=False")
        n = _nranks(group)
        if tensor.is_floating_point():
            tensor.div_(n)
        else:
            tensor.floor_divide_(n)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place."""
    if _solo(group):
        return tensor
    out = _issue("all_reduce", dist.all_reduce, sync_op, tensor,
                 op=_TORCH_OP[op], group=_pg(group), result=tensor)
    _avg(tensor, op, group, sync_op)
    return out


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` onto rank ``dst`` (the others keep an undefined
    value, as the reference's)."""
    if _solo(group):
        return tensor
    out = _issue("reduce", dist.reduce, sync_op, tensor, dst,
                 op=_TORCH_OP[op], group=_pg(group), result=tensor)
    if dist.get_rank() == dst:
        _avg(tensor, op, group, sync_op)
    return out


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Append every rank's ``tensor`` to ``tensor_list``; returns them
    stacked."""
    if _solo(group):
        if isinstance(tensor_list, list):
            tensor_list.append(tensor.clone())
        return tensor[None].clone()
    n = _nranks(group)
    out = torch.empty((n,) + tuple(tensor.shape), dtype=tensor.dtype,
                      device=tensor.device)
    _issue("all_gather", _all_gather_single, sync_op, out.view(-1),
           tensor.contiguous().view(-1), group=_pg(group), result=out)
    if isinstance(tensor_list, list):
        tensor_list.extend(out.unbind(0))
    return out


def all_gather_into_tensor(out, tensor, group=None, sync_op=True):
    """Every rank's ``tensor`` laid end to end, in rank order, into the flat
    ``out`` (``numel`` = ranks x ``tensor.numel()``)."""
    if _solo(group):
        out.view(-1).copy_(tensor.reshape(-1))
        return out
    return _issue("all_gather", _all_gather_single, sync_op, out.view(-1),
                  tensor.contiguous().view(-1), group=_pg(group), result=out)


def all_gather_object(object_list, obj, group=None):
    if _solo(group):
        object_list.append(obj)
        return
    COLLECTIVE_COUNTS["all_gather"] += 1
    got = [None] * _nranks(group)
    dist.all_gather_object(got, obj, group=_pg(group))
    object_list.extend(got)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``tensor`` of global rank ``src`` into every rank's, in place."""
    if _solo(group):
        return tensor
    return _issue("broadcast", dist.broadcast, sync_op, tensor, src,
                  group=_pg(group), result=tensor)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``src``'s ``tensor_list[i]`` into the i-th rank's ``tensor``."""
    if _solo(group):
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    lst = [t.contiguous() for t in tensor_list] \
        if dist.get_rank() == src else None
    return _issue("scatter", dist.scatter, sync_op, tensor, lst, src,
                  group=_pg(group), result=tensor)


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """The group's sum of ``tensor_list[i]`` (a list, or a tensor stacked
    on its first axis) into the i-th rank's ``tensor``."""
    if isinstance(tensor_list, (list, tuple)):
        stacked = torch.stack([t for t in tensor_list])
    else:
        stacked = tensor_list
    if _solo(group):
        red = stacked.sum(0) if op in (ReduceOp.SUM, ReduceOp.AVG) \
            else stacked.amax(0) if op == ReduceOp.MAX \
            else stacked.amin(0) if op == ReduceOp.MIN else stacked.prod(0)
        tensor.copy_(red)
        return tensor
    src = stacked.contiguous().reshape(-1)
    dst = tensor if tensor.is_contiguous() else torch.empty_like(tensor)
    out = _issue("reduce_scatter", _reduce_scatter_single, sync_op,
                 dst.view(-1), src, op=_TORCH_OP[op], group=_pg(group),
                 result=tensor)
    if dst is not tensor:
        tensor.copy_(dst)
    _avg(tensor, op, group, sync_op)
    return out


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Slot i of ``in_tensor_list`` to rank i; what each rank sent this one
    is appended to ``out_tensor_list`` in rank order (one
    ``all_to_all_single`` over the stacked slots: gloo has no list
    form)."""
    if _solo(group):
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return
    stacked = torch.stack(list(in_tensor_list)).contiguous()
    out = torch.empty_like(stacked)
    _issue("all_to_all", dist.all_to_all_single, sync_op, out, stacked,
           group=_pg(group), result=out)
    out_tensor_list.extend(out.unbind(0))


def all_to_all_single(out_tensor, in_tensor, out_split_sizes=None,
                      in_split_sizes=None, group=None, sync_op=True):
    if _solo(group):
        out_tensor.copy_(in_tensor)
        return out_tensor
    return _issue("all_to_all", dist.all_to_all_single, sync_op, out_tensor,
                  in_tensor.contiguous(), output_split_sizes=out_split_sizes,
                  input_split_sizes=in_split_sizes, group=_pg(group),
                  result=out_tensor)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor`` appended, in rank order, to rank ``dst``'s
    ``gather_list``."""
    if _solo(group):
        if gather_list is not None:
            gather_list.append(tensor.clone())
        return tensor
    bufs = None
    if dist.get_rank() == dst:
        bufs = [torch.empty_like(tensor) for _ in range(_nranks(group))]
    _issue("gather", dist.gather, sync_op, tensor.contiguous(), bufs, dst,
           group=_pg(group))
    if bufs is not None and gather_list is not None:
        gather_list.extend(bufs)
    return tensor


def _need_peers(kind, group=None):
    if _solo(group):
        raise RuntimeError(
            f"{kind} needs a peer: call init_parallel_env first, over a "
            "group of more than this rank (a silent no-op would deliver "
            "nothing)")


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send to global rank ``dst`` (reference
    communication/send.py)."""
    _need_peers("send", group)
    return _issue("send", dist.isend, sync_op, tensor.contiguous(), dst,
                  group=_pg(group), result=tensor)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive from global rank ``src`` into ``tensor``, in place."""
    _need_peers("recv", group)
    return _issue("recv", dist.irecv, sync_op, tensor, src,
                  group=_pg(group), result=tensor)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One send or receive of :func:`batch_isend_irecv`: ``op`` is this
    module's ``isend`` / ``irecv`` (or ``send`` / ``recv``)."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv, send, recv):
            raise ValueError("P2POp: op must be isend, irecv, send or recv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Issue every op of the list together; returns their tasks."""
    _need_peers("batch_isend_irecv")
    for p in p2p_op_list:
        _need_peers("batch_isend_irecv", p.group)
    ops = []
    for p in p2p_op_list:
        sending = p.op in (isend, send)
        COLLECTIVE_COUNTS["send" if sending else "recv"] += 1
        ops.append(dist.P2POp(dist.isend if sending else dist.irecv,
                              p.tensor, p.peer, group=_pg(p.group)))
    works = dist.batch_isend_irecv(ops)
    return [_Task(w, "send" if p.op in (isend, send) else "recv",
                  _on_card(p.tensor), p.tensor)
            for w, p in zip(works, p2p_op_list)]
