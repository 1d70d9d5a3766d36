"""Pipeline parallelism over the ``pp`` axis, eager on ``torch.distributed``
(port of ``paddle_tpu/parallel/pipeline.py``: ``PipelineTrainStep``, the
GPipe schedule; reference fleet/meta_parallel/pipeline_parallel.py, the P2P
helper p2p_communication.py:651).

JAX runs the schedule as one program: a ``lax.scan`` over ticks inside
``shard_map`` whose activations hop stage to stage with ``lax.ppermute``
and whose backward is ``jax.grad`` through the scan.  Here a mesh axis is a
process group and each rank a process (``distributed.topology``): every
rank runs its own stages' microbatches eagerly and hands activations on,
and cotangents back, with point-to-point calls
(``communication.collectives.batch_isend_irecv``), issued tick by tick in
one global order on both ends of each pair.  A hop to this rank itself (pp
1, or a chunk that wraps onto its own rank) is a tensor handoff, never a
P2P call.

The model is three functions, as in JAX:
  embed_apply(embed_params, batch)         -> [n_micro, mbs, ...]  (stage 0)
  block_apply(one_block_params, act)       -> act    (layers_per_stage each)
  head_loss_apply(head_params, act, batch) -> scalar loss       (last stage)

This module also holds what the schedules of ``pipeline_schedules`` share:
the ring (:class:`_Pipe`), the saved microbatch graph (:class:`_MbGraph`)
and the LM step's parameter placement and gradient combine
(:class:`_LMPipelineStep`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..distributed.communication.collectives import (
    P2POp, ReduceOp, all_gather, all_reduce, batch_isend_irecv, irecv, isend)

__all__ = ["PipelineTrainStep", "_flatten", "_unflatten"]


def _flatten(tree, prefix=""):
    """Nested dicts -> ``{"outer.inner": leaf}``; other leaves pass as they
    are (the port's parameters are dicts of tensors)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat, like):
    """The inverse of :func:`_flatten`, shaped like the nested dict
    ``like``."""
    out = {}
    for k, v in like.items():
        if isinstance(v, dict):
            sub = {kk[len(str(k)) + 1:]: vv for kk, vv in flat.items()
                   if kk.startswith(f"{k}.")}
            out[k] = _unflatten(sub, v)
        else:
            out[k] = flat[str(k)]
    return out


# -- the mesh ----------------------------------------------------------------
def _mesh_of(mesh):
    from ..distributed.topology import get_default_mesh
    from ..distributed.env import is_initialized
    if mesh is not None:
        return mesh
    return get_default_mesh() if is_initialized() else None


def _axis_names(mesh):
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def _axis_size(mesh, axis):
    names = _axis_names(mesh)
    return int(mesh.size(names.index(axis))) if axis in names else 1


def _batch_axes(mesh, batch_spec, default):
    """The mesh axes the batch's leading axis splits over: ``batch_spec``
    (an axis name or a sequence of them, JAX's ``P(...)`` entries) or the
    ``default`` axes the mesh has."""
    if batch_spec is None:
        return tuple(a for a in default if a in _axis_names(mesh))
    if isinstance(batch_spec, str):
        return (batch_spec,)
    out = []
    for a in batch_spec:
        if a is None:
            continue
        out.extend((a,) if isinstance(a, str) else tuple(a))
    return tuple(out)


def _local_batch(batch, mesh, axes, device):
    """This rank's part of the global ``batch`` (a tensor or a tuple of
    them): the leading axis cut over ``axes`` in order, as ``shard_map``
    cuts it over ``P(axes)``."""
    from ..distributed.topology import axis_group
    batch = batch if isinstance(batch, (tuple, list)) else (batch,)
    parts, index = 1, 0
    for a in axes:
        g = axis_group(a, mesh)
        parts, index = parts * g.nranks, index * g.nranks + max(g.rank, 0)
    out = []
    for b in batch:
        if isinstance(b, np.ndarray) or np.isscalar(b):
            b = torch.as_tensor(b)
        b = b.to(device, non_blocking=True)
        if parts > 1:
            if b.shape[0] % parts:
                raise ValueError(f"batch dim {b.shape[0]} does not split "
                                 f"over {parts} ranks of {axes}")
            per = b.shape[0] // parts
            b = b[index * per:(index + 1) * per]
        out.append(b)
    return tuple(out)


def _microbatches(batch, n_micro):
    """Each tensor of ``batch`` as ``[n_micro, mbs, ...]``."""
    out = []
    for x in batch:
        if x.shape[0] % n_micro:
            raise ValueError(f"batch dim {x.shape[0]} does not split into "
                             f"{n_micro} microbatches")
        out.append(x.reshape((n_micro, x.shape[0] // n_micro)
                             + tuple(x.shape[1:])))
    return tuple(out)


# -- the ring -----------------------------------------------------------------
class _Pipe:
    """This rank's place on the ``pp`` ring: n ranks, this one r, the hops
    of a tick (:meth:`exchange`) and the receive rings (one preallocated
    buffer a slot, at the activation's shape and dtype)."""

    def __init__(self, mesh, device):
        from ..distributed.communication.group import get_backend
        from ..distributed.topology import axis_group
        self.group = axis_group("pp", mesh)
        self.n = self.group.nranks
        self.r = max(self.group.rank, 0)
        self.device = device
        self._rings = {}
        if self.n > 1 and get_backend() == "nccl":
            # NCCL makes a group's communicator on its first collective, and
            # a first batched P2P call would need every rank of the group
            all_reduce(torch.zeros(1, device=device), ReduceOp.SUM,
                       self.group)

    def buffer(self, key, slot, like):
        """Slot ``slot`` of the receive ring ``key``, a tensor shaped and
        typed like ``like`` ((shape, dtype)), made once and reused."""
        shape, dtype = like
        buf = self._rings.get((key, slot))
        if buf is None or tuple(buf.shape) != tuple(shape) \
                or buf.dtype != dtype:
            buf = self._rings[(key, slot)] = torch.empty(
                shape, dtype=dtype, device=self.device)
        return buf

    def exchange(self, msgs):
        """One tick's hops.  ``msgs`` lists every hop of the tick in one
        global order, the same on every rank: ``(src, dst, tensor, key)``
        with ``src`` / ``dst`` pp ranks, ``tensor`` the payload where this
        rank sends and the receive buffer where it receives.  A hop from
        this rank to itself is a handoff.  Returns ``{key: tensor}`` of what
        this rank got."""
        got, ops = {}, []
        for src, dst, t, key in msgs:
            if src == self.r and dst == self.r:
                got[key] = t
            elif src == self.r:
                ops.append(P2POp(isend, t.contiguous(),
                                 self.group.ranks[dst], self.group))
            elif dst == self.r:
                ops.append(P2POp(irecv, t, self.group.ranks[src],
                                 self.group))
                got[key] = t
        if ops:
            for task in batch_isend_irecv(ops):
                task.wait()
        return got


def _hop(pipe, kind, src, dst, outs, mb, depth, like):
    """One hop of a tick between virtual stages ``src`` -> ``dst`` (each
    owned by rank ``stage % n``): this rank's payload ``outs[src]`` where it
    owns ``src``, its receive buffer (ring slot ``mb % depth`` of ``(kind,
    dst)``) where it owns ``dst``; an entry of :meth:`_Pipe.exchange`."""
    n = pipe.n
    if src % n == pipe.r:
        t = outs[src]
    elif dst % n == pipe.r:
        t = pipe.buffer((kind, dst), mb % depth, like)
    else:
        t = None
    return (src % n, dst % n, t, (kind, dst))


def _leaf(t):
    """A received (or handed-off) activation as the stage input whose
    gradient the backward returns."""
    return t.detach().requires_grad_(True)


class _MbGraph:
    """One microbatch's forward through one virtual stage, kept until its
    backward: ``out`` the stage's output (sent on), ``loss`` the head loss
    (last stage), ``x_in`` the stage input whose gradient is sent back
    (the block chain's input on stage 0), ``targets`` the parameter tensors
    of the stage (views of the stacked leaves included) and ``accs`` the
    accumulators their gradients add into; ``g`` the cotangent, kept from
    B to W."""

    __slots__ = ("out", "loss", "x_in", "targets", "accs", "g")

    def __init__(self, out, loss, x_in, targets, accs):
        self.out, self.loss, self.x_in = out, loss, x_in
        self.targets, self.accs, self.g = targets, accs, None

    def root(self, g):
        """What the backward starts from: the loss on the last stage, else
        the output with the cotangent ``g``."""
        return (self.loss, None) if self.loss is not None else (self.out, g)

    def accumulate(self, grads):
        for acc, g in zip(self.accs, grads):
            if g is not None:
                acc.add_(g)


def _backward(rec, g, want_input):
    """The whole backward of ``rec``: parameter gradients accumulated, the
    input's gradient returned when ``want_input``."""
    root, go = rec.root(g)
    inputs = list(rec.targets) + ([rec.x_in] if want_input else [])
    grads = torch.autograd.grad(root, inputs, go, allow_unused=True)
    rec.accumulate(grads[:len(rec.targets)])
    if not want_input:
        return None
    gx = grads[-1]
    return torch.zeros_like(rec.x_in) if gx is None else gx


# -- the gradient combine and the LM step's parameters ----------------------
@torch.no_grad()
def _combine(pipe, mesh, loss_sum, scale, grads, pp_summed, avg_axes,
             split=None):
    """JAX's combine of a pipeline step's loss and gradients: the loss
    (``loss_sum * scale``, nonzero on the last stage) summed over pp and
    averaged over every other axis; the gradients (``grads``, dicts of
    tensors, in place) scaled, those of ``pp_summed`` summed over pp, and
    every one averaged over ``avg_axes`` — except a leaf split over that
    axis (``split``: per tree of ``grads``, a dict of each leaf's axes, as
    ``block_specs`` gives them), which is scaled by 1 / the axis's size
    with no collective (JAX ``pipeline_schedules.py:329-346``: each rank
    holds other experts, and every rank's loss reached them).  Returns the
    loss."""
    from ..distributed.topology import axis_group
    loss = (loss_sum * scale).reshape(())
    all_reduce(loss, ReduceOp.SUM, pipe.group)
    for ax in _axis_names(mesh):
        if ax != "pp" and _axis_size(mesh, ax) > 1:
            all_reduce(loss, ReduceOp.AVG, axis_group(ax, mesh))
    for t in grads:
        for g in t.values():
            g.mul_(scale)
    for t in pp_summed:
        for g in t.values():
            all_reduce(g, ReduceOp.SUM, pipe.group)
    split = split or [{}] * len(grads)
    for ax in avg_axes:
        n = _axis_size(mesh, ax)
        if n > 1:
            grp = axis_group(ax, mesh)
            for t, axes in zip(grads, split):
                for name, g in t.items():
                    if ax in axes.get(name, ()):
                        g.mul_(1.0 / n)
                    else:
                        all_reduce(g, ReduceOp.AVG, grp)
    return loss


def _cut(v, dim, group):
    w = v.shape[dim] // group.nranks
    if v.shape[dim] % group.nranks:
        raise ValueError(f"axis {dim} of {tuple(v.shape)} does not split "
                         f"over {group.nranks} ranks")
    return v.narrow(dim, max(group.rank, 0) * w, w)


class _LMPipelineStep:
    """What the GPipe and the 1F1B LM steps share: the placement of the
    three parameter trees on this rank (embed and head whole, this rank's
    layers of the ``[L, ...]`` block stack in ``n_chunks`` chunks, the
    ``block_specs`` leaves cut to this rank's mp shard), their optimizer
    states, the gradient accumulators, the combine of loss and gradients
    over the mesh and the update."""

    def _place(self, mesh, embed_params, block_params, head_params,
               optimizer, n_micro, n_chunks, batch_spec, block_specs,
               device):
        from ..distributed.topology import axis_group
        self.device = resolve_device(device)
        self.mesh = _mesh_of(mesh)
        self.opt = optimizer
        self.n_micro = int(n_micro)
        self.n_chunks = int(n_chunks)
        self.pipe = _Pipe(self.mesh, self.device)
        self.n_pp = self.pipe.n
        self._block_specs = dict(block_specs or {})
        self._batch_axes = _batch_axes(self.mesh, batch_spec, ("dp", "ep"))
        n, v = self.n_pp, self.n_chunks
        L = next(iter(block_params.values())).shape[0]
        if L % (n * v):
            raise ValueError(f"layers {L} not divisible by n_pp*n_chunks = "
                             f"{n}*{v}")
        self.n_layers = L
        self.lpc = L // (n * v)                 # layers per chunk
        # chunk c of rank r holds virtual stage c * n + r (JAX's vpp_order)
        self.layer_ids = [(c * n + self.pipe.r) * self.lpc + i
                          for c in range(v) for i in range(self.lpc)]

        def own(v_):
            return v_.to(self.device).detach().requires_grad_(True)

        def local_block(name, t):
            if getattr(t, "is_distributed", False) is not True:
                for i, ax in enumerate(self._block_specs.get(name, ())):
                    if ax is not None:
                        t = _cut(t, 1 + i, axis_group(ax, self.mesh))
            lo = self.layer_ids[0]
            if self.layer_ids == list(range(lo, lo + len(self.layer_ids))):
                t = t.narrow(0, lo, len(self.layer_ids))
            else:
                t = t[self.layer_ids]
            return own(t)
        self.embed_params = {k: own(t) for k, t in embed_params.items()}
        self.block_params = {k: local_block(k, t)
                             for k, t in block_params.items()}
        self.head_params = {k: own(t) for k, t in head_params.items()}
        self.trees = (self.embed_params, self.block_params, self.head_params)
        self.opt_state = {
            name: optimizer.init_opt_state(_flatten(t), device=self.device)
            for name, t in zip(("embed", "block", "head"), self.trees)}
        self._grads = None
        self._likes = {}
        self.max_in_flight = 0

    def _like(self, batch, embed):
        """A microbatch activation's (shape, dtype), learnt once for the
        shapes of ``batch`` from ``embed()`` (stage 0's embed of one
        microbatch, run without gradients: JAX's ``eval_shape``)."""
        key = tuple(tuple(b.shape) for b in batch)
        if key not in self._likes:
            with torch.no_grad():
                x = embed()
            self._likes[key] = (tuple(x.shape), x.dtype)
        return self._likes[key]

    def _zero_grads(self):
        if self._grads is None:
            self._grads = tuple({k: torch.zeros_like(v) for k, v in t.items()}
                                for t in self.trees)
        else:
            for t in self._grads:
                for g in t.values():
                    g.zero_()
        return self._grads

    def _combine_and_update(self, loss_sum, grads, scale):
        """:func:`_combine` with embed's and head's gradients summed over
        pp (each lives on its owning stage) and every one averaged over the
        batch's axes, but the block leaves split over ``ep`` (the
        experts), which are scaled by 1 / ep.  Under mp the blocks' own
        ``copy_to_group`` / ``reduce_from_group`` already give each rank
        the whole gradient of its replicated leaves and the true gradient
        of its shards, so JAX's pmean over mp and its 1/n_ax rescale of
        sharded leaves (the transposes inside ``shard_map`` over-count)
        have nothing to do here.  Then the update."""
        ge, gb, gh = grads
        loss = _combine(self.pipe, self.mesh, loss_sum, scale, grads,
                        (ge, gh), self._batch_axes,
                        ({}, self._block_specs, {}))
        with torch.no_grad():
            lr = self.opt.get_lr()
            for name, p, g in zip(("embed", "block", "head"), self.trees,
                                  grads):
                self.opt.apply_gradients_functional(
                    _flatten(p), _flatten(g), self.opt_state[name], lr=lr)
        self.opt.finish_step()
        return loss

    @torch.no_grad()
    def materialized_params(self):
        """(embed, block, head) with the block stack all-gathered over pp
        into the original ``[L, ...]`` layer order (every pp rank must
        call it); detached copies.  Leaves cut over mp stay this rank's
        shards."""
        blocks = {}
        for k, v in self.block_params.items():
            parts = all_gather(None, v.detach().contiguous(),
                               self.pipe.group)     # [n, v * lpc, ...]
            full = torch.empty((self.n_layers,) + tuple(v.shape[1:]),
                               dtype=v.dtype, device=v.device)
            for r in range(self.n_pp):
                for c in range(self.n_chunks):
                    lo = (c * self.n_pp + r) * self.lpc
                    full[lo:lo + self.lpc] = parts[r][c * self.lpc:
                                                      (c + 1) * self.lpc]
            blocks[k] = full
        return ({k: v.detach().clone() for k, v in self.embed_params.items()},
                blocks,
                {k: v.detach().clone() for k, v in self.head_params.items()})


class PipelineTrainStep(_LMPipelineStep):
    """The GPipe train step (JAX ``pipeline.py:86``): dp x pp (x mp through
    the blocks) for LM-shaped models, with JAX's whole-batch contract —
    ``embed_apply(ep, batch) -> [n_micro, mbs, ...]`` on stage 0,
    ``head_loss_apply(hp, y, batch)`` over all ``n_micro`` outputs on the
    last stage.  Every microbatch runs forward through the ring first,
    then every backward (JAX's F-then-B: ``jax.grad`` through the scan), so
    a rank holds all ``n_micro`` microbatch graphs at once
    (``max_in_flight``).

    ``block_params`` is the full ``[L, ...]`` stack; rank r keeps layers
    ``[r * L / n_pp, (r + 1) * L / n_pp)``.  The tensors kept may share
    storage with those given and are updated in place.  ``batch_spec``
    names the axes the batch splits over (default ``dp``); ``donate`` is
    accepted for JAX's signature.  ``device=None`` means the card."""

    def __init__(self, mesh, embed_apply, block_apply, head_loss_apply,
                 embed_params, block_params, head_params, optimizer,
                 n_micro: int, batch_spec=None, donate=True, device=None):
        self._place(mesh, embed_params, block_params, head_params,
                    optimizer, n_micro, 1, batch_spec or ("dp",), None,
                    device)
        self.embed_apply = embed_apply
        self.block_apply = block_apply
        self.head_loss_apply = head_loss_apply

    def _blocks(self, x):
        """This rank's layers on ``x``: the output (the stacked leaves are
        the gradient targets)."""
        layers = {k: v.unbind(0) for k, v in self.block_params.items()}
        for i in range(self.lpc):
            x = self.block_apply({k: layers[k][i] for k in layers}, x)
        return x

    def __call__(self, batch):
        batch = _local_batch(batch, self.mesh, self._batch_axes, self.device)
        pipe, M = self.pipe, self.n_micro
        n, r = pipe.n, pipe.r
        ge, gb, gh = self._zero_grads()
        first, last = r == 0, r == n - 1
        x_all = self.embed_apply(self.embed_params, batch) if first else None
        like = self._like(batch, lambda: x_all[0] if first else
                          self.embed_apply(self.embed_params, batch)[0])
        held, acts = [], {}
        ticks = M + n - 1
        for t in range(ticks):                       # forward phase
            m, outs = t - r, {}
            if 0 <= m < M:
                x_in = _leaf(x_all[m] if first else acts.pop(r))
                held.append(_MbGraph(self._blocks(x_in), None, x_in,
                                     list(self.block_params.values()),
                                     list(gb.values())))
                outs[r] = held[m].out.detach()
            msgs = [_hop(pipe, "f", s, s + 1, outs, t - s, M, like)
                    for s in range(n - 1) if 0 <= t - s < M]
            for (_, dst), x in pipe.exchange(msgs).items():
                acts[dst] = x
        self.max_in_flight = len(held)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        if last:
            ys = [_leaf(rec.out) for rec in held]
            hp = list(self.head_params.values())
            head = self.head_loss_apply(self.head_params, torch.stack(ys),
                                        batch)
            grads = torch.autograd.grad(head, hp + ys)
            for acc, g in zip(gh.values(), grads[:len(hp)]):
                acc.add_(g)
            head_cots = grads[len(hp):]
            loss = head.detach().float()
        gx, cots = [None] * M, {}
        for t in range(ticks):                       # backward phase
            m, outs = t - (n - 1 - r), {}
            if 0 <= m < M:
                g = head_cots[m] if last else cots.pop(r)
                gx[m] = outs[r] = _backward(held[m], g, True)
                held[m] = None
            msgs = [_hop(pipe, "b", s, s - 1, outs, 0, 1, like)
                    for s in range(n - 1, 0, -1) if 0 <= t - (n - 1 - s) < M]
            for (_, dst), x in pipe.exchange(msgs).items():
                cots[dst] = x
        if first:
            grads = torch.autograd.grad(
                x_all, list(self.embed_params.values()), torch.stack(gx))
            for acc, g in zip(ge.values(), grads):
                acc.add_(g)
        return self._combine_and_update(loss, (ge, gb, gh), 1.0)
