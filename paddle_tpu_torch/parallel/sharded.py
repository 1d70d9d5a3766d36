"""The ZeRO (group-sharded) train step, stages 0-3 (port of
``paddle_tpu/parallel/sharded.py``; reference
python/paddle/distributed/fleet/meta_parallel/sharding/
group_sharded_stage2.py, group_sharded_stage3.py:174 ``_param2buffer``,
:335 ``_update_params_slice``, :560 the forward gather / release hooks).

JAX's layouts, kept: every parameter is flattened and zero-padded to
``n * chunk`` so each of the n ranks of the ZeRO axis owns one contiguous
``chunk`` slice; ``bucket=True`` packs every parameter of one dtype into one
flat buffer (``_layout`` holds each leaf's buffer and offset), so a step
issues one collective a bucket instead of one a leaf.

* stage 0: the gradients all-reduced to their mean, the update on the
  whole (replicated) buffer;
* stage 1: the gradients all-reduced, each rank updates its slice with its
  shard of the optimizer state, the slices all-gathered back;
* stage 2: the gradients reduce-scattered (each rank receives the sum of
  its slice), then as stage 1;
* stage 3: the buffers live sharded between steps; the step all-gathers
  them for the forward and the backward reduce-scatters the gradients
  (``communication.differentiable.gather_flat_leaves``), and only the
  local slice is updated.  With ``remat`` the backward gathers again.

A step is eager: forward and backward through autograd, the collectives
through :mod:`paddle_tpu_torch.distributed.communication` (counted by
kind), the update through ``opt.apply_gradients_functional`` on the
slices — with ``AdamW(fused=True)`` one launch of the fused AdamW kernel a
bucket.  The gradients are reduced in f32, as JAX casts them.

``loss_fn(params, batch)`` takes the parameters as a dict of tensors (as
nested as ``params`` was) and the batch as a tuple.  ``params`` is a dict
of tensors, or an ``nn.Module`` whose trainable parameters are taken in
its order, by dotted name, and whose loss goes through
``torch.func.functional_call(model, params, ...)`` inside ``loss_fn``.  At
stages 0-2 a module's parameters are rebound onto the flat buffers (the
module sees every update); at stage 3 they are released (the flat slices
hold the model).  The batch given to a call is the global batch: its
leading axis is split over the ranks, as JAX's ``shard_map`` splits it, and
the loss is the mean over the ranks.  ``remat`` recomputes the forward in
the backward (``torch.utils.checkpoint``, which replays the default CPU
and CUDA generators); the ``torch.Generator``s a module's submodules hold
(ERNIE's dropout generators) are replayed too, so the recompute draws the
forward's masks, as JAX's ``jax.checkpoint`` replays its keys.  A dict
``loss_fn`` that draws from a generator of its own is not replayed.

The flat layout, the gradient reduction by stage, the global norm and the
all-gather of the updated slices are :class:`FlatLayout`'s, which the
eager ``distributed.sharding.group_sharded_parallel`` shares.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import on_device, resolve_device
from ..distributed.communication.collectives import (
    ReduceOp, all_gather_into_tensor, all_reduce, reduce_scatter)

__all__ = ["ShardedTrainStep", "zero_stage_name"]


def zero_stage_name(stage) -> int:
    """Paddle's level strings ('os', 'os_g', 'p_g_os') as 0/1/2/3 (0:
    plain data parallel, nothing sharded)."""
    if stage in (0, 1, 2, 3):
        return int(stage)
    table = {"os": 1, "os_g": 2, "p_g_os": 3,
             "stage1": 1, "stage2": 2, "stage3": 3, "none": 0,
             "0": 0, "1": 1, "2": 2, "3": 3}
    key = str(stage)
    if key not in table:
        raise ValueError(
            f"unknown ZeRO stage {stage!r}; expected one of 0/1/2/3 or "
            f"{sorted(table)}")
    return table[key]


def _tree_leaves(tree, prefix=""):
    """(dotted name, leaf) pairs of a nested dict in JAX's flattening order
    (keys sorted at every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_tree_leaves(v, name))
        else:
            out.append((name, v))
    return out


def _tree_unflatten(like, leaves):
    """The nested dict shaped like ``like`` with ``leaves`` in
    :func:`_tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return build(like)


def _dtype_name(dt):
    return str(dt).split(".")[-1]


class FlatLayout:
    """JAX's flat layout (``paddle_tpu/parallel/sharded.py:83-124``) of
    leaves of ``shapes`` / ``dtypes`` over ``group``'s n ranks: each leaf
    (with ``bucket``, every leaf of one dtype, in order) in one flat buffer
    zero-padded to n * chunk, of which rank r owns ``[r * chunk,
    (r + 1) * chunk)``.  ``layout`` holds each leaf's (buffer, offset)."""

    def __init__(self, shapes, dtypes, group, bucket=False):
        n = self.n = group.nranks
        self.group, self.rank = group, max(group.rank, 0)
        self.shapes = [tuple(sh) for sh in shapes]
        self.sizes = [int(np.prod(sh)) if sh else 1 for sh in self.shapes]
        if bucket:
            totals = {}
            self.layout = []
            for size, dt in zip(self.sizes, dtypes):
                key = f"b_{_dtype_name(dt)}"
                off = totals.get(key, 0)
                self.layout.append((key, off))
                totals[key] = off + size
        else:
            self.layout = [(f"p{i}", 0) for i in range(len(self.sizes))]
            totals = {k: size for (k, _), size in zip(self.layout,
                                                      self.sizes)}
        self.padded = {k: ((t + n - 1) // n) * n for k, t in totals.items()}
        self.keys = list(self.padded)
        self.chunk = {k: v // n for k, v in self.padded.items()}
        self.dtype_of = {k: dt for (k, _), dt in zip(self.layout, dtypes)}

    def flatten(self, tensors, device, dtype=None):
        """The leaves laid into their zero-padded flat buffers (each of its
        leaves' dtype, or ``dtype``).  A ``None`` leaf stays zero; a buffer
        none of whose leaves is given is left out."""
        out = {}
        with torch.no_grad():
            for (k, off), size, t in zip(self.layout, self.sizes, tensors):
                if t is None:
                    continue
                if k not in out:
                    out[k] = torch.zeros(self.padded[k], device=device,
                                         dtype=dtype or self.dtype_of[k])
                out[k][off:off + size].copy_(t.reshape(-1))
        return out

    def views(self, flats):
        """Each leaf's view into the full flat buffers ``flats``."""
        return [flats[k][off:off + size].view(shape)
                for (k, off), size, shape in zip(self.layout, self.sizes,
                                                 self.shapes)]

    def own(self, flat, key):
        """This rank's slice of the full buffer ``flat`` of ``key``."""
        c = self.chunk[key]
        return flat[self.rank * c:(self.rank + 1) * c]

    def reduce_grads(self, gflat, stage):
        """This rank's share of the group's mean of the f32 flat gradients
        ``gflat``: the whole mean at stage 0, its slice of the all-reduced
        mean at stage 1, the reduce-scattered slice over n from stage 2."""
        out = {}
        for k, g in gflat.items():
            if stage >= 2:
                loc = torch.empty(self.chunk[k], dtype=g.dtype,
                                  device=g.device)
                reduce_scatter(loc, g.view(self.n, -1), ReduceOp.SUM,
                               self.group)
                out[k] = loc.div_(self.n)
            else:
                all_reduce(g, ReduceOp.AVG, self.group)
                out[k] = g if stage == 0 else self.own(g, k)
        return out

    def global_norm(self, shares, sharded):
        """The global norm of the gradients of which ``shares`` (f32) are
        this rank's: the squared sums of disjoint slices summed over the
        group where ``sharded``, else this rank's whole copy's."""
        sq = torch.zeros((), dtype=torch.float32,
                         device=next(iter(shares.values())).device)
        for g in shares.values():
            sq = sq + torch.sum(torch.square(g))
        if sharded:
            all_reduce(sq, ReduceOp.SUM, self.group)
        return torch.sqrt(sq)

    def gather_(self, flats, slices):
        """Every rank's slice of ``slices`` all-gathered back into the full
        buffers ``flats``, in place."""
        for k, s in slices.items():
            all_gather_into_tensor(flats[k], s.clone(), self.group)
        return flats


def _module_generators(module):
    """The ``torch.Generator``s ``module``'s submodules hold, once each."""
    seen = {}
    for m in module.modules():
        for v in vars(m).values():
            if isinstance(v, torch.Generator):
                seen.setdefault(id(v), v)
    return list(seen.values())


def _replay(generators):
    """``checkpoint``'s ``context_fn``: the recompute starts ``generators``
    where the forward started them and leaves them where the forward left
    them, so it draws the forward's masks and each advances once a step."""
    saved = []

    @contextlib.contextmanager
    def forward():
        saved[:] = [g.get_state() for g in generators]
        yield

    @contextlib.contextmanager
    def recompute():
        after = [g.get_state() for g in generators]
        for g, st in zip(generators, saved):
            g.set_state(st)
        try:
            yield
        finally:
            for g, st in zip(generators, after):
                g.set_state(st)
    return lambda: (forward(), recompute())


class ShardedTrainStep:
    """``step(batch) -> loss`` over ``params`` with ``opt`` at ZeRO
    ``stage`` over the ``axis`` group of ``mesh`` (the default mesh when
    ``None``)."""

    def __init__(self, mesh, loss_fn: Callable, params, opt, stage=2,
                 axis: str = "dp", remat: bool = False,
                 clip_norm: Optional[float] = None, donate: bool = True,
                 bucket: bool = False, device=None):
        """``donate`` is accepted for JAX's signature: the updates are in
        place anyway."""
        from ..distributed.topology import (axis_group, get_default_mesh,
                                            require_axis)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else get_default_mesh()
        require_axis(self.mesh, axis)
        self.axis = axis
        self.group = axis_group(axis, self.mesh)
        self.stage = zero_stage_name(stage)
        self.opt = opt
        self.remat = remat
        self.clip_norm = clip_norm
        self.bucket = bucket
        self.n_shards = self.group.nranks
        self.rank = max(self.group.rank, 0)
        self._loss_fn = loss_fn

        self.module = params if isinstance(params, nn.Module) else None
        if self.module is not None:
            named = [(k, p) for k, p in self.module.named_parameters()
                     if p.requires_grad]
            self._tree = None
            self._generators = _module_generators(self.module)
        else:
            named = _tree_leaves(params)
            self._tree = params
            self._generators = []
        for k, p in named:
            if not on_device(p, self.device):
                raise ValueError(f"ShardedTrainStep on {self.device}: "
                                 f"parameter {k} is on {p.device}")
        self.leaf_names = [k for k, _ in named]
        self.dtypes = [p.dtype for _, p in named]
        lay = self.flat = FlatLayout([p.shape for _, p in named],
                                     self.dtypes, self.group, bucket)
        self.shapes, self.sizes = lay.shapes, lay.sizes
        self._layout, self._padded_of, self._chunk = (lay.layout, lay.padded,
                                                      lay.chunk)
        self._names = lay.keys
        n = self.n_shards
        self.padded = [((sz + n - 1) // n) * n for sz in self.sizes]

        full = lay.flatten([p for _, p in named], self.device)
        if self.stage >= 3:
            self.flat_params = {k: lay.own(v, k).clone().requires_grad_(True)
                                for k, v in full.items()}
            del full
            self._leaves = None
            if self.module is not None:
                for _, p in named:            # the slices hold the model
                    p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        else:
            self.flat_params = full
            self._leaves = []
            for view, (_, p) in zip(lay.views(full), named):
                if self.module is not None:
                    p.data = view                # the module sees updates
                    self._leaves.append(p)
                else:
                    self._leaves.append(view.requires_grad_(True))
        # optimizer state: one shard a rank from stage 1 up
        self.opt_state = opt.init_opt_state(self._param_slices(),
                                            device=self.device)

    # -- plumbing ----------------------------------------------------------
    def _param_slices(self):
        if self.stage == 0 or self.stage >= 3:
            return dict(self.flat_params)
        return {k: self.flat.own(v, k) for k, v in self.flat_params.items()}

    def _assemble(self, leaves):
        if self._tree is None:
            return dict(zip(self.leaf_names, leaves))
        return _tree_unflatten(self._tree, leaves)

    def _local_batch(self, batch):
        batch = batch if isinstance(batch, (tuple, list)) else (batch,)
        n, r = self.n_shards, self.rank
        out = []
        for b in batch:
            if isinstance(b, np.ndarray) or np.isscalar(b):
                b = torch.as_tensor(b)
            b = b.to(self.device, non_blocking=True)
            if b.dim() and n > 1:
                if b.shape[0] % n:
                    raise ValueError(f"batch dim {b.shape[0]} does not split "
                                     f"over {n} ranks")
                per = b.shape[0] // n
                b = b[r * per:(r + 1) * per]
            out.append(b)
        return tuple(out)

    # -- the step ------------------------------------------------------------
    def _loss(self, loss_of, inputs):
        if not self.remat:
            return loss_of(*inputs)
        from torch.utils.checkpoint import checkpoint
        return checkpoint(loss_of, *inputs, use_reentrant=False,
                          context_fn=_replay(self._generators))

    def __call__(self, batch):
        from ..distributed.communication.differentiable import \
            gather_flat_leaves
        batch = self._local_batch(batch)
        n, stage, lay = self.n_shards, self.stage, self.flat
        lr = self.opt.get_lr()
        if stage >= 3:
            slices = [self.flat_params[k] for k in self._names]

            def loss_of(*sl):
                return self._loss_fn(
                    self._assemble(gather_flat_leaves(lay, sl)), batch)
            loss = self._loss(loss_of, slices)
            graw = torch.autograd.grad(loss, slices)
            gslice = {k: g.float().div_(n)
                      for k, g in zip(self._names, graw)}
        else:
            def loss_of(*lv):
                return self._loss_fn(self._assemble(lv), batch)
            loss = self._loss(loss_of, self._leaves)
            grads = torch.autograd.grad(loss, self._leaves,
                                        materialize_grads=True)
            gslice = lay.reduce_grads(
                lay.flatten(grads, self.device, torch.float32), stage)
        loss = loss.detach().float().clone()
        all_reduce(loss, ReduceOp.AVG, self.group)

        if self.clip_norm is not None:
            # JAX's formula (sharded.py:227-234); at stage 0 every rank
            # holds the whole mean gradient, so nothing is summed
            norm = lay.global_norm(gslice, sharded=stage >= 1)
            scale = torch.clamp(self.clip_norm / (norm + 1e-6), max=1.0)
            for g in gslice.values():
                g.mul_(scale)

        with torch.no_grad():
            pslice = self._param_slices()
            self.opt.apply_gradients_functional(pslice, gslice,
                                                self.opt_state, lr=lr)
            if stage in (1, 2):
                lay.gather_(self.flat_params, pslice)
        self.opt.finish_step()
        return loss

    # -- introspection -----------------------------------------------------
    def _full_flats(self):
        if self.stage < 3:
            return self.flat_params
        return {k: all_gather_into_tensor(
            torch.empty(self._padded_of[k], dtype=s.dtype, device=s.device),
            s.detach(), self.group) for k, s in self.flat_params.items()}

    @torch.no_grad()
    def materialized_params(self):
        """The full (unsharded) parameters, as a dict shaped like ``params``
        (by dotted name for a module), detached copies on the step's
        device.  At stage 3 every rank of the group must call it (it
        all-gathers)."""
        return self._assemble([v.clone() for v in
                               self.flat.views(self._full_flats())])

    def bytes_per_device(self):
        """(parameter bytes, optimizer-state bytes) this rank holds."""
        def nbytes(tree):
            if isinstance(tree, dict):
                return sum(nbytes(v) for v in tree.values())
            return tree.numel() * tree.element_size() \
                if isinstance(tree, torch.Tensor) else 0
        return nbytes(self.flat_params), nbytes(self.opt_state)

    def sharded_state_dict(self):
        """The flat buffers and the optimizer state for
        ``distributed.checkpoint.save_state_dict`` / ``load_state_dict``: a
        sharded buffer as a ``ShardView`` of its global extent (the
        coordinator writes a replicated one once); ``{"params": {name},
        "opt": {name: {key}}}``, the names those of ``flat_params``."""
        from ..distributed.checkpoint.save_state_dict import ShardView

        def view(t, key):
            if self.stage >= 1 and t.dim() >= 1 \
                    and t.numel() == self._chunk[key]:
                return ShardView(t, (self._padded_of[key],),
                                 (self.rank * self._chunk[key],))
            return t
        params = {k: (ShardView(v, (self._padded_of[k],),
                                (self.rank * self._chunk[k],))
                      if self.stage >= 3 else v)
                  for k, v in self.flat_params.items()}
        opt = {k: {s: view(t, k) for s, t in st.items()}
               for k, st in self.opt_state.items()}
        return {"params": params, "opt": opt}
