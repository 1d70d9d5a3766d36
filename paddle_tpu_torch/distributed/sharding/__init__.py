"""The group-sharded (ZeRO) eager API (port of
``paddle_tpu/distributed/sharding/__init__.py``; reference
python/paddle/distributed/sharding/group_sharded.py group_sharded_parallel
and fleet/meta_parallel/sharding/ — stage 2's optimizer and model, stage
3's group_sharded_stage3.py).

``group_sharded_parallel(model, optimizer, level)`` returns the model and
an optimizer whose ``step()`` keeps, for each parameter, only this rank's
slice of its zero-padded flat copy and that slice's optimizer state (the
``_param2buffer`` layout ``parallel.ShardedTrainStep`` uses, through the
same ``parallel.sharded.FlatLayout`` with one buffer a parameter):

* ``os`` (stage 1): the gradient all-reduced to its mean, the slice
  updated, the slices all-gathered back into the parameter;
* ``os_g`` (stage 2): the gradient reduce-scattered instead;
* ``p_g_os`` (stage 3): as stage 2, and between steps each parameter is
  released (an empty tensor); a forward pre-hook on the model all-gathers
  them before each forward.

The update is the inner optimizer's ``apply_gradients_functional`` on the
slices (coupled and decoupled weight decay apply; as on that path,
``apply_decay_param_fun`` does not), then its step count advances.  A
``ClipGradByGlobalNorm`` clip takes the norm over the slices, summed over
the group, and scales by its own rule (``clip_norm / max(norm,
clip_norm)``, as JAX's eager optimizer under ``group_sharded_parallel``
applies it; ``ShardedTrainStep`` keeps JAX's compiled step's rule).  The group is the default mesh's ``sharding`` axis where it has
more than one rank, else its ``dp`` axis; with one rank the model and the
optimizer come back as they are.  The compiled-step counterpart is
``paddle_tpu_torch.parallel.ShardedTrainStep``.
"""
from __future__ import annotations

import os

import torch

from ..topology import axis_group

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "shard_accumulator_specs"]


def _shard_axis_for(shape, n):
    """The first axis of ``shape`` that splits over ``n`` ranks (the flat
    slice buffer's analog, group_sharded_stage3.py:174)."""
    if n <= 1:
        return None
    for d, s in enumerate(shape):
        if s % n == 0 and s >= n:
            return d
    return None


def shard_accumulator_specs(params, mesh=None, axis="sharding"):
    """``{name: entries}`` of the optimizer accumulators' stage-1 layout:
    one entry an axis, ``axis`` on the one that splits over the group,
    ``None`` elsewhere (JAX's ``PartitionSpec`` entries)."""
    n = axis_group(axis, mesh).nranks
    specs = {}
    for name, v in params.items():
        entries = [None] * v.dim()
        d = _shard_axis_for(tuple(v.shape), n)
        if d is not None:
            entries[d] = axis
        specs[name] = tuple(entries)
    return specs


def _zero_group():
    g = axis_group("sharding")
    return g if g.nranks > 1 else axis_group("dp")


class _GroupShardedOptimizer:
    def __init__(self, optimizer, model, stage, group):
        from ...parallel.sharded import FlatLayout, zero_stage_name
        self._inner = optimizer
        self._stage = zero_stage_name(stage)
        self._group = group
        self._model = model
        if not optimizer._parameter_list:
            optimizer._parameter_list = [p for p in model.parameters()
                                         if p.requires_grad]
        self._params = [p for p in optimizer._parameter_list
                        if p.requires_grad]
        names = optimizer._param_names()
        self._names = [names[id(p)] for p in self._params]
        self._device = self._params[0].device
        lay = self._lay = FlatLayout([p.shape for p in self._params],
                                     [p.dtype for p in self._params], group)
        full = lay.flatten([p.detach() for p in self._params], self._device)
        self._slices = {k: lay.own(v, k).clone() for k, v in full.items()}
        self._state = {}
        if self._stage >= 3:
            self._release()
            model.register_forward_pre_hook(lambda *_: self._gather())

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def _whole(self, slices):
        """The whole tensors of ``slices`` (``{key: slice}``), each
        all-gathered over the group, by key."""
        lay = self._lay
        full = {k: torch.empty(lay.padded[k], dtype=v.dtype, device=v.device)
                for k, v in slices.items()}
        lay.gather_(full, slices)
        return {k: full[k][:size].view(shape) for (k, _), size, shape in
                zip(lay.layout, lay.sizes, lay.shapes) if k in full}

    @torch.no_grad()
    def _gather(self):
        """Every parameter back at its full value (stage 3's pre-forward
        all-gather)."""
        whole = self._whole(self._slices)
        for (k, _), p in zip(self._lay.layout, self._params):
            p.data = whole[k]

    def _release(self):
        for p in self._params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    @torch.no_grad()
    def step(self):
        from ...nn.clip import ClipGradByGlobalNorm, _need_clip
        inner, lay, stage = self._inner, self._lay, self._stage
        gs = lay.reduce_grads(lay.flatten(
            [p.grad for p in self._params], self._device, torch.float32),
            stage)
        clip = inner._grad_clip
        if clip is not None:
            if not isinstance(clip, ClipGradByGlobalNorm):
                raise NotImplementedError(
                    "group_sharded_parallel: only ClipGradByGlobalNorm "
                    "clips sliced gradients")
            clipped = {k: gs[k] for (k, _), p in zip(lay.layout,
                                                     self._params)
                       if k in gs and _need_clip(p)}
            if clipped:
                scale = clip.scale_for(lay.global_norm(clipped, True))
                for g in clipped.values():
                    g.mul_(scale)
        key_name = {k: nm for (k, _), nm in zip(lay.layout, self._names)}
        params = {key_name[k]: self._slices[k] for k in gs}
        grads = {key_name[k]: g for k, g in gs.items()}
        state = {key_name[k]: self._state.get(k, {}) for k in gs}
        _, new_state = inner.apply_gradients_functional(params, grads, state)
        for k in gs:
            self._state[k] = new_state[key_name[k]]
        inner._global_step += 1
        if stage >= 3:
            self._release()
            return
        whole = self._whole({k: self._slices[k] for k in gs})
        for (k, _), p in zip(lay.layout, self._params):
            if k in whole:
                p.data.copy_(whole[k])

    @torch.no_grad()
    def state_dict(self):
        """The inner optimizer's ``state_dict`` layout (``{name}.{key}``,
        ``global_step``) with every state tensor whole: each rank's slice of
        a moment all-gathered (every rank of the group calls it)."""
        sd = {}
        for (key, _), name in zip(self._lay.layout, self._names):
            for k, v in self._state.get(key, {}).items():
                if v.dim():
                    v = self._whole({key: v})[key].clone()
                sd[f"{name}.{k}"] = v
        sd["global_step"] = self._inner._global_step
        return sd

    def clear_grad(self, set_to_zero=False):
        for p in self._params:
            p.grad = None if not set_to_zero or p.grad is None \
                else p.grad.zero_()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """reference group_sharded.py group_sharded_parallel(level='os' |
    'os_g' | 'p_g_os'); returns ``(model, optimizer, scaler)``."""
    if offload:
        raise NotImplementedError("group_sharded_parallel(offload=True)")
    g = group if group is not None else _zero_group()
    if g.nranks <= 1:
        return model, optimizer, scaler
    return model, _GroupShardedOptimizer(optimizer, model, level, g), scaler


def save_group_sharded_model(model, output, optimizer=None):
    """The model's state and the optimizer's, whole, one ``torch.save``
    file each under ``output`` (``model.pdparams``, ``model.pdopt``),
    written by rank 0.  Every rank of the group calls it: at ``p_g_os`` the
    released parameters are gathered first, and a sharded optimizer's
    moments always are."""
    from ..env import get_rank
    sharded = isinstance(optimizer, _GroupShardedOptimizer)
    if sharded and optimizer._stage >= 3:
        optimizer._gather()
    opt_state = None if optimizer is None else optimizer.state_dict()
    if get_rank() == 0:
        os.makedirs(output, exist_ok=True)
        torch.save(model.state_dict(), os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            torch.save(opt_state, os.path.join(output, "model.pdopt"))
    if sharded and optimizer._stage >= 3:
        optimizer._release()
