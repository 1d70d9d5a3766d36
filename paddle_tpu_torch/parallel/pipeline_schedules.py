"""The 1F1B, interleaved (VPP) and zero-bubble pipeline schedules, eager on
``torch.distributed`` (port of ``paddle_tpu/parallel/pipeline_schedules.py``
``spmd_pipeline_1f1b``, ``Pipeline1F1BTrainStep``,
``GenericPipeline1F1BTrainStep`` and of ``zero_bubble.py
spmd_pipeline_zero_bubble``; reference fleet/meta_parallel/
pipeline_parallel.py:242 (1F1B), :1308 (interleaved),
passes/pipeline_scheduler_pass/pipeline_zero_bubble.py:62).

The tick engines (:func:`run_1f1b`, :func:`run_zero_bubble`): each rank
runs its own row of the schedule.

* 1F1B (v chunks a rank, S = v * n virtual stages; chunk c of rank r is
  virtual stage c * n + r): the forward of microbatch f on stage s at tick
  f + s, its backward at tick 2 (S - 1) - s + f; rank n - 1's chunk c feeds
  rank 0's chunk c + 1.  With v = 1 nothing crosses the ring's wrap (JAX's
  ``ppermute`` carries zeros there).
* Zero bubble: the slot table of ``zero_bubble.build_schedule``, one slot
  a tick — F, B (the input's gradient only) or W (the weights').

Embed runs only on global stage 0 and the head loss only on the last stage:
Python branches on the rank, where JAX masks them with ``where`` on every
rank.  Every hop goes through ``_Pipe.exchange`` in the tick's global order.

Memory: 1F1B keeps each in-flight microbatch's autograd graph — at most
``min(n_micro, 2 (S - 1) + 1)`` a virtual stage (JAX's ring depth,
``max_in_flight``) — and its backward slot is one ``torch.autograd.grad``
from the kept graph; JAX keeps only the stage inputs and recomputes the
stage forward inside ``jax.vjp``.  Both compute the same function;
``remat_stage=True`` recomputes each block in the backward instead
(``torch.utils.checkpoint``, non-reentrant).  Zero bubble keeps the F
slot's graph (JAX's residuals): B takes ``torch.autograd.grad(out, x_in,
g, retain_graph=True)`` — autograd's masks skip the weight products — and
W ``torch.autograd.grad(out, params, g)``, re-deriving the dx chain inside
the stage as JAX's W does.  Stage 0's input is the token ids: its B only
keeps the cotangent for W, so at pp 1 every backward is W's.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from .pipeline import (_LMPipelineStep, _MbGraph, _Pipe, _axis_names,
                       _backward, _batch_axes, _combine, _hop,
                       _leaf, _local_batch, _mesh_of, _microbatches)
from .zero_bubble import B, F, W, _depths, build_schedule

__all__ = ["run_1f1b", "run_zero_bubble", "Pipeline1F1BTrainStep",
           "GenericPipeline1F1BTrainStep", "ActivationContractError"]


class ActivationContractError(ValueError):
    """A stage boundary of a ``PipelineLayer`` does not carry one
    activation of the first stage's shape and dtype."""


def _depth(n_micro, n_virtual):
    return max(1, min(n_micro, 2 * (n_virtual - 1) + 1))


def run_1f1b(pipe: _Pipe, forward, n_micro: int, n_chunks: int, like):
    """The 1F1B (v = ``n_chunks`` = 1) / interleaved (v > 1) schedule on
    this rank.  ``forward(c, a_in, f) -> _MbGraph`` runs microbatch f
    through this rank's chunk c (``a_in`` the received activation, ``None``
    on stage 0); ``like`` is an activation's (shape, dtype).  Parameter
    gradients go to the graphs' accumulators.  Returns (the last stage's
    sum of the microbatch losses, the most graphs a chunk held at once)."""
    n, r, v, M = pipe.n, pipe.r, n_chunks, n_micro
    S = v * n
    depth = _depth(M, S)
    held = [dict() for _ in range(v)]
    most = 0
    loss = torch.zeros((), dtype=torch.float32, device=pipe.device)
    acts, cots = {}, {}
    for t in range(M + 2 * (S - 1)):
        out_f, out_b = {}, {}
        for c in range(v):
            s = c * n + r
            f = t - s
            if 0 <= f < M:
                rec = forward(c, _leaf(acts.pop(s)) if s else None, f)
                held[c][f] = rec
                most = max(most, len(held[c]))
                if rec.loss is not None:
                    loss = loss + rec.loss.detach()
                else:
                    out_f[s] = rec.out.detach()
            b = t - (2 * (S - 1) - s)
            if 0 <= b < M:
                rec = held[c].pop(b)
                gx = _backward(rec, cots.pop(s, None), s > 0)
                if s > 0:
                    out_b[s] = gx
        msgs = []
        for s in range(S - 1):                  # activations, s -> s + 1
            if 0 <= t - s < M:
                msgs.append(_hop(pipe, "f", s, s + 1, out_f, t - s, depth,
                                 like))
        for s in range(S - 1, 0, -1):           # cotangents, s -> s - 1
            if 0 <= t - (2 * (S - 1) - s) < M:
                msgs.append(_hop(pipe, "b", s, s - 1, out_b, 0, 1, like))
        for (kind, dst), x in pipe.exchange(msgs).items():
            (acts if kind == "f" else cots)[dst] = x
    return loss, most


def run_zero_bubble(pipe: _Pipe, forward, n_micro: int, like,
                    policy: str = "zb1"):
    """The slot table of ``build_schedule(n, n_micro, policy)`` on this
    rank: F runs ``forward(0, a_in, m)`` and keeps the graph, B sends the
    input's gradient back, W accumulates the weights'.  The receive rings
    are ``_depths``' deep.  Returns (loss sum, the most graphs held at
    once)."""
    n, r, M = pipe.n, pipe.r, n_micro
    rows = build_schedule(n, M, policy)
    act_d, cot_d, _ = _depths(rows, M)
    held = {}
    most = 0
    loss = torch.zeros((), dtype=torch.float32, device=pipe.device)
    acts, cots = {}, {}
    for t in range(len(rows[0])):
        kind, m = rows[r][t]
        outs = {}
        if kind == F:
            rec = held[m] = forward(0, _leaf(acts.pop(m)) if r else None, m)
            most = max(most, len(held))
            if rec.loss is not None:
                loss = loss + rec.loss.detach()
            else:
                outs["f"] = rec.out.detach()
        elif kind == B:
            rec = held[m]
            rec.g = cots.pop(m, None)
            if r > 0:               # stage 0's input is the token ids
                root, go = rec.root(rec.g)
                outs["b"], = torch.autograd.grad(root, [rec.x_in], go,
                                                 retain_graph=True)
        elif kind == W:
            rec = held.pop(m)
            root, go = rec.root(rec.g)
            rec.accumulate(torch.autograd.grad(root, rec.targets, go,
                                               allow_unused=True))
        msgs = []
        for s in range(n - 1):
            k, ms = rows[s][t]
            if k == F:
                buf = outs["f"] if s == r else (
                    pipe.buffer(("f", s + 1), ms % act_d, like)
                    if s + 1 == r else None)
                msgs.append((s, s + 1, buf, ("f", ms)))
        for s in range(n - 1, 0, -1):
            k, ms = rows[s][t]
            if k == B:
                buf = outs["b"] if s == r else (
                    pipe.buffer(("b", s - 1), ms % cot_d, like)
                    if s - 1 == r else None)
                msgs.append((s, s - 1, buf, ("b", ms)))
        for (k, ms), x in pipe.exchange(msgs).items():
            (acts if k == "f" else cots)[ms] = x
    return loss, most


def _remat(fn):
    """``fn(lp, x)`` recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``: the default CPU and CUDA generators are
    replayed, and the generators of ``fn``'s modules, as
    ``ShardedTrainStep(remat=)`` replays them)."""
    from torch.utils.checkpoint import checkpoint

    from ..distributed.fleet.recompute import _generators_of
    from .sharded import _replay
    gens = _generators_of(fn)
    kw = {"context_fn": _replay(gens)} if gens else {}

    def run(lp, x):
        return checkpoint(fn, lp, x, use_reentrant=False, **kw)
    return run


class Pipeline1F1BTrainStep(_LMPipelineStep):
    """The dp x pp (x mp) train step on the 1F1B / interleaved / zero-bubble
    schedule for LM-shaped models (JAX ``pipeline_schedules.py:136``), with
    JAX's per-microbatch contract: ``embed_apply_mb(ep, mb)`` and
    ``head_loss_mb(hp, y, mb)`` run inside the tick on one microbatch
    (``models.llama.llama_microbatch_fns``), ``block_apply(lp, x)`` on one
    layer.

    ``block_params`` is the full ``[L, ...]`` stack (L a multiple of
    ``n_pp * n_chunks``); this rank keeps its chunks' layers (chunk c holds
    virtual stage c * n_pp + r, JAX's ``vpp_order``), and with
    ``block_specs`` (``llama_block_specs("mp")``, or ``llama_block_specs(
    mp_axis=None, moe=True, ep_axis="ep")`` for the expert stacks) the
    leaves sharded over mp or ep are cut to this rank's shard (leaves
    already marked ``is_distributed``, as ``build_functional_llama(
    mp_axis=, ep_axis=)`` gives them, are kept as they are); an expert
    shard's gradient is scaled by 1 / ep, every other leaf's averaged over
    ep, as in JAX.  The tensors kept may share storage with those
    given and are updated in place.  The update goes through
    ``optimizer.apply_gradients_functional`` (``AdamW(fused=True)``: one
    launch of row 9 a tensor).  ``batch_spec`` names the axes the global
    batch splits over (default: the mesh's ``dp`` / ``ep``); ``donate`` is
    accepted for JAX's signature; ``device=None`` means the card.
    ``max_in_flight`` holds the most microbatch graphs a virtual stage held
    at once in the last step."""

    def __init__(self, mesh, embed_apply_mb, block_apply, head_loss_mb,
                 embed_params, block_params, head_params, optimizer,
                 n_micro: int, n_chunks: int = 1, batch_spec=None,
                 donate=True, remat_stage: bool = False, block_specs=None,
                 schedule: str = "1f1b", device=None):
        if schedule not in ("1f1b", "zero_bubble"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if schedule == "zero_bubble" and n_chunks != 1:
            raise ValueError("zero_bubble schedule has no VPP chunks")
        if block_specs is not None and not isinstance(block_params, dict):
            raise ValueError("block_specs requires dict block_params")
        bad = {a for sfx in (block_specs or {}).values()
               for a in sfx if a not in (None, "mp", "ep")}
        if bad:
            raise ValueError(
                f"block_specs may only shard over 'mp'/'ep', got {bad}")
        self.schedule = schedule
        self._place(mesh, embed_params, block_params, head_params,
                    optimizer, n_micro, n_chunks, batch_spec, block_specs,
                    device)
        self._embed_apply_mb = embed_apply_mb
        self._block_apply = _remat(block_apply) if remat_stage \
            else block_apply
        self._head_loss_mb = head_loss_mb

    def _forward_fn(self, mb_batch, grads):
        """``forward(c, a_in, f)`` of the engines for this batch: this
        rank's chunk c on microbatch f."""
        ep, bp, hp = self.trees
        ge, gb, gh = grads
        n, r, lpc = self.n_pp, self.pipe.r, self.lpc
        last = self.n_chunks * n - 1

        def forward(c, a_in, f):
            s = c * n + r
            mb = tuple(x[f] for x in mb_batch)
            targets, accs = [], []
            if s == 0:
                targets += list(ep.values())
                accs += list(ge.values())
                x = self._embed_apply_mb(ep, mb)
            else:
                x = a_in
            x_in = x
            lo = c * lpc
            views = {k: v[lo:lo + lpc] for k, v in bp.items()}
            targets += list(views.values())
            accs += [gb[k][lo:lo + lpc] for k in views]
            layers = {k: v.unbind(0) for k, v in views.items()}
            for i in range(lpc):
                x = self._block_apply({k: layers[k][i] for k in layers}, x)
            loss = None
            if s == last:
                targets += list(hp.values())
                accs += list(gh.values())
                loss = self._head_loss_mb(hp, x, mb).float()
            return _MbGraph(x, loss, x_in, targets, accs)
        return forward

    def __call__(self, batch):
        batch = _local_batch(batch, self.mesh, self._batch_axes, self.device)
        mb_batch = _microbatches(batch, self.n_micro)
        grads = self._zero_grads()
        forward = self._forward_fn(mb_batch, grads)
        like = self._like(mb_batch, lambda: self._embed_apply_mb(
            self.embed_params, tuple(b[0] for b in mb_batch)))
        if self.schedule == "zero_bubble":
            loss_sum, self.max_in_flight = run_zero_bubble(
                self.pipe, forward, self.n_micro, like)
        else:
            loss_sum, self.max_in_flight = run_1f1b(
                self.pipe, forward, self.n_micro, self.n_chunks, like)
        return self._combine_and_update(loss_sum, grads, 1.0 / self.n_micro)


class GenericPipeline1F1BTrainStep:
    """The 1F1B schedule for any ``PipelineLayer`` (JAX
    ``pipeline_schedules.py:395``): stage s runs layers
    ``segment_parts[s]:segment_parts[s + 1]``, stage 0 on the microbatch's
    input, the last stage then ``pipeline_layer.loss_fn(out, y)``.  The
    parameters are replicated over pp (the module's own tensors, updated in
    place) and their gradients summed over pp, as in JAX, so weights a
    ``SharedLayerDesc`` ties across stages come out right.  Every stage
    boundary must carry one activation of stage 0's output shape and dtype
    (:class:`ActivationContractError` otherwise); the stage count must be
    the mesh's pp.  The batch is ``(x, y)``, global, split over the axes of
    ``batch_spec`` (default ``dp``)."""

    def __init__(self, mesh, pipeline_layer, optimizer, n_micro: int,
                 example_input, batch_spec=None, donate=True, device=None):
        self.device = resolve_device(device)
        self.mesh = _mesh_of(mesh)
        self.pl = pipeline_layer
        self.opt = optimizer
        self.n_micro = int(n_micro)
        self.pipe = _Pipe(self.mesh, self.device)
        self.n_pp = self.pipe.n
        self._batch_axes = _batch_axes(self.mesh, batch_spec, ("dp",))
        if pipeline_layer.loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn for training")
        segs = pipeline_layer.segment_parts
        if len(segs) - 1 != self.n_pp:
            raise ValueError(f"PipelineLayer has {len(segs) - 1} stages, "
                             f"mesh pp={self.n_pp}")
        self.params = dict(pipeline_layer.named_parameters())
        self.opt_state = optimizer.init_opt_state(self.params,
                                                  device=self.device)
        ids = {id(p): k for k, p in self.params.items()}
        lo, hi = segs[self.pipe.r], segs[self.pipe.r + 1]
        mine = {}
        for i in range(lo, hi):
            for p in pipeline_layer.run_function[i].parameters():
                mine.setdefault(id(p), ids[id(p)])
        self._stage_names = list(mine.values())
        self._act = self._contract(example_input)
        self._grads = None
        self.max_in_flight = 0

    def _run_stage(self, s, x):
        segs = self.pl.segment_parts
        for i in range(segs[s], segs[s + 1]):
            layer = self.pl.run_function[i]
            x = layer(*x) if isinstance(x, tuple) else layer(x)
        return x

    def _contract(self, example_input):
        """Every stage on one microbatch of ``example_input`` (without
        gradients): each boundary's activation must match stage 0's.
        Returns an activation's shape past the batch axis, and its
        dtype."""
        x = torch.as_tensor(example_input).to(self.device)
        x = x[:max(1, x.shape[0] // self.n_micro)]
        with torch.no_grad():
            act = self._run_stage(0, x)
            for s in range(1, self.n_pp - 1):
                nxt = self._run_stage(s, act)
                if not isinstance(nxt, torch.Tensor) \
                        or nxt.shape != act.shape or nxt.dtype != act.dtype:
                    raise ActivationContractError(
                        f"stage {s} output {getattr(nxt, 'shape', None)}/"
                        f"{getattr(nxt, 'dtype', None)} != activation "
                        f"contract {tuple(act.shape)}/{act.dtype}")
        if not isinstance(act, torch.Tensor):
            raise ActivationContractError(
                f"stage 0 output is a {type(act).__name__}, not one "
                "activation")
        return tuple(act.shape[1:]), act.dtype

    def __call__(self, batch):
        batch = _local_batch(batch, self.mesh, self._batch_axes, self.device)
        mb_x, mb_y = _microbatches(batch, self.n_micro)
        if self._grads is None:
            self._grads = {k: torch.zeros_like(p)
                           for k, p in self.params.items()}
        for g in self._grads.values():
            g.zero_()
        n, r = self.n_pp, self.pipe.r
        targets = [self.params[k] for k in self._stage_names]
        accs = [self._grads[k] for k in self._stage_names]

        def forward(c, a_in, f):
            x = self._run_stage(r, mb_x[f] if r == 0 else a_in)
            loss = self.pl.loss_fn(x, mb_y[f]).float() if r == n - 1 \
                else None
            return _MbGraph(x, loss, a_in, targets, accs)

        tail, dtype = self._act
        loss_sum, self.max_in_flight = run_1f1b(
            self.pipe, forward, self.n_micro, 1,
            ((mb_x.shape[1],) + tail, dtype))
        # JAX's rule (:498-499): every gradient summed over pp (the
        # parameters are replicated there) and averaged over the other axes
        loss = _combine(self.pipe, self.mesh, loss_sum, 1.0 / self.n_micro,
                        (self._grads,), (self._grads,),
                        [a for a in _axis_names(self.mesh) if a != "pp"])
        with torch.no_grad():
            self.opt.apply_gradients_functional(self.params, self._grads,
                                                self.opt_state)
        self.opt.finish_step()
        return loss

    def sync_to_model(self):
        """JAX copies its step's parameters back into the layer; here the
        step updates the layer's own tensors in place, so there is nothing
        to copy."""
        return self.pl

