"""The MoE layer with expert parallelism (port of
``paddle_tpu.incubate.distributed.models.moe.moe_layer``; reference
moe_layer.py MoEScatter :97, MoEGather :147 and the global_scatter /
global_gather all-to-all underneath).

The path (:func:`routed_ffn`, which every MoE MLP of the port takes): the
gate routes T tokens into C slots of each of E experts
(:func:`~.gate.route`), the dispatch copies each kept token into its slot
of an ``[E, C, d]`` buffer, :func:`ep_all_to_all` sends each rank of the
``ep`` group its experts' slots from every rank (``[E_local, W * C, d]``),
the local experts run, :func:`ep_all_to_all_back` returns the slots, and
the combine sums each token's ≤ k expert outputs by their weights.  JAX
dispatches and combines by einsums over one-hot ``[T, E, C]`` masks; here
the dispatch writes rows by slot index and the combine gathers them —
the same function (:func:`moe_dispatch` / :func:`moe_combine` keep JAX's
mask form for callers that hold masks).  The two all-to-alls are
``torch.autograd.Function``s whose backward is the other one.

``ep_axis`` names an axis of the default mesh (or is a
``communication.Group``); without a mesh, or along an axis the mesh
lacks, the group is this rank alone and the all-to-alls are copies."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.profiler import record_function

from . import gate as _gate
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate, \
    compute_capacity

__all__ = ["MoELayer", "moe_dispatch", "moe_combine", "moe_ffn",
           "ep_all_to_all", "ep_all_to_all_back", "dispatch_routed",
           "combine_routed", "routed_ffn"]


def _ep_group(ep_axis):
    if ep_axis is None or not isinstance(ep_axis, str):
        return ep_axis
    from .....distributed.topology import axis_group
    return axis_group(ep_axis)


def _to_experts(disp, group):
    """[E, C, d] -> [E / W, W * C, d]: rank j gets its experts' slots from
    every rank, the source rank leading within each expert's rows."""
    from .....distributed.communication.collectives import all_to_all_single
    W = group.nranks
    E, C, d = disp.shape
    if E % W:
        raise ValueError(f"{E} experts do not split over ep = {W}")
    inp = disp.reshape(W, E // W, C, d).contiguous()
    out = torch.empty_like(inp)
    all_to_all_single(out, inp, group=group)
    return out.permute(1, 0, 2, 3).reshape(E // W, W * C, d)


def _from_experts(y, group):
    """[E / W, W * C, d] -> [E, C, d], the inverse of :func:`_to_experts`."""
    from .....distributed.communication.collectives import all_to_all_single
    W = group.nranks
    El, WC, d = y.shape
    inp = y.reshape(El, W, WC // W, d).permute(1, 0, 2, 3).contiguous()
    out = torch.empty_like(inp)
    all_to_all_single(out, inp, group=group)
    return out.reshape(W * El, WC // W, d)


class _ToExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_experts(x, group)

    @staticmethod
    def backward(ctx, g):
        return _from_experts(g.contiguous(), ctx.group), None


class _FromExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _from_experts(y, group)

    @staticmethod
    def backward(ctx, g):
        return _to_experts(g.contiguous(), ctx.group), None


def ep_all_to_all(disp, ep_axis):
    """This rank's dispatch buffer [E, C, d] -> its experts' inbox [E / W,
    W * C, d] over the ``ep`` group of size W (E % W == 0); the leading W
    chunk of the second axis is the source rank (reference MoEScatter /
    global_scatter).  Differentiable."""
    return _ToExperts.apply(disp, _ep_group(ep_axis))


def ep_all_to_all_back(y, ep_axis):
    """The inverse of :func:`ep_all_to_all`: [E / W, W * C, d] -> [E, C, d]
    (reference MoEGather / global_gather).  Differentiable."""
    return _FromExperts.apply(y, _ep_group(ep_axis))


def moe_dispatch(x, dispatch_mask, dtype=None):
    """x [T, d] by the mask [T, E, C] -> [E, C, d] (JAX's einsum
    ``td,tec->ecd``)."""
    m = dispatch_mask.to(dtype or x.dtype)
    return torch.einsum("td,tec->ecd", x, m)


def moe_combine(y, combine_weights):
    """y [E, C, d] by the weights [T, E, C] -> [T, d] (JAX's einsum
    ``ecd,tec->td``, the weights cast to y's dtype)."""
    return torch.einsum("ecd,tec->td", y, combine_weights.to(y.dtype))


def dispatch_routed(x, routing):
    """x [T, d] -> [E, C, d]: each kept (choice, token) copied into its
    slot, every other slot zero (what :func:`moe_dispatch` gives for the
    routing's mask, bit for bit).  The backward gathers the slots'
    gradients back to their tokens and sums a token's ≤ k of them."""
    with record_function("moe_route"):
        k = routing.top_k
        T, d = x.shape
        E, C = routing.num_experts, routing.capacity
        src = x.unsqueeze(0).expand(k, T, d).reshape(k * T, d)
        buf = x.new_zeros(E * C + 1, d).index_copy(0, routing.dest, src)
        return buf[:E * C].view(E, C, d)


def combine_routed(y, routing):
    """y [E, C, d] -> [T, d]: each token's kept slots weighted and summed,
    the weights cast to y's dtype and the products summed in f32 (what
    :func:`moe_combine` gives for the routing's weights, to the order of
    the ≤ k terms)."""
    with record_function("moe_route"):
        k, T = routing.weight.shape
        E, C = routing.num_experts, routing.capacity
        d = y.shape[-1]
        dest = torch.where(routing.dest < E * C, routing.dest, 0)
        rows = y.reshape(E * C, d).index_select(0, dest).view(k, T, d)
        w = routing.weight.to(y.dtype).float()
        return (rows.float() * w[..., None]).sum(0).to(y.dtype)


_ACTIVATIONS = {"gelu": lambda h: F.gelu(h, approximate="tanh")}


def _activation(name):
    """``jax.nn``'s activation of that name (``gelu`` is its tanh form)."""
    return _ACTIVATIONS.get(name) or getattr(F, name)


def routed_ffn(x, logits, experts, *, top_k, capacity, ep_axis=None,
               normalize=True, balance_loss_weight=1.0, uniform=None):
    """The routed path every MoE MLP of the port takes: ``logits`` [T, E]
    route x [T, d] into ``capacity`` slots an expert (:func:`~.gate.route`,
    ``uniform`` as there), the slots go to their experts' ranks over
    ``ep_axis``, ``experts`` maps this rank's slots [E', N, d] to [E', N,
    d], and the outputs come back and are combined.  Returns (out [T, d],
    the :class:`~.gate.Routing`)."""
    r = _gate.route(logits, top_k, capacity, normalize=normalize,
                    balance_loss_weight=balance_loss_weight, uniform=uniform)
    disp = dispatch_routed(x, r)                             # [E, C, d]
    if ep_axis is not None:
        disp = ep_all_to_all(disp, ep_axis)                  # [E_l, W C, d]
    y = experts(disp)
    if ep_axis is not None:
        y = ep_all_to_all_back(y, ep_axis)                   # [E, C, d]
    return combine_routed(y, r), r


def moe_ffn(x, gate_weight, w1, b1, w2, b2, *, top_k=2, capacity_factor=1.25,
            ep_axis=None, activation="gelu", normalize=True,
            balance_loss_weight=1.0, capacity=None):
    """Gate, dispatch, expert FFN and combine of x [T, d]; returns (out [T,
    d], aux).  ``gate_weight`` [d, E]; ``w1`` [E', d, h], ``b1`` [E', h],
    ``w2`` [E', h, d], ``b2`` [E', d] (biases may be None), E' = E without
    ``ep_axis``, this rank's E / W with it.  The expert products are
    batched matmuls."""
    T = x.shape[0]
    E = gate_weight.shape[-1]
    logits = (x @ gate_weight.to(x.dtype)).float()
    if capacity is None:
        capacity = compute_capacity(T, E, top_k, capacity_factor)

    def experts(disp):
        h = torch.bmm(disp, w1.to(disp.dtype))
        if b1 is not None:
            h = h + b1[:, None, :].to(h.dtype)
        h = _activation(activation)(h)
        y = torch.bmm(h, w2.to(h.dtype))
        if b2 is not None:
            y = y + b2[:, None, :].to(y.dtype)
        return y
    out, r = routed_ffn(x, logits, experts, top_k=top_k, capacity=capacity,
                        ep_axis=ep_axis, normalize=normalize,
                        balance_loss_weight=balance_loss_weight)
    return out, r.aux


def _make_gate(gate, d_model, num_expert, n_worker, top_k, capacity_factor,
               mk):
    if isinstance(gate, BaseGate):
        return gate
    cfg = dict(gate) if isinstance(gate, dict) else {"type": gate or "gshard"}
    typ = cfg.pop("type", "gshard")
    k = cfg.pop("top_k", top_k)
    # MoELayer's capacity_factor wins unless the gate config names its own
    cfg.setdefault("capacity", cfg.pop("capacity_factor", capacity_factor))
    if typ == "naive":
        cap = cfg.pop("capacity", None)
        if isinstance(cap, (tuple, list)):
            cap = cap[0]
        return NaiveGate(d_model, num_expert, n_worker, topk=k,
                         capacity_factor=cap, **cfg, **mk)
    if typ == "switch":
        return SwitchGate(d_model, num_expert, n_worker, **cfg, **mk)
    return GShardGate(d_model, num_expert, n_worker, topk=k, **cfg, **mk)


class MoELayer(nn.Module):
    """Reference-parity MoE layer (``moe_layer.py:MoELayer``).

    ``experts``: the expert modules (this rank's under expert parallelism,
    all of them otherwise), each mapping [n, d_model] -> [n, d_model].
    ``gate``: a :class:`BaseGate`, or a config ``{"type": "gshard" |
    "switch" | "naive", "top_k": k, ...}`` built with ``dtype``, ``device``
    and ``generator``.  With ``ep_axis`` the gate covers ``ep_world_size``
    times the local experts.  After a forward the balance loss is
    ``gate.get_loss()``.  In training, a gate with ``random_routing``
    draws one uniform a token from ``generator`` (on the tokens' device;
    JAX draws from its default key)."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, top_k=2,
                 capacity_factor=1.25, ep_axis=None, ep_world_size=1, *,
                 dtype=torch.float32, device=None, generator=None, **kw):
        super().__init__()
        self.d_model = d_model
        self.experts = experts if isinstance(experts, nn.ModuleList) \
            else nn.ModuleList(experts)
        self.ep_axis = ep_axis
        # under expert parallelism this layer holds only the local
        # experts, but routing covers all ep_world_size * len(experts)
        if ep_axis is not None:
            n_worker = int(ep_world_size)
            if n_worker < 1:
                raise ValueError("ep_world_size must be >= 1 when ep_axis "
                                 "is set")
        else:
            n_worker = (getattr(moe_group, "nranks", 1) or 1) \
                if moe_group is not None else 1
        self.world_size = n_worker
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.generator = generator
        self.gate = _make_gate(gate, d_model, len(self.experts), n_worker,
                               top_k, capacity_factor,
                               dict(dtype=dtype, device=device,
                                    generator=generator))
        if getattr(self.gate, "capacity_factor", None) is None:
            self.gate.capacity_factor = capacity_factor

    def forward(self, x):
        shape = x.shape
        d = shape[-1]
        xf = x.reshape(-1, d)
        T = xf.shape[0]
        logits = self.gate(xf)
        capacity = self.gate.capacity_for(T, training=self.training)
        uniform = None
        if self.training and getattr(self.gate, "random_routing", False) \
                and self.gate.top_k == 2:
            uniform = torch.rand(T, generator=self.generator,
                                 device=x.device)
        out, r = routed_ffn(
            xf, logits.float(),
            lambda disp: torch.stack([expert(disp[i]) for i, expert
                                      in enumerate(self.experts)]),
            top_k=self.gate.top_k, capacity=capacity, ep_axis=self.ep_axis,
            balance_loss_weight=self.gate.balance_loss_weight,
            uniform=uniform)
        self.gate.loss = r.aux
        return out.to(x.dtype).reshape(shape)
