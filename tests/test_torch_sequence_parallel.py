"""Sequence parallelism of the port at mp 4 (the counterpart of
``tests/test_weak_fixes.py:23`` and ``:54``): one gang of four ranks on
gloo (``tests/torch_launch_scripts/sp_rank.py``); while it runs, the
module fixture runs JAX's ``AllGatherOp`` / ``ReduceScatterOp`` pair and
``_ring_allgather_matmul`` under ``shard_map`` over 4 devices on the same
numpy inputs.

Held, in f32 (2e-5; gradients within 1e-4 of the tensor's max |grad|):
the column / row pair with the sequence split and its gradients against
``jax.grad`` of JAX's ``shard_map`` body; the ring all-gather x matmul
against JAX's; the column, row and overlapped column layers, with the
fused hooks summing the row bias's gradient, against JAX's dense
``value_and_grad`` of the same weights; and the scatter / gather pair."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from torch_gang import start_gang

N = 4
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs():
    rng = np.random.default_rng(0)
    S, B, H, O = 8, 2, 16, 32
    out = {"x": rng.standard_normal((S, B, H)).astype(np.float32),
           "w1": rng.standard_normal((H, O)).astype(np.float32),
           "w2": rng.standard_normal((O, H)).astype(np.float32)}
    rng = np.random.default_rng(1)
    out["rx"] = rng.standard_normal((8, 16)).astype(np.float32)
    out["rw"] = rng.standard_normal((16, 24)).astype(np.float32)
    return out


def _jax_oracle(inp):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.utils.sequence_parallel_utils import (
        AllGatherOp, ReduceScatterOp, _ring_allgather_matmul)
    from paddle_tpu.distributed.topology import build_mesh
    mesh = build_mesh({"mp": N}, devices=jax.devices()[:N])

    def body(xs, w1s, w2s):
        full = AllGatherOp.apply(paddle.Tensor(xs), axis=0)
        h = jnp.maximum(full._value @ w1s, 0)
        return ReduceScatterOp.apply(paddle.Tensor(h @ w2s), axis=0)._value

    pair = jax.shard_map(body, mesh=mesh,
                         in_specs=(P("mp"), P(None, "mp"), P("mp", None)),
                         out_specs=P("mp"))
    args = (inp["x"], inp["w1"], inp["w2"])
    ref = {"pair": np.asarray(pair(*args))}
    g = jax.grad(lambda *a: jnp.sum(pair(*a) ** 2), argnums=(0, 1, 2))(*args)
    ref.update({f"pair_d{k}": np.asarray(v)
                for k, v in zip(("x", "w1", "w2"), g)})
    ring = jax.shard_map(lambda xs, ws: _ring_allgather_matmul(xs, ws, "mp"),
                         mesh=mesh, in_specs=(P("mp"), P(None, "mp")),
                         out_specs=P(None, "mp"))
    ref["ring"] = np.asarray(ring(inp["rx"], inp["rw"]))
    return ref


def _dense_layers(x, w1, b1, w2, b2):
    """JAX's dense ``value_and_grad`` of sum(y^2), y = relu(x W1 + b1) W2 +
    b2: (y, dx, dW1, db1, dW2, db2)."""
    def f(x, w1, b1, w2, b2):
        y = jnp.maximum(x @ w1 + b1, 0) @ w2 + b2
        return jnp.sum(y ** 2), y
    (_, y), g = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4),
                                   has_aux=True)(x, w1, b1, w2, b2)
    return [np.asarray(t) for t in (y, *g)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's arrays, the ranks' JSON, JAX's oracle and the inputs."""
    d = str(tmp_path_factory.mktemp("sp"))
    inp = _inputs()
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    wait = start_gang("sp_rank.py", d, nproc=N)
    ref = _jax_oracle(inp)
    meta = wait()
    ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(N)]
    return ranks, meta, ref, inp


def _close(got, want):
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_sequence_parallel_layers_real_split(runs):
    """AllGatherOp, a column shard, relu, a row shard and ReduceScatterOp
    with the sequence split over mp 4 equal JAX's ``shard_map`` of the same
    body and the dense product; the gradients of the shards equal
    ``jax.grad`` of JAX's (all-gather's backward is a reduce-scatter, and
    the other way round)."""
    ranks, _, ref, inp = runs
    cat = lambda k, ax: np.concatenate([r[k] for r in ranks], axis=ax)
    got = cat("pair", 0)
    np.testing.assert_allclose(got, ref["pair"], **TOL)
    dense = np.maximum(inp["x"] @ inp["w1"], 0) @ inp["w2"]
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)
    _close(cat("pair_dx", 0), ref["pair_dx"])
    _close(cat("pair_dw1", 1), ref["pair_dw1"])
    _close(cat("pair_dw2", 0), ref["pair_dw2"])


def test_sp_overlap_linear_matches_allgather(runs):
    """The ring all-gather x matmul (each chunk multiplied as it arrives)
    equals JAX's ``_ring_allgather_matmul`` and the plain product."""
    ranks, _, ref, inp = runs
    got = np.concatenate([r["ring"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, ref["ring"], **TOL)
    np.testing.assert_allclose(got, inp["rx"] @ inp["rw"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["layers", "overlap"])
def test_sequence_parallel_linear_layers(runs, name):
    """ColumnSequenceParallelLinear (or SPInnerOverlapLinear), relu and
    RowSequenceParallelLinear on the sequence-split input give JAX's dense
    output and gradients for the weights they hold; the fused hooks make
    the row bias's gradient the whole one on every rank."""
    ranks, meta, _, inp = runs
    cat = lambda k, ax: np.concatenate([r[f"{name}_{k}"] if k else r[name]
                                        for r in ranks], axis=ax)
    w1, b1, w2 = cat("w1", 1), cat("b1", 0), cat("w2", 0)
    y, dx, dw1, db1, dw2, db2 = _dense_layers(inp["x"], w1, b1, w2,
                                              np.zeros(16, np.float32))
    np.testing.assert_allclose(cat("", 0), y, **TOL)
    _close(cat("dx", 0), dx)
    _close(cat("dw1", 1), dw1)
    _close(cat("db1", 0), db1)
    _close(cat("dw2", 0), dw2)
    for r in ranks:
        _close(r[f"{name}_db2"], db2)
    assert all(m["hooks"] == 1 for m in meta)


def test_scatter_and_gather_are_inverse(runs):
    """GatherOp after ScatterOp gives the whole sequence back, and the
    gradient through GatherOp, ScatterOp and GatherOp is this rank's slice
    of the cotangent."""
    ranks, _, _, inp = runs
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["roundtrip"], inp["x"])
        np.testing.assert_array_equal(res["roundtrip_dx"],
                                      inp["x"][2 * r:2 * (r + 1)])


def test_ring_allgather_matmul_overlaps_each_hop(monkeypatch):
    """Each hop of the overlapped ring is issued before the product of the
    chunk in hand and waited on after it, in the forward and in the
    backward; with every hop a handoff (a stand-in exchange that returns
    what it is given) over a ring of 3 the result is the product of the
    chunk taken three times, and the gradients are three times one's."""
    import types

    import torch
    from paddle_tpu_torch.distributed.fleet.utils import (
        sequence_parallel_utils as spu)
    events = []

    class Task:
        def wait(self):
            events.append("wait")

    def start(tensors, group, step=1):
        events.append("hop")
        return [t.clone() for t in tensors], [Task()]

    matmul = torch.Tensor.__matmul__

    def product(a, b):
        events.append("mm")
        return matmul(a, b)

    monkeypatch.setattr(spu, "_shift_start", start)
    monkeypatch.setattr(torch.Tensor, "__matmul__", product)
    group = types.SimpleNamespace(nranks=3, rank=1)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    x.requires_grad_()
    w.requires_grad_()
    y = spu._ring_allgather_matmul(x, w, group=group)
    assert events == ["hop", "mm", "wait"] * 2 + ["mm"]
    events.clear()
    y.backward(torch.ones_like(y))
    # dW, chunk r - 1's share, then a hop over each share computed after
    assert events == ["mm", "mm"] + ["hop", "mm", "wait"] * 2
    monkeypatch.undo()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.concatenate([x.detach().numpy()] * 3)
                               @ w.detach().numpy(), **TOL)
    ones = np.ones((2, 3, 5), np.float32)
    np.testing.assert_allclose(x.grad.numpy(),
                               3 * ones @ w.detach().numpy().T, **TOL)
    np.testing.assert_allclose(
        w.grad.numpy(), 3 * x.detach().numpy().reshape(-1, 4).T
        @ ones.reshape(-1, 5), **TOL)
