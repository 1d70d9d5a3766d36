"""Rank script: tensor parallelism at dp 2 x mp 2 (four processes, gloo),
through ``fleet.init``'s hybrid groups: ``hybrid4_rank.py``'s model
(column- then row-parallel, the batch split over dp), each tensor-parallel
layer against the dense layer (the test holds the results against
``jax.vjp``), the tiny LLaMA with ``mp_axis="mp"`` on the JAX weights
(``llama.npz``), and the hybrid optimizer's global-norm clip; before
``fleet.init``, the same LLaMA on the default ``dp``-only mesh."""
import os
import sys

import numpy as np
import torch

from _rank import as_list, dist, dump, start

from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.communication.differentiable import (
    copy_to_group, reduce_from_group)
from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu


def hybrid4(hcg):
    """``tests/launch_scripts/hybrid4_rank.py``'s model and data: loss per
    step, averaged over dp."""
    rng = np.random.default_rng(7)
    B, D, H = 8, 4, 8
    X = rng.normal(0, 1, (B, D)).astype(np.float32)
    Y = (X @ np.arange(1, D + 1).astype(np.float32)[:, None] * 0.1)
    W1 = rng.normal(0, 0.3, (D, H)).astype(np.float32)
    W2 = rng.normal(0, 0.3, (H, 1)).astype(np.float32)
    dp_r, mp_r = hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank()
    mpg, dpg = hcg.get_model_parallel_group(), hcg.get_data_parallel_group()
    half_b, half_h = B // 2, H // 2
    x = torch.from_numpy(X[dp_r * half_b:(dp_r + 1) * half_b])
    y = torch.from_numpy(Y[dp_r * half_b:(dp_r + 1) * half_b])
    w1 = torch.from_numpy(W1[:, mp_r * half_h:(mp_r + 1) * half_h].copy())
    w2 = torch.from_numpy(W2[mp_r * half_h:(mp_r + 1) * half_h].copy())
    losses = []
    for _ in range(8):
        w1.requires_grad_(True)
        w2.requires_grad_(True)
        h = torch.tanh(copy_to_group(x, mpg) @ w1)
        out = reduce_from_group(h @ w2, mpg)
        loss = torch.mean((out - y) ** 2)
        g1, g2 = torch.autograd.grad(loss, [w1, w2])
        for g in (g1, g2):
            dist.all_reduce(g, dist.ReduceOp.AVG, dpg)
        with torch.no_grad():
            w1, w2 = w1 - 0.1 * g1, w2 - 0.1 * g2
        glob = loss.detach().clone()
        dist.all_reduce(glob, dist.ReduceOp.AVG, dpg)
        losses.append(float(glob))
    return losses


def _set(param, full, dim, group):
    n, r = group.nranks, group.rank
    w = full.shape[dim] // n
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.ascontiguousarray(
            np.take(full, range(r * w, (r + 1) * w), axis=dim))))


def mp_layers(hcg):
    """Each layer on fixed inputs (``layer_inputs``): the output (gathered
    where it is split), the input's gradient and the local weight
    gradients, for the cotangent ``dy``."""
    from layer_inputs import inputs
    v = inputs()
    g = hcg.get_model_parallel_group()
    n, r = g.nranks, g.rank
    out = {}

    def run(name, layer, x, dy, split_out=False):
        x = torch.from_numpy(x).requires_grad_(x.dtype == np.float32)
        y = layer(x)
        if split_out:                      # this rank's columns of dy
            w = dy.shape[-1] // n
            dy = dy[..., r * w:(r + 1) * w]
        (y * torch.from_numpy(np.ascontiguousarray(dy))).sum().backward()
        full = y.detach()
        if split_out:
            full = torch.cat(dist.all_gather(None, full.contiguous(), g)
                             .unbind(0), -1)
        out[name] = {"y": as_list(full),
                     "dx": as_list(x.grad) if x.grad is not None else None,
                     "dw": as_list(layer.weight.grad),
                     "db": as_list(layer.bias.grad)
                     if getattr(layer, "bias", None) is not None else None}

    for gather in (True, False):
        col = mpu.ColumnParallelLinear(8, 6, gather_output=gather,
                                       device="cpu")
        _set(col.weight, v["wc"], 1, g)
        _set(col.bias, v["bc"], 0, g)
        run(f"column_gather{int(gather)}", col, v["x8"], v["dy6"],
            split_out=not gather)
    for parallel in (False, True):
        row = mpu.RowParallelLinear(6, 4, input_is_parallel=parallel,
                                    device="cpu")
        _set(row.weight, v["wr"], 0, g)
        with torch.no_grad():
            row.bias.copy_(torch.from_numpy(v["br"]))
        x6 = v["x6"]
        if parallel:
            x6 = np.ascontiguousarray(x6[:, r * 3:(r + 1) * 3])
        run(f"row_parallel{int(parallel)}", row, x6, v["dy4"])
    emb = mpu.VocabParallelEmbedding(10, 4, device="cpu")
    _set(emb.weight, v["emb"], 0, g)
    run("vocab_embedding", emb, v["ids"], v["dye"])
    ce = mpu.ParallelCrossEntropy(ignore_index=-100)
    w = v["logits"].shape[-1] // n
    logits = torch.from_numpy(np.ascontiguousarray(
        v["logits"][:, r * w:(r + 1) * w])).requires_grad_(True)
    loss = ce(logits, torch.from_numpy(v["labels"]))
    loss.sum().backward()
    out["cross_entropy"] = {"loss": as_list(loss), "dlogits": as_list(
        logits.grad)}
    return out


def _llama_run(out_dir, mp_axis, group=None, shift=0):
    """The tiny LLaMA built with ``mp_axis`` on JAX's weights (the block
    ones cut to ``group``'s shards), on the batch rolled by ``shift``
    tokens: (loss, {name: grad}, the collectives issued, the block
    weights)."""
    from paddle_tpu_torch.models.convert import params_from_numpy
    from paddle_tpu_torch.models.llama import (build_functional_llama,
                                               llama_config_tiny,
                                               shard_llama_block_params)
    z = np.load(os.path.join(out_dir, "llama.npz"))
    trees = [{k[len(p):]: z[k] for k in z.files if k.startswith(p)}
             for p in ("ep.", "bp.", "hp.")]
    ep, bp, hp = params_from_numpy(*trees, device="cpu")
    if group is not None:
        bp = shard_llama_block_params(bp, group.rank, group.nranks)
    cfg = llama_config_tiny(vocab=64, hidden=32, layers=2, heads=4, seq=16)
    _, _, _, ea, ba, hl = build_functional_llama(
        cfg, mp_axis=mp_axis, init_params=False, device="cpu")
    leaves = [t.requires_grad_(True) for tree in (ep, bp, hp)
              for t in tree.values()]
    ids = torch.from_numpy(np.roll(z["ids"], shift, axis=1)).long()
    labels = torch.from_numpy(np.roll(z["labels"], shift, axis=1)).long()
    dist.reset_collective_counts()
    x = ea(ep, (ids, labels))[0]
    for i in range(cfg.num_hidden_layers):
        x = ba({k: v[i] for k, v in bp.items()}, x)
    loss = hl(hp, x[None], (ids, labels))
    grads = torch.autograd.grad(loss, leaves)
    names = [f"{p}.{k}" for p, tree in zip(("ep", "bp", "hp"), (ep, bp, hp))
             for k in tree]
    return (float(loss.detach()), dict(zip(names, grads)),
            dist.collective_counts(), bp)


def llama(hcg, out_dir):
    """The tiny LLaMA at mp 2 on JAX's weights, the whole batch on every
    rank: the loss and the gradients (the block ones this rank's
    shards)."""
    loss, grads, counts, bp = _llama_run(out_dir, "mp",
                                         hcg.get_model_parallel_group())
    return {"loss": loss,
            "grads": {n: as_list(g) for n, g in grads.items()},
            "counts": counts,
            "distributed": sorted(k for k, v in bp.items()
                                  if getattr(v, "is_distributed", 0) is True)}


def lone_axis(out_dir):
    """On the default mesh (``{"dp": 4}``, no ``mp`` axis), each rank on
    its own batch (rolled by its rank): the LLaMA built with
    ``mp_axis="mp"`` runs this rank alone — its loss and gradients, and
    the collectives it issued, beside the dense model's on the same batch —
    and ``ShardedTrainStep`` over the absent ``sharding`` axis raises, as
    JAX's ``mesh.shape[axis]`` does."""
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainStep
    mesh = topology.reset_default_mesh()
    rank = dist.get_rank()
    loss, grads, counts, _ = _llama_run(out_dir, "mp", shift=rank)
    dense, dgrads, _, _ = _llama_run(out_dir, None, shift=rank)
    gap = max(float((grads[k] - dgrads[k]).abs().max()) for k in grads)
    try:
        ShardedTrainStep(None, lambda p, b: p["w"].sum(),
                         {"w": torch.ones(2)}, AdamW(0.1), axis="sharding",
                         device="cpu")
        raised = None
    except ValueError as e:
        raised = str(e)
    topology.set_default_mesh(None)
    return {"axes": list(mesh.mesh_dim_names), "loss": loss,
            "dense_loss": dense, "gap": gap, "counts": counts,
            "raised": raised}


def hybrid_clip(hcg):
    """Column- then row-parallel layers stepped by ``fleet``'s hybrid
    optimizer with ``ClipGradByGlobalNorm(0.1)`` (Momentum lr 1, momentum
    0, so the step is the clipped gradient): the step of each local
    parameter."""
    from layer_inputs import inputs
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Momentum
    v = inputs()
    g = hcg.get_model_parallel_group()
    col = mpu.ColumnParallelLinear(8, 6, gather_output=False, device="cpu")
    row = mpu.RowParallelLinear(6, 4, input_is_parallel=True, device="cpu")
    _set(col.weight, v["wc"], 1, g)
    _set(col.bias, v["bc"], 0, g)
    _set(row.weight, v["wr"], 0, g)
    with torch.no_grad():
        row.bias.copy_(torch.from_numpy(v["br"]))
    net = torch.nn.ModuleList([col, row])
    params = list(net.parameters())
    before = [p.detach().clone() for p in params]
    opt = fleet.distributed_optimizer(Momentum(
        learning_rate=1.0, momentum=0.0, parameters=params,
        grad_clip=ClipGradByGlobalNorm(0.1)))
    y = row(col(torch.from_numpy(v["x8"])))
    (y * torch.from_numpy(v["dy4"])).sum().backward()
    opt.step()
    return {"clip": type(opt._grad_clip).__name__,
            "steps": [as_list(b - p.detach()) for b, p in zip(before,
                                                              params)]}


def main(out_dir):
    rank, world = start()
    assert world == 4, world
    lone = lone_axis(out_dir)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    res = {"coords": [hcg.get_data_parallel_rank(),
                      hcg.get_model_parallel_rank()],
           "mp_ranks": hcg.get_model_parallel_group().ranks,
           "dp_ranks": hcg.get_data_parallel_group().ranks,
           "axis": hcg.get_model_parallel_group().axis_name}
    res["lone_axis"] = lone
    res["hybrid4"] = hybrid4(hcg)
    res["layers"] = mp_layers(hcg)
    res["llama"] = llama(hcg, out_dir)
    res["hybrid_clip"] = hybrid_clip(hcg)
    dump(out_dir, res)


if __name__ == "__main__":
    main(sys.argv[1])
