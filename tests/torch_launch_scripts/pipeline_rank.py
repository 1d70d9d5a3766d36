"""Rank script: pipeline parallelism at world 4 (gloo).  On the tiny LLaMA
of JAX's pipeline tests (``llama.npz``: JAX's weights and the batch), each
case of ``CASES`` trains 3 steps through ``Pipeline1F1BTrainStep`` (1F1B,
interleaved, zero bubble; pp 4, pp 2 x dp 2, pp 2 x mp 2) or the GPipe
``PipelineTrainStep``, and writes its losses, its first step's gradients
(this rank's), the second step's sends and receives, ``max_in_flight`` and
the parameters after the third step (the block stack gathered over pp) to
``rank{r}.npz`` / ``rank{r}.json``.  Then ``fleet.distributed_model`` on a
``PipelineLayer`` of four ``Linear``s at pp 2 x dp 2, and a pp 4 layer
whose stage widths differ (the fallback), train through
``PipelineParallel.train_batch``."""
import os
import sys
import warnings

import numpy as np
import torch

from _rank import dist, dump, start
from pipeline_cases import (CASES, FALLBACK_STEPS, FALLBACK_WIDTHS, LR,
                            PP_STEPS, PP_WIDTHS, STEPS, TINY, linear_data)

from paddle_tpu_torch.distributed import fleet, topology
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import (build_functional_llama,
                                           llama_block_specs,
                                           llama_config_tiny,
                                           llama_microbatch_fns)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import (Pipeline1F1BTrainStep,
                                       PipelineTrainStep)


def cfg():
    return llama_config_tiny(**TINY)


def load(out_dir):
    z = np.load(os.path.join(out_dir, "llama.npz"))
    trees = [{k[len(p):]: z[k] for k in z.files if k.startswith(p)}
             for p in ("ep.", "bp.", "hp.")]
    batch = (torch.from_numpy(z["ids"]).long(),
             torch.from_numpy(z["labels"]).long())
    return trees, batch


def make_step(trees, axes, n_micro, schedule, n_chunks, mp):
    mesh = topology.build_mesh(axes)
    topology.set_default_mesh(mesh)
    ep, bp, hp = params_from_numpy(*trees, device="cpu")
    opt = AdamW(learning_rate=LR)
    c = cfg()
    if schedule == "gpipe":
        _, _, _, ea, ba, hl = build_functional_llama(
            c, n_micro=n_micro, init_params=False, device="cpu")
        return PipelineTrainStep(mesh, ea, ba, hl, ep, bp, hp, opt,
                                 n_micro=n_micro, device="cpu")
    ea, ba, hl = llama_microbatch_fns(c, mp_axis="mp" if mp else None,
                                      device="cpu")
    return Pipeline1F1BTrainStep(
        mesh, ea, ba, hl, ep, bp, hp, opt, n_micro=n_micro,
        n_chunks=n_chunks, schedule=schedule,
        block_specs=llama_block_specs("mp") if mp else None, device="cpu")


def run_case(name, trees, batch, arrays):
    step = make_step(trees, *CASES[name])
    losses = []
    for i in range(STEPS):
        if i == 1:
            dist.reset_collective_counts()
        losses.append(float(step(batch)))
        if i == 0:
            for tname, t in zip(("ep", "bp", "hp"), step._grads):
                for k, g in t.items():
                    arrays[f"{name}/grad/{tname}.{k}"] = g.numpy().copy()
        if i == 1:
            counts = dist.collective_counts()
    ep, bp, hp = step.materialized_params()
    for tname, t in zip(("ep", "bp", "hp"), (ep, bp, hp)):
        for k, v in t.items():
            arrays[f"{name}/param/{tname}.{k}"] = v.numpy().copy()
    res = {"losses": losses, "layer_ids": step.layer_ids,
           "pp_rank": step.pipe.r, "max_in_flight": step.max_in_flight,
           "send": counts.get("send", 0), "recv": counts.get("recv", 0)}
    topology.set_default_mesh(None)
    return res


def linear_layer(widths, pp, hcg=None, strategy=None):
    """A ``PipelineLayer`` of ``Linear``s of ``widths`` (the weights of
    ``linear_data`` cut to them) over ``pp`` stages, MSE loss, wrapped in
    ``PipelineParallel``; the AdamW of its parameters."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, PipelineParallel)
    from paddle_tpu_torch.nn.layers import Linear
    ws, _, _ = linear_data()
    gen = torch.Generator().manual_seed(0)
    pl = PipelineLayer(
        layers=[LayerDesc(Linear, a, b, dtype=torch.float32, device="cpu",
                          generator=gen)
                for a, b in zip(widths[:-1], widths[1:])],
        num_stages=pp, loss_fn=lambda out, y: ((out - y) ** 2).mean())
    with torch.no_grad():
        for layer, (w, b), a, o in zip(pl.run_function, ws, widths[:-1],
                                       widths[1:]):
            layer.weight.copy_(torch.from_numpy(w[:a, :o]))
            layer.bias.copy_(torch.from_numpy(b[:o]))
    opt = AdamW(learning_rate=LR, parameters=pl.parameters())
    if hcg is not None:
        model = fleet.distributed_model(pl)
    else:
        model = PipelineParallel(pl, None, strategy)
    return pl, model, opt


def pipeline_parallel(arrays):
    """``fleet.init`` at pp 2 x dp 2, ``distributed_model`` on the
    ``PipelineLayer``, 4 ``train_batch`` steps on the global batch."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineParallel)
    from paddle_tpu_torch.parallel import GenericPipeline1F1BTrainStep
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "pp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    pl, model, opt = linear_layer(PP_WIDTHS, 2, hcg=hcg)
    _, x, y = linear_data()
    data = (torch.from_numpy(x), torch.from_numpy(y))
    losses = [float(model.train_batch(data, opt)) for _ in range(PP_STEPS)]
    for k, p in pl.named_parameters():
        arrays[f"pipeline_parallel/param/{k}"] = p.detach().numpy().copy()
    return {"wrapper": type(model).__name__,
            "is_pipeline_parallel": isinstance(model, PipelineParallel),
            "step": type(model._step).__name__,
            "generic": isinstance(model._step, GenericPipeline1F1BTrainStep),
            "stage": hcg.get_stage_id(), "losses": losses,
            "eval": float(model.eval_batch(data))}


def fallback(arrays):
    """At pp 4, a layer whose stage outputs change width cannot ride the
    1F1B ring: ``train_batch`` warns once and accumulates instead."""
    topology.set_default_mesh(topology.build_mesh({"pp": 4}))
    pl, model, opt = linear_layer(FALLBACK_WIDTHS, 4)
    _, x, y = linear_data()
    data = (torch.from_numpy(x), torch.from_numpy(y[:, :4]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses = [float(model.train_batch(data, opt))
                  for _ in range(FALLBACK_STEPS)]
    for k, p in pl.named_parameters():
        arrays[f"fallback/param/{k}"] = p.detach().numpy().copy()
    topology.set_default_mesh(None)
    return {"losses": losses, "step": model._step is None,
            "warnings": [str(w.message) for w in caught
                         if "PipelineParallel" in str(w.message)]}


def main(out_dir):
    rank, world = start()
    assert world == 4, world
    trees, batch = load(out_dir)
    arrays, res = {}, {}
    for name in CASES:
        res[name] = run_case(name, trees, batch, arrays)
    res["fallback"] = fallback(arrays)
    res["pipeline_parallel"] = pipeline_parallel(arrays)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    dump(out_dir, res)


if __name__ == "__main__":
    main(sys.argv[1])
