"""Rank script: expert parallelism at world 4 (gloo).  On an ``ep`` mesh of
4: the ``ep_all_to_all`` round trip, ``moe_ffn`` over this rank's tokens
and experts with its gradients (``moe_cases.FFN_CASES``), and
``ClipGradForMOEByGlobalNorm`` over this rank's expert gradient.  Then the
tiny MoE LLaMA of ``llama.npz`` (JAX's weights) trains ``STEPS`` steps
through ``Pipeline1F1BTrainStep`` twice: at pp 2 (on a ``{"dp": 2, "pp":
2}`` mesh whose batch does not split over dp, so each dp row is one pp 2
run on the whole batch) and at ``{"pp": 2, "ep": 2}`` with the expert
stacks split over ep; each run's first-step gradients are kept.  Arrays go
to ``rank{r}.npz``, the rest to ``rank{r}.json``."""
import os
import sys

import numpy as np
import torch

from _rank import dist, dump, start
from moe_cases import (FFN_CASES, LLAMA, LR, N_MICRO, STEPS, W, clip_grads,
                       ffn_inputs, llama_ids)

from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm, ep_all_to_all, ep_all_to_all_back, gate,
    moe_ffn)
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import (LlamaConfig, llama_block_specs,
                                           llama_microbatch_fns)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import Pipeline1F1BTrainStep


def experts(rank, a):
    per = a.shape[0] // W
    return torch.from_numpy(a[rank * per:(rank + 1) * per].copy())


def ffn(rank, arrays, res):
    for name, (T, E, d, h, cap, act) in FFN_CASES.items():
        x, gw, w1, b1, w2, b2 = ffn_inputs(name)
        leaves = [torch.from_numpy(x[rank * T:(rank + 1) * T].copy()),
                  torch.from_numpy(gw)] \
            + [experts(rank, a) for a in (w1, b1, w2, b2)]
        for t in leaves:
            t.requires_grad_(True)
        out, aux = moe_ffn(leaves[0], leaves[1], *leaves[2:], top_k=2,
                           ep_axis="ep", capacity=cap, activation=act)
        grads = torch.autograd.grad((out ** 2).sum(), leaves)
        arrays[f"{name}/out"] = out.detach().numpy()
        for k, g in zip(("x", "gw", "w1", "b1", "w2", "b2"), grads):
            arrays[f"{name}/d{k}"] = g.numpy()
        res[f"{name}/aux"] = float(aux)


def clip(rank, arrays):
    shared, expert = clip_grads()
    for tag, kw, mark in (("attr", {}, True),
                          ("func", {"is_expert_param_func":
                                    lambda p: getattr(p, "mine", False)},
                           False)):
        ps = torch.nn.Parameter(torch.zeros(6))
        pe = torch.nn.Parameter(torch.zeros(6))
        if mark:
            pe.is_expert = True
        else:
            pe.mine = True
        for norm in (1.0, 100.0):
            c = ClipGradForMOEByGlobalNorm(norm, **kw)
            out = c([(ps, torch.from_numpy(shared)),
                     (pe, torch.from_numpy(expert[rank]))])
            arrays[f"clip/{tag}/{norm:g}/shared"] = out[0][1].numpy()
            arrays[f"clip/{tag}/{norm:g}/expert"] = out[1][1].numpy()


def llama_run(out_dir, axes, ep, res, margins, arrays, tag):
    z = np.load(os.path.join(out_dir, "llama.npz"))
    trees = [{k[len(p):]: z[k] for k in z.files if k.startswith(p)}
             for p in ("ep.", "bp.", "hp.")]
    mesh = topology.build_mesh(axes)
    topology.set_default_mesh(mesh)
    cfg = LlamaConfig(**LLAMA)
    ep_t, bp, hp = params_from_numpy(*trees, device="cpu")
    ea, ba, hl = llama_microbatch_fns(cfg, ep_axis="ep" if ep else None,
                                      device="cpu")
    kw = dict(block_specs=llama_block_specs(mp_axis=None, moe=True,
                                            ep_axis="ep")) if ep \
        else dict(batch_spec=())
    step = Pipeline1F1BTrainStep(mesh, ea, ba, hl, ep_t, bp, hp,
                                 AdamW(learning_rate=LR), n_micro=N_MICRO,
                                 device="cpu", **kw)
    ids = torch.from_numpy(llama_ids()).long()
    losses = []
    for i in range(STEPS):
        if i == 1:
            dist.reset_collective_counts()
        margins.clear()
        losses.append(float(step((ids, ids))))
        res.setdefault("min_margin", []).append(min(margins))
        if i == 0:
            for tname, t in zip(("ep", "bp", "hp"), step._grads):
                for k, g in t.items():
                    arrays[f"{tag}/grad/{tname}.{k}"] = g.numpy().copy()
        if i == 1:
            res["collectives"] = dict(dist.collective_counts())
    res["losses"] = losses
    res["shapes"] = {k: list(v.shape) for k, v in step.block_params.items()}
    res["layer_ids"] = step.layer_ids
    res["pp_rank"] = step.pipe.r
    res["ep_rank"] = max(topology.axis_group("ep").rank, 0)
    topology.set_default_mesh(None)


def main(out_dir):
    rank, world = start()
    assert world == W
    arrays, res = {}, {}
    z = np.load(os.path.join(out_dir, "inputs.npz"))
    topology.set_default_mesh(topology.build_mesh({"ep": W}))
    disp = torch.from_numpy(z["a2a"][rank])
    inbox = ep_all_to_all(disp, "ep")
    arrays["a2a/inbox"] = inbox.numpy()
    arrays["a2a/back"] = ep_all_to_all_back(inbox, "ep").numpy()
    ffn(rank, arrays, res)
    clip(rank, arrays)
    margins = []
    route = gate.route

    def watched(logits, top_k, *a, **kw):
        # the margin of the top-k choice in log-probabilities (the logits'
        # gap), whose f32 error is ~1e-6 of the logits
        r = route(logits, top_k, *a, **kw)
        p = -np.sort(-np.log(r.probs.detach().numpy().astype(np.float64)),
                     -1)
        margins.append(float((p[:, top_k - 1] - p[:, top_k]).min()))
        return r
    gate.route = watched
    res["pp2"], res["pp2ep2"] = {}, {}
    llama_run(out_dir, {"dp": 2, "pp": 2}, False, res["pp2"], margins,
              arrays, "pp2")
    llama_run(out_dir, {"pp": 2, "ep": 2}, True, res["pp2ep2"], margins,
              arrays, "pp2ep2")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    dump(out_dir, res)


if __name__ == "__main__":
    main(sys.argv[1])
