"""Rank script: ``ShardedTrainStep`` at ZeRO stages 0-3, with and without
buckets, at world 2 (gloo) on ``tests/test_zero_sharded.py``'s model
(weights from ``params.npz``, which the test writes from JAX's
initialiser), with the collectives each step issued, the bytes each rank
holds, the clip, and the eager ``group_sharded_parallel`` levels (the
test holds them against JAX's ``group_sharded_parallel``; each rank also
against one process's AdamW on the whole batch)."""
import os
import sys

import numpy as np
import torch

from _rank import as_list, dist, dump, start

from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ShardedTrainStep

NAMES = ("b1", "b2", "w1", "w2")


def loss_fn(p, batch):
    x, y = batch
    h = torch.relu(x @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 16)).astype("float32")
    y = rng.normal(size=(32, 1)).astype("float32")
    return torch.from_numpy(x), torch.from_numpy(y)


class MLP(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k in NAMES:
            setattr(self, k, torch.nn.Parameter(params[k].clone()))

    def forward(self, x, y):
        return loss_fn({k: getattr(self, k) for k in NAMES}, (x, y))


def make(params, stage, bucket=False, **kw):
    return ShardedTrainStep(None, loss_fn, {k: v.clone() for k, v in
                                            params.items()},
                            AdamW(learning_rate=1e-2), stage=stage,
                            axis="dp", bucket=bucket, device="cpu", **kw)


def eager_level(params, level, x, y, out_dir, steps=3):
    """``group_sharded_parallel(level)`` on this rank's half of the batch,
    and one process's eager AdamW on the whole batch; returns the ranks'
    losses, the parameters after ``steps`` steps, their largest gap to the
    one process's and the collectives, and what
    ``save_group_sharded_model`` wrote (rank 0: the parameters, the
    optimizer state by parameter name, and its gaps to the one
    process's)."""
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    rank, world = dist.get_rank(), dist.get_world_size()
    half = len(x) // world
    xs, ys = x[rank * half:(rank + 1) * half], y[rank * half:(rank + 1) * half]
    model = MLP(params)
    opt = AdamW(learning_rate=1e-2, parameters=list(model.parameters()))
    model, opt, _ = group_sharded_parallel(model, opt, level)
    ref = MLP(params)
    ropt = AdamW(learning_rate=1e-2, parameters=list(ref.parameters()))
    dist.reset_collective_counts()
    losses = []
    for _ in range(steps):
        loss = model(xs, ys)               # stage 3 gathers in a pre-hook
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        ref(x, y).backward()
        ropt.step()
        ropt.clear_grad()
    counts = dist.collective_counts()
    out = os.path.join(out_dir, f"eager_{level}")
    save_group_sharded_model(model, out, opt)
    released = all(getattr(model, k).numel() == 0 for k in NAMES)
    model(xs, ys)
    gap = max(float((getattr(model, k) - getattr(ref, k)).abs().max())
              for k in NAMES)
    saved = {}
    if dist.get_rank() == 0:
        sd = torch.load(os.path.join(out, "model.pdparams"))
        so = torch.load(os.path.join(out, "model.pdopt"))
        rs = ropt.state_dict()
        pname = opt._param_names()
        by_name = {pname[id(getattr(model, k))]: k for k in NAMES}
        saved = {"params": {k: as_list(sd[k]) for k in NAMES},
                 "opt": {f"{by_name[n.split('.')[0]]}.{n.split('.')[1]}":
                         as_list(v) for n, v in so.items()
                         if n != "global_step"},
                 "global_step": so["global_step"],
                 "params_gap": max(float((sd[k] - getattr(ref, k)).abs()
                                         .max()) for k in NAMES),
                 "moments_gap": max(float((so[k] - rs[k]).abs().max())
                                    for k in rs if k.endswith("moment1")
                                    or k.endswith("moment2")),
                 "keys": sorted(so) == sorted(rs),
                 "step": so["global_step"] == rs["global_step"]}
    return {"losses": losses, "gap": gap, "counts": counts,
            "params": {k: as_list(getattr(model, k)) for k in NAMES},
            "released": released, "saved": saved}


def eager_clipped(params, clip, x, y, steps=3):
    """``group_sharded_parallel("os_g", offload=True)`` on this rank's half
    of the batch with ``clip`` ("norm": ``ClipGradByNorm(0.05)``, "value":
    ``ClipGradByValue(0.01)``) on the inner AdamW; the parameters after
    ``steps`` steps."""
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn.clip import ClipGradByNorm, ClipGradByValue
    rank, world = dist.get_rank(), dist.get_world_size()
    half = len(x) // world
    xs, ys = x[rank * half:(rank + 1) * half], y[rank * half:(rank + 1) * half]
    model = MLP(params)
    opt = AdamW(learning_rate=1e-2, parameters=list(model.parameters()),
                grad_clip=ClipGradByNorm(0.05) if clip == "norm"
                else ClipGradByValue(0.01))
    model, opt, _ = group_sharded_parallel(model, opt, "os_g", offload=True)
    for _ in range(steps):
        model(xs, ys).backward()
        opt.step()
        opt.clear_grad()
    return {k: as_list(getattr(model, k)) for k in NAMES}


def main(out_dir):
    rank, world = start()
    npz = np.load(os.path.join(out_dir, "params.npz"))
    params = {k: torch.from_numpy(npz[k]) for k in NAMES}
    x, y = data()
    res = {}
    for stage in (0, 1, 2, 3):
        for bucket in (False, True):
            step = make(params, stage, bucket)
            dist.reset_collective_counts()
            losses = [float(step((x, y))) for _ in range(3)]
            counts = {k: v / 3 for k, v in dist.collective_counts().items()}
            mat = step.materialized_params()
            res[f"s{stage}_b{int(bucket)}"] = {
                "losses": losses, "counts": counts,
                "params": {k: as_list(v) for k, v in mat.items()},
                "bytes": list(step.bytes_per_device()),
                "local": {k: v.numel() for k, v in step.flat_params.items()},
                "names": list(step.flat_params)}
    s3 = make(params, 3)
    res["s3_roundtrip"] = max(float((v - params[k]).abs().max())
                              for k, v in s3.materialized_params().items())
    clip = make(params, 2, clip_norm=0.05)
    res["clip"] = [float(clip((x, y))) for _ in range(4)]
    s3b = make(params, 3, bucket=True, remat=True)
    dist.reset_collective_counts()
    res["s3_bucket_remat"] = [float(s3b((x, y))) for _ in range(6)]
    res["s3_bucket_remat_counts"] = dist.collective_counts()
    for level in ("os", "os_g", "p_g_os"):
        res[f"eager_{level}"] = eager_level(params, level, x, y, out_dir)
    for clip in ("norm", "value"):
        res[f"clip_{clip}"] = eager_clipped(params, clip, x, y)
    dump(out_dir, res)


if __name__ == "__main__":
    main(sys.argv[1])
