"""Rank script: sequence parallelism at mp 4 (four processes, gloo).  Each
rank runs ``tests/test_weak_fixes.py``'s two in-mesh cases on its shards
of the inputs the test wrote (``inputs.npz``) — the all-gather /
reduce-scatter pair around a column and a row product, with the gradients
of its shards, and the ring all-gather x matmul — then the
sequence-parallel layers (column, row and the overlapped column layer,
with the fused gradient hooks), and the scatter / gather pair; arrays go
to ``rank{r}.npz``."""
import os
import sys

import numpy as np
import torch

from _rank import dist, dump, start

from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils import (
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
    RowSequenceParallelLinear, ScatterOp, SPInnerOverlapLinear,
    _ring_allgather_matmul, create_fused_allreduce_gradient_hooks)


def main(out_dir):
    rank, world = start()
    topology.set_default_mesh(topology.build_mesh({"mp": world}))
    z = np.load(os.path.join(out_dir, "inputs.npz"))

    def cut(name, axis, grad=False):
        a = z[name]
        per = a.shape[axis] // world
        t = torch.from_numpy(np.ascontiguousarray(
            np.take(a, range(rank * per, (rank + 1) * per), axis=axis)))
        return t.requires_grad_(grad)

    out = {}
    # the column / row pair with the sequence split (test_weak_fixes :23)
    xs, w1s, w2s = cut("x", 0, True), cut("w1", 1, True), cut("w2", 0, True)
    full = AllGatherOp.apply(xs, axis=0)
    y = ReduceScatterOp.apply(torch.relu(full @ w1s) @ w2s, axis=0)
    (y ** 2).sum().backward()
    out.update(pair=y, pair_dx=xs.grad, pair_dw1=w1s.grad,
               pair_dw2=w2s.grad)
    # the ring all-gather x matmul (test_weak_fixes :54)
    out["ring"] = _ring_allgather_matmul(cut("rx", 0), cut("rw", 1), "mp")
    # the layers: column (or its overlapped form) then row, the row bias's
    # gradient summed by the fused hooks
    for name, col_cls in (("layers", ColumnSequenceParallelLinear),
                          ("overlap", SPInnerOverlapLinear)):
        col = col_cls(16, 32, device="cpu", seed=3)
        row = RowSequenceParallelLinear(32, 16, device="cpu", seed=4)
        model = torch.nn.ModuleList([col, row])
        hooks = create_fused_allreduce_gradient_hooks(model)
        xl = cut("x", 0, True)
        yl = row(torch.relu(col(xl)))
        (yl ** 2).sum().backward()
        out.update({f"{name}": yl, f"{name}_dx": xl.grad,
                    f"{name}_w1": col.weight, f"{name}_b1": col.bias,
                    f"{name}_w2": row.weight,
                    f"{name}_dw1": col.weight.grad,
                    f"{name}_db1": col.bias.grad,
                    f"{name}_dw2": row.weight.grad,
                    f"{name}_db2": row.bias.grad})
        for h in hooks:
            h.remove()
    xg = cut("x", 0, True)
    back = GatherOp.apply(ScatterOp.apply(GatherOp.apply(xg, axis=0), 0), 0)
    (back * torch.from_numpy(z["x"])).sum().backward()
    out.update(roundtrip=back, roundtrip_dx=xg.grad)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() for k, v in out.items()})
    dump(out_dir, {"rank": rank, "hooks": len(hooks),
                   "counts": dist.collective_counts()})


if __name__ == "__main__":
    main(sys.argv[1])
