"""Rank script: data parallel across two processes (gloo) — the linear
model of ``tests/launch_scripts/dp_train_rank.py`` through
``DataParallel``'s gradient hooks, the hooks' mean gradient against the
full batch's, and ``hapi.Model`` over a ``DataParallel`` network fed by a
``DistributedBatchSampler`` (``hapi_dp_fit_rank.py``'s model)."""
import sys

import numpy as np
import torch

from _rank import as_list, dist, dump, start

from paddle_tpu_torch.distributed.communication.collectives import \
    COLLECTIVE_COUNTS


class _Data:
    def __init__(self, X, Y):
        self.X, self.Y = X, Y

    def __len__(self):
        return len(self.X)

    def __getitem__(self, i):
        return self.X[i], self.Y[i]


def _data(B=8, D=4):
    rng = np.random.default_rng(42)
    X = rng.normal(0, 1, (B, D)).astype(np.float32)
    Y = (X @ np.arange(1, D + 1).astype(np.float32)[:, None] * 0.1)
    return rng, X, Y


class _Lin(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, x):
        return x @ self.w


def hapi_net(seed=0):
    """Linear(4, 8), Tanh, Linear(8, 1) with weights [in, out] from a numpy
    seed (the test gives JAX's network the same)."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 0.4, (4, 8)).astype(np.float32),
          np.zeros(8, np.float32),
          rng.normal(0, 0.4, (8, 1)).astype(np.float32),
          np.zeros(1, np.float32)]

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.p = torch.nn.ParameterList(
                [torch.nn.Parameter(torch.from_numpy(w)) for w in ws])

        def forward(self, x):
            h = torch.tanh(x @ self.p[0] + self.p[1])
            return h @ self.p[2] + self.p[3]
    return Net(), ws


def main(out_dir):
    rank, world = start()
    res = {}
    rng, X, Y = _data()
    W0 = rng.normal(0, 0.1, (4, 1)).astype(np.float32)
    shard = len(X) // world
    x = torch.from_numpy(X[rank * shard:(rank + 1) * shard])
    y = torch.from_numpy(Y[rank * shard:(rank + 1) * shard])

    # the loss curve: local mean loss, hooks average the gradient
    model = dist.DataParallel(_Lin(W0.copy()))
    dist.reset_collective_counts()
    losses = []
    for step in range(10):
        loss = torch.mean((model(x) - y) ** 2)
        loss.backward()
        if step == 0:
            full = torch.from_numpy(W0).requires_grad_(True)
            ref = torch.mean((torch.from_numpy(X) @ full
                              - torch.from_numpy(Y)) ** 2)
            (g_full,) = torch.autograd.grad(ref, full)
            res["hook_grad_gap"] = float(
                (model._layers.w.grad - g_full).abs().max())
            res["hook_all_reduces"] = COLLECTIVE_COUNTS["all_reduce"]
        with torch.no_grad():
            model._layers.w -= 0.1 * model._layers.w.grad
            model._layers.w.grad = None
        glob = loss.detach().clone()
        dist.all_reduce(glob, op=dist.ReduceOp.AVG)
        losses.append(float(glob))
    res["dp_losses"] = losses

    # hapi Model over DataParallel, batches from a DistributedBatchSampler
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import DataLoader, DistributedBatchSampler
    from paddle_tpu_torch.optimizer import Momentum
    net, _ = hapi_net()
    dp = dist.DataParallel(net)
    opt = Momentum(learning_rate=0.1, momentum=0.0,
                   parameters=dp.parameters())
    m = Model(dp, device="cpu")
    m.prepare(optimizer=opt, loss=lambda out, t: ((out - t) ** 2).mean())
    ds = _Data(X, Y)
    loader = DataLoader(ds, batch_sampler=DistributedBatchSampler(
        ds, batch_size=shard, shuffle=False))
    curve = []
    for _ in range(6):
        for xb, yb in loader:
            res_b = m.train_batch(xb, yb)
            curve.append(res_b[0])
    res["hapi_losses"] = curve
    res["hapi_rows"] = [int(i) for i in list(loader.batch_sampler)[0]]
    res["final_w0"] = as_list(net.p[0])
    dump(out_dir, res)


if __name__ == "__main__":
    main(sys.argv[1])
