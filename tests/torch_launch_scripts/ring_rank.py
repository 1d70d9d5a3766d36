"""Rank script: ring, Ulysses and ring flash attention at sep 4 (four
processes, gloo).  Each rank takes its sequence shard of the inputs the
test wrote (``inputs.npz``) and writes its output shards and the
gradients of its shards to ``rank{r}.npz``, the shapes its ring flash
forward saved for the backward to ``rank{r}.json``; the test holds them
against JAX's ``shard_map`` functions."""
import os
import sys

import numpy as np
import torch

from _rank import dist, dump, start

from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.parallel.ring_attention import (ring_attention,
                                                      ring_flash_attention,
                                                      ulysses_attention)


def main(out_dir):
    rank, world = start()
    topology.set_default_mesh(topology.build_mesh({"sep": world}))
    z = np.load(os.path.join(out_dir, "inputs.npz"))

    def shard(name, grad=False):
        a = z[name]
        per = a.shape[1] // world
        t = torch.from_numpy(np.ascontiguousarray(
            a[:, rank * per:(rank + 1) * per]))
        return t.requires_grad_(grad)

    out = {}
    for causal in (False, True):
        out[f"ring_{int(causal)}"] = ring_attention(
            *(shard(f"ring_{x}") for x in "qkv"), causal=causal)
        out[f"uly_{int(causal)}"] = ulysses_attention(
            *(shard(f"uly_{x}") for x in "qkv"), causal=causal)
    qkv = [shard(f"rgrad_{x}", True) for x in "qkv"]
    (ring_attention(*qkv, causal=True).float() ** 2).sum().backward()
    for x, t in zip("qkv", qkv):
        out[f"rgrad_d{x}"] = t.grad
    for case, causal in (("full", False), ("causal", True),
                         ("causal_gqa", True)):
        out[f"flash_{case}"] = ring_flash_attention(
            *(shard(f"flash_{case}_{x}") for x in "qkv"), causal=causal)
    qkv = [shard(f"fgrad_{x}", True) for x in "qkv"]
    (ring_flash_attention(*qkv, causal=True).float() ** 2).sum().backward()
    for x, t in zip("qkv", qkv):
        out[f"fgrad_d{x}"] = t.grad
    saved = []

    def pack(t):
        saved.append(list(t.shape))
        return t

    qkv = [shard(f"fgrad_{x}", True) for x in "qkv"]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = ring_flash_attention(*qkv, causal=False)
    o.float().sum().backward()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() for k, v in out.items()})
    dump(out_dir, {"rank": rank, "saved": saved})


if __name__ == "__main__":
    main(sys.argv[1])
