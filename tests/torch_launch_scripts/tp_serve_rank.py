"""Rank script: tensor-parallel paged serving at mp 2 (two processes,
gloo).  Each rank builds ``ServingEngine(mesh=build_mesh({"mp": 2}))`` on
the echo-biased weights the test wrote (``echo{seed}.npz``, JAX's
initialiser) and records its greedy streams in each scenario of
``tests/test_tp_serving.py`` (plain decode, no prefix cache, chunked
prefill with speculation K 4, int8 pages, the quantized all-reduce arm),
a sampled and an overlapped run, the logit drift of the quantized
all-reduce, the collectives of one decode step, the head-divisibility
guard, the per-rank page bytes, the quantized all-reduce on fixed
partials, a mid-flight snapshot and a KV packet (its planes written by
rank 0 to ``packet.npz``, the rest to ``packet.json``) with its import
into a second engine.  The test holds the results against JAX's engines
and functions."""
import json
import os
import sys

import numpy as np
import torch

from _rank import as_list, dist, dump, start

from paddle_tpu_torch.distributed import quant_collectives as qc
from paddle_tpu_torch.distributed import topology
from paddle_tpu_torch.inference.paged import KVHandoffError, ServingEngine
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import (LlamaConfig,
                                           build_llama_paged_decode,
                                           llama_config_tiny,
                                           shard_llama_paged_params)
from paddle_tpu_torch.serving.quant import logit_drift

ENGINE = dict(num_slots=3, page_size=8, num_pages=64, prompt_bucket=16,
              decode_horizon=4, attention_impl="ref", device="cpu")


def cfg():
    return llama_config_tiny(vocab=96, hidden=32, layers=2, heads=4, seq=128)


def weights(out_dir, seed):
    z = np.load(os.path.join(out_dir, f"echo{seed}.npz"))
    trees = [{k.split(".", 1)[1]: z[k] for k in z.files
              if k.startswith(p + ".")} for p in ("ep", "bp", "hp")]
    return params_from_numpy(*trees, device="cpu")


def prompts():
    r = np.random.default_rng(7)
    return [r.integers(1, 96, (t,)).astype(np.int32) for t in (5, 8, 13)]


def drive(prm, mesh, **kw):
    """``tests/test_tp_serving.py``'s ``_drive``: three prompts, ten new
    tokens each; returns the streams and the engine."""
    eng = ServingEngine(prm, cfg(), mesh=mesh, **dict(ENGINE, **kw))
    rids = [eng.submit(p, max_new_tokens=10) for p in prompts()]
    done = eng.run()
    eng.check_invariants()
    return [[int(t) for t in done[i].generated] for i in rids], eng


def serving(out_dir, mesh, res):
    for name, seed, kw in (("plain", 11, {}),
                           ("no_prefix_cache", 12, {"prefix_cache": False}),
                           ("chunked_spec", 13, {"prefill_chunk": 4,
                                                 "speculative": 4}),
                           ("int8", 11, {"kv_dtype": "int8"}),
                           ("f32_arm", 14, {}),
                           ("quant_arm", 14, {"quantized_allreduce": True}),
                           ("overlap", 11, {"overlap": True})):
        outs, eng = drive(weights(out_dir, seed), mesh, **kw)
        st = eng.stats()
        res[name] = {"outs": outs, "tp_degree": st["tp_degree"],
                     "quantized_allreduce": st["quantized_allreduce"],
                     "verify_steps": st["verify_steps"]}
    eng = ServingEngine(weights(out_dir, 11), cfg(), mesh=mesh,
                        **dict(ENGINE, seed=3))
    rids = [eng.submit(p, max_new_tokens=10, temperature=0.8)
            for p in prompts()]
    done = eng.run()
    res["sampled"] = [[int(t) for t in done[r].generated] for r in rids]


def one_decode_step(out_dir, mesh, res):
    """The collectives one decode step issues: an all-gather and one
    all-reduce a layer."""
    c = cfg()
    init, _, _, decode_step, _ = build_llama_paged_decode(
        c, page_size=8, num_pages=4, attention_impl="ref", device="cpu",
        mesh=mesh)
    g = topology.axis_group("mp", mesh)
    prm = shard_llama_paged_params(weights(out_dir, 11), g.rank, g.nranks)
    pages = init()
    i32 = dict(dtype=torch.int32)
    dist.reset_collective_counts()
    decode_step(prm, torch.tensor([5, 7], **i32), torch.tensor([0, 0], **i32),
                torch.tensor([[0], [1]], **i32), pages["k"], pages["v"],
                torch.tensor([True, True]))
    res["decode_step_counts"] = dist.collective_counts()
    res["page_shape"] = list(pages["k"].shape)


def guard_and_bytes(out_dir, mesh, res):
    bad = LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=1, max_position_embeddings=128)
    try:
        ServingEngine(weights(out_dir, 11), bad, mesh=mesh, **ENGINE)
        res["guard"] = None
    except ValueError as e:
        res["guard"] = str(e)
    small = dict(ENGINE, num_slots=2, num_pages=16)
    prm = weights(out_dir, 11)
    res["page_bytes"] = [ServingEngine(prm, cfg(), **small).page_bytes,
                         ServingEngine(prm, cfg(), mesh=mesh,
                                       **small).page_bytes]


def drift(out_dir, mesh, res):
    prm = weights(out_dir, 15)
    d, per = logit_drift(prm, prm, cfg(), [np.arange(1, 7, dtype=np.int32)],
                         kv_dtype=None, steps=3, attention_impl="ref",
                         device="cpu", ref_build_kw={"mesh": mesh},
                         q_build_kw={"mesh": mesh,
                                     "quantized_allreduce": True})
    res["drift"] = d
    res["drift_steps"] = len(per[0])


def collectives(mesh, res):
    g = topology.axis_group("mp", mesh)
    partials = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1.0, (2, 48)).astype(np.float32))
    res["quantized_allreduce"] = as_list(qc.quantized_allreduce(
        partials[g.rank], g, chunk=16))
    res["quantized_allreduce_ref"] = as_list(qc.quantized_allreduce_ref(
        partials, chunk=16))
    f32 = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1.0, (2, 32)).astype(np.float32))
    res["f32_allreduce"] = as_list(qc.allreduce(f32[g.rank], g,
                                                quantized=False))
    res["f32_sum"] = as_list(f32[0] + f32[1])


def handoff(out_dir, mesh, res, kv_dtype=None):
    """A mid-flight full-KV snapshot restored into a fresh engine, and a KV
    packet exported after two steps, imported into a fresh engine; both
    continuations, and the refusal of a packet of another degree.  The f32
    packet goes to ``packet.{npz,json}`` (rank 0)."""
    prm = weights(out_dir, 11)
    kw = dict(ENGINE, kv_dtype=kv_dtype)
    tag = "" if kv_dtype is None else f"_{kv_dtype}"
    eng = ServingEngine(prm, cfg(), mesh=mesh, **kw)
    rids = [eng.submit(p, max_new_tokens=10) for p in prompts()]
    for _ in range(2):
        eng.step()
    state = eng.snapshot()
    fresh = ServingEngine(prm, cfg(), mesh=mesh, **kw)
    res["restore_mode" + tag] = fresh.restore(state)
    done = fresh.run()
    res["restored" + tag] = [[int(t) for t in done[r].generated]
                             for r in rids]
    packet = eng.export_kv(rids)
    if dist.get_rank() == 0 and kv_dtype is None:
        np.savez(os.path.join(out_dir, "packet.npz"), **packet["planes"])
        with open(os.path.join(out_dir, "packet.json"), "w") as f:
            json.dump({k: v for k, v in packet.items() if k != "planes"}, f)
    res["packet_tp" + tag] = packet["tp"]
    for r in rids:
        eng.cancel(r)
    dst = ServingEngine(prm, cfg(), mesh=mesh, **kw)
    try:
        dst.import_kv(dict(packet, tp=1))
        res["refused" + tag] = None
    except KVHandoffError as e:
        res["refused" + tag] = str(e)
    mapping = dst.import_kv(packet)
    done = dst.run()
    res["imported" + tag] = [[int(t) for t in done[mapping[r]].generated]
                             for r in rids]


def main(out_dir):
    rank, world = start()
    assert world == 2, world
    mesh = topology.build_mesh({"mp": 2})
    res = {"rank": rank}
    serving(out_dir, mesh, res)
    one_decode_step(out_dir, mesh, res)
    guard_and_bytes(out_dir, mesh, res)
    drift(out_dir, mesh, res)
    collectives(mesh, res)
    handoff(out_dir, mesh, res)
    handoff(out_dir, mesh, res, "int8")
    dump(out_dir, res)


if __name__ == "__main__":
    main(sys.argv[1])
