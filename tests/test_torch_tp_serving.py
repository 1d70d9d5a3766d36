"""Tensor-parallel paged serving of the port (the counterpart of
``tests/test_tp_serving.py``): one gang of two ranks on gloo
(``tests/torch_launch_scripts/tp_serve_rank.py``) runs
``ServingEngine(mesh=build_mesh({"mp": 2}))`` on JAX's echo-biased
weights (crossed through numpy); while it runs, the module fixture runs
JAX's single-device engine and JAX's engine on a 2-device mesh on the same
weights and prompts.

Greedy streams must be equal to both JAX engines and equal on both ranks
in every scenario (plain decode, no prefix cache, chunked prefill with
speculation K 4, int8 pages, the quantized all-reduce arm against the f32
arm); sampled and overlapped runs agree across the ranks; each decode
step issues one all-gather and one all-reduce a layer.  The quantized
all-reduce is bit-equal to JAX's ``shard_map`` result and to the
single-process reference, the reference keeps JAX's error bound, and the
f32 path is the plain sum; ``fake_quant_chunks`` is bit-equal to JAX's.
``logit_drift``'s build-kwargs seam measures the quantized all-reduce
(0 < drift < 0.1) within 1e-5 of JAX's drift.  The head-divisibility
guard raises JAX's message, ``page_bytes`` is one rank's, and a KV packet
at tp 2 holds JAX's whole planes: equal to JAX's mp-2 packet, and spliced
into JAX's mp-2 engine it continues JAX's streams."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from torch_gang import start_gang

SEEDS = (11, 12, 13, 14, 15)
ENGINE = dict(num_slots=3, page_size=8, num_pages=64, prompt_bucket=16,
              decode_horizon=4, attention_impl="ref")


def _cfg(**kw):
    from paddle_tpu.models.llama import LlamaConfig
    base = dict(vocab_size=96, hidden_size=32, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=128)
    return LlamaConfig(**dict(base, **kw))


def _echo_params(seed):
    """``tests/test_tp_serving.py``'s ``_echo_params``: JAX's initialiser,
    blocks x 0.05, the LM head the embedding's transpose x 4."""
    from paddle_tpu.models.llama import build_functional_llama
    ep, bp, hp, *_ = build_functional_llama(_cfg(),
                                            key=jax.random.PRNGKey(seed))
    bp = {k: (v * 0.05 if k.startswith("w") else v) for k, v in bp.items()}
    hp = dict(hp, lm=(ep["tok"].T * 4.0).astype(hp["lm"].dtype))
    return ep, bp, hp


def _mesh(n=2):
    from paddle_tpu.distributed.topology import build_mesh
    return build_mesh({"mp": n}, devices=jax.devices()[:n])


def _prompts():
    r = np.random.default_rng(7)
    return [r.integers(1, 96, (t,)).astype(np.int32) for t in (5, 8, 13)]


def _drive(params, mesh=None, **kw):
    from paddle_tpu.inference.paged import ServingEngine
    eng = ServingEngine(params, _cfg(), mesh=mesh, **dict(ENGINE, **kw))
    rids = [eng.submit(p, max_new_tokens=10) for p in _prompts()]
    done = eng.run()
    return [[int(t) for t in done[i].generated] for i in rids]


SCENARIOS = {"plain": (11, {}),
             "no_prefix_cache": (12, {"prefix_cache": False}),
             "chunked_spec": (13, {"prefill_chunk": 4, "speculative": 4}),
             "int8": (11, {"kv_dtype": "int8"}),
             "f32_arm": (14, {})}


def _jax_packet(params, mesh):
    """The KV packet of JAX's mp-2 engine two steps into the prompts."""
    from paddle_tpu.inference.paged import ServingEngine
    eng = ServingEngine(params, _cfg(), mesh=mesh, **ENGINE)
    rids = [eng.submit(p, max_new_tokens=10) for p in _prompts()]
    for _ in range(2):
        eng.step()
    return eng.export_kv(rids)


def _jitted(build):
    """``build_llama_paged_decode`` whose four model functions come back
    under ``jax.jit``."""
    def jitted_build(*a, **k):
        init, *fns = build(*a, **k)
        return (init, *map(jax.jit, fns))
    return jitted_build


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gang's results and JAX's oracle, computed while the gang runs."""
    from paddle_tpu.distributed.quant_collectives import (
        allreduce, quantized_allreduce)
    from paddle_tpu.inference.paged import ServingEngine
    from paddle_tpu.models import llama as jllama
    from paddle_tpu.serving.quant import logit_drift
    d = str(tmp_path_factory.mktemp("tp_serve"))
    params = {s: _echo_params(s) for s in SEEDS}
    for s, (ep, bp, hp) in params.items():
        np.savez(os.path.join(d, f"echo{s}.npz"),
                 **{f"{p}.{k}": np.asarray(v)
                    for p, tree in (("ep", ep), ("bp", bp), ("hp", hp))
                    for k, v in tree.items()})
    wait = start_gang("tp_serve_rank.py", d)
    mesh = _mesh(2)
    ref = {}
    for name, (seed, kw) in SCENARIOS.items():
        ref[name] = {"single": _drive(params[seed], **kw),
                     "mp2": _drive(params[seed], mesh, **kw)}
    ref["quant_arm"] = _drive(params[14], mesh, quantized_allreduce=True)
    with pytest.MonkeyPatch.context() as mp:
        # JAX's logit_drift calls the built functions eagerly; jitted, as
        # JAX's engine calls them, they give the same values sooner
        mp.setattr(jllama, "build_llama_paged_decode",
                   _jitted(jllama.build_llama_paged_decode))
        ref["drift"], _ = logit_drift(
            params[15], params[15], _cfg(),
            [np.arange(1, 7, dtype=np.int32)], kv_dtype=None, steps=3,
            ref_build_kw={"mesh": mesh},
            q_build_kw={"mesh": mesh, "quantized_allreduce": True})
    partials = jnp.asarray(np.random.default_rng(2).normal(
        0, 1.0, (2, 48)).astype(np.float32))
    ref["quantized_allreduce"] = np.asarray(jax.shard_map(
        lambda p: quantized_allreduce(p[0], "mp", chunk=16), mesh=mesh,
        in_specs=(P("mp"),), out_specs=P(), check_vma=False)(partials))
    f32 = jnp.asarray(np.random.default_rng(3).normal(
        0, 1.0, (2, 32)).astype(np.float32))
    ref["f32_allreduce"] = np.asarray(jax.shard_map(
        lambda p: allreduce(p[0], "mp", quantized=False), mesh=mesh,
        in_specs=(P("mp"),), out_specs=P(), check_vma=False)(f32))
    try:
        ServingEngine(params[11], _cfg(num_key_value_heads=1), mesh=mesh,
                      attention_impl="ref")
        ref["guard"] = None
    except ValueError as e:
        ref["guard"] = str(e)
    ref["packet"] = _jax_packet(params[11], mesh)
    gang = wait()
    with open(os.path.join(d, "packet.json")) as f:
        port_packet = json.load(f)
    port_packet["planes"] = dict(np.load(os.path.join(d, "packet.npz")))
    dst = ServingEngine(params[11], _cfg(), mesh=mesh, **ENGINE)
    mapping = dst.import_kv(port_packet)
    done = dst.run()
    ref["jax_import"] = [[int(t) for t in done[mapping[r["req"]["rid"]]]
                          .generated] for r in port_packet["requests"]]
    return gang, ref, port_packet


@pytest.fixture(scope="module")
def gang(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[1]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_greedy_streams_equal_jax_single_and_mp2(gang, jax_ref, name):
    """Every scenario's streams equal JAX's single-device engine's and its
    mp-2 engine's, on both ranks; the engine reports its degree."""
    want = jax_ref[name]
    assert want["single"] == want["mp2"]
    for r in gang:
        assert r[name]["outs"] == want["mp2"]
        assert r[name]["tp_degree"] == 2
        assert r[name]["quantized_allreduce"] is False
    if name == "chunked_spec":
        assert all(r[name]["verify_steps"] > 0 for r in gang)


def test_quantized_allreduce_arm_keeps_greedy_parity(gang, jax_ref):
    """The quantized all-reduce arm (lossy on the logits) gives the f32
    arm's greedy streams, as JAX's mp-2 quantized engine does."""
    assert jax_ref["quant_arm"] == jax_ref["f32_arm"]["mp2"]
    for r in gang:
        assert r["quant_arm"]["outs"] == r["f32_arm"]["outs"]
        assert r["quant_arm"]["outs"] == jax_ref["quant_arm"]
        assert r["quant_arm"]["quantized_allreduce"] is True


@pytest.mark.parametrize("name", ["sampled", "overlap", "restored",
                                  "imported", "restored_int8",
                                  "imported_int8"])
def test_ranks_run_in_lockstep(gang, jax_ref, name):
    """Sampled streams (every rank's generator seeded alike), the
    overlapped loop, a mid-flight full-KV snapshot restored into a fresh
    engine and a KV packet imported into one (f32 and int8 pages, whose
    codes and scales gather and split alike) agree across the ranks; the
    greedy ones continue JAX's streams."""
    got = [r[name] if name == "sampled" else
           r[name]["outs"] if name == "overlap" else r[name] for r in gang]
    assert got[0] == got[1]
    if name != "sampled":
        want = "int8" if name.endswith("int8") else "plain"
        assert got[0] == jax_ref[want]["mp2"]
    for r in gang:
        assert r["restore_mode"] == r["restore_mode_int8"] == "full_kv"
        assert r["packet_tp_int8"] == 2
        assert "rank-local only at equal mp degree" in r["refused_int8"]


def test_one_all_gather_and_one_all_reduce_a_layer(gang):
    """A decode step at mp 2 over 2 layers issues 2 all-gathers (the heads
    before ``wo``) and 2 all-reduces (the ``wdown`` partials), and its
    pages hold one rank's 2 of the 4 KV heads."""
    for r in gang:
        assert r["decode_step_counts"] == {"all_gather": 2, "all_reduce": 2}
        assert r["page_shape"] == [2, 2, 5, 8, 8]


def test_head_divisibility_guard_and_per_rank_page_bytes(gang, jax_ref):
    assert jax_ref["guard"] is not None
    assert "num_key_value_heads" in jax_ref["guard"]
    for r in gang:
        assert r["guard"] == jax_ref["guard"]
        single, tp = r["page_bytes"]
        assert tp == single // 2


def test_logit_drift_seam_measures_the_quantized_allreduce(gang, jax_ref):
    for r in gang:
        assert 0 < r["drift"] < 0.1, r["drift"]
        assert r["drift_steps"] == 3
        assert abs(r["drift"] - jax_ref["drift"]) <= 1e-5


def test_quantized_allreduce_is_bit_equal_to_jax_shard_map(gang, jax_ref):
    for r in gang:
        got = np.asarray(r["quantized_allreduce"], np.float32)
        np.testing.assert_array_equal(got, jax_ref["quantized_allreduce"])
        np.testing.assert_array_equal(
            got, np.asarray(r["quantized_allreduce_ref"], np.float32))
        f32 = np.asarray(r["f32_allreduce"], np.float32)
        np.testing.assert_array_equal(f32, jax_ref["f32_allreduce"])
        np.testing.assert_array_equal(
            f32, np.asarray(r["f32_sum"], np.float32))


def test_fake_quant_chunks_bit_equal_to_jax_and_bounded():
    from paddle_tpu.distributed import quant_collectives as jqc
    from paddle_tpu_torch.distributed import quant_collectives as tqc
    x = np.random.default_rng(0).normal(0, 3.0, (5, 97)).astype(np.float32)
    got = tqc.fake_quant_chunks(torch.from_numpy(x), chunk=64)
    want = np.asarray(jqc.fake_quant_chunks(jnp.asarray(x), chunk=64))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    bound = np.abs(x).max() / (2 * tqc.DEFAULT_QMAX) + 1e-7
    assert np.abs(got.numpy() - x).max() <= bound
    assert float(tqc.fake_quant_chunks(torch.zeros(3, 5)).abs().max()) == 0


def test_reference_error_bound_against_the_f32_sum():
    from paddle_tpu.distributed import quant_collectives as jqc
    from paddle_tpu_torch.distributed import quant_collectives as tqc
    p = np.random.default_rng(1).normal(0, 2.0, (4, 33)).astype(np.float32)
    got = tqc.quantized_allreduce_ref(torch.from_numpy(p), chunk=16).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jqc.quantized_allreduce_ref(jnp.asarray(p),
                                                    chunk=16)))
    bound = 4 * np.abs(p).max() / (2 * tqc.DEFAULT_QMAX) + 1e-6
    err = np.abs(got - p.sum(0)).max()
    assert 0 < err <= bound, (err, bound)


def test_kv_packet_holds_jax_whole_planes(runs):
    """The port's packet at tp 2 is stamped ``tp`` 2 and holds every head's
    f32 planes: the pages, page tables and lengths of JAX's mp-2 packet at
    the same point, its planes within 1e-5; JAX's mp-2 engine splices it
    and continues JAX's streams; a packet of another degree is refused
    with JAX's text."""
    gang, ref, port = runs
    jp = ref["packet"]
    assert port["tp"] == jp["tp"] == 2
    assert port["kv_pages"] == jp["kv_pages"]
    assert [e["length"] for e in port["requests"]] == \
        [e["length"] for e in jp["requests"]]
    for k in ("kv_k", "kv_v"):
        assert port["planes"][k].shape == np.asarray(jp["planes"][k]).shape
        np.testing.assert_allclose(port["planes"][k],
                                   np.asarray(jp["planes"][k]), rtol=1e-5,
                                   atol=1e-5)
    assert ref["jax_import"] == ref["plain"]["mp2"]
    for r in gang:
        assert r["packet_tp"] == 2
        assert "rank-local only at equal mp degree" in r["refused"]
