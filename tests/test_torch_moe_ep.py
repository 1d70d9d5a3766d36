"""Expert parallelism of the port against JAX's (the counterpart of
``tests/test_moe_ep.py`` and ``tests/test_moe_pipeline.py``): one gang of
four ranks on gloo (``tests/torch_launch_scripts/moe_rank.py``); while it
runs, the module fixture computes JAX's oracle on the same numpy inputs
(``shard_map`` over 4 devices where JAX's tests use it).

Held: the ``ep_all_to_all`` round trip at ep 4 (each rank's inbox equal to
JAX's, the way back exact); ``moe_ffn`` at ep 4 against JAX's ``shard_map``
run of it (rtol 2e-4 / atol 2e-5) and its gradients — x, the gate and
every expert stack — against ``jax.grad`` of JAX's single-device function
(rtol 5e-4 / atol 1e-5, ``tests/test_moe_ep.py:184``), at ample and tight
capacity; ``ClipGradForMOEByGlobalNorm`` counting the expert norm once over
ep and the shared norm once; 4 steps of ``Pipeline1F1BTrainStep`` at
``{pp 2, ep 2}`` against the port's pp 2 run at rtol 5e-4
(``tests/test_moe_pipeline.py:52``) with the expert stacks split over ep
and the all-to-alls counted, its first loss against JAX's single-device
functional loss, and every routing's top-2 margin (in log-probabilities)
above 1e-4."""
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from torch_gang import start_gang

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "torch_launch_scripts"))
import moe_cases as cases  # noqa: E402

sys.path.pop(0)

W = cases.W
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def _a2a_input():
    E, C, d = cases.A2A
    return np.random.default_rng(4).normal(size=(W, E, C, d)) \
        .astype(np.float32)


def _jax_llama():
    """JAX's tiny MoE LLaMA (key 11, the gate scaled by ``GATE_GAIN``) as
    numpy, and its single-device loss on the whole batch."""
    import paddle_tpu
    from paddle_tpu.models.llama import LlamaConfig, build_functional_llama
    prev = paddle_tpu.get_flags(["use_pallas_kernels"])
    paddle_tpu.set_flags({"use_pallas_kernels": False})
    try:
        cfg = LlamaConfig(**cases.LLAMA)
        ep, bp, hp, ea, ba, hl = build_functional_llama(
            cfg, key=jax.random.PRNGKey(11))
        bp = dict(bp, gate_w=bp["gate_w"] * cases.GATE_GAIN)
        ids = jnp.asarray(cases.llama_ids())

        def loss_fn(ep, bp, hp):
            x = ea(ep, (ids, ids))[0]
            y, _ = jax.lax.scan(lambda c, lp: (ba(lp, c), None), x, bp)
            return hl(hp, y[None], (ids, ids))
        loss = float(jax.jit(loss_fn)(ep, bp, hp))
    finally:
        paddle_tpu.set_flags(prev)
    trees = {p: {k: np.asarray(v) for k, v in t.items()}
             for p, t in (("ep", ep), ("bp", bp), ("hp", hp))}
    return trees, loss


def _jax_oracle():
    from paddle_tpu.incubate.distributed.models.moe import (
        ep_all_to_all, moe_ffn)
    mesh = Mesh(np.array(jax.devices()[:W]), ("ep",))
    ref = {}
    ref["a2a/inbox"] = np.asarray(jax.jit(jax.shard_map(
        lambda a: ep_all_to_all(a[0], "ep")[None], mesh=mesh,
        in_specs=P("ep"), out_specs=P("ep"), check_vma=False))(
        jnp.asarray(_a2a_input())))
    for name, (T, E, d, h, cap, act) in cases.FFN_CASES.items():
        x, gw, w1, b1, w2, b2 = (jnp.asarray(a)
                                 for a in cases.ffn_inputs(name))
        kw = dict(top_k=2, capacity=cap, activation=act)

        def body(xs, gw, w1, b1, w2, b2, kw=kw):
            out, aux = moe_ffn(xs, gw, w1, b1, w2, b2, ep_axis="ep", **kw)
            return out, aux[None]
        out, aux = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("ep"), P()) + (P("ep"),) * 4,
            out_specs=(P("ep"), P("ep")), check_vma=False))(
            x, gw, w1, b1, w2, b2)

        def loss_ref(x, gw, w1, b1, w2, b2, kw=kw, T=T):
            return sum(jnp.sum(moe_ffn(x[r * T:(r + 1) * T], gw, w1, b1, w2,
                                       b2, **kw)[0] ** 2) for r in range(W))
        grads = jax.jit(jax.grad(loss_ref, argnums=tuple(range(6))))(
            x, gw, w1, b1, w2, b2)
        ref[f"{name}/out"] = np.asarray(out)
        ref[f"{name}/aux"] = np.asarray(aux)
        for k, g in zip(("x", "gw", "w1", "b1", "w2", "b2"), grads):
            ref[f"{name}/d{k}"] = np.asarray(g)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' arrays and results, JAX's oracle and its LLaMA loss."""
    d = str(tmp_path_factory.mktemp("moe_ep"))
    np.savez(os.path.join(d, "inputs.npz"), a2a=_a2a_input())
    trees, jloss = _jax_llama()
    np.savez(os.path.join(d, "llama.npz"),
             **{f"{p}.{k}": v for p, t in trees.items()
                for k, v in t.items()})
    wait = start_gang("moe_rank.py", d, nproc=W)
    ref = _jax_oracle()
    meta = wait()
    arrays = [dict(np.load(os.path.join(d, f"rank{r}.npz")))
              for r in range(W)]
    return arrays, meta, ref, jloss


def test_ep_all_to_all_round_trip(runs):
    arrays, _, ref, _ = runs
    disp = _a2a_input()
    for r in range(W):
        np.testing.assert_array_equal(arrays[r]["a2a/inbox"],
                                      ref["a2a/inbox"][r])
        np.testing.assert_array_equal(arrays[r]["a2a/back"], disp[r])
        assert arrays[r]["a2a/inbox"].shape == (2, W * 3, 5)


@pytest.mark.parametrize("name", list(cases.FFN_CASES))
def test_moe_ffn_at_ep4_matches_jax_shard_map(runs, name):
    arrays, meta, ref, _ = runs
    out = np.concatenate([a[f"{name}/out"] for a in arrays])
    np.testing.assert_allclose(out, ref[f"{name}/out"], **OUT_TOL)
    np.testing.assert_allclose([m[f"{name}/aux"] for m in meta],
                               ref[f"{name}/aux"], rtol=1e-6)


@pytest.mark.parametrize("name", list(cases.FFN_CASES))
def test_moe_ffn_gradients_at_ep4_match_jax_grad(runs, name):
    """Each rank's x and expert shards' gradients are its slices of JAX's;
    the replicated gate's gradient is the sum over the ranks."""
    arrays, _, ref, _ = runs
    for k in ("x", "w1", "b1", "w2", "b2"):
        got = np.concatenate([a[f"{name}/d{k}"] for a in arrays])
        np.testing.assert_allclose(got, ref[f"{name}/d{k}"], err_msg=k,
                                   **GRAD_TOL)
    got = sum(a[f"{name}/dgw"] for a in arrays)
    np.testing.assert_allclose(got, ref[f"{name}/dgw"], **GRAD_TOL)


@pytest.mark.parametrize("tag", ["attr", "func"])
def test_moe_clip_counts_the_expert_norm_once(runs, tag):
    """The global norm is sqrt(|shared|^2 + sum over ranks |expert_r|^2):
    the expert part summed over ep once, the shared part not at all."""
    arrays, _, _, _ = runs
    shared, expert = cases.clip_grads()
    total = np.sqrt((shared ** 2).sum() + (expert ** 2).sum())
    assert total > 1.0
    for r in range(W):
        for norm, scale in ((1.0, 1.0 / total), (100.0, 1.0)):
            key = f"clip/{tag}/{norm:g}"
            np.testing.assert_allclose(arrays[r][f"{key}/shared"],
                                       shared * scale, rtol=1e-6)
            np.testing.assert_allclose(arrays[r][f"{key}/expert"],
                                       expert[r] * scale, rtol=1e-6)


def test_pp2_ep2_pipeline_matches_pp2_and_jax(runs):
    _, meta, _, jloss = runs
    E = cases.LLAMA["num_experts"]
    for m in meta:
        ref, got = m["pp2"], m["pp2ep2"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=5e-4)
        np.testing.assert_allclose(got["losses"][0], jloss, rtol=1e-5)
        assert got["losses"][-1] < got["losses"][0], got["losses"]
        for k in ("we_gate", "we_up", "we_down"):
            assert got["shapes"][k][1] * 2 == E, got["shapes"]
            assert ref["shapes"][k][1] == E
        assert got["shapes"]["gate_w"][-1] == E
        # a microbatch's forward and backward cross two all-to-alls a
        # layer each: 2 microbatches x 2 layers a stage x 4
        assert got["collectives"].get("all_to_all", 0) == 16, got
        assert "all_to_all" not in ref["collectives"]
        assert min(got["min_margin"] + ref["min_margin"]) > 1e-4


def test_pp2_ep2_gradients_are_the_pp2_runs(runs):
    """The first step's combined gradients at {pp 2, ep 2} equal the pp 2
    run's on the same stage: each expert shard its slice (scaled by 1 / ep:
    every ep rank's loss reached it), the gate, attention, norms,
    embedding and head averaged over ep.  AdamW would normalise a wrong
    gradient scale away, so the losses alone cannot show it."""
    arrays, meta, _, _ = runs
    E = cases.LLAMA["num_experts"]
    ref = {m["pp2"]["pp_rank"]: a for m, a in zip(meta, arrays)}
    for m, a in zip(meta, arrays):
        want = ref[m["pp2ep2"]["pp_rank"]]
        e, per = m["pp2ep2"]["ep_rank"], E // 2
        keys = [k[len("pp2ep2/grad/"):] for k in a
                if k.startswith("pp2ep2/grad/")]
        assert len(keys) == 13
        for k in keys:
            got, exp = a[f"pp2ep2/grad/{k}"], want[f"pp2/grad/{k}"]
            if k.split(".")[1] in ("we_gate", "we_up", "we_down"):
                exp = exp[:, e * per:(e + 1) * per]
            np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-7,
                                       err_msg=k)
