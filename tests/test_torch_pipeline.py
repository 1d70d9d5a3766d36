"""Pipeline parallelism of the port at world 4 on gloo (the counterpart of
``tests/test_pipeline_schedules.py``, ``tests/test_zero_bubble.py``,
``tests/test_tensor_parallel_pipeline.py:62, 113``, ``tests/
test_parallel.py:57`` and ``tests/test_weak_fixes.py:160``): one gang of
four ranks (``tests/torch_launch_scripts/pipeline_rank.py``) trains JAX's
tiny LLaMA on JAX's weights through ``Pipeline1F1BTrainStep`` (1F1B at pp 4
with 4 and 8 microbatches, zero bubble at pp 4; 1F1B, zero bubble and
interleaved at pp 2 x dp 2; 1F1B and interleaved at pp 2 x mp 2 with
``llama_block_specs``) and through the GPipe ``PipelineTrainStep`` at pp 4,
and a ``PipelineLayer`` through ``fleet.distributed_model`` ->
``PipelineParallel.train_batch``.  JAX's pipelines are proven equal to
dense training by JAX's own tests, so the oracle is JAX's dense training
(``torch_pipeline_oracle``), computed while the gang runs: losses within
2e-4 relative (JAX's tolerance), first-step gradients within 1e-4 of each
tensor's max |grad|, parameters after 3 steps at rtol 1e-4 / atol 1e-5
(``assert_params``: an element whose AdamW denominator sqrt(v) came
within 10 eps of 0 at some step, at most 0.1% of a tensor, is held to the
2 lr a step AdamW can move it, since AdamW turns the rounding of such a
gradient into a step change — JAX's own micro-batched training misses
1e-4 there against JAX's dense).  Each
rank's sends and receives a step are counted, and each rank's
``max_in_flight`` is held to the schedule's bound."""
import json
import os

import numpy as np
import pytest

from torch_gang import start_gang
from torch_pipeline_oracle import (LOSS_RTOL, assert_params, cases,
                                   linear_oracle, llama_oracle)

NAMES = list(cases.CASES)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """JAX's weights and batch written for the gang; JAX's oracles while it
    runs; then each rank's JSON and arrays."""
    from torch_pipeline_oracle import jax_llama, plain_jax
    d = str(tmp_path_factory.mktemp("pipeline"))
    with plain_jax():
        _, trees, _ = jax_llama()
    ids, labels = cases.batch()
    np.savez(os.path.join(d, "llama.npz"), ids=ids, labels=labels,
             **{f"{p}.{k}": v for p, t in zip(("ep", "bp", "hp"), trees)
                for k, v in t.items()})
    wait = start_gang("pipeline_rank.py", d, nproc=4)
    llama_oracle()
    linear_oracle(tuple(cases.PP_WIDTHS), cases.PP_STEPS)
    linear_oracle(tuple(cases.FALLBACK_WIDTHS), cases.FALLBACK_STEPS)
    res = wait()
    arrays = [dict(np.load(os.path.join(d, f"rank{r}.npz")))
              for r in range(4)]
    return res, arrays


def _mp_rank(name, rank):
    return rank % 2 if cases.CASES[name][4] else None


def _slice(key, want, layer_ids, mp_rank):
    """The part of the dense ``want`` this rank holds: its layers of a
    block leaf, cut to its mp shard per ``llama_block_specs("mp")``."""
    tree, leaf = key.split(".", 1)
    if tree != "bp":
        return want
    if layer_ids is not None:
        want = want[layer_ids]
    if mp_rank is None:
        return want
    from paddle_tpu.models.llama import llama_block_specs
    spec = llama_block_specs("mp")[leaf]
    for i, ax in enumerate(spec):
        if ax is not None:
            dim = 1 + i
            w = want.shape[dim] // 2
            want = np.take(want, range(mp_rank * w, (mp_rank + 1) * w),
                           axis=dim)
    return want


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_dense(gang, name):
    want = llama_oracle()["losses"]
    for res in gang[0]:
        np.testing.assert_allclose(res[name]["losses"], want,
                                   rtol=LOSS_RTOL, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_first_step_gradients_match_dense(gang, name):
    """Each rank's gradients of its own layers (and of the replicated
    embed and head, summed over pp) after the first step's combine."""
    oracle = llama_oracle()["grads"]
    for rank, (res, arrays) in enumerate(zip(*gang)):
        mp = _mp_rank(name, rank)
        for key, want in oracle.items():
            got = arrays[f"{name}/grad/{key}"]
            want = _slice(key, want, res[name]["layer_ids"], mp)
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("name", NAMES)
def test_parameters_after_three_steps_match_dense(gang, name):
    """``materialized_params()`` (the block stack gathered over pp)."""
    oracle = llama_oracle()
    for rank, arrays in enumerate(gang[1]):
        mp = _mp_rank(name, rank)
        for key, want in oracle["params"].items():
            assert_params(arrays[f"{name}/param/{key}"],
                          _slice(key, want, None, mp),
                          _slice(key, oracle["ill"][key], None, mp),
                          f"rank {rank} {key}")


@pytest.mark.parametrize("name", NAMES)
def test_sends_and_receives_per_step(gang, name):
    """M * v activations leave every rank but the last virtual stage's
    owner (which sends M * (v - 1) across the wrap), and M * v cotangents
    every rank but stage 0's owner; receives mirror them."""
    axes, M, schedule, v, _ = cases.CASES[name]
    n = axes["pp"]
    for res in gang[0]:
        r = res[name]["pp_rank"]
        fwd_out = M * v if r < n - 1 else M * (v - 1)
        bwd_out = M * v if r > 0 else M * (v - 1)
        fwd_in = M * v if r > 0 else M * (v - 1)
        bwd_in = M * v if r < n - 1 else M * (v - 1)
        assert res[name]["send"] == fwd_out + bwd_out, (r, res[name])
        assert res[name]["recv"] == fwd_in + bwd_in, (r, res[name])


def _zero_bubble_in_flight(n, M, r):
    """The most graphs rank r's row of the zb1 table holds at an F slot
    (F done, W not yet), from JAX's table."""
    from paddle_tpu.parallel.zero_bubble import (F, _slot_ticks,
                                                 build_schedule)
    rows = build_schedule(n, M, "zb1")
    f_t, _, w_t = _slot_ticks(rows)
    return max(sum(1 for m in range(M) if f_t[r][m] <= t < w_t[r][m])
               for t, (k, _) in enumerate(rows[r]) if k == F)


@pytest.mark.parametrize("name", NAMES)
def test_max_in_flight_is_the_schedule_bound(gang, name):
    """1F1B: chunk 0 of rank r (virtual stage r) holds min(M, 2 (S - 1 -
    r) + 1) graphs at most — never above JAX's ring depth min(M, 2 (S - 1)
    + 1); zero bubble: the table's own count, within ``_depths``' ring;
    GPipe: all M."""
    from paddle_tpu.parallel.zero_bubble import _depths, build_schedule
    axes, M, schedule, v, _ = cases.CASES[name]
    n = axes["pp"]
    S = n * v
    for res in gang[0]:
        r, got = res[name]["pp_rank"], res[name]["max_in_flight"]
        if schedule == "gpipe":
            assert got == M
        elif schedule == "zero_bubble":
            assert got == _zero_bubble_in_flight(n, M, r)
            assert got <= _depths(build_schedule(n, M, "zb1"), M)[2]
        else:
            assert got == min(M, 2 * (S - 1 - r) + 1)
            assert got <= min(M, 2 * (S - 1) + 1)


def _linear_names(widths):
    return [f"run_function.{i}.{k}" for i in range(len(widths) - 1)
            for k in ("weight", "bias")]


def test_distributed_model_pipeline_parallel_matches_dense(gang):
    """``fleet.init`` at pp 2 x dp 2 and ``distributed_model`` give a
    ``PipelineParallel`` whose ``train_batch`` runs the 1F1B step (each
    rank its stage of the four ``Linear``s, the global batch split over
    dp) and trains as the dense model does."""
    oracle = linear_oracle(tuple(cases.PP_WIDTHS), cases.PP_STEPS)
    for rank, (res, arrays) in enumerate(zip(*gang)):
        pp = res["pipeline_parallel"]
        assert pp["is_pipeline_parallel"] and pp["generic"], pp
        assert pp["stage"] == rank % 2
        np.testing.assert_allclose(pp["losses"], oracle["losses"],
                                   rtol=LOSS_RTOL, atol=1e-6)
        for k in _linear_names(cases.PP_WIDTHS):
            assert_params(arrays[f"pipeline_parallel/param/{k}"],
                          oracle["params"][k], oracle["ill"][k],
                          f"rank {rank} {k}", steps=cases.PP_STEPS)


def test_pipeline_parallel_falls_back_on_the_activation_contract(gang):
    """At pp 4 a layer whose stages change width cannot ride the ring:
    ``train_batch`` warns once per rank, builds no step, and trains by
    micro-batch accumulation as the dense model does."""
    oracle = linear_oracle(tuple(cases.FALLBACK_WIDTHS),
                           cases.FALLBACK_STEPS)
    for rank, (res, arrays) in enumerate(zip(*gang)):
        fb = res["fallback"]
        assert fb["step"] and len(fb["warnings"]) == 1, fb
        assert "activation contract" in fb["warnings"][0]
        np.testing.assert_allclose(fb["losses"], oracle["losses"],
                                   rtol=LOSS_RTOL, atol=1e-6)
        for k in _linear_names(cases.FALLBACK_WIDTHS):
            assert_params(arrays[f"fallback/param/{k}"], oracle["params"][k],
                          oracle["ill"][k], f"rank {rank} {k}",
                          steps=cases.FALLBACK_STEPS)


def test_every_rank_reports(gang):
    """Four ranks, each through every case (the JSON is what ``dump``
    wrote)."""
    res, arrays = gang
    assert len(res) == len(arrays) == 4
    for r in res:
        assert set(NAMES) <= set(r), json.dumps(sorted(r))
