"""The port's pipeline pieces in one process (the counterpart of
``tests/test_zero_bubble.py``, ``tests/test_pipeline_schedules.py``,
``tests/test_jit_io.py:137`` and the one-rank half of
``tests/test_weak_fixes.py:160``):

* ``build_schedule`` / ``schedule_stats`` / ``_depths`` equal JAX's element
  for element for S in 1-4, M in {1, 2, 4, 6, 8} and both policies, and
  every table passes JAX's ``_validate``;
* ``SegmentLayers`` bounds equal JAX's;
* ``recompute`` / ``recompute_sequential`` against plain autograd and
  against JAX's ``recompute``, dropout replayed;
* at pp 1 (no process group) 1F1B, interleaved (2 and 4 chunks), zero
  bubble, remat, the fused AdamW and GPipe on the tiny LLaMA against JAX's
  dense training (``torch_pipeline_oracle``; JAX's compiled pipelines,
  which JAX's own tests hold to it, are not built), ``max_in_flight`` at
  the schedule's bound;
  ``GenericPipeline1F1BTrainStep`` and ``PipelineParallel``'s accumulation
  against the dense ``Linear`` model;
* JAX's ``ValueError``s, ``distributed_model``'s pipeline branch, the
  exports, and the entry points' card default."""
import functools

import numpy as np
import pytest
import torch

from torch_pipeline_oracle import (LOSS_RTOL, assert_params, cases,
                                   linear_oracle, llama_oracle)

SHAPES = [(S, M) for S in (1, 2, 3, 4) for M in (1, 2, 4, 6, 8)]


# -- the schedule tables ------------------------------------------------------
@pytest.mark.parametrize("policy", ["1f1b", "zb1"])
@pytest.mark.parametrize("S,M", SHAPES, ids=[f"S{s}-M{m}" for s, m in SHAPES])
def test_schedule_tables_equal_jax(S, M, policy):
    from paddle_tpu.parallel import zero_bubble as jzb
    from paddle_tpu_torch.parallel import zero_bubble as tzb
    from test_zero_bubble import _validate
    rows = tzb.build_schedule(S, M, policy)
    assert rows == jzb.build_schedule(S, M, policy)
    assert tzb.schedule_stats(rows) == jzb.schedule_stats(rows)
    assert tzb._slot_ticks(rows) == jzb._slot_ticks(rows)
    assert tzb._depths(rows, M) == jzb._depths(rows, M)
    assert (tzb.IDLE, tzb.F, tzb.B, tzb.W) == (jzb.IDLE, jzb.F, jzb.B, jzb.W)
    _validate(rows, S, M)


def test_zero_bubble_table_has_fewer_idle_slots():
    """JAX's ``test_zero_bubble_reduces_bubble`` on the port's tables."""
    from paddle_tpu_torch.parallel.zero_bubble import (build_schedule,
                                                       schedule_stats)
    for S, M in ((4, 4), (4, 8), (2, 8)):
        t1, _, frac1 = schedule_stats(build_schedule(S, M, "1f1b"))
        tz, _, fracz = schedule_stats(build_schedule(S, M, "zb1"))
        assert tz <= t1 and fracz < frac1


# -- SegmentLayers ------------------------------------------------------------
def _descs(kinds):
    """The same desc list for both packages: ``kinds`` of "Linear" /
    "ReLU" / "Embedding"."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import (
        LayerDesc as JDesc)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import LayerDesc
    from paddle_tpu_torch.nn import layers as tnn
    j = [JDesc(getattr(jnn, k), 4, 4) if k != "ReLU" else JDesc(jnn.ReLU)
         for k in kinds]
    t = [LayerDesc(getattr(tnn, k)) for k in kinds]
    return j, t


SEGMENTS = [
    (["Linear"] * 4, 2, "uniform"),
    (["Linear"] * 7, 3, "uniform"),
    (["Linear"] * 5, 4, "uniform"),
    (["Embedding"] + ["Linear", "ReLU"] * 4 + ["Linear"], 2, "layer:Linear"),
    (["Embedding"] + ["Linear", "ReLU"] * 4, 4, "layer:Linear"),
    (["Linear", "ReLU", "ReLU", "ReLU"], 3, "layer:Linear"),
]


@pytest.mark.parametrize("kinds,parts,method", SEGMENTS,
                         ids=[f"{len(k)}-{p}-{m}" for k, p, m in SEGMENTS])
def test_segment_layers_equal_jax(kinds, parts, method):
    from paddle_tpu.distributed.fleet.meta_parallel.pp_layers import (
        SegmentLayers as JSeg)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        SegmentLayers)
    j, t = _descs(kinds)
    want = JSeg(j, parts, method).do_segment()
    assert SegmentLayers(t, parts, method).do_segment() == want
    assert len(want) == parts + 1


def test_segment_layers_unknown_method_raises():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        SegmentLayers)
    with pytest.raises(ValueError, match="unknown segment method"):
        SegmentLayers([1, 2], 2, "random").do_segment()


def test_pipeline_layer_builds_a_shared_layer_once():
    """A ``SharedLayerDesc`` key builds one layer; its two places tie
    their weight, which ``named_parameters`` lists once; ``forward`` runs
    every place in order."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)
    from paddle_tpu_torch.nn.layers import Linear
    gen = torch.Generator().manual_seed(0)
    kw = dict(dtype=torch.float32, device="cpu", generator=gen)
    pl = PipelineLayer(
        [SharedLayerDesc("tied", Linear, None, "weight", 4, 4, **kw),
         LayerDesc(Linear, 4, 4, **kw),
         SharedLayerDesc("tied", Linear, lambda m, x: x @ m.weight.T,
                         "weight", 4, 4, **kw)],
        num_stages=3)
    assert pl.segment_parts == [0, 1, 2, 3]
    names = [k for k, _ in pl.named_parameters()]
    assert names == ["run_function.0.weight", "run_function.0.bias",
                     "run_function.1.weight", "run_function.1.bias"]
    assert pl.run_function[2].inner is pl.run_function[0]
    x = torch.randn(2, 4, generator=gen)
    want = pl.run_function[1](pl.run_function[0](x)) \
        @ pl.run_function[0].weight.T
    torch.testing.assert_close(pl(x), want)
    assert [len(pl.get_stage_layers(s)) for s in range(3)] == [1, 1, 1]


# -- recompute ----------------------------------------------------------------
def _linear_pair(seed=0):
    from paddle_tpu_torch.nn.layers import Linear
    gen = torch.Generator().manual_seed(seed)
    kw = dict(dtype=torch.float32, device="cpu", generator=gen)
    return Linear(4, 4, **kw), Linear(4, 4, **kw)


def _grads(fn, x, params):
    x = x.detach().clone().requires_grad_(True)
    out = fn(x)
    out.sum().backward()
    gs = [x.grad.clone()] + [p.grad.clone() for p in params]
    for p in params:
        p.grad = None
    return out.detach(), gs


def test_recompute_matches_plain_autograd():
    from paddle_tpu_torch.distributed.fleet import recompute
    l1, l2 = _linear_pair()
    params = list(l1.parameters()) + list(l2.parameters())
    x = torch.randn(2, 4)

    def block(t):
        return l2(torch.tanh(l1(t)))
    y_re, g_re = _grads(lambda t: recompute(block, t), x, params)
    y, g = _grads(block, x, params)
    torch.testing.assert_close(y_re, y, rtol=0, atol=0)
    for a, b in zip(g_re, g):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_recompute_matches_jax():
    """``tests/test_jit_io.py:137``'s case on JAX's weights: the input's
    and every weight's gradient through ``recompute`` equal JAX's."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn
    from paddle_tpu.distributed.fleet import recompute as jrecompute
    from paddle_tpu_torch.distributed.fleet import recompute
    paddle.seed(5)
    j1, j2 = jnn.Linear(4, 4), jnn.Linear(4, 4)
    xv = np.random.default_rng(5).standard_normal((2, 4)).astype(np.float32)
    x = paddle.to_tensor(xv, stop_gradient=False)
    jrecompute(lambda t: j2(paddle.tanh(j1(t))), x).sum().backward()
    want = [x.grad.numpy()] + [p.grad.numpy() for p in
                               list(j1.parameters()) + list(j2.parameters())]
    l1, l2 = _linear_pair()
    with torch.no_grad():
        for t, j in ((l1, j1), (l2, j2)):
            t.weight.copy_(torch.from_numpy(np.array(j.weight.numpy())))
            t.bias.copy_(torch.from_numpy(np.array(j.bias.numpy())))
    params = list(l1.parameters()) + list(l2.parameters())
    _, got = _grads(lambda t: recompute(lambda u: l2(torch.tanh(l1(u))), t),
                    torch.from_numpy(xv), params)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


class _DropBlock(torch.nn.Module):
    """Linear -> dropout 0.5 (its own generator) -> tanh."""

    def __init__(self):
        super().__init__()
        from paddle_tpu_torch.nn.layers import Dropout
        self.lin = _linear_pair(3)[0]
        self.gen = torch.Generator().manual_seed(7)
        self.drop = Dropout(0.5, generator=self.gen)

    def forward(self, x):
        return torch.tanh(self.drop(self.lin(x)))


def test_recompute_replays_the_dropout_generator():
    """The recompute draws the forward's mask: gradients equal a plain run
    from the same generator state, and the generator ends where the plain
    forward leaves it (one draw a step)."""
    from paddle_tpu_torch.distributed.fleet import recompute
    m = _DropBlock()
    params = list(m.parameters())
    x = torch.randn(8, 4)
    start = m.gen.get_state()
    y_re, g_re = _grads(lambda t: recompute(m, t), x, params)
    after_re = m.gen.get_state()
    m.gen.set_state(start)
    y, g = _grads(m, x, params)
    assert torch.equal(after_re, m.gen.get_state())
    torch.testing.assert_close(y_re, y, rtol=0, atol=0)
    for a, b in zip(g_re, g):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (y == torch.tanh(torch.zeros(()))).any()     # dropped entries


def test_recompute_sequential_matches_plain():
    """Two segments over four layers (dropout among them) equal the plain
    ``Sequential``."""
    from paddle_tpu_torch.distributed.fleet import recompute_sequential
    seq = torch.nn.Sequential(_DropBlock(), torch.nn.Tanh(), _DropBlock(),
                              torch.nn.ReLU())
    params = list(seq.parameters())
    gens = [seq[0].gen, seq[2].gen]
    start = [g.get_state() for g in gens]
    x = torch.randn(8, 4)
    y_re, g_re = _grads(
        lambda t: recompute_sequential({"segments": 2}, seq, t), x, params)
    for g, s in zip(gens, start):
        g.set_state(s)
    y, g = _grads(seq, x, params)
    torch.testing.assert_close(y_re, y, rtol=0, atol=0)
    for a, b in zip(g_re, g):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_recompute_without_grad_is_the_plain_call():
    from paddle_tpu_torch.distributed.fleet import recompute
    l1, _ = _linear_pair()
    x = torch.randn(2, 4)
    with torch.no_grad():
        y = recompute(l1, x)
    assert y.grad_fn is None
    torch.testing.assert_close(y, l1(x).detach())


# -- the LLaMA at pp 1 --------------------------------------------------------
PP1 = {
    "1f1b": dict(),
    "vpp2": dict(n_chunks=2),
    "vpp4": dict(n_chunks=4),
    "zero_bubble": dict(schedule="zero_bubble"),
    "remat": dict(remat_stage=True),
    "fused_adamw": dict(fused=True),
    "gpipe": dict(gpipe=True),
}
N_MICRO = 4


@functools.lru_cache(maxsize=None)
def _pp1_run(name):
    """``name``'s step on JAX's weights at pp 1 for 3 steps: (losses,
    first-step gradients, parameters after, max_in_flight)."""
    from paddle_tpu_torch.models.convert import params_from_numpy
    from paddle_tpu_torch.models.llama import (build_functional_llama,
                                               llama_config_tiny,
                                               llama_microbatch_fns)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import (Pipeline1F1BTrainStep,
                                           PipelineTrainStep)
    kw = dict(PP1[name])
    ep, bp, hp = params_from_numpy(*llama_oracle()["init"], device="cpu")
    opt = AdamW(learning_rate=cases.LR, fused=kw.pop("fused", False))
    cfg = llama_config_tiny(**cases.TINY)
    if kw.pop("gpipe", False):
        _, _, _, ea, ba, hl = build_functional_llama(
            cfg, n_micro=N_MICRO, init_params=False, device="cpu")
        step = PipelineTrainStep(None, ea, ba, hl, ep, bp, hp, opt,
                                 n_micro=N_MICRO, device="cpu")
    else:
        ea, ba, hl = llama_microbatch_fns(cfg, device="cpu")
        step = Pipeline1F1BTrainStep(None, ea, ba, hl, ep, bp, hp, opt,
                                     n_micro=N_MICRO, device="cpu", **kw)
    ids, labels = (torch.from_numpy(a).long() for a in cases.batch())
    losses, grads = [], None
    for _ in range(cases.STEPS):
        losses.append(float(step((ids, labels))))
        if grads is None:
            grads = {f"{t}.{k}": g.clone().numpy()
                     for t, tree in zip(("ep", "bp", "hp"), step._grads)
                     for k, g in tree.items()}
    params = {f"{t}.{k}": v.numpy() for t, tree in zip(
        ("ep", "bp", "hp"), step.materialized_params())
        for k, v in tree.items()}
    return losses, grads, params, step.max_in_flight


@pytest.mark.parametrize("name", list(PP1))
def test_pp1_losses_match_dense(name):
    np.testing.assert_allclose(_pp1_run(name)[0], llama_oracle()["losses"],
                               rtol=LOSS_RTOL, atol=1e-6)


@pytest.mark.parametrize("name", list(PP1))
def test_pp1_first_step_gradients_match_dense(name):
    got = _pp1_run(name)[1]
    for key, want in llama_oracle()["grads"].items():
        np.testing.assert_allclose(got[key], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)


@pytest.mark.parametrize("name", list(PP1))
def test_pp1_parameters_after_three_steps_match_dense(name):
    oracle = llama_oracle()
    got = _pp1_run(name)[2]
    for key, want in oracle["params"].items():
        assert_params(got[key], want, oracle["ill"][key], key)


def _zb_in_flight(n, M, r):
    from paddle_tpu_torch.parallel.zero_bubble import (F, _slot_ticks,
                                                       build_schedule)
    rows = build_schedule(n, M, "zb1")
    f_t, _, w_t = _slot_ticks(rows)
    return max(sum(1 for m in range(M) if f_t[r][m] <= t < w_t[r][m])
               for t, (k, _) in enumerate(rows[r]) if k == F)


@pytest.mark.parametrize("name", list(PP1))
def test_pp1_max_in_flight_is_the_depth_bound(name):
    """1F1B with v chunks on one rank: stage 0 holds min(M, 2 (v - 1) + 1)
    graphs (1 at v = 1); zero bubble the table's count; GPipe all M."""
    got = _pp1_run(name)[3]
    v = PP1[name].get("n_chunks", 1)
    if name == "gpipe":
        assert got == N_MICRO
    elif name == "zero_bubble":
        assert got == _zb_in_flight(1, N_MICRO, 0) == 2
    else:
        assert got == min(N_MICRO, 2 * (v - 1) + 1)


# -- the generic step and PipelineParallel at pp 1 ----------------------------
def _linear_pipeline(widths, num_stages=1, accumulate_steps=1):
    """``pipeline_rank.py``'s ``PipelineLayer`` of ``Linear``s on
    ``linear_data``'s weights, its AdamW and a ``PipelineParallel`` over
    it."""
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, PipelineParallel)
    from paddle_tpu_torch.nn.layers import Linear
    from paddle_tpu_torch.optimizer import AdamW
    ws, _, _ = cases.linear_data()
    gen = torch.Generator().manual_seed(0)
    pl = PipelineLayer(
        [LayerDesc(Linear, a, b, dtype=torch.float32, device="cpu",
                   generator=gen) for a, b in zip(widths[:-1], widths[1:])],
        num_stages=num_stages, loss_fn=lambda o, y: ((o - y) ** 2).mean())
    with torch.no_grad():
        for layer, (w, b), a, o in zip(pl.run_function, ws, widths[:-1],
                                       widths[1:]):
            layer.weight.copy_(torch.from_numpy(w[:a, :o]))
            layer.bias.copy_(torch.from_numpy(b[:o]))
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"pp_configs": {
        "micro_batch_size": 1, "accumulate_steps": accumulate_steps}}
    opt = AdamW(learning_rate=cases.LR, parameters=pl.parameters())
    return pl, opt, PipelineParallel(pl, None, strategy)


def _linear_batch(widths):
    _, x, y = cases.linear_data()
    return torch.from_numpy(x), torch.from_numpy(y[:, :widths[-1]])


def _hold_linear(pl, oracle, widths):
    for i in range(len(widths) - 1):
        for k in ("weight", "bias"):
            name = f"run_function.{i}.{k}"
            assert_params(dict(pl.named_parameters())[name].detach().numpy(),
                          oracle["params"][name], oracle["ill"][name],
                          name, steps=len(oracle["losses"]))


def test_generic_step_at_pp1_matches_dense():
    """One stage, 4 microbatches: the 1F1B engine's handoff-free path
    trains the module's own parameters as the dense model does."""
    from paddle_tpu_torch.parallel import GenericPipeline1F1BTrainStep
    widths = tuple(cases.PP_WIDTHS)
    pl, opt, _ = _linear_pipeline(widths)
    x, y = _linear_batch(widths)
    step = GenericPipeline1F1BTrainStep(None, pl, opt, n_micro=4,
                                        example_input=x, device="cpu")
    losses = [float(step((x, y))) for _ in range(cases.PP_STEPS)]
    assert step.sync_to_model() is pl and step.max_in_flight == 1
    oracle = linear_oracle(widths, cases.PP_STEPS)
    np.testing.assert_allclose(losses, oracle["losses"], rtol=LOSS_RTOL,
                               atol=1e-6)
    _hold_linear(pl, oracle, widths)


def test_pipeline_parallel_without_pp_accumulates():
    """No pp axis: ``train_batch`` runs JAX's micro-batch accumulation
    (2 microbatches) with the eager optimizer; ``eval_batch`` gives the
    loss of the trained model."""
    widths = tuple(cases.PP_WIDTHS)
    pl, opt, model = _linear_pipeline(widths, accumulate_steps=2)
    x, y = _linear_batch(widths)
    losses = [float(model.train_batch((x, y), opt))
              for _ in range(cases.PP_STEPS)]
    assert model._step is None
    oracle = linear_oracle(widths, cases.PP_STEPS)
    np.testing.assert_allclose(losses, oracle["losses"], rtol=LOSS_RTOL,
                               atol=1e-6)
    _hold_linear(pl, oracle, widths)
    want = float(((pl(x) - y) ** 2).mean().detach())
    assert float(model.eval_batch((x, y))) == pytest.approx(want, rel=1e-6)
    torch.testing.assert_close(model.eval_batch((x, y), compute_loss=False),
                               pl(x).detach())


# -- JAX's errors -------------------------------------------------------------
def _tiny_step(**kw):
    from paddle_tpu_torch.models.llama import (llama_config_tiny,
                                               llama_microbatch_fns,
                                               init_llama_params)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import Pipeline1F1BTrainStep
    cfg = llama_config_tiny(**cases.TINY)
    ep, bp, hp = init_llama_params(cfg, device="cpu")
    ea, ba, hl = llama_microbatch_fns(cfg, device="cpu")
    return Pipeline1F1BTrainStep(None, ea, ba, hl, ep, bp, hp, AdamW(1e-2),
                                 n_micro=2, device="cpu", **kw)


ERRORS = {
    "unknown_schedule": (dict(schedule="gpipe"), ValueError,
                         "unknown schedule"),
    "zero_bubble_chunks": (dict(schedule="zero_bubble", n_chunks=2),
                           ValueError, "no VPP chunks"),
    "block_specs_axis": (dict(block_specs={"wq": (None, "dp")}), ValueError,
                         "only shard over 'mp'/'ep'"),
    "layers_not_divisible": (dict(n_chunks=3), ValueError,
                             "not divisible by n_pp\\*n_chunks"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_pipeline_1f1b_step_raises_as_jax(name):
    kw, exc, match = ERRORS[name]
    with pytest.raises(exc, match=match):
        _tiny_step(**kw)


def test_microbatches_must_split_the_batch():
    step = _tiny_step()
    ids = torch.zeros((3, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="2 microbatches"):
        step((ids, ids))


def test_generic_step_raises_as_jax():
    """JAX's stage-count and loss_fn errors (``test_pipeline_schedules.py
    :128``)."""
    from paddle_tpu_torch.parallel import GenericPipeline1F1BTrainStep
    widths = tuple(cases.PP_WIDTHS)
    pl, opt, _ = _linear_pipeline(widths, num_stages=2)
    x, _ = _linear_batch(widths)
    with pytest.raises(ValueError, match="stages"):
        GenericPipeline1F1BTrainStep(None, pl, opt, n_micro=2,
                                     example_input=x, device="cpu")
    pl, opt, _ = _linear_pipeline(widths)
    pl._loss_fn = None
    with pytest.raises(ValueError, match="loss_fn"):
        GenericPipeline1F1BTrainStep(None, pl, opt, n_micro=2,
                                     example_input=x, device="cpu")


# -- the wiring ---------------------------------------------------------------
class _HCG:
    def __init__(self, pp=1, mp=1, dp=1):
        self.pp, self.mp, self.dp = pp, mp, dp

    def get_pipe_parallel_world_size(self):
        return self.pp

    def get_model_parallel_world_size(self):
        return self.mp

    def get_data_parallel_world_size(self):
        return self.dp


@pytest.mark.parametrize("pipeline_layer", [True, False],
                         ids=["PipelineLayer", "plain"])
def test_distributed_model_at_pp2(monkeypatch, pipeline_layer):
    """pp 2: a ``PipelineLayer`` becomes ``PipelineParallel`` (where the
    port raised for every model); another model falls through to the mp /
    dp branches (here: returned as it is)."""
    from paddle_tpu_torch.distributed.fleet import fleet_api
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineParallel)
    monkeypatch.setattr(fleet_api, "get_hybrid_communicate_group",
                        lambda: _HCG(pp=2))
    pl, _, _ = _linear_pipeline(tuple(cases.PP_WIDTHS), num_stages=2)
    model = pl if pipeline_layer else torch.nn.Linear(2, 2)
    out = fleet_api.distributed_model(model)
    if pipeline_layer:
        assert isinstance(out, PipelineParallel) and out._layers is pl
    else:
        assert out is model


def test_exports():
    import paddle_tpu_torch.parallel as par
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel, utils
    assert fleet.recompute is utils.recompute
    assert fleet.recompute_sequential is utils.recompute_sequential
    for name in ("PipelineLayer", "LayerDesc", "SharedLayerDesc",
                 "PipelineParallel"):
        assert getattr(fleet, name) is getattr(meta_parallel, name)
    for name in ("PipelineTrainStep", "Pipeline1F1BTrainStep",
                 "GenericPipeline1F1BTrainStep"):
        assert name in par.__all__ and hasattr(par, name)


@pytest.mark.parametrize("which", ["1f1b", "gpipe", "generic"])
def test_entry_points_without_device_need_a_card(monkeypatch, which):
    """Each step resolves ``device=None`` to the card and raises without
    one."""
    from paddle_tpu_torch.models.llama import (llama_config_tiny,
                                               init_llama_params)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import (GenericPipeline1F1BTrainStep,
                                           Pipeline1F1BTrainStep,
                                           PipelineTrainStep)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama_config_tiny(**cases.TINY)
    ep, bp, hp = init_llama_params(cfg, device="cpu")
    f = lambda *a: None  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if which == "1f1b":
            Pipeline1F1BTrainStep(None, f, f, f, ep, bp, hp, AdamW(1e-2),
                                  n_micro=2)
        elif which == "gpipe":
            PipelineTrainStep(None, f, f, f, ep, bp, hp, AdamW(1e-2),
                              n_micro=2)
        else:
            pl, opt, _ = _linear_pipeline(tuple(cases.PP_WIDTHS))
            GenericPipeline1F1BTrainStep(None, pl, opt, n_micro=2,
                                         example_input=np.zeros((4, 16)))

