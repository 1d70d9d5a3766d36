"""Port parity of the eager MoE and LLaMA modules against the JAX
package's eager Layers, on one process: ``MoELayer`` with experts as
modules (its output and the gate's balance loss, random routing off, at
the train and the eval capacity), ``LlamaForCausalLM`` dense and MoE (loss
and logits, weights crossed by name through ``llama_params_from_numpy``;
the MoE loss carries each layer's balance loss), ``functional_params_
from_layer``, the ``RMSNorm`` layer and ``swiglu``; and the eager entry
points' device rule."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoELayer
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.incubate.distributed.models.moe import gate as tgate
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import llama_params_from_numpy
from paddle_tpu_torch.nn.functional.activation import gelu

MARGIN = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """JAX's oracle runs its plain ops even where an earlier test of this
    worker registered the Pallas overrides."""
    prev = paddle.get_flags(["use_pallas_kernels"])
    paddle.set_flags({"use_pallas_kernels": False})
    yield
    paddle.set_flags(prev)


@pytest.fixture
def margins(monkeypatch):
    """Every routing the port computes in the test, by its top-k margin."""
    seen = []
    route = tgate.route

    def watched(logits, top_k, *a, **kw):
        r = route(logits, top_k, *a, **kw)
        p = -np.sort(-r.probs.detach().numpy().astype(np.float64), -1)
        seen.append((p[:, top_k - 1] - p[:, top_k]).min())
        return r
    monkeypatch.setattr(tgate, "route", watched)
    return seen


def _named(layer):
    return {n: np.asarray(p.numpy()) for n, p in layer.named_parameters()}


def _load(module, named):
    state = llama_params_from_numpy(named, device="cpu")
    module.load_state_dict(state, strict=True)


class _Expert(torch.nn.Module):
    """JAX's test expert (``tests/test_moe_ep.py:195``): fc2(gelu(fc1))."""

    def __init__(self, d, h):
        super().__init__()
        from paddle_tpu_torch.nn.layers import Linear
        mk = dict(dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0))
        self.fc1, self.fc2 = Linear(d, h, **mk), Linear(h, d, **mk)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


def _jax_expert(d, h):
    from paddle_tpu import nn

    class Expert(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(d, h)
            self.fc2 = nn.Linear(h, d)

        def forward(self, x):
            return self.fc2(nn.functional.gelu(self.fc1(x)))
    return Expert()


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_moe_layer_matches_jax(training, margins):
    """Capacity factors (1.0, 2.0): training drops some of the 48 tokens'
    choices, eval keeps them.  The routing's margin is made by
    construction: the gate reads only the first E features (``gate_weight``
    the identity there, 0 elsewhere), and each token's first E features
    are a permutation of (1.2, 0.4, -0.4, -1.2)."""
    d, h, E, T = 16, 32, 4, 48
    gate = {"type": "gshard", "top_k": 2, "random_routing": False,
            "capacity": (1.0, 2.0)}
    paddle.seed(7)
    jl = JMoELayer(d_model=d, experts=[_jax_expert(d, h) for _ in range(E)],
                   gate=dict(gate))
    named = _named(jl)
    named["gate.gate_weight"] = np.eye(d, E, dtype=np.float32)
    jl.gate.gate_weight.set_value(named["gate.gate_weight"])
    tl = MoELayer(d_model=d, experts=[_Expert(d, h) for _ in range(E)],
                  gate=dict(gate), device="cpu")
    _load(tl, named)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, T // 2, d)).astype(np.float32)
    x[..., :E] = rng.permuted(np.broadcast_to(
        np.float32([1.2, 0.4, -0.4, -1.2]), (2, T // 2, E)), axis=-1)
    (jl.train if training else jl.eval)()
    tl.train(training)
    jout = jl(paddle.to_tensor(x))
    jaux = jl.gate.get_loss()
    tx = torch.from_numpy(x)
    out = tl(tx)
    aux = tl.gate.get_loss()
    assert margins and min(margins) > MARGIN, margins
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.numpy()),
                               **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux.numpy()),
                               rtol=1e-6)
    assert tl.gate.capacity_for(T, training) \
        == jl.gate.capacity_for(T, training)
    (out.square().mean() + aux).backward()
    assert float(tl.gate.gate_weight.grad.abs().sum()) > 0
    assert tl.experts[0].fc1.weight.grad is not None


def _configs(moe):
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=16)
    if moe:
        kw.update(num_experts=4, moe_topk=2)
    return jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_llama_for_causal_lm_matches_jax(moe, margins):
    """JAX's eager model (seed 3; GQA 4:2) and the port's with its weights:
    loss and logits within 1e-5, every parameter's gradient within rtol
    1e-4 / atol 1e-5; the MoE model in training mode at factor 1.25 with
    random routing off on both sides, its loss the cross-entropy plus 0.01
    x each layer's balance loss, and the balance losses' own gradient on
    every gate and on the embedding held apart."""
    jcfg, tcfg = _configs(moe)
    paddle.seed(3)
    jm = jllama.LlamaForCausalLM(jcfg)
    tm = tllama.LlamaForCausalLM(tcfg, device="cpu")
    named = _named(jm)
    assert list(named) == [n for n, _ in tm.named_parameters()]
    _load(tm, named)
    if moe:
        for jl, tl in zip(jm.model.layers, tm.model.layers):
            jl.mlp.moe.gate.random_routing = False
            tl.mlp.moe.gate.random_routing = False
    ids = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32)
    jloss, jlogits = jm(paddle.to_tensor(ids), paddle.to_tensor(ids))
    tids = torch.from_numpy(ids)
    loss, logits = tm(tids, tids)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits.numpy()), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, 64).float(),
                                           tids.reshape(-1).long())
    jloss.backward()
    loss.backward()
    for (n, jp), (_, tp) in zip(jm.named_parameters(),
                                tm.named_parameters()):
        np.testing.assert_allclose(tp.grad.numpy(),
                                   np.asarray(jp.grad.numpy()), err_msg=n,
                                   **GRAD_TOL)
    if moe:
        assert len(margins) == 2 and min(margins) > MARGIN, margins
        aux = float((loss - ce).detach())
        assert aux > 1e-4, aux
        # the balance losses alone, from a forward without labels (which
        # leaves them on the gates): their gradient reaches the gates and,
        # through every layer below, the embedding
        jm(paddle.to_tensor(ids))
        tm(tids)
        jaux = sum(layer.mlp.moe.gate.get_loss() for layer in jm.model.layers)
        aux = sum(layer.mlp.moe.gate.get_loss() for layer in tm.model.layers)
        np.testing.assert_allclose(float(aux.detach()), float(jaux.numpy()),
                                   rtol=1e-6)
        names = [f"llama.layers.{i}.mlp.moe.gate.gate_weight"
                 for i in range(tcfg.num_hidden_layers)] \
            + ["llama.embed_tokens.weight"]
        jp, tp = dict(jm.named_parameters()), dict(tm.named_parameters())
        jg = paddle.grad(jaux, [jp[n] for n in names])
        tg = torch.autograd.grad(aux, [tp[n] for n in names])
        for n, a, b in zip(names, tg, jg):
            assert float(a.abs().sum()) > 0, n
            np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                       err_msg=n, **GRAD_TOL)
        with pytest.raises(NotImplementedError):
            tllama.functional_params_from_layer(tm)
        with pytest.raises(NotImplementedError, match="MoE"):
            tm.generate(tids)
    else:
        assert abs(float((loss - ce).detach())) < 1e-6
        want = jllama.functional_params_from_layer(jm)
        got = tllama.functional_params_from_layer(tm)
        for jt, t in zip(want, got):
            assert jt.keys() == t.keys()
            for k in jt:
                np.testing.assert_array_equal(t[k].numpy(),
                                              np.asarray(jt[k]), err_msg=k)
        with pytest.raises(NotImplementedError, match="5h"):
            tm.generate(tids)
        assert torch.equal(tm(tids), logits)


def test_rms_norm_layer_and_swiglu_match_jax():
    from paddle_tpu import nn as jnn
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn.functional import swiglu
    from paddle_tpu_torch.nn.layers import RMSNorm
    x = np.random.default_rng(2).normal(size=(3, 5, 128)).astype(np.float32)
    w = np.random.default_rng(3).normal(size=(128,)).astype(np.float32)
    jn = jnn.RMSNorm(128, 1e-5)
    jn.weight.set_value(w)
    for kernels in (True, False):
        tn = RMSNorm(128, 1e-5, dtype=torch.float32, device="cpu",
                     kernels=kernels)
        with torch.no_grad():
            tn.weight.copy_(torch.from_numpy(w))
        np.testing.assert_allclose(tn(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(jn(paddle.to_tensor(x))
                                              .numpy()), **TOL)
    a, b = x[..., :64], x[..., 64:]
    np.testing.assert_allclose(
        swiglu(torch.from_numpy(x)).numpy(),
        np.asarray(JF.swiglu(paddle.to_tensor(x)).numpy()), **TOL)
    np.testing.assert_allclose(
        swiglu(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JF.swiglu(paddle.to_tensor(a),
                             paddle.to_tensor(b)).numpy()), **TOL)


def test_tied_embeddings_and_the_tensor_parallel_layers():
    """``tie_word_embeddings`` has no ``lm_head`` (logits = h @ E^T); at
    ``tensor_parallel_degree`` 2 without a mesh the layers are the mp
    layers over this rank alone (the dense model), and the MoE block
    raises, as JAX's does."""
    import dataclasses
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    _, tcfg = _configs(False)
    tied = tllama.LlamaForCausalLM(
        dataclasses.replace(tcfg, tie_word_embeddings=True), device="cpu")
    assert tied.lm_head is None
    ids = torch.randint(0, 64, (1, 16), generator=torch.Generator()
                        .manual_seed(0))
    h = tied.model(ids)
    assert torch.allclose(tied(ids), h @ tied.model.embed_tokens.weight.t())
    tp = tllama.LlamaForCausalLM(
        dataclasses.replace(tcfg, tensor_parallel_degree=2), device="cpu")
    layer = tp.model.layers[0]
    assert isinstance(layer.self_attn.q_proj, ColumnParallelLinear)
    assert isinstance(layer.mlp.down_proj, RowParallelLinear)
    assert isinstance(tp.model.embed_tokens, VocabParallelEmbedding)
    loss, _ = tp(ids, ids)
    assert torch.isfinite(loss)
    with pytest.raises(NotImplementedError, match="tensor-parallel experts"):
        tllama.LlamaForCausalLM(dataclasses.replace(
            _configs(True)[1], tensor_parallel_degree=2), device="cpu")


def test_eager_entry_points_need_a_card(monkeypatch):
    from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs(True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.LlamaForCausalLM(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GShardGate(16, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MoELayer(16, [_Expert(16, 8)])
    assert tllama.LlamaConfig(num_experts=8).moe_capacity_factor == 1.25
    assert len(tllama.LlamaConfig.__dataclass_fields__) \
        == len(jllama.LlamaConfig.__dataclass_fields__) == 17
