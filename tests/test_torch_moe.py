"""Port parity of the MoE core (``paddle_tpu_torch.incubate.distributed.
models.moe`` and the MoE blocks of ``models.llama``) against the JAX
package's, on one process.

Held, on the same seeded numpy inputs: the capacity helpers (``utils``)
and ``top_k_gating``'s dispatch mask, slot positions and top indices
exactly, its combine weights and balance loss within 1e-6 (ample
capacity, overflow, ``NaiveGate`` without capacity, ``SwitchGate`` top-1,
random routing fed JAX's own uniform draw); the routed dispatch bit for
bit and the routed combine within 1e-6 of the mask einsums; ``moe_ffn``
and its gradients in f32 at JAX's tolerance (rtol 2e-4 / atol 2e-5,
``tests/test_moe_ep.py:160``); the tiny MoE LLaMA's loss and every
gradient against ``jax.value_and_grad`` of JAX's ``build_functional_llama``
at rtol 1e-4 / atol 1e-5; ``fused_moe``; the MoE leaves through
``params_from_numpy``.  Where a top-k could sit on a near-tie the test
asserts the inputs' top-k margin exceeds 1e-4 first."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import build_functional_llama as jbuild
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.incubate.distributed.models.moe import gate as tgate
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama import build_functional_llama as tbuild

MARGIN = 1e-4
FFN_TOL = dict(rtol=2e-4, atol=2e-5)
LLAMA_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """JAX's oracle runs its plain ops even where an earlier test of this
    worker registered the Pallas overrides."""
    import paddle_tpu
    prev = paddle_tpu.get_flags(["use_pallas_kernels"])
    paddle_tpu.set_flags({"use_pallas_kernels": False})
    yield
    paddle_tpu.set_flags(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _margin(probs, k):
    """The smallest gap between a token's k-th and (k+1)-th probability."""
    s = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    return (s[:, k - 1] - s[:, k]).min() if s.shape[-1] > k else np.inf


def _logits(seed, T, E, scale=1.0):
    """Seeded logits whose top-k choices are more than MARGIN apart."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(T, E)) * scale).astype(np.float32)
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    for k in (1, 2):
        assert _margin(p, k) > MARGIN, (seed, k)
    return x


# -- utils --------------------------------------------------------------------
GATE_IDX = np.array([0, 1, 0, 2, 0, 1, -1, 3, 0], np.int32)


@pytest.mark.parametrize("fn", ["number_count", "assign_pos",
                                "limit_by_capacity", "prune_gate_by_capacity",
                                "count_by_gate"])
def test_utils_match_jax(fn):
    ju, tu = jmoe.utils, tmoe.utils
    idx = GATE_IDX
    if fn == "number_count":
        want, got = ju.number_count(jnp.asarray(idx), 4), \
            tu.number_count(_t(idx), 4)
    elif fn == "assign_pos":
        want, got = ju.assign_pos(jnp.asarray(idx), 4), \
            tu.assign_pos(_t(idx), 4)
    elif fn == "limit_by_capacity":
        c = np.array([3, 2, 1, 0], np.int32)
        want, got = ju.limit_by_capacity(jnp.asarray(c), 2, n_worker=1), \
            tu.limit_by_capacity(_t(c), 2, n_worker=1)
    elif fn == "prune_gate_by_capacity":
        lim = np.array([2, 2, 1, 1], np.int32)
        want = ju.prune_gate_by_capacity(jnp.asarray(idx), jnp.asarray(lim), 4)
        got = tu.prune_gate_by_capacity(_t(idx), _t(lim), 4)
    else:
        want = ju.count_by_gate(jnp.asarray(idx), 4)
        got = tu.count_by_gate(_t(idx), 4)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_routing_matches_jax_on_the_same_draw():
    rng = np.random.default_rng(1)
    v = np.sort(rng.uniform(0, 0.5, (64, 2)), axis=-1)[:, ::-1] \
        .astype(np.float32).copy()
    i = rng.integers(0, 8, (64, 2)).astype(np.int32)
    r = rng.uniform(size=64).astype(np.float32)
    assert np.abs(r - 2 * v[:, 1]).min() > MARGIN
    want = jmoe.utils.random_routing(jnp.asarray(i), jnp.asarray(v),
                                     jnp.asarray(r))
    got = tmoe.utils.random_routing(_t(i), _t(v), _t(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 1] == -1).any() and (got[:, 1] >= 0).any()


def test_compute_capacity_matches_jax():
    for args in ((8192, 8, 2, 1.25), (16, 4, 2, 2.0), (7, 3, 1, 1.2),
                 (1, 64, 1, 0.1)):
        assert tmoe.compute_capacity(*args) == jmoe.compute_capacity(*args)


# -- gating -------------------------------------------------------------------
# name: (T, E, k, capacity or None = compute_capacity(T, E, k, 1.25))
GATING = {"ample": (32, 4, 2, 32), "overflow": (48, 4, 2, 18),
          "naive_no_capacity": (24, 6, 2, 24), "switch_top1": (40, 4, 1, 8),
          "random_routing": (64, 8, 2, None)}


@pytest.mark.parametrize("case", list(GATING))
def test_top_k_gating_matches_jax(case):
    T, E, k, C = GATING[case]
    C = C or jmoe.compute_capacity(T, E, k, 1.25)
    x = _logits(10 + len(case), T, E)
    kw = {}
    uniform = None
    if case == "random_routing":
        key = jax.random.PRNGKey(5)
        kw = dict(prng=key, random_routing_prob=True)
        r = np.asarray(jax.random.uniform(key, (T,)))
        p = np.asarray(jax.nn.softmax(jnp.asarray(x), -1))
        second = -np.sort(-p, -1)[:, 1]
        assert np.abs(r - 2 * second).min() > MARGIN
        uniform = _t(r)
    # jitted: eager JAX compiles each op of the gating alone
    jc, jd, jaux, jinfo = jax.jit(
        lambda v: jmoe.top_k_gating(v, k, C, **kw))(jnp.asarray(x))
    r = tgate.route(_t(x), k, C, uniform=uniform)
    tc = r.combine_weights()
    np.testing.assert_array_equal((tc > 0).numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(r.aux), float(jaux), rtol=1e-6)
    np.testing.assert_array_equal(r.top_idx.numpy(),
                                  np.asarray(jinfo["top_idx"]))
    np.testing.assert_array_equal(r.within.numpy(),
                                  np.asarray(jinfo["within_capacity"]))
    kept = int(np.asarray(jd).sum())
    assert int(r.kept()) == kept
    if case == "overflow":
        assert kept < k * T, "no token was dropped"
    if case == "random_routing":
        assert (r.top_idx[:, 1] == -1).any()
    if not kw:
        tc2, td2, taux2, _ = tmoe.top_k_gating(_t(x), k, C)
        assert torch.equal(tc2, tc) and float(taux2) == float(r.aux)


def test_gate_layers_capacity_like_jax():
    """NaiveGate without capacity keeps every token; GShardGate / SwitchGate
    take their train / eval factors."""
    dev = dict(device="cpu", generator=torch.Generator().manual_seed(0))
    for tg, jg in ((tmoe.NaiveGate(16, 4, topk=2, **dev),
                    jmoe.NaiveGate(16, 4, topk=2)),
                   (tmoe.GShardGate(16, 4, capacity=(1.0, 2.0), **dev),
                    jmoe.GShardGate(16, 4, capacity=(1.0, 2.0))),
                   (tmoe.SwitchGate(16, 4, **dev), jmoe.SwitchGate(16, 4))):
        assert tg.top_k == jg.top_k and tg.tot_expert == jg.tot_expert
        assert tg.random_routing == jg.random_routing
        for training in (True, False):
            assert tg.capacity_for(37, training) \
                == jg.capacity_for(37, training)


def test_routed_dispatch_and_combine_equal_the_mask_einsums():
    T, E, d, k = 48, 4, 24, 2
    x = np.random.default_rng(3).normal(size=(T, d)).astype(np.float32)
    y = np.random.default_rng(4).normal(size=(E, 30, d)).astype(np.float32)
    C = 30
    r = tgate.route(_t(_logits(21, T, E)), k, C)
    combine = r.combine_weights()
    disp = tmoe.moe_layer.dispatch_routed(_t(x), r)
    want = tmoe.moe_dispatch(_t(x), combine > 0)
    assert torch.equal(disp, want)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jmoe.moe_dispatch(
            jnp.asarray(x), jnp.asarray((combine > 0).numpy()))))
    out = tmoe.moe_layer.combine_routed(_t(y), r)
    ref = tmoe.moe_combine(_t(y), combine)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jmoe.moe_combine(
            jnp.asarray(y), jnp.asarray(combine.numpy()))), rtol=1e-6,
        atol=1e-6)


# -- moe_ffn ------------------------------------------------------------------
def _ffn_inputs(seed, T, E, d, h, bias):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    gw = rng.normal(0, 0.1, (d, E)).astype(np.float32)
    w1 = rng.normal(0, 0.05, (E, d, h)).astype(np.float32)
    w2 = rng.normal(0, 0.05, (E, h, d)).astype(np.float32)
    b1 = rng.normal(0, 0.05, (E, h)).astype(np.float32) if bias else None
    b2 = rng.normal(0, 0.05, (E, d)).astype(np.float32) if bias else None
    p = np.exp(x @ gw - (x @ gw).max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    assert _margin(p, 2) > MARGIN
    return x, gw, w1, b1, w2, b2


@pytest.mark.parametrize("case", ["ample_gelu", "overflow_gelu",
                                  "overflow_relu_bias", "overflow_aux_only"])
def test_moe_ffn_and_its_gradients_match_jax(case):
    """Output, balance loss and the gradients of sum(out ** 2) + aux; the
    aux-only case differentiates the balance loss alone (the expert
    stacks' gradients zero on both sides), so a detached or rescaled
    balance-loss gradient cannot hide under the output's."""
    T, E, d, h = 40, 4, 16, 32
    act = "relu" if "relu" in case else "gelu"
    cap = T if case.startswith("ample") else None
    w_out = 0.0 if "aux_only" in case else 1.0
    args = _ffn_inputs(7, T, E, d, h, bias="bias" in case)
    kw = dict(top_k=2, activation=act, capacity=cap)

    def jloss(x, gw, w1, w2):
        out, aux = jmoe.moe_ffn(x, gw, w1, None if args[3] is None
                                else jnp.asarray(args[3]), w2,
                                None if args[5] is None
                                else jnp.asarray(args[5]), **kw)
        return w_out * jnp.sum(out ** 2) + aux, (out, aux)
    x, gw, w1, _, w2, _ = (None if a is None else jnp.asarray(a)
                           for a in args)
    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(x, gw, w1, w2)
    tx, tgw, tw1, tb1, tw2, tb2 = (None if a is None else _t(a)
                                   for a in args)
    leaves = [t.requires_grad_(True) for t in (tx, tgw, tw1, tw2)]
    out, aux = tmoe.moe_ffn(tx, tgw, tw1, tb1, tw2, tb2, **kw)
    tg = torch.autograd.grad(w_out * (out ** 2).sum() + aux, leaves)
    if w_out == 0.0:
        assert float(tg[1].abs().sum()) > 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FFN_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    for name, a, b in zip(("x", "gate_weight", "w1", "w2"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **FFN_TOL)


# -- the functional MoE LLaMA -------------------------------------------------
def _moe_configs(capacity_factor):
    """JAX's MoE pipeline config (``tests/test_moe_pipeline.py:20``) at 2
    layers: E 4, top-2, hidden 32."""
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, max_position_embeddings=16,
              num_experts=4, moe_topk=2, moe_capacity_factor=capacity_factor)
    return JConfig(**kw), LlamaConfig(**kw)


# JAX's initial gate (0.02 a weight at hidden 32) gives probabilities
# within ~1e-4 of a tie on a few of the 128 tokens; 25x its logits give
# the routing a margin far above f32's error, as the repo's
# margin-engineered parity does
GATE_GAIN = 25.0


def _llama_batch():
    ids = np.random.default_rng(7).integers(0, 64, (4, 16)).astype(np.int32)
    return ids


@functools.lru_cache(maxsize=None)
def _jax_moe_llama(capacity_factor):
    """JAX's loss and gradients on its weights (key 11), the gate's
    ``gate_w`` scaled by ``GATE_GAIN`` (both sides use the scaled one)."""
    jcfg, _ = _moe_configs(capacity_factor)
    ep, bp, hp, ea, ba, hl = jbuild(jcfg, key=jax.random.PRNGKey(11))
    bp = dict(bp, gate_w=bp["gate_w"] * GATE_GAIN)
    ids = jnp.asarray(_llama_batch())
    batch = (ids, ids)

    def loss_fn(ep, bp, hp):
        x = ea(ep, batch)[0]
        for i in range(jcfg.num_hidden_layers):
            x = ba(jax.tree_util.tree_map(lambda v: v[i], bp), x)
        return hl(hp, x[None], batch)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2)))(
        ep, bp, hp)
    to_np = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return (float(loss), [to_np(t) for t in (ep, bp, hp)],
            [to_np(g) for g in grads])


@pytest.mark.parametrize("capacity_factor", [2.0, 1.25],
                         ids=["no_drops", "drops"])
def test_moe_llama_loss_and_grads_match_jax(capacity_factor, monkeypatch):
    """The tiny MoE LLaMA's loss and every gradient (gate, expert stacks,
    attention, norms, embedding, head) against ``jax.value_and_grad`` of
    JAX's functional model on JAX's weights; the gate's top-2 margin is
    asserted at every layer, and with factor 1.25 some choices drop."""
    jloss, params, jgrads = _jax_moe_llama(capacity_factor)
    _, tcfg = _moe_configs(capacity_factor)
    seen = []
    route = tgate.route

    def watched(logits, *a, **kw):
        r = route(logits, *a, **kw)
        seen.append((_margin(r.probs.detach().numpy(), 2),
                     int(r.kept()), r.weight.numel()))
        return r
    monkeypatch.setattr(tgate, "route", watched)
    _, _, _, ea, ba, hl = tbuild(tcfg, init_params=False, device="cpu")
    trees = params_from_numpy(*params, device="cpu")
    assert set(trees[1]) == {"ln1", "wq", "wk", "wv", "wo", "ln2", "gate_w",
                             "we_gate", "we_up", "we_down"}
    leaves = [v.requires_grad_(True) for t in trees for v in t.values()]
    ids = torch.from_numpy(_llama_batch())
    x = ea(trees[0], (ids, ids))[0]
    for i in range(tcfg.num_hidden_layers):
        x = ba({k: v[i] for k, v in trees[1].items()}, x)
    loss = hl(trees[2], x[None], (ids, ids))
    gs = iter(torch.autograd.grad(loss, leaves))
    assert len(seen) == tcfg.num_hidden_layers
    assert all(m > MARGIN for m, _, _ in seen), seen
    dropped = sum(n - kept for _, kept, n in seen)
    assert (dropped > 0) == (capacity_factor < 2.0), seen
    np.testing.assert_allclose(float(loss.detach()), jloss,
                               rtol=LLAMA_TOL["rtol"])
    for jt, t in zip(jgrads, trees):
        for k in t:
            np.testing.assert_allclose(next(gs).numpy(), jt[k], err_msg=k,
                                       **LLAMA_TOL)


def test_moe_init_shapes_and_scales_are_jaxs():
    """``init_llama_params``' MoE leaves: JAX's shapes and JAX's explicit
    scales (1 / sqrt(H) for ``we_gate`` / ``we_up``, 1 / sqrt(I) for
    ``we_down``, 0.02 for ``gate_w``), not 1 / sqrt(shape[0])."""
    from paddle_tpu_torch.models.llama import init_llama_params
    _, tcfg = _moe_configs(1.25)
    tcfg = dataclasses.replace(tcfg, hidden_size=256, intermediate_size=1024,
                               num_experts=16)
    _, params, _ = _jax_moe_llama(1.25)
    _, bp, _ = init_llama_params(tcfg, device="cpu", seed=1)
    H, I = tcfg.hidden_size, tcfg.intermediate_size
    for k, scale in (("gate_w", 0.02), ("we_gate", H ** -0.5),
                     ("we_up", H ** -0.5), ("we_down", I ** -0.5)):
        np.testing.assert_allclose(float(bp[k].std()), scale, rtol=0.05,
                                   err_msg=k)
        assert bp[k].dim() == params[1][k].ndim
    assert tuple(bp["we_down"].shape) == (2, 16, I, H)


def test_moe_block_specs_and_shards_cut_the_expert_axis():
    _, tcfg = _moe_configs(1.25)
    from paddle_tpu_torch.models import llama as tl
    specs = tl.llama_block_specs(mp_axis=None, moe=True, ep_axis="ep")
    assert specs["we_gate"] == ("ep", None, None)
    assert specs["gate_w"] == (None, None) and "wgate" not in specs
    _, _, _, _, _, _ = tbuild(tcfg, device="cpu", ep_axis="ep")   # solo ep
    _, bp, _ = tl.init_llama_params(tcfg, device="cpu")
    cut = tl.shard_llama_block_params(bp, 1, 2, specs, axis="ep")
    assert torch.equal(cut["we_up"], bp["we_up"][:, 2:])
    assert cut["we_up"].is_distributed is True and cut["wq"] is bp["wq"]


# -- fused_moe and the converter ----------------------------------------------
@pytest.mark.parametrize("swiglu", [True, False], ids=["swiglu", "gelu"])
def test_fused_moe_matches_jax(swiglu):
    from paddle_tpu.incubate.nn.functional import fused_moe as jfused
    from paddle_tpu_torch.incubate.nn.functional import fused_moe as tfused
    rng = np.random.default_rng(9)
    B, S, d, E, h = 2, 6, 16, 4, 24
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    gw = rng.normal(0, 0.3, (d, E)).astype(np.float32)
    w1 = rng.normal(0, 0.1, (E, d, 2 * h if swiglu else h)).astype(np.float32)
    b1 = rng.normal(0, 0.1, (E, w1.shape[-1])).astype(np.float32)
    w2 = rng.normal(0, 0.1, (E, h, d)).astype(np.float32)
    b2 = rng.normal(0, 0.1, (E, d)).astype(np.float32)
    logits = (x @ gw).reshape(-1, E)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    assert _margin(p / p.sum(-1, keepdims=True), 2) > MARGIN
    args = (x, gw, w1, b1, w2, b2)
    want = jfused(*(paddle_tensor(a) for a in args))
    got = tfused(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-5, atol=1e-6)


def paddle_tensor(a):
    import paddle_tpu
    return paddle_tpu.to_tensor(a)


def test_params_from_numpy_carries_the_moe_leaves():
    _, params, _ = _jax_moe_llama(2.0)
    trees = params_from_numpy(*params, device="cpu")
    for jt, t in zip(params, trees):
        assert jt.keys() == t.keys()
        for k in jt:
            np.testing.assert_array_equal(t[k].numpy(), jt[k])
