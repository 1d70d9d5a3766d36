"""Port parity of the LLaMA train step: ``build_functional_llama`` loss and
gradients against ``jax.value_and_grad`` of the JAX package's, composed as
``bench.py``'s step composes them, on a tiny f32 config (2 layers, hidden
128, 4 heads, MHA and GQA 4:2, B = 2, S = 128) with the JAX weights crossed
over through numpy; the chunked head against the dense one; AdamW against
JAX's ``apply_gradients_functional`` on equal inputs.  On the CPU the JAX
side runs its jnp attention and ``rms_norm_ref``; the port runs the plain
versions of its kernels (``kernels=True``) or plain attention and
``rms_norm_ref`` under autograd (``kernels=False``)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import optimizer as joptim
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import build_functional_llama as jbuild
from paddle_tpu.parallel.pipeline import _flatten as jflatten
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama import build_functional_llama as tbuild
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused as tfu
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.parallel import _flatten, _unflatten

B, S, VOCAB = 2, 128, 256
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops, as on a CPU where no Pallas
    override is registered, even after an earlier test on this worker
    registered them (``paddle_tpu.ops.pallas.register_all(force=True)``):
    a registered override would call a Pallas kernel outside interpret
    mode."""
    import paddle_tpu
    prev = paddle_tpu.get_flags(["use_pallas_kernels"])
    paddle_tpu.set_flags({"use_pallas_kernels": False})
    yield
    paddle_tpu.set_flags(prev)


def _configs(kv_heads):
    kw = dict(vocab_size=VOCAB, hidden_size=128, intermediate_size=384,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=kv_heads, max_position_embeddings=S)
    return JConfig(**kw), LlamaConfig(**kw)


def _batch(seed=0):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (B, S)) \
        .astype(np.int32)
    return ids


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(kv_heads, seed, head_chunks):
    """The JAX oracle for one config and batch (shared by the kernels-on
    and kernels-off cases)."""
    jcfg, _ = _configs(kv_heads)
    ids = _batch(seed)
    ep, bp, hp, ea, ba, hl = jbuild(jcfg, key=jax.random.PRNGKey(3),
                                    head_chunks=head_chunks)
    L = jcfg.num_hidden_layers
    batch = (jnp.asarray(ids), jnp.asarray(ids))

    def loss_fn(ep, bp, hp):
        x = ea(ep, batch)[0]
        for i in range(L):
            x = ba(jax.tree_util.tree_map(lambda v: v[i], bp), x)
        return hl(hp, x[None], batch)

    # jitted: eager JAX compiles every op of the forward and backward alone
    loss, grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2)))(
        ep, bp, hp)
    to_np = lambda t: {k: np.asarray(v) for k, v in t.items()}
    return (float(loss), [to_np(t) for t in (ep, bp, hp)],
            [to_np(g) for g in grads])


def _port_loss_and_grads(tcfg, params_np, ids, head_chunks, kernels):
    _, _, _, ea, ba, hl = tbuild(tcfg, init_params=False, device="cpu",
                                 head_chunks=head_chunks, kernels=kernels)
    trees = params_from_numpy(*params_np, device="cpu")
    leaves = [v.requires_grad_(True) for t in trees for v in t.values()]
    ids_t = torch.from_numpy(ids)
    batch = (ids_t, ids_t)
    x = ea(trees[0], batch)[0]
    for i in range(tcfg.num_hidden_layers):
        x = ba({k: v[i] for k, v in trees[1].items()}, x)
    loss = hl(trees[2], x[None], batch)
    gs = iter(torch.autograd.grad(loss, leaves))
    return float(loss.detach()), [{k: next(gs).numpy() for k in t}
                                  for t in trees]


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa4:2"])
def test_loss_and_grads_match_jax_value_and_grad(kv_heads, kernels):
    _, tcfg = _configs(kv_heads)
    ids = _batch()
    jloss, params, jgrads = _jax_loss_and_grads(kv_heads, 0, head_chunks=8)
    counts = (tfa.flash_attention_fwd.launches, tfu.rms_norm_fwd.launches)
    tloss, tgrads = _port_loss_and_grads(tcfg, params, ids, 8, kernels)
    assert counts == (tfa.flash_attention_fwd.launches,
                      tfu.rms_norm_fwd.launches)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    for jt, tt in zip(jgrads, tgrads):
        assert jt.keys() == tt.keys()
        for k in jt:
            np.testing.assert_allclose(tt[k], jt[k], err_msg=k, **GRAD_TOL)


def test_chunked_head_equals_dense_head_in_both_frameworks():
    _, tcfg = _configs(4)
    ids = _batch(1)
    jdense, params, jgd = _jax_loss_and_grads(4, 1, head_chunks=0)
    jchunk, _, jgc = _jax_loss_and_grads(4, 1, head_chunks=8)
    tdense, tgd = _port_loss_and_grads(tcfg, params, ids, 0, True)
    tchunk, tgc = _port_loss_and_grads(tcfg, params, ids, 8, True)
    np.testing.assert_allclose(jchunk, jdense, rtol=2e-5)
    np.testing.assert_allclose(tchunk, tdense, rtol=2e-5)
    np.testing.assert_allclose(tdense, jdense, rtol=LOSS_RTOL)
    for gd, gc in ((jgd, jgc), (tgd, tgc)):
        for a, b in zip(gd, gc):
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=2e-4, atol=1e-6,
                                           err_msg=k)


def test_chunked_head_takes_a_divisor_of_the_vocab():
    """n_chunks that does not divide V falls back to the largest divisor
    below it, as in JAX; the loss is unchanged."""
    from paddle_tpu.incubate.nn.functional import \
        fused_linear_cross_entropy_impl as jce
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy_impl as tce
    r = np.random.default_rng(2)
    x = r.standard_normal((16, 32)).astype(np.float32)
    w = r.standard_normal((32, 96)).astype(np.float32)
    lab = r.integers(0, 96, 16).astype(np.int32)
    want = np.asarray(jce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(lab),
                          n_chunks=7))
    for n in (7, 8, 1):
        got = tce(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(lab), n_chunks=n)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _adam_case(seed, step, shape=(8, 16)):
    r = np.random.default_rng(seed)
    p = r.standard_normal(shape).astype(np.float32)
    g = (r.standard_normal(shape) * 10.0 ** r.integers(-6, 1, shape)) \
        .astype(np.float32)
    m = (r.standard_normal(shape) * 1e-2).astype(np.float32)
    v = (r.random(shape) * 1e-3).astype(np.float32)
    pows = np.float32(0.9 ** step), np.float32(0.999 ** step)
    return p, g, m, v, pows


def _check_update_on_equal_inputs(jopt, topt, step):
    """One update from the same parameter, gradient and state, at the beta
    powers of steps 1-3 (not a chain: Adam's first step is +-lr wherever
    |g| is tiny, so a chain would magnify rounding)."""
    names = ("a", "b.c")
    cases = {n: _adam_case(10 * step + i, step) for i, n in enumerate(names)}
    jp = {n: jnp.asarray(c[0]) for n, c in cases.items()}
    jg = {n: jnp.asarray(c[1]) for n, c in cases.items()}
    jst = {n: {"moment1": jnp.asarray(c[2]), "moment2": jnp.asarray(c[3]),
               "beta1_pow": jnp.asarray(c[4][0]),
               "beta2_pow": jnp.asarray(c[4][1])} for n, c in cases.items()}
    jnew, jnst = jopt.apply_gradients_functional(
        jp, jg, jst, lr=jnp.asarray(1e-4, jnp.float32))

    tp = {n: torch.from_numpy(c[0].copy()) for n, c in cases.items()}
    tg = {n: torch.from_numpy(c[1]) for n, c in cases.items()}
    tst = {n: {"moment1": torch.from_numpy(c[2].copy()),
               "moment2": torch.from_numpy(c[3].copy()),
               "beta1_pow": torch.tensor(c[4][0]),
               "beta2_pow": torch.tensor(c[4][1])} for n, c in cases.items()}
    tnew, tnst = topt.apply_gradients_functional(tp, tg, tst)
    for n in names:
        assert tnew[n] is tp[n]                      # updated in place
        np.testing.assert_allclose(tnew[n].numpy(), np.asarray(jnew[n]),
                                   rtol=1e-6, atol=1e-6)
        for key in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_allclose(tnst[n][key].numpy(),
                                       np.asarray(jnst[n][key]),
                                       rtol=1e-6, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_adamw_update_matches_jax_on_equal_inputs(step):
    """Decoupled decay: p * (1 - lr * wd) before the Adam step."""
    _check_update_on_equal_inputs(
        joptim.AdamW(learning_rate=1e-4, parameters=[], weight_decay=0.01),
        AdamW(learning_rate=1e-4, weight_decay=0.01), step)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_adam_l2_update_matches_jax_on_equal_inputs(step):
    """Adam's weight decay is L2 on the gradient: g + wd * p."""
    _check_update_on_equal_inputs(
        joptim.Adam(learning_rate=1e-4, parameters=[], weight_decay=0.01),
        Adam(learning_rate=1e-4, weight_decay=0.01), step)


def test_adamw_state_and_dtypes():
    """init_opt_state matches JAX's (f32 zeros, beta powers 1); a bf16
    parameter stays bf16 with f32 moments; a parameter without a gradient
    passes through."""
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
              "n": torch.ones(4)}
    opt = AdamW(learning_rate=0.1)       # a step bf16 can show at 1.0
    st = opt.init_opt_state(params, device="cpu")
    jst = joptim.AdamW(learning_rate=1e-3, parameters=[]).init_opt_state(
        {"w": jnp.ones((4, 4), jnp.bfloat16)})
    for key in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
        assert st["w"][key].dtype == torch.float32
        np.testing.assert_array_equal(st["w"][key].numpy(),
                                      np.asarray(jst["w"][key]))
    new, nst = opt.apply_gradients_functional(
        params, {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}, st)
    assert new["w"].dtype == torch.bfloat16 and bool((new["w"] < 1).all())
    assert new["n"] is params["n"] and bool((new["n"] == 1).all())
    assert float(nst["w"]["beta1_pow"]) == pytest.approx(0.9)


def test_flatten_round_trip_matches_jax():
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert _flatten(tree) == jflatten(tree)
    assert _unflatten(_flatten(tree), tree) == tree


def test_three_steps_lower_the_loss():
    """The bench composition end to end on the CPU: three AdamW steps on
    labels equal to the inputs lower the loss (seeded torch init)."""
    _, tcfg = _configs(2)
    ep, bp, hp, ea, ba, hl = tbuild(tcfg, device="cpu", head_chunks=8, seed=1)
    trees = (ep, bp, hp)
    for t in trees:
        for v in t.values():
            v.requires_grad_(True)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01)
    states = [opt.init_opt_state(_flatten(t), device="cpu") for t in trees]
    ids = torch.from_numpy(_batch(4))
    losses = []
    for _ in range(3):
        x = ea(ep, (ids, ids))[0]
        for i in range(tcfg.num_hidden_layers):
            x = ba({k: v[i] for k, v in bp.items()}, x)
        loss = hl(hp, x[None], (ids, ids))
        leaves = [v for t in trees for v in t.values()]
        gs = iter(torch.autograd.grad(loss, leaves))
        for t, st in zip(trees, states):
            grads = {k: next(gs) for k in t}
            opt.apply_gradients_functional(_flatten(t), _flatten(grads), st)
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_not_ported_options_raise():
    """Expert parallelism and MoE blocks raise, naming the next slice;
    ``mp_axis`` is ported (without a mesh its group is this process
    alone, and the blocks are whole)."""
    _, tcfg = _configs(4)
    with pytest.raises(NotImplementedError, match="next slice"):
        tbuild(dataclasses.replace(tcfg), device="cpu", ep_axis="ep")
    moe = dataclasses.replace(tcfg)
    moe.num_experts = 2
    with pytest.raises(NotImplementedError, match="next slice"):
        tbuild(moe, device="cpu")
    _, bp, *_ = tbuild(tcfg, device="cpu", mp_axis="mp")
    assert bp["wq"].shape[-1] == tcfg.hidden_size
