"""Port parity: paddle_tpu_torch.ops.fused.adamw_update (the fused AdamW
kernel's plain version on the CPU) against the JAX package's Pallas AdamW
kernel (``fused.adamw_update(..., interpret=True)``) at the JAX suite's
1e-6, and against JAX's eager update (``Adam._adam_core``, the path the
JAX optimizer takes for a tensor whose size the TPU kernel does not tile)
at 1e-6; and the port optimizer's ``fused`` knob.  On CPU tensors the
wrapper runs its plain version, so the launch counter must not move."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import optimizer as joptim
from paddle_tpu_torch.ops import fused as tfu
from paddle_tpu_torch.optimizer import Adam, AdamW

jfu = importlib.import_module("paddle_tpu.ops.pallas.fused")

TOL = dict(rtol=1e-6, atol=1e-6)
HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


def _state(n, seed):
    r = np.random.default_rng(seed)
    p = r.standard_normal(n).astype(np.float32)
    g = r.standard_normal(n).astype(np.float32)
    m = (0.1 * r.standard_normal(n)).astype(np.float32)
    v = (0.01 * r.random(n)).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("step", [1, 3])
@pytest.mark.parametrize("n", [16384, 8192 + 1024])
def test_update_matches_pallas_interpret(n, step):
    p, g, m, v = _state(n, seed=n + step)
    jp, jm, jv = jfu.adamw_update(*(jnp.asarray(a) for a in (p, g, m, v)),
                                  step=step, interpret=True, **HYPER)
    tp, tg, tm, tv = (torch.from_numpy(a.copy()) for a in (p, g, m, v))
    before = tfu.adamw_update.launches
    out = tfu.adamw_update(tp, tg, tm, tv, step=step, **HYPER)
    assert tfu.adamw_update.launches == before
    assert out[0] is tp and out[1] is tm and out[2] is tv
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_parameter_with_f32_moments():
    p, g, m, v = _state(8192, seed=5)
    jp, jm, jv = jfu.adamw_update(
        jnp.asarray(p).astype(jnp.bfloat16), jnp.asarray(g).astype(
            jnp.bfloat16), jnp.asarray(m), jnp.asarray(v), step=3,
        interpret=True, **HYPER)
    tp = torch.from_numpy(p).bfloat16()
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    tfu.adamw_update(tp, torch.from_numpy(g).bfloat16(), tm, tv, step=3,
                     **HYPER)
    assert tp.dtype == torch.bfloat16 and tm.dtype == torch.float32
    np.testing.assert_array_equal(tp.float().numpy(),
                                  np.asarray(jp.astype(jnp.float32)))
    for got, want in ((tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [768, 1000, 40000])
def test_untileable_length_matches_jax_eager_update(n):
    """The JAX wrapper declines these lengths (not a multiple of 1,024, or
    under 8,192) and the JAX optimizer runs its eager update; the port's
    kernel takes them.  Same function, rounded once differently."""
    p, g, m, v = _state(n, seed=n)
    assert jfu.adamw_update(*(jnp.asarray(a) for a in (p, g, m, v)), step=2,
                            interpret=True, **HYPER) is None
    jopt = joptim.AdamW(learning_rate=HYPER["lr"],
                        weight_decay=HYPER["weight_decay"])
    st = {"moment1": jnp.asarray(m), "moment2": jnp.asarray(v),
          "beta1_pow": jnp.asarray(0.9, jnp.float32),
          "beta2_pow": jnp.asarray(0.999, jnp.float32)}
    jp, jst = jopt._update(jnp.asarray(p), jnp.asarray(g), st, HYPER["lr"])
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    tfu.adamw_update(tp, torch.from_numpy(g), tm, tv,
                     beta1_pow=torch.tensor(0.9 * 0.9),
                     beta2_pow=torch.tensor(0.999 * 0.999), **HYPER)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jst["moment1"]), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jst["moment2"]), **TOL)


def test_bias_from_step_from_bias_and_from_beta_pows_agree():
    p, g, m, v = _state(4096, seed=7)
    runs = []
    for kw in (dict(step=4), dict(bias1=1 - 0.9 ** 4, bias2=1 - 0.999 ** 4),
               dict(beta1_pow=torch.tensor(0.9 ** 4),
                    beta2_pow=torch.tensor(0.999 ** 4))):
        runs.append(tfu.adamw_update_ref(*(torch.from_numpy(a)
                                           for a in (p, g, m, v)),
                                         **HYPER, **kw))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _opt_step(opt, params, grads):
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    st = opt.init_opt_state(tp, device="cpu")
    new, nst = opt.apply_gradients_functional(tp, tg, st)
    new, nst = opt.apply_gradients_functional(new, tg, nst)
    return new, nst


@pytest.mark.parametrize("cls", [AdamW, Adam])
def test_optimizer_fused_knob_matches_eager_update(cls):
    """Two steps of ``fused=True`` (every tensor through the kernel's plain
    version) against ``fused=False`` (the eager update): equal to 1e-6,
    and the beta powers step the same way."""
    params = {f"t{i}": _state(n, seed=i)[0] for i, n in enumerate((96, 9216))}
    grads = {k: _state(v.size, seed=40 + i)[1]
             for i, (k, v) in enumerate(params.items())}
    kw = dict(learning_rate=1e-3, weight_decay=0.01)
    before = tfu.adamw_update.launches
    fp, fst = _opt_step(cls(fused=True, **kw), params, grads)
    assert tfu.adamw_update.launches == before
    ep, est = _opt_step(cls(**kw), params, grads)
    for k in params:
        np.testing.assert_allclose(fp[k].numpy(), ep[k].numpy(), **TOL)
        for key in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_allclose(fst[k][key].numpy(),
                                       est[k][key].numpy(), **TOL)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for dtype in (torch.float32, torch.bfloat16):
        p, g, m, v = (torch.from_numpy(a).cuda() for a in _state(40000, 8))
        p, g = p.to(dtype), g.to(dtype)
        pows = dict(beta1_pow=torch.tensor(0.9 ** 3, device="cuda"),
                    beta2_pow=torch.tensor(0.999 ** 3, device="cuda"))
        want = tfu.adamw_update_ref(p, g, m, v, **HYPER, **pows)
        before = tfu.adamw_update.launches
        tfu.adamw_update(p, g, m, v, **HYPER, **pows)
        torch.cuda.synchronize()
        assert tfu.adamw_update.launches == before + 1
        for got, ref in zip((p, m, v), want):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
